"""The JAX package's cold fresh-pair tracker on chip_smoke.py's phase-5
workload, on the CPU: the reference the port's tracked NMSE there is read
against.

    python3 tests/jax_mobility_reference.py [windows]

Runs ``twoace_tpu.pipeline.mobility.track`` with ``make_pair_solver`` at
``AdmmConfig(maxiter=500)`` on the fresh-pair stream of
scripts/bench_mobility_r05.py's workload (16x16, windows of 64 kron
probes, max_window 256), over the first ``windows`` windows (default all
40), and prints the tracked NMSE of each window and the median of the
first and last quarters, as chip_smoke.py phase 5 does.  Full size: run
it where memory and minutes are plentiful, not inside the test suite.
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from chip_smoke import (MOB_WINDOWS, NR, NT, mobility_workload,  # noqa: E402
                        tracked_nmse_db)
from twoace_tpu.config import AdmmConfig, ArrayConfig  # noqa: E402
from twoace_tpu.pipeline.mobility import (MobilityConfig,  # noqa: E402
                                          make_pair_solver, track)


def main(windows: int = MOB_WINDOWS):
    _, _, rows, amps, vhs, _, p = mobility_workload()
    rows, amps, vhs = rows[:windows * p], amps[:windows * p], vhs[:windows]
    cfg = ArrayConfig(nt=NT, nr=NR)
    admm = AdmmConfig(maxiter=500)
    mob = MobilityConfig(window_probes=p, max_window=256, admm=admm)
    t0 = time.perf_counter()
    trace = track(jax.random.PRNGKey(0), rows, amps, cfg, mob,
                  solver=make_pair_solver(cfg, admm))
    secs = time.perf_counter() - t0
    db = tracked_nmse_db(trace.estimates, vhs)
    q = max(windows // 4, 1)
    print(f"JAX cold_freshpairs_window256, {windows} windows: tracked NMSE "
          f"median first quarter {np.median(db[1:q]):.2f} dB, last quarter "
          f"{np.median(db[-q:]):.2f} dB | per window "
          f"{np.round(db, 1).tolist()} | budgets "
          f"{trace.probe_budget.tolist()} | {secs:.1f} s (CPU)", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else MOB_WINDOWS)
