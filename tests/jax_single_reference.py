"""The JAX package's single-recovery solver on chip_smoke.py's phase-4
workloads, on the CPU: the reference the port's accuracy there is read
against.

    python3 tests/jax_single_reference.py [reps]

Runs ``twoace_tpu.ops.pair_solver.solve_lowrank_multi_pair`` at the cold
``AdmmConfig(maxiter=500)`` on bench.py's single-latency workload (seed
3, 16x16, m = 1024, a random complex x) and on a two-path channel through
the same codebook, ``reps`` keys each (default 2), and prints NMSE,
held-out quality and iterations.  Full size: run it where memory and
minutes are plentiful, not inside the test suite.
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from chip_smoke import NR, NT, single_workload  # noqa: E402
from twoace_tpu.config import AdmmConfig  # noqa: E402
from twoace_tpu.ops.cplx import Pair  # noqa: E402
from twoace_tpu.ops.pair_solver import solve_lowrank_multi_pair  # noqa: E402


def main(reps: int = 2):
    a, workloads = single_workload()
    ap = Pair(jnp.asarray(a.real, jnp.float32),
              jnp.asarray(a.imag, jnp.float32))
    for name, x in workloads.items():
        b = jnp.asarray(np.abs(a @ x), jnp.float32)
        for i in range(reps):
            t0 = time.perf_counter()
            res = solve_lowrank_multi_pair(
                jax.random.fold_in(jax.random.PRNGKey(0), i), ap, b, NT, NR,
                AdmmConfig(maxiter=500))
            xe = np.asarray(res.x.re) + 1j * np.asarray(res.x.im)
            c = np.vdot(xe, x) / max(np.vdot(xe, xe).real, 1e-30)
            nmse = (np.linalg.norm(x - c * xe) ** 2
                    / np.linalg.norm(x) ** 2)
            print(f"JAX {name} key {i}: NMSE {10 * np.log10(nmse):.2f} dB | "
                  f"quality {float(res.quality):.6f} | iters "
                  f"{int(res.iters)} | {time.perf_counter() - t0:.1f} s "
                  f"(CPU)", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
