"""The JAX package's own testbed campaign on chip_smoke.py's phase-6
inputs, on the CPU: the reference the port's per-point NMSE of phase 9's
grid (the testbed driver's random campaign, on the same rows; its RSS
is measured a round at a time, so its jitter is drawn otherwise) is read
against.

    python3 tests/jax_campaign_reference.py

Builds phase 6's inputs with the port on the CPU
(``chip_smoke.campaign_workload(device="cpu")``: the 3968-row 16x16
random codebook, the 3-path channel and its RSS at the provider's
defaults, all drawn on the CPU from one seed, so they equal what the card
sees), hands them to JAX as numpy, and runs
``twoace_tpu.pipeline.recovery.recover_a2only`` over the probe-budget grid
at the default ``CampaignConfig``, then the noiseless M = 1024 point.
Prints each point's projection NMSE and seconds.  Full size: JAX compiles
its solver once per grid shape, so this takes minutes; run it where memory
and minutes are plentiful, not inside the test suite.
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

from chip_smoke import (M, NR, NT, campaign_estimate,  # noqa: E402
                        campaign_workload, proj_nmse_db)
from twoace_tpu.config import ArrayConfig, MethodFlags  # noqa: E402
from twoace_tpu.pipeline.recovery import (CampaignConfig,  # noqa: E402
                                          recover_a2only, recover_campaign)


def main():
    cb, x_true, rss, clean = campaign_workload(device="cpu")
    cb, x_true = cb.numpy(), x_true.numpy()
    cc = CampaignConfig(array=ArrayConfig(nt=NT, nr=NR))
    t0 = time.perf_counter()
    out = recover_a2only(jnp.asarray(cb), jnp.asarray(rss), 1, cc)
    secs = time.perf_counter() - t0
    dbs = [round(proj_nmse_db(campaign_estimate(out, i), x_true), 2)
           for i in range(len(out.m_grid))]
    print(f"JAX recover_a2only on phase 6's inputs, grid {out.m_grid}: NMSE "
          f"dB {dbs} | {secs:.1f} s (CPU, compiles included)", flush=True)
    t0 = time.perf_counter()
    out = recover_campaign(jnp.asarray(cb), jnp.asarray(clean),
                           MethodFlags(), cc, 1, m_grid=(M,))
    print(f"JAX noiseless M {M}: NMSE "
          f"{proj_nmse_db(campaign_estimate(out, 0), x_true):.2f} dB | "
          f"{time.perf_counter() - t0:.1f} s (CPU)", flush=True)


if __name__ == "__main__":
    main()
