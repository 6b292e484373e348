"""Conventional compressive sensing with perfect or noisy phase (port of
``twoace_tpu.ops.cpr_baselines.conventional_cs``).

ref: My_Conventional_CS.m:14-30: EMBGAMP with lambda learning, and OMP as
the fallback.  The other baselines of the JAX module (``cprl``,
``lifted_omp``, ``sparse_phaselift``, ``unconventional_cs``) are still to
port.
"""

from __future__ import annotations

import math

import torch

from .gamp import embgamp
from .omp import omp
from .twostage import omp_fallback_gate


def conventional_cs(measurements_complex, a, s: int, noise_power: float,
                    use_gamp: bool = True):
    """Conventional CS given the (perfect or noisy) phase: ``y``: (m,)
    complex measurements, ``a``: (m, n).

    With ``use_gamp`` EMBGAMP runs and OMP is computed as well; GAMP's
    answer is kept unless it is non-finite or collapsed.  The collapse
    test is noise-aware: a residual counts as collapse only if it beats
    neither the zero-solution bound 0.9 ||y|| nor twice the expected
    noise floor m sigma^2 (a perfect estimate's residual power).
    ``use_gamp=False`` answers OMP alone.
    """
    y = measurements_complex
    if not use_gamp:
        return omp(a, y, max_steps=s)
    m, n = a.shape
    snr_db = 10.0 * math.log10(1.0 / max(noise_power, 1e-20))
    x = embgamp(y, a, snr_db, lam0=s / n, learn_lambda=True)
    x_omp = omp(a, y, max_steps=s)
    floor2 = torch.clamp(0.81 * torch.sum(y.abs() ** 2),
                         min=2.0 * m * noise_power)
    return omp_fallback_gate(x, x_omp, a, y, floor2)
