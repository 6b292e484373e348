"""The remaining compressive-phase-retrieval baselines (port of
``twoace_tpu.ops.cpr_baselines``).

- CPRL: lifted sparse PhaseLift ``min ||b - A(X)||_1 + mu ||X||_1,
  X >= 0`` (ref: main/src/my_recovery_algorithms/MyCPRL.m:66-116; the
  reference solves it with CVX/Mosek, the JAX package and the port by a
  proximal subgradient method: smoothed L1 data term, elementwise soft
  threshold, PSD projection).
- lifted OMP: OMP on the rank-1-lifted system (ref: MyOMP.m:63-82).
- SparsePL: correlation pre-screening to 5% of the columns, then
  PhaseLift on the reduced dictionary (ref: MySparsePL.m:70-120).
- conventional CS with perfect or noisy phase: EMBGAMP with the OMP
  fallback (ref: My_Conventional_CS.m:14-30).
- unconventional CS: norm-constrained ridge least squares
  (ref: My_Unconventional_CS.m:1-16).

Each loop has a fixed trip count, as in the JAX package, and reads
nothing back to the host; CPRL runs a ``torch.linalg.eigh`` of the
(n, n) lifted iterate every trip.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import PhaseLiftConfig
from ..utils.metrics import top_k_first
from .gamp import embgamp
from .omp import omp
from .phaselift import (_adjoint, _apply_linop, _extract, _lipschitz,
                        phaselift_fista)
from .twostage import omp_fallback_gate


def cprl(measurements, a, mu: float = 5e-2, iters: int = 500,
         smooth_eps: float = 1e-6):
    """CPRL lifted sparse phase retrieval.

    ``measurements``: (m,) intensities; ``a``: (m, n).  A diminishing
    subgradient step ``t0 / sqrt(k + 1)`` (the smoothed L1 data term's
    gradient is bounded row by row), then the complex soft threshold and
    the PSD projection.  Returns the rank-1 extraction sqrt(w_max) v_max
    (ref: MyCPRL.m:110-116).
    """
    m, n = a.shape
    b = measurements.real
    t0 = (torch.mean(b) / _lipschitz(a)) * m ** 0.5
    x = torch.zeros((n, n), dtype=a.dtype, device=a.device)
    for k in range(iters):
        # the JAX package counts k in float32
        t = t0 / float(np.sqrt(np.float32(1.0 + k)))
        r = _apply_linop(a, x) - b
        g = _adjoint(a, r / torch.sqrt(r * r + smooth_eps))
        z = x - t.to(a.dtype) * g
        # the elementwise complex soft threshold (prox of mu ||X||_1)
        mag = z.abs()
        z = z * (torch.clamp(mag - t * mu, min=0.0)
                 / torch.clamp(mag, min=1e-30)).to(a.dtype)
        # the PSD projection
        w, v = torch.linalg.eigh(0.5 * (z + z.mH))
        x = (v * torch.clamp(w, min=0.0).to(v.dtype)) @ v.mH
    return _extract(x)


def lifted_omp(measurements, a, s: int):
    """OMP on the lifted system: rows kron(a_i^T, a_i^H), unknown
    vec(x x^H) (ref: MyOMP.m:63-82).  O(m n^2) memory and an (n^2, n^2)
    Gram: small-n baselines only."""
    m, n = a.shape
    a_lift = (a[:, :, None] * a.conj()[:, None, :]).reshape(m, n * n)
    vec_z = omp(a_lift, measurements.real.to(a.dtype), max_steps=s)
    z = vec_z.reshape(n, n)
    return _extract(0.5 * (z + z.mH))


def sparse_phaselift(measurements, a, keep: int = 0,
                     cfg: PhaseLiftConfig = PhaseLiftConfig()):
    """Correlation pre-screening to ``keep`` columns (5% of them by
    default), then PhaseLift FISTA on the reduced dictionary (ref:
    MySparsePL.m:77-120).  ``measurements``: intensities; the screening
    scores column j by sum_i |A_ij| sqrt(y_i) (ref :80-84), the lower
    index first among equal scores."""
    n = a.shape[1]
    k = keep if keep > 0 else max(1, math.ceil(0.05 * n))
    b = measurements.real
    corr = torch.sum(a.abs() * torch.sqrt(b)[:, None], dim=0)
    idx = top_k_first(corr, k)
    xt = phaselift_fista(a[:, idx], b, cfg).x
    out = torch.zeros(n, dtype=a.dtype, device=a.device)
    return out.index_copy(0, idx, xt)


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


def unconventional_cs(measurements, f):
    """Norm-constrained ridge least squares, the "unconventional CS" entry
    (ref: My_Unconventional_CS.m:1-16): ``x = (A'A + lam I)^{-1} A'b``
    with ``A = F^T`` and ``lam`` in [0, 1] picked so that ``||x|| = 1``.
    In the eigenbasis of A'A the norm is ``||c / (s + lam)||`` with
    ``c = U'A'b``, decreasing in lam, so the reference's 1-D fmincon
    becomes a 50-step bisection (kept on the device)."""
    b = measurements
    a = f.T
    s, u = torch.linalg.eigh(a.mH @ a)
    c = u.mH @ (a.mH @ b)
    lo = torch.zeros((), dtype=s.dtype, device=s.device)
    hi = torch.ones((), dtype=s.dtype, device=s.device)
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        # too large a norm needs more shrinkage: raise lam
        too_big = torch.linalg.vector_norm(c / (s + mid)) > 1.0
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    return u @ (c / (s + 0.5 * (lo + hi)))
