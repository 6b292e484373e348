"""Two-stage compressive phase retrieval: PLOMP and PLGAMP (port of
``twoace_tpu.ops.twostage``).

ref: main/src/my_recovery_algorithms/My_TwoStage_Recovery.m:75-182:

  1. SVD-compress the sensing matrix ``A = P C`` keeping ``mCS``
     directions (ref :81-100);
  2. stage 1: PhaseLift (FISTA) on ``P`` recovers the compressed vector
     up to a global phase (ref :117-153);
  3. stage 2: OMP (PLOMP) or Bernoulli-Gaussian GAMP (PLGAMP) solves the
     sparse system ``C z = intermediate`` (ref :156-181).

mCS is an integer chosen on the host from the singular values with the
reference's data-dependent rules (:func:`adaptive_mcs`); a float32 SVD
that moves it by one changes the whole result.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import TwoStageConfig
from .gamp import embgamp
from .omp import omp
from .phaselift import phaselift_fista


class TwoStageResult(NamedTuple):
    plomp: torch.Tensor       #: (n,) sparse recovery via OMP stage 2
    plgamp: torch.Tensor      #: (n,) sparse recovery via GAMP stage 2
    compressed: torch.Tensor  #: (mcs,) stage-1 intermediate solution
    mcs: int                  #: the compression size


def static_mcs(m: int, n: int, s: int, cfg: TwoStageConfig) -> int:
    """The m-driven compression size ``min(m, n, min{k: 1.75 k log k >=
    m})`` (the JAX package's static shortcut, kept for reference)."""
    lo = max(2, round(cfg.cs_oversample * s * math.log(max(n / max(s, 1), 2))))
    k = max(2, min(lo, min(m, n)) - 1)
    while round(cfg.cs_oversample * k * math.log(max(k, 2))) < m \
            and k < min(m, n):
        k += 1
    return k


def adaptive_mcs(singular_values, m: int, n: int, s: int,
                 cfg: TwoStageConfig) -> int:
    """The reference's exact data-dependent mCS rules (host side).

    ref: My_TwoStage_Recovery.m:79-95: start near 1.75 s log(n/s), grow
    until the captured singular-value mass reaches ``energy_threshold``,
    then grow further while 1.75 mCS log(mCS) < m.
    """
    ds = np.asarray(singular_values)
    total = float(ds.sum())
    k_max = len(ds)
    lo = round(cfg.cs_oversample * s * math.log(max(n / max(s, 1), 2)))
    k = max(1, min(lo, k_max) - 1)
    while float(ds[:k].sum()) < cfg.energy_threshold * total and k < k_max:
        k += 1
    while round(cfg.cs_oversample * k * math.log(max(k, 2))) < m and k < k_max:
        k += 1
    return k


def omp_fallback_gate(raw, omp_soln, c, target, floor2):
    """EMBGAMP -> OMP fallback (ref: My_TwoStage_Recovery.m:173-178 wraps
    EMBGAMP in try/catch and answers OMP on failure): keep GAMP's ``raw``
    unless it is non-finite or its residual ``||target - c raw||^2`` is
    not below ``floor2`` (a collapsed iterate sits at the zero fixed
    point), else take ``omp_soln``.  All on the device."""
    fin = torch.isfinite(raw.real) & torch.isfinite(raw.imag)
    raw_safe = torch.where(fin, raw, 0)
    r2 = torch.sum((target - c @ raw_safe).abs() ** 2)
    ok = torch.all(fin) & (r2 < floor2)
    return torch.where(ok, raw, omp_soln)


def two_stage_recovery(measurements, a, s: int, noise_power: float = 1.0,
                       cfg: TwoStageConfig = TwoStageConfig(),
                       run_plomp: bool = True, run_plgamp: bool = True,
                       mcs: Optional[int] = None) -> TwoStageResult:
    """``measurements``: (m,) intensities |y|^2; ``a``: (m, n) measurement
    matrix (already FW @ AD); ``s``: sparsity (number of paths).

    mCS is picked on the host from ``a``'s singular values
    (:func:`adaptive_mcs`) unless given.
    """
    m, n = a.shape
    u, sv, vh = torch.linalg.svd(a, full_matrices=False)
    if mcs is None:
        mcs = adaptive_mcs(sv.cpu().numpy(), m, n, s, cfg)
    k = mcs
    # SVD split A = P C (ref :81-100)
    root = torch.sqrt(sv[:k]).to(a.dtype)
    p = u[:, :k] * root
    c = root[:, None] * vh[:k]

    # stage 1: PhaseLift on P (ref :117-153)
    int_soln = phaselift_fista(p, measurements.real, cfg.phaselift).x

    # stage 2 (ref :156-181); the OMP solve doubles as PLGAMP's fallback
    zero = torch.zeros(n, dtype=a.dtype, device=a.device)
    omp_soln = (omp(c, int_soln, max_steps=max(2 * s, 4))
                if run_plomp or run_plgamp else zero)
    plgamp = zero
    if run_plgamp:
        snr_db = 10.0 * math.log10(1.0 / max(noise_power, 1e-20))
        raw = embgamp(int_soln, c, snr_db, lam0=s / n, learn_lambda=False)
        # the stage-2 "noise" is the stage-1 PhaseLift error, which has no
        # a-priori power: the collapse floor is estimated from the
        # achievable residual, OMP's LS refit (a GAMP residual within 2x of
        # it, 4x in power, is a healthy fit), or 0.9 ||int_soln||
        r2_omp = torch.sum((int_soln - c @ omp_soln).abs() ** 2)
        floor2 = torch.maximum(0.81 * torch.sum(int_soln.abs() ** 2),
                               4.0 * r2_omp)
        plgamp = omp_fallback_gate(raw, omp_soln, c, int_soln, floor2)
    return TwoStageResult(plomp=omp_soln if run_plomp else zero,
                          plgamp=plgamp, compressed=int_soln, mcs=mcs)
