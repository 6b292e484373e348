"""Recovery campaign entry points (port of ``twoace_tpu.pipeline.recovery``):
the ``channel_recovery_ADMM_v2_simulation_*.m`` entry scripts as a library
(ref: main/channel_recovery_ADMM_v2_simulation_A2only.m:9-179, _A2nuclear.m,
_multiresolution.m:111-143, _phaselift.m, _directional.m).

Given a probed codebook and its measured RSS trace, sweep the probe-budget
grid M and recover the channel with every enabled method.  The solves run
on the codebook's device (the card by default for numpy input).  The
seed table indexes the same experiments as the JAX package, but the
generators drawn from a seed are torch's, so the probe subsets differ.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import (DEFAULT_RSS_FCT, MULTIRES_SEPARATION,
                      MULTIRES_THRESHOLDS, SEED_TABLE, AdmmConfig,
                      ArrayConfig, MethodFlags, probe_budget_grid)
from ..interop import resolve_device
from ..models.steering import angle_dictionary
from ..ops.admm import (_make_prox, _normalize_problem, _quality, infer_admm,
                        solve_lowrank_multi)
from ..ops.dispatch import recover_channel
from ..sensing.sensing_matrix import pick_beams
from ..utils.rng import fold_in
from ..utils.units import dbm_to_amplitude


class RecoveryOutput(NamedTuple):
    h_amp: np.ndarray     #: (len(m_grid), n_methods, n) |H| estimates
    h_angle: np.ndarray   #: (len(m_grid), n_methods, n) angle(H)
    m_grid: Tuple[int, ...]
    methods: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    """Shared scaffold of the entry points (ref: A2only.m:37-64)."""

    array: ArrayConfig = ArrayConfig()
    searching_area_deg: float = 95.0
    n_paths: int = 3
    rss_fct: float = DEFAULT_RSS_FCT
    beam_mode: str = "Random_Phase_State"   #: or "Bayes_Beam"
    multires: bool = False
    multires_thresholds: Tuple[int, int] = MULTIRES_THRESHOLDS
    multires_separation: Tuple[int, int, int] = MULTIRES_SEPARATION
    admm: AdmmConfig = AdmmConfig()


def _pick_m_indices(generator, m_cur: int, total: int, cc: CampaignConfig):
    """Probe subset, tier-aware for multires (ref: A2only.m:137, plain
    randperm; multiresolution.m:137-143, tier thresholds 96/256 with row
    offsets 1984/3968/3968).  Drawn on the CPU."""
    if cc.multires:
        t1, t2 = cc.multires_thresholds
        s1, s2, s3 = cc.multires_separation
        if m_cur <= t1:
            lo, size = 0, min(s1, total)
        elif m_cur <= t2:
            lo, size = s1, min(s2, max(total - s1, 1))
        else:
            lo, size = s1 + s2, min(s3, max(total - s1 - s2, 1))
        return torch.randperm(size, generator=generator)[:m_cur] + lo
    return torch.randperm(total, generator=generator)[:m_cur]


def _campaign_inputs(cb_rows, rss_dbm, cc: CampaignConfig, seed_id: int,
                     m_grid, device):
    """Codebook and amplitudes on the solve device, the grid, and the
    campaign's generator (ref: A2only.m:103-104, :139)."""
    dev = cb_rows.device if isinstance(cb_rows, torch.Tensor) \
        else resolve_device(device)
    cb_rows = torch.as_tensor(cb_rows, device=dev)
    amps = dbm_to_amplitude(torch.as_tensor(rss_dbm, device=dev).reshape(-1),
                            cc.rss_fct)
    if m_grid is None:
        m_grid = probe_budget_grid(cc.array.nt, cc.array.nr)
    gen = torch.Generator().manual_seed(
        SEED_TABLE[(seed_id - 1) % len(SEED_TABLE)])
    return cb_rows, amps, tuple(m_grid), gen


def _store(h_amp, h_angle, i, j, x, rss_fct):
    h = np.nan_to_num(x.detach().cpu().numpy() / rss_fct)
    h_amp[i, j] = np.abs(h)
    h_angle[i, j] = np.angle(h)


def recover_campaign(cb_rows, rss_dbm, methods: MethodFlags,
                     cc: CampaignConfig = CampaignConfig(),
                     seed_id: int = 1,
                     m_grid: Optional[Tuple[int, ...]] = None,
                     nuclear: bool = False, device="cuda") -> RecoveryOutput:
    """Sweep the probe-budget grid and recover with every enabled method.

    ``cb_rows``: (total, nt*nr) complex probe rows (the compiled codebook),
    a tensor (its device is used) or numpy (put on ``device``);
    ``rss_dbm``: (total,) measured RSS in dBm.  ``seed_id`` indexes the
    reference's fixed seed table (ref: A2only.m:103-104).  Grid point i
    draws its probe subset from ``fold_in(gen, i)``, its beam pick from
    ``fold_in(.., 1)`` and its solves from ``fold_in(.., 2)``.

    Returns amplitude/angle arrays scaled back by 1/rss_fct
    (ref: A2only.m:170).
    """
    cb_rows, amps, m_grid, gen = _campaign_inputs(cb_rows, rss_dbm, cc,
                                                  seed_id, m_grid, device)
    total, n = cb_rows.shape
    flags = methods
    if nuclear:
        flags = dataclasses.replace(methods, admm_lowrank_v4=False,
                                    admm_nuclear=True)
    names = tuple(flags.enabled())
    ad = angle_dictionary(cc.array, cc.searching_area_deg,
                          dtype=cb_rows.dtype, device=cb_rows.device)
    h_amp = np.zeros((len(m_grid), len(names), n))
    h_angle = np.zeros_like(h_amp)
    for i, m_cur in enumerate(m_grid):
        m_cur = min(m_cur, total)
        g_i = fold_in(gen, i)
        m_idx = _pick_m_indices(g_i, m_cur, total, cc).to(cb_rows.device)
        cb_train, rss_train = cb_rows[m_idx], amps[m_idx]
        picked = pick_beams(fold_in(g_i, 1), cc.beam_mode, m_cur, cb_train)
        est = recover_channel(fold_in(g_i, 2), rss_train[picked],
                              cb_train[picked], flags, cc.array,
                              s=cc.n_paths, ad=ad, admm_cfg=cc.admm)
        for j, name in enumerate(names):
            _store(h_amp, h_angle, i, j, est[name], cc.rss_fct)
    return RecoveryOutput(h_amp=h_amp, h_angle=h_angle, m_grid=m_grid,
                          methods=names)


def recover_a2only(cb_rows, rss_dbm, seed_id: int = 1,
                   cc: CampaignConfig = CampaignConfig(), device="cuda"
                   ) -> RecoveryOutput:
    """ADMMLowRankV4 only (ref: channel_recovery_ADMM_v2_simulation_A2only.m)."""
    return recover_campaign(cb_rows, rss_dbm,
                            MethodFlags(admm_lowrank_v4=True), cc, seed_id,
                            device=device)


def recover_a2nuclear(cb_rows, rss_dbm, seed_id: int = 1,
                      cc: CampaignConfig = CampaignConfig(), device="cuda"
                      ) -> RecoveryOutput:
    """Nuclear-norm variant (ref: ..._A2nuclear.m; its seeds
    [1024, 2048, ...] collapse to the same table here)."""
    return recover_campaign(cb_rows, rss_dbm,
                            MethodFlags(admm_lowrank_v4=True), cc, seed_id,
                            nuclear=True, device=device)


def recover_multiresolution(cb_rows, rss_dbm, seed_id: int = 1,
                            cc: Optional[CampaignConfig] = None,
                            device="cuda") -> RecoveryOutput:
    """Tier-aware multires sampling (ref: ..._multiresolution.m:111-143)."""
    if cc is None:
        cc = CampaignConfig(multires=True)
    return recover_campaign(cb_rows, rss_dbm,
                            MethodFlags(admm_lowrank_v4=True), cc, seed_id,
                            device=device)


def recover_phaselift(cb_rows, rss_dbm, seed_id: int = 1,
                      cc: CampaignConfig = CampaignConfig(), device="cuda"
                      ) -> RecoveryOutput:
    """PhaseLift baseline entry (ref: ..._phaselift.m): the lifted FISTA
    on the testbed's scaling chain at every grid point."""
    return recover_campaign(cb_rows, rss_dbm, MethodFlags(
        admm_lowrank_v4=False, phaselift=True), cc, seed_id, device=device)


def recover_directional(cb_rows, rss_dbm, seed_id: int = 1,
                        cc: Optional[CampaignConfig] = None, device="cuda"
                        ) -> RecoveryOutput:
    """PLOMP/PLGAMP on a directional codebook (ref: ..._directional.m,
    d = 2.9 mm, 180 deg search area), through the sparse dictionary of
    the campaign's search area."""
    if cc is None:
        cc = CampaignConfig(array=ArrayConfig(spacing=2.9e-3),
                            searching_area_deg=180.0)
    return recover_campaign(cb_rows, rss_dbm, MethodFlags(
        admm_lowrank_v4=False, plomp=True, plgamp=True), cc, seed_id,
        device=device)


def recover_warm_sweep(cb_rows, rss_dbm, seed_id: int = 1,
                       cc: CampaignConfig = CampaignConfig(),
                       m_grid: Optional[Tuple[int, ...]] = None,
                       quality_gate: float = 0.6, device="cuda"):
    """Warm-started coarse -> fine probe-budget sweep (A2 only).

    The first budget runs the full 3-restart scaffold; each later one runs
    one refinement-phase ADMM from the previous estimate (the reference's
    full-data refine, ref: inferLowRankV4_multi.m:89-101) and falls back
    to the full solve when the quality drops below ``quality_gate``.

    The gate's quality is computed as the JAX package computes it,
    ``_quality(a, b, x[:, None])``: the (m, 1) amplitudes broadcast
    against b (m,), so it measures an m x m residual and lies far below
    the gate for any real fit.  Every later budget therefore falls back
    to the full solve, in both packages (ROADMAP.md records this as a
    fault of the reference).

    Returns ``(RecoveryOutput, qualities)``.
    """
    cb_rows, amps, m_grid, gen = _campaign_inputs(cb_rows, rss_dbm, cc,
                                                  seed_id, m_grid, device)
    total, n = cb_rows.shape
    cfg = cc.array
    h_amp = np.zeros((len(m_grid), 1, n))
    h_angle = np.zeros_like(h_amp)
    qualities = []
    x_prev = None
    for i, m_cur in enumerate(m_grid):
        m_cur = min(m_cur, total)
        g_i = fold_in(gen, i)
        m_idx = _pick_m_indices(g_i, m_cur, total, cc).to(cb_rows.device)
        a, b = cb_rows[m_idx], amps[m_idx].real
        q = None
        if x_prev is not None:
            # refinement-only warm solve on the normalized problem
            a_n, b_n, a_norm, b_norm = _normalize_problem(a, b,
                                                          cc.admm.tol_abs)
            x0 = (x_prev * (a_norm / b_norm).to(a.dtype))[:, None]
            prox = _make_prox("spectral_profile", cfg.nt, cfg.nr, m_cur, n,
                              False, cc.admm, "jacobi")
            xr, _, _ = infer_admm(a_n, b_n, x0, scale_by_row=True, prox=prox,
                                  mu0=cc.admm.mu0, rho=cc.admm.rho,
                                  tol_rel=cc.admm.tol_rel,
                                  tol_abs=cc.admm.tol_abs,
                                  maxiter=cc.admm.maxiter)
            x = xr[:, 0] * (b_norm / a_norm).to(a.dtype)
            q = float(_quality(a, b, x[:, None]))
        if q is None or not np.isfinite(q) or q < quality_gate:
            res = solve_lowrank_multi(fold_in(g_i, 2), a, b, cfg.nt, cfg.nr,
                                      cc.admm)
            x, q = res.x, float(res.quality)
        x_prev = x
        qualities.append(q)
        _store(h_amp, h_angle, i, 0, x, cc.rss_fct)
    return (RecoveryOutput(h_amp=h_amp, h_angle=h_angle, m_grid=m_grid,
                           methods=("admm_lowrank_v4_warm",)),
            qualities)
