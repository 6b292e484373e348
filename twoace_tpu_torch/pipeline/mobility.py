"""Adaptive mobility tracking (port of ``twoace_tpu.pipeline.mobility``).

The RSS_Mobility loop (ref: Numerical_Simulation/main_programs/
RSS_Mobility.m:146-190 and RSS_Mobility_simu.m): per time window, predict
RSS with the previous channel estimate; if the prediction error exceeds a
threshold, grow the probe budget ``M <- min(ceil(1.2 M + 1), M_max)`` and
re-solve on a sliding window of the most recent probes; otherwise reset
the budget to zero.

The tracking loops (:func:`track`, :func:`track_simulated`) are host-side
numpy, as in the JAX package; the solver callbacks own the device (the
card by default) and take a ``torch.Generator`` where JAX's take a PRNG
key.  Their default solver, as in JAX, is the complex-dtype A2 solver
``ops.admm.solve_lowrank_multi`` (:func:`make_complex_solver`), on the
card.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import warnings
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import AdmmConfig, ArrayConfig, ChannelConfig
from ..interop import complex_from_numpy, pair_from_numpy, resolve_device
from ..ops.admm import solve_lowrank_multi
from ..ops.cplx import Pair
from ..utils.rng import fold_in  # noqa: F401  (re-exported)
from ..ops.pair_solver import (_normalize_problem_pair, refine_lowrank_pair,
                               solve_lowrank_multi_pair,
                               spectral_initialize_pair)


@dataclasses.dataclass(frozen=True)
class MobilityConfig:
    """ref: RSS_Mobility.m:128-131."""

    window_probes: int = 62     #: probes per time window (T_size)
    max_window: int = 80        #: sliding-window cap (Mw_max)
    threshold: float = 0.3      #: rss-error threshold for re-probing
    growth: float = 1.2         #: probe-budget growth factor
    admm: AdmmConfig = AdmmConfig()


class MobilityTrace(NamedTuple):
    rss_error: np.ndarray       #: (T,) per-window prediction error
    probe_budget: np.ndarray    #: (T,) adaptive M at each window
    estimates: np.ndarray       #: (T, n) channel estimate per window


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _relative_rss_error(rss_pred, rss_actual, eps: float = 1e-12) -> float:
    """Mean relative RSS prediction error (ref: Evaluate_rss.m:1-7) with a
    floor on the denominator: a zero/near-zero amplitude probe (a dead
    beam or a padded row) must not yield inf/NaN, which would permanently
    saturate the probe-budget loop."""
    denom = np.maximum(np.abs(rss_actual), eps)
    return float(np.mean(np.abs(rss_pred - rss_actual) / denom))


def _pad_window(cb_rows, rss_amps, window: List[int], max_window: int):
    """Fixed-shape sliding window: always (max_window, n) / (max_window,),
    with the unoccupied tail as INACTIVE rows (A_i = 0, b_i = 0).

    The solvers treat b == 0 rows as absent (their prox is 0 and the
    normalization counts only active rows), so the padded solve equals
    the unpadded one.  The port keeps the padding so both packages solve
    the same problems; on the card it also keeps each run's shapes fixed.
    """
    k = len(window)
    n = cb_rows.shape[1]
    a = np.zeros((max_window, n), cb_rows.dtype)
    b = np.zeros((max_window,), rss_amps.dtype)
    idx = np.asarray(window)
    a[:k] = cb_rows[idx]
    b[:k] = rss_amps[idx]
    return a, b


def _solver_takes_ladder_m(solver) -> bool:
    """Whether a tracking solver callback accepts the ``ladder_m`` kwarg:
    an explicit ``ladder_m`` parameter, or ``solver.takes_ladder_m =
    True``.  A bare ``**kwargs`` does NOT opt in: a callback that merely
    swallows kwargs would silently ignore ladder_m."""
    if getattr(solver, "takes_ladder_m", False):
        return True
    try:
        params = inspect.signature(solver).parameters
    except (TypeError, ValueError):
        return False
    return "ladder_m" in params


def _solver_cc_frac(solver, default: float) -> float:
    """The train-split fraction the solver actually uses: the ladder snap
    must evaluate the train-ladder boundary with the SOLVER's cc_frac.
    Warns when a callback that takes ladder_m carries no ``.cc_frac``."""
    cc = getattr(solver, "cc_frac", None)
    if cc is None:
        warnings.warn(
            "tracking solver accepts ladder_m but carries no .cc_frac "
            "attribute; ladder snapping falls back to the tracking "
            f"config's cc_frac={default}; set solver.cc_frac to the "
            "fraction the solver's own AdmmConfig uses",
            stacklevel=3)
        cc = default
    return float(cc)


def _ladder_m_for_window(m_active: int, m_padded: int, n: int,
                         frac: float = 0.95):
    """Snap the active window length to a canonical ladder-equivalent count.

    The constraint-ladder selection depends on the row count only through
    the booleans ``m >= 3n`` (full-data ladder) and ``floor(m*frac) >= 3n``
    (train-split ladder), ref: inferLowRankV4_multi.m:447.  Returns one
    canonical representative per boolean pair, or None when the padded
    count already selects the same ladders.
    """
    def pair(m):
        return (m >= 3 * n, math.floor(m * frac) >= 3 * n)

    if pair(m_active) == pair(m_padded):
        return None
    b1, b2 = pair(m_active)
    if not b1:
        return 3 * n - 1
    if not b2:
        return 3 * n
    return math.ceil(3 * n / frac)


def _window_problem(cb_rows, rss_amps, window, max_window, n, solver,
                    cc_default, static_pad, takes_ladder_m):
    """The solver's (a, b, kwargs) of one sliding window."""
    if static_pad:
        a_w, b_w = _pad_window(cb_rows, rss_amps, window, max_window)
        lm = (_ladder_m_for_window(len(window), max_window, n,
                                   _solver_cc_frac(solver, cc_default))
              if takes_ladder_m else None)
    else:
        idx = np.asarray(window)
        a_w, b_w = cb_rows[idx], rss_amps[idx]
        lm = None
    return a_w, b_w, ({"ladder_m": lm} if lm is not None else {})


def track(generator: Optional[torch.Generator], cb_rows, rss_amps,
          cfg: ArrayConfig, mob: MobilityConfig = MobilityConfig(),
          solver: Optional[Callable] = None,
          static_pad: bool = True) -> MobilityTrace:
    """Run the adaptive tracking loop over a probe stream.

    ``cb_rows``: (T * window_probes, n) probe rows in time order;
    ``rss_amps``: matching linear RSS amplitudes (numpy, or tensors that
    are brought to the host).  ``solver(gen, a, b) -> x`` gets window t's
    generator ``fold_in(generator, t)``; None runs JAX's default, the
    complex A2 solver on the card (:func:`make_complex_solver` with
    ``mob.admm``), and raises without one.

    The sliding window holds *whole* windows of probes, trimmed to the
    last ``max_window`` probes (ref :169-174); the reference always
    re-solves on the current window content regardless of the budget M,
    whose role is purely to be recorded, as here.  ``static_pad`` pads
    every solve to ``max_window`` rows with inactive (b = 0) rows (see
    :func:`_pad_window`); pass False for the reference's dynamic shapes.
    """
    if solver is None:
        solver = make_complex_solver(cfg, mob.admm)
    n = cfg.n
    t_size = mob.window_probes
    cb_rows = _host(cb_rows)
    rss_amps = _host(rss_amps)
    n_windows = cb_rows.shape[0] // t_size

    takes_ladder_m = _solver_takes_ladder_m(solver)
    h = np.zeros((n,), cb_rows.dtype)
    m_budget = 0
    window: List[int] = []

    errors = np.zeros(n_windows)
    budgets = np.zeros(n_windows, np.int64)
    estimates = np.zeros((n_windows, n), np.complex128)

    for t in range(n_windows):
        budgets[t] = m_budget
        cur = list(range(t * t_size, (t + 1) * t_size))
        cb_cur = cb_rows[np.asarray(cur)]
        rss_cur = rss_amps[np.asarray(cur)]

        rss_eval = np.abs(cb_cur @ h)                    # Evaluate_rss.m:1-7
        err = _relative_rss_error(rss_eval, rss_cur)
        errors[t] = err
        if err < mob.threshold:
            m_budget = 0
        else:
            m_budget = min(int(np.ceil(m_budget * mob.growth + 1)),
                           mob.max_window)
        window = (window + cur)[-mob.max_window:]

        a_w, b_w, kw = _window_problem(cb_rows, rss_amps, window,
                                       mob.max_window, n, solver,
                                       mob.admm.cc_frac, static_pad,
                                       takes_ladder_m)
        h = np.asarray(solver(fold_in(generator, t), a_w, b_w, **kw))
        estimates[t] = h
    return MobilityTrace(rss_error=errors, probe_budget=budgets,
                         estimates=estimates)


def _pair_problem(a, b, device):
    """Split a host window into the solver's float32 Pair and b on
    ``device``."""
    ap = pair_from_numpy(np.asarray(a), None, device=device)
    return ap, torch.as_tensor(np.asarray(b, np.float32), device=ap.re.device)


def _to_numpy(x: Pair) -> np.ndarray:
    return x.re.cpu().numpy() + 1j * x.im.cpu().numpy()


def make_complex_solver(cfg: ArrayConfig, admm: AdmmConfig = AdmmConfig(),
                        device="cuda") -> Callable:
    """The tracking loops' default solver (JAX's): every window re-solved
    cold by the complex A2 solver :func:`..ops.admm.solve_lowrank_multi`
    on ``device``, with the window's ``ladder_m``.  The window keeps its
    complex type (complex64 from the tracker's rows); b takes the matching
    real type.  On the card each trip's magnitude prox and M-dual run in
    kernel K5.
    """
    resolve_device(device)

    def solver(gen, a, b, ladder_m=None):
        at = complex_from_numpy(a, device=device)
        bt = torch.as_tensor(np.asarray(b), dtype=at.real.dtype,
                             device=at.device)
        res = solve_lowrank_multi(gen, at, bt, cfg.nt, cfg.nr, admm,
                                  ladder_m=ladder_m)
        return res.x.cpu().numpy()

    solver.cc_frac = admm.cc_frac     # ladder-snap boundary (see track())
    return solver


def make_pair_solver(cfg: ArrayConfig, admm: AdmmConfig = AdmmConfig(),
                     device="cuda") -> Callable:
    """A tracking solver that re-solves every window cold with the pair
    A2 solver (:func:`solve_lowrank_multi_pair`) on ``device``; on the
    card its inner solves run in the loop kernel K3.
    """
    resolve_device(device)

    def solver(gen, a, b, ladder_m=None):
        ap, bt = _pair_problem(a, b, device)
        res = solve_lowrank_multi_pair(gen, ap, bt, cfg.nt, cfg.nr, admm,
                                       ladder_m=ladder_m)
        return _to_numpy(res.x)

    solver.cc_frac = admm.cc_frac     # ladder-snap boundary (see track())
    return solver


def make_warm_pair_solver(cfg: ArrayConfig, admm: AdmmConfig = AdmmConfig(),
                          quality_gate: float = 0.6,
                          anchor_weight: float = 3.0,
                          use_rank_one: bool = False,
                          device="cuda") -> Callable:
    """A tracking solver that WARM-STARTS each window from the previous
    window's estimate, on ``device``.

    Each window runs ONE refinement-style solve (the reference's own
    full-data refinement step, inferLowRankV4_multi.m:89-101) with a
    proximal anchor ``anchor_weight * ||x - x_prev||^2`` in the
    X-subproblem, so directions the window does not measure stay at the
    previous estimate and cross-window beam diversity accumulates.  It
    falls back to a cold start when the refined fit drops below
    ``quality_gate`` (the scaffold's own gate, ref :73), and on the first
    window.  ``use_rank_one=True`` pins the solves to the rank-1
    constraint ladder; its cold start is the top spectral vector refined
    on that ladder.  On the card the anchored refine runs the per-op loop
    (K4, K1, K2) and the cold start's inner solves run K3 (the rank-1
    cold start's refine, unanchored, runs K3 too).

    ``solver.state["x"]`` holds the previous window's estimate (None
    before the first window); ``solver.reset()`` clears it.
    """
    resolve_device(device)
    state = {"x": None}

    def cold_start(gen, ap, bt, kw):
        if not use_rank_one:
            return solve_lowrank_multi_pair(gen, ap, bt, cfg.nt, cfg.nr,
                                            admm, **kw)
        # rank-1 cold start: top spectral vector -> rank-1-ladder refine
        a_n, b_n, a_norm, b_norm = _normalize_problem_pair(ap, bt,
                                                           admm.tol_abs)
        xs = spectral_initialize_pair(Pair(a_n.re[None], a_n.im[None]),
                                      b_n[None, None], 1, gen)
        s = b_norm / a_norm
        x0 = Pair(xs.re[0, 0, 0] * s, xs.im[0, 0, 0] * s)
        return refine_lowrank_pair(ap, bt, x0, cfg.nt, cfg.nr, admm,
                                   use_rank_one=True, **kw)

    def solver(gen, a, b, ladder_m=None):
        ap, bt = _pair_problem(a, b, device)
        kw = dict(ladder_m=ladder_m) if ladder_m is not None else {}
        if state["x"] is not None:
            x0 = pair_from_numpy(state["x"], None, device=ap.re.device)
            res = refine_lowrank_pair(ap, bt, x0, cfg.nt, cfg.nr, admm,
                                      anchor_weight=anchor_weight,
                                      use_rank_one=use_rank_one, **kw)
            if float(res.quality) < quality_gate:
                res = cold_start(gen, ap, bt, kw)
        else:
            res = cold_start(gen, ap, bt, kw)
        x = _to_numpy(res.x)
        state["x"] = x
        return x

    solver.cc_frac = admm.cc_frac
    solver.takes_ladder_m = True
    solver.state = state
    solver.reset = lambda: state.update(x=None)
    return solver


@dataclasses.dataclass(frozen=True)
class SimulatedMobilityConfig:
    """ref: RSS_Mobility_simu.m:112-115,133-163."""

    window_probes: int = 100    #: probes per time window
    max_window: int = 400       #: sliding-window probe cap
    threshold: float = 0.2      #: rss-error threshold driving the budget
    m_init: int = 80            #: initial probe budget
    m_max: int = 80             #: probe-budget cap
    max_angle_change_deg: float = 1.0  #: Brownian per-window angle jitter
    admm: AdmmConfig = AdmmConfig()


def brownian_trace(generator: Optional[torch.Generator], cfg: ArrayConfig,
                   mob: SimulatedMobilityConfig = SimulatedMobilityConfig(),
                   n_windows: int = 20, channel_cfg=None, device="cuda"):
    """Synthesize a Brownian-mobility probe stream on ``device``.

    Stands in for the reference's pregenerated
    ``rss_trace_movement_simu_12x12_brownian`` dataset
    (ref: RSS_Mobility_simu.m:100-105): per window the channel's AoD/AoA
    random-walk by <= ``max_angle_change_deg`` (Generate_Dynamic_Channel
    semantics) and every probe is an independent random 2-bit phase row.
    Returns ``(cb_rows, rss_amps, vec_h_per_window)`` tensors.
    """
    from ..models.channel import generate_channel, perturb_channel
    from ..sensing.codebooks import random_sensing_rows

    if channel_cfg is None:
        channel_cfg = ChannelConfig(n_paths=2)
    p = mob.window_probes
    gc, gb = fold_in(generator, 0), fold_in(generator, 1)
    ch = generate_channel(gc, cfg, channel_cfg, batch=1, device=device)
    cb = random_sensing_rows(gb, n_windows * p, cfg.n, cfg.phase_bit,
                             device=device)

    vec_hs = []
    for t in range(n_windows):
        ch = perturb_channel(fold_in(gc, t + 1), ch, cfg,
                             mob.max_angle_change_deg)
        vec_hs.append(ch.vec_h[0])
    vec_h = torch.stack(vec_hs)                          # (T, n)
    rss = torch.abs(torch.einsum("tpn,tn->tp",
                                 cb.reshape(n_windows, p, -1), vec_h))
    return cb, rss.reshape(-1), vec_h


def track_simulated(generator: Optional[torch.Generator], cb_rows, rss_amps,
                    cfg: ArrayConfig,
                    mob: SimulatedMobilityConfig = SimulatedMobilityConfig(),
                    solver: Optional[Callable] = None,
                    static_pad: bool = True) -> MobilityTrace:
    """Adaptive tracking with the simulated-trace budget rule.

    ref: RSS_Mobility_simu.m:133-163: window t contributes its first M
    probes to a sliding window capped at ``max_window``; the estimate is
    scored on the *held-out remainder* of the window (probes M+1..P), and
    the budget shrinks ``M <- max(0, M - floor(M/5) - 1)`` on success or
    grows ``M <- min(m_max, M + floor(M/5) + 1)`` on failure.  A window
    contributes at most P - 1 probes, so a held-out remainder always
    exists.  ``solver=None`` runs the complex A2 solver on the card, as in
    :func:`track`.
    """
    if solver is None:
        solver = make_complex_solver(cfg, mob.admm)
    n = cfg.n
    p = mob.window_probes
    cb_rows = _host(cb_rows)
    rss_amps = _host(rss_amps)
    n_windows = cb_rows.shape[0] // p

    takes_ladder_m = _solver_takes_ladder_m(solver)
    m_budget = mob.m_init
    window: List[int] = []
    errors = np.zeros(n_windows)
    budgets = np.zeros(n_windows, np.int64)
    estimates = np.zeros((n_windows, n), np.complex128)

    for t in range(n_windows):
        budgets[t] = m_budget
        start = t * p
        m_used = min(m_budget, p - 1) if p > 1 else 0
        window = (window + list(range(start, start + m_used)))[-mob.max_window:]
        a_w, b_w, kw = _window_problem(cb_rows, rss_amps, window,
                                       mob.max_window, n, solver,
                                       mob.admm.cc_frac, static_pad,
                                       takes_ladder_m)
        h = np.asarray(solver(fold_in(generator, t), a_w, b_w, **kw))
        estimates[t] = h

        test = np.arange(start + m_used, start + p)   # nonempty by m_used cap
        rss_eval = np.abs(cb_rows[test] @ h)
        err = _relative_rss_error(rss_eval, rss_amps[test])
        errors[t] = err
        if err < mob.threshold:
            m_budget = max(0, m_budget - m_budget // 5 - 1)
        else:
            m_budget = min(mob.m_max, m_budget + m_budget // 5 + 1)
    return MobilityTrace(rss_error=errors, probe_budget=budgets,
                         estimates=estimates)
