"""Monte-Carlo simulation drivers (port of the Vs_M and Vs_SNR parts of
``twoace_tpu.pipeline.simulation``).

  - ``Vs_M{,_par}.m``: recovery error vs number of measurements
    (ref: Numerical_Simulation/main_programs/Vs_M_par.m:75-219)
  - ``Vs_SNR{,_par}.m``: recovery error vs SNR

A cell draws a batch of channels, sensing matrices and measurements (the
instance axis is a tensor axis), runs every enabled method and scores it.
Random draws come from ``torch.Generator``s, derived with
:func:`..utils.rng.fold_in` where the JAX package folds keys; every
entry point runs on ``device`` (the card by default).  The A2 family runs
one solve per instance: ``impl="pair"`` through
``solve_lowrank_multi_pair`` (its restarts are K3's lanes; per-instance
codebooks rule out the batch solver), ``impl="complex"`` through
``ops.admm.solve_lowrank_multi`` (K5).  The sparse baselines run one
``recover_sparse`` per instance (their compression size is
data-dependent); the H-domain PhaseLift runs ``phaselift_bm`` batched
over the trials.  ``measurements_needed_vs_range``,
``sweep_measurements_trace`` and ``infer_channel_windows`` are still to
port.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AdmmConfig, ArrayConfig, ChannelConfig, MethodFlags
from ..interop import resolve_device
from ..models.channel import generate_channel
from ..models.measurement import generate_measurement
from ..models.sparse import sparse_formulation
from ..ops.admm import solve_lowrank_multi
from ..ops.cplx import Pair
from ..ops.dispatch import recover_sparse
from ..ops.pair_solver import solve_lowrank_multi_pair
from ..ops.phaselift import phaselift_bm
from ..sensing.sensing_matrix import generate_sensing_matrix
from ..utils.metrics import (angle_error, angles_from_sparse,
                             nmse_h_projection, sparse_projection_omp)
from ..utils.rng import fold_in
from ..utils.timing import synced_seconds


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """Shared Monte-Carlo scaffold (ref: Vs_M_par.m:75-134)."""

    array: ArrayConfig = ArrayConfig(nt=12, nr=12)
    channel: ChannelConfig = ChannelConfig(n_paths=1, rician_k=0)
    snr_db: float = 0.0
    add_noise: bool = True
    beam_method: str = "Directional_Beam_Angular"
    methods: MethodFlags = MethodFlags(admm_lowrank_v4=False, plomp=True,
                                       plgamp=True)
    admm: AdmmConfig = AdmmConfig()
    n_trials: int = 10
    #: "complex" (``ops.admm``, K5) or "pair" (``ops.pair_solver``, K3)
    impl: str = "complex"


#: sensing modes whose rows are drawn directly (no physical F/W split)
_NO_COMBINER_MODES = ("Random_Phase_State", "Random_Beam_Bayes")


def _mt_mr(sim: SimulationConfig, m: int) -> Tuple[int, int]:
    """Read a grid value m as (Mt, Mr): directional modes count beams per
    side (total Mt*Mr, ref: Vs_M_par.m:149 sweeping Mt = Mr);
    combiner-less random modes count total probe rows (ref:
    A2only.m:110-111)."""
    if sim.beam_method in _NO_COMBINER_MODES:
        return m, 1
    return m, m


class SweepResult(NamedTuple):
    grid: np.ndarray                 #: swept values (M or SNR)
    nmse: Dict[str, np.ndarray]      #: method -> (len(grid),) mean NMSE
    aoda_err: Dict[str, np.ndarray]  #: method -> mean AoD/AoA error (deg)
    #: method -> (len(grid), n_trials) per-trial NMSE
    nmse_trials: Optional[Dict[str, np.ndarray]] = None
    #: host seconds per point: "cell" (the whole cell) and each method
    #: group ("phaselift", "plomp+plgamp", "perfect+noisy CS", the A2
    #: method's name), each read once the device has finished
    seconds: Optional[Dict[str, np.ndarray]] = None
    #: (len(grid), n_trials) two-stage compression sizes (PLOMP/PLGAMP),
    #: or (len(grid), 0) when neither runs
    mcs: Optional[np.ndarray] = None


def _recover_all(generator: Optional[torch.Generator], sim: SimulationConfig,
                 meas, sensing, rep, ch, stats: Optional[dict] = None
                 ) -> Dict[str, torch.Tensor]:
    """Run the enabled methods on a batch; returns {name: (U, P or n)
    estimates} on the data's device.  ``stats``, when given, receives
    each method group's host seconds under ``"seconds"`` and the
    per-instance two-stage compression sizes under ``"mcs"``."""
    del rep, ch
    cfg = sim.array
    out: Dict[str, torch.Tensor] = {}
    batch = meas.norm_square.shape[0]
    dev = meas.norm_square.device
    seconds: Dict[str, float] = {}
    infos = [{} for _ in range(batch)]
    base_flags = dataclasses.replace(sim.methods, admm_lowrank_v4=False,
                                     admm=False, admm_nuclear=False,
                                     phaselift=False)

    # standalone PhaseLift in the H domain through the factored
    # Burer-Monteiro solver, batched over the instances; the reference's
    # z-domain lifted SDP (MyCPR.m:120-139) is the "hours per solve" path.
    # Its estimate carries no sparse support: _evaluate projects it.
    if sim.methods.phaselift:
        t0 = time.perf_counter()
        out["phaselift"] = phaselift_bm(fold_in(generator, 777), sensing.fw,
                                        meas.norm_square).x
        seconds["phaselift"] = synced_seconds(t0, dev)
    if base_flags.enabled() or sim.add_noise:
        noise_power = float(meas.noise_power)
        per_inst = [recover_sparse(
            fold_in(generator, u), meas.norm_square[u],
            sensing.measurement_mat[u], base_flags, s=sim.channel.n_paths,
            noise_power=noise_power,
            measurements_perfect=meas.perfect_phase[u],
            measurements_noisy=meas.noisy_phase[u], info=infos[u])
            for u in range(batch)]
        for name in per_inst[0]:
            out[name] = torch.stack([r[name] for r in per_inst])
        for info in infos:
            for k, v in info["seconds"].items():
                seconds[k] = seconds.get(k, 0.0) + v

    # the A2 family, H domain, one solve per instance
    if sim.methods.admm_lowrank_v4 or sim.methods.admm_nuclear:
        prox = "nuclear" if sim.methods.admm_nuclear else "spectral_profile"
        name = ("admm_nuclear" if sim.methods.admm_nuclear
                else "admm_lowrank_v4")
        gen_a2 = fold_in(generator, 999)
        t0 = time.perf_counter()
        b = torch.sqrt(meas.norm_square)
        xs = []
        for u in range(batch):
            g_u = fold_in(gen_a2, u)
            if sim.impl == "pair":
                a_u = sensing.fw[u]
                res = solve_lowrank_multi_pair(
                    g_u, Pair(a_u.real.float().contiguous(),
                              a_u.imag.float().contiguous()),
                    b[u].float(), cfg.nt, cfg.nr, sim.admm, prox_kind=prox)
                xs.append(torch.complex(res.x.re, res.x.im))
            elif sim.impl == "complex":
                xs.append(solve_lowrank_multi(g_u, sensing.fw[u], b[u], cfg.nt,
                                              cfg.nr, sim.admm,
                                              prox_kind=prox).x)
            else:
                raise ValueError(f"unknown impl {sim.impl!r}")
        out[name] = torch.stack(xs)
        seconds[name] = synced_seconds(t0, dev)
    if stats is not None:
        stats["seconds"] = seconds
        stats["mcs"] = [info["mcs"] for info in infos if "mcs" in info]
    return out


def _evaluate(out, rep, ch, sim: SimulationConfig):
    """NMSE and angle errors per method (ref: Evaluation_Recovery.m:73-214).

    Returns ``(mean_nmse, mean_angle_err, per_trial_nmse)``: dicts of
    floats, floats and numpy (U,) arrays.
    """
    cfg = sim.array
    n_paths = sim.channel.n_paths
    nmse_d, ang_d, trials_d = {}, {}, {}
    for name, est in out.items():
        if est.shape[-1] == rep.ad.shape[1]:         # sparse z -> vec H
            vec_est = est @ rep.ad.T.to(est.dtype)
            z_for_ang = est
        else:                                        # a direct vec H estimate
            vec_est = est
            # angle readout for H-domain solvers: project onto the FoV
            # dictionary and read angles off the OMP support
            z_for_ang = sparse_projection_omp(est, rep.ad.to(est.dtype),
                                              n_paths)
        aod, aoa = angles_from_sparse(z_for_ang, cfg, rep.tx_window,
                                      rep.rx_window, n_paths)
        ang = angle_error(aod, aoa, ch.aod_deg.to(aod.dtype),
                          ch.aoa_deg.to(aoa.dtype))
        ang_d[name] = float(torch.mean(ang.aoda_err))
        per = nmse_h_projection(vec_est, ch.vec_h.to(vec_est.dtype))
        trials_d[name] = per.cpu().numpy()
        nmse_d[name] = float(np.mean(trials_d[name]))
    return nmse_d, ang_d, trials_d


def _one_cell(generator: Optional[torch.Generator], sim: SimulationConfig,
              mt: int, mr: int, searching_area: float, device="cuda",
              stats: Optional[dict] = None):
    """One (config, M) Monte-Carlo cell: channels -> sensing ->
    measurements -> recovery -> metrics (ref: Vs_M_par.m:149-197).
    ``stats`` as in :func:`_recover_all`."""
    cfg = sim.array
    dev = resolve_device(device)
    ch = generate_channel(fold_in(generator, 0), cfg, sim.channel,
                          batch=sim.n_trials, device=dev)
    rep = sparse_formulation(cfg, ch, searching_area)
    half = searching_area / 2
    sensing = generate_sensing_matrix(
        fold_in(generator, 1), sim.beam_method, mt, mr, cfg, rep.ad,
        aod_range=(-half, half), aoa_range=(-half, half), batch=sim.n_trials)
    # Combiner-less modes (random 2-bit rows) get iid noise: the reference
    # leaves W = zeros there (Generate_Sensing_Matrix.m:105, the assignment
    # commented out at :117), which makes its colored noise diag(W' N)
    # silently zero, a quirk its noisy drivers never reach; the JAX
    # package and the port draw iid noise instead.
    w_noise = None if sim.beam_method in _NO_COMBINER_MODES else sensing.w
    meas = generate_measurement(fold_in(generator, 2), sensing.fw, ch.vec_h,
                                sim.snr_db, sim.add_noise, w=w_noise, mt=mt)
    out = _recover_all(fold_in(generator, 3), sim, meas, sensing, rep, ch,
                       stats)
    return _evaluate(out, rep, ch, sim)


def _sweep(generator, grid, cells, sim, searching_area, device):
    nmse_acc: Dict[str, list] = {}
    ang_acc: Dict[str, list] = {}
    tr_acc: Dict[str, list] = {}
    sec_acc: Dict[str, list] = {}
    mcs_acc = []
    for i, (sim_i, m) in enumerate(cells):
        mt, mr = _mt_mr(sim_i, m)
        stats: dict = {}
        t0 = time.perf_counter()
        nm, an, tr = _one_cell(fold_in(generator, i), sim_i, mt, mr,
                               searching_area, device, stats)
        sec = dict(cell=time.perf_counter() - t0, **stats["seconds"])
        mcs_acc.append(stats["mcs"])
        for acc, d in ((nmse_acc, nm), (ang_acc, an), (tr_acc, tr),
                       (sec_acc, sec)):
            for k, v in d.items():
                acc.setdefault(k, []).append(v)
    return SweepResult(grid=np.asarray(grid),
                       nmse={k: np.asarray(v) for k, v in nmse_acc.items()},
                       aoda_err={k: np.asarray(v) for k, v in ang_acc.items()},
                       nmse_trials={k: np.stack(v) for k, v in tr_acc.items()},
                       seconds={k: np.asarray(v) for k, v in sec_acc.items()},
                       mcs=np.asarray(mcs_acc, dtype=np.int64))


def sweep_measurements(generator: Optional[torch.Generator],
                       m_grid: Sequence[int],
                       sim: SimulationConfig = SimulationConfig(),
                       searching_area: float = 60.0,
                       device="cuda") -> SweepResult:
    """Error vs measurement count (Vs_M): cell i draws from
    ``fold_in(generator, i)``."""
    return _sweep(generator, m_grid, [(sim, m) for m in m_grid], sim,
                  searching_area, device)


def sweep_snr(generator: Optional[torch.Generator],
              snr_grid: Sequence[float], m: int,
              sim: SimulationConfig = SimulationConfig(),
              searching_area: float = 60.0, device="cuda") -> SweepResult:
    """Error vs SNR (Vs_SNR) at one measurement count: cell i draws from
    ``fold_in(generator, i)``."""
    cells = [(dataclasses.replace(sim, snr_db=float(snr)), m)
             for snr in snr_grid]
    return _sweep(generator, snr_grid, cells, sim, searching_area, device)
