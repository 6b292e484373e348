"""Solver dispatchers (port of ``twoace_tpu.ops.dispatch``): the
framework's ``ADMM_v2`` and ``Recover_Channel``.

- :func:`admm_v2`: the version 0-4 dispatch (ref: main/src/
  my_recovery_algorithms/ADMM_v2.m:22-45; nuclear variant
  ADMM_v2_nuclear.m:32) with its out-of-range escalation;
- :func:`recover_channel` / :func:`recover_channel_bf`: testbed H-domain
  recovery over the enabled methods (ref: Recover_Channel.m:1-47,
  Recover_Channel_bf.m:1-45);
- :func:`recover_sparse`: the simulation tree's z-domain recovery over
  the baselines (ref: Numerical_Simulation/src/my_recovery_algorithms/
  MyCPR.m:74-190): PhaseLift, CPRL, PRGAMP, SparsePL, PLOMP, PLGAMP and
  perfect/noisy-phase CS.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional

import torch

from ..config import (AdmmConfig, ArrayConfig, MethodFlags, PhaseLiftConfig,
                      TwoStageConfig)
from ..utils.rng import fold_in
from ..utils.timing import synced_seconds
from .admm import AdmmResult, solve_lowrank_multi, solve_minl2
from .cplx import Pair
from .cpr_baselines import conventional_cs, cprl, sparse_phaselift
from .gamp import prgamp
from .pair_solver import solve_lowrank_multi_pair
from .phaselift import phaselift_fista
from .twostage import two_stage_recovery

#: ``MethodFlags`` field -> ADMM_v2 version (ref: Recover_Channel.m:13-31)
_VERSIONS = {"admm": 0, "admm_lowrank_v1": 1, "admm_lowrank_v2": 2,
             "admm_lowrank_v3": 3, "admm_lowrank_v4": 4}
_LIFTED = ("phaselift", "plomp", "plgamp")
#: the reference's PhaseLift measurement scaling chain
#: (ref: Recover_Channel.m:35,41-44)
_PL_IN_SCALE = 2e5
_PL_LIFT_SCALE = 1e10


def _with_ladder(cfg: AdmmConfig, ladder: str) -> AdmmConfig:
    return dataclasses.replace(
        cfg, profile=dataclasses.replace(cfg.profile, ladder=ladder))


def _solve_pair(generator, a, b, nt: int, nr: int, cfg: AdmmConfig,
                **kwargs) -> AdmmResult:
    """The pair solver on the real and imaginary planes of complex ``a``,
    with its result back in complex form on a's device."""
    ap = Pair(a.real.to(torch.float32).contiguous(),
              a.imag.to(torch.float32).contiguous())
    res = solve_lowrank_multi_pair(generator, ap, b.to(torch.float32), nt, nr,
                                   cfg, **kwargs)
    x = torch.complex(res.x.re, res.x.im)
    return AdmmResult(x=x, y=a.to(x.dtype) @ x, quality=res.quality,
                      converged=res.converged)


def admm_v2(generator: Optional[torch.Generator], measurements, beams,
            nt: int, nr: int, version: int = 4,
            cfg: AdmmConfig = AdmmConfig(), nuclear: bool = False,
            impl: str = "complex") -> AdmmResult:
    """Dispatch the ADMM solver family (ref: ADMM_v2.m:22-45,
    ADMM_v2_nuclear.m:32).

    ``measurements``: (m,) linear amplitudes; ``beams``: (m, nt*nr)
    complex probe rows.  Version 0 is inferMinL2; 1/2/3 the historical
    single-restart ladders; 4 inferLowRankV4_multi (or
    inferLowRank_Nuclear with ``nuclear``); anything else the escalation.
    ``impl="pair"`` routes versions 1-4 through the port's pair solver
    (:func:`.pair_solver.solve_lowrank_multi_pair`) in float32.
    """
    b = torch.as_tensor(measurements).real.reshape(-1)
    a = torch.as_tensor(beams)
    if version > 4 or version < 0:
        return _admm_v2_escalation(generator, a, b, nt, nr, cfg, impl)
    if version == 0:
        return solve_minl2(generator, a, b, cfg)
    kwargs = {}
    if version in (1, 2, 3):
        cfg = _with_ladder(cfg, "v1" if version == 1 else "v2")
        kwargs["n_restarts"] = 1
    elif nuclear:
        kwargs.update(prox_kind="nuclear", n_restarts=1)
    if impl == "pair":
        return _solve_pair(generator, a, b, nt, nr, cfg, **kwargs)
    return solve_lowrank_multi(generator, a, b, nt, nr, cfg, **kwargs)


def _admm_v2_escalation(generator, a, b, nt: int, nr: int, cfg: AdmmConfig,
                        impl: str) -> AdmmResult:
    """The dispatcher's out-of-range escalation (ADMM_v2.m:33-44): up to 3
    runs of the V2 solver with growing parameters.

    Two quirks of the reference are kept, as in the JAX package:

    - the 6-positional call ``inferLowRankV2(A, B, TX, RX, RZ, R)`` lands
      RZ in the LAMBDA slot and R in the width slot (inferLowRankV2.m:1),
      so the escalation grows the ridge weight (5, 7, 9) and the
      over-parameterization width (TX, TX + TX/2, ...), not a Z rank;
    - the loop breaks on ``if converged`` where "converged" is V2's
      QUALITY output (inferLowRankV2.m:1,42): any nonzero quality ends it,
      so the second and third runs happen only at quality exactly 0.

    The pair solver folds no ridge into its U, so ``impl="pair"`` grows
    the width only.
    """
    r_cur, lam_cur = nt, 5.0
    res = None
    for _ in range(3):
        cfg_i = _with_ladder(dataclasses.replace(cfg, rank=r_cur, lam=lam_cur),
                             "v2")
        if impl == "pair":
            res = _solve_pair(generator, a, b, nt, nr, cfg_i, n_restarts=1)
        else:
            res = solve_lowrank_multi(generator, a, b, nt, nr, cfg_i,
                                      n_restarts=1)
        if float(res.quality) != 0.0:
            break
        r_cur += nt // 2
        lam_cur += 2.0
    return res


def _admm_methods(generator, b, a, flags: MethodFlags, cfg: ArrayConfig,
                  admm_cfg: AdmmConfig) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, version in _VERSIONS.items():
        if getattr(flags, name):
            out[name] = admm_v2(fold_in(generator, version), b, a, cfg.nt,
                                cfg.nr, version, admm_cfg).x
    if flags.admm_nuclear:
        out["admm_nuclear"] = admm_v2(fold_in(generator, 14), b, a, cfg.nt,
                                      cfg.nr, 4, admm_cfg, nuclear=True).x
    return out


def recover_channel(generator: Optional[torch.Generator], measurements,
                    beams, flags: MethodFlags, cfg: ArrayConfig, s: int,
                    ad=None, admm_cfg: AdmmConfig = AdmmConfig(),
                    pl_cfg: PhaseLiftConfig = PhaseLiftConfig(),
                    ts_cfg: TwoStageConfig = TwoStageConfig()
                    ) -> Dict[str, torch.Tensor]:
    """Run every enabled method; returns {method name: vec_h estimate}
    (ref: Recover_Channel.m:1-47, Recover_Channel_nuclear.m).

    ``measurements`` are linear amplitudes
    (:func:`..utils.units.dbm_to_amplitude`).  Method ``version`` draws
    from ``fold_in(generator, version)``, the nuclear variant from
    ``fold_in(generator, 14)``.  The lifted methods take the reference's
    scaling chain, intensities ``(b / 2e5)^2 * 1e10`` (ref:
    Recover_Channel.m:35), and scale their estimates back: PhaseLift
    solves on the probe rows; PLOMP and PLGAMP share one two-stage
    recovery on ``beams @ ad`` (``ad``, the sparse dictionary, is
    required for them; ``s`` is their sparsity) mapped back through
    ``ad``.
    """
    b = torch.as_tensor(measurements).real.reshape(-1)
    a = torch.as_tensor(beams)
    out = _admm_methods(generator, b, a, flags, cfg, admm_cfg)
    intens = (b / _PL_IN_SCALE) ** 2 * _PL_LIFT_SCALE
    scale = _PL_IN_SCALE / math.sqrt(_PL_LIFT_SCALE)
    if flags.phaselift:
        out["phaselift"] = phaselift_fista(a, intens, pl_cfg).x * scale
    if flags.plomp or flags.plgamp:
        if ad is None:
            raise ValueError("PLOMP/PLGAMP need the sparse dictionary AD")
        ad = torch.as_tensor(ad).to(dtype=a.dtype, device=a.device)
        ts = two_stage_recovery(intens, a @ ad, s, cfg=ts_cfg,
                                run_plomp=flags.plomp,
                                run_plgamp=flags.plgamp)
        if flags.plomp:
            out["plomp"] = (ad @ ts.plomp) * scale
        if flags.plgamp:
            out["plgamp"] = (ad @ ts.plgamp) * scale
    return out


def recover_channel_bf(generator: Optional[torch.Generator], measurements,
                       beams, flags: MethodFlags, cfg: ArrayConfig,
                       recovered: Dict[str, torch.Tensor],
                       admm_cfg: AdmmConfig = AdmmConfig()
                       ) -> Dict[str, torch.Tensor]:
    """Beamforming-time re-recovery (ref: Recover_Channel_bf.m:1-45): the
    ADMM variants re-run on the fresh measurements; the lifted methods'
    estimates are passed through from ``recovered``, an earlier
    :func:`recover_channel` result (ref :32-44)."""
    b = torch.as_tensor(measurements).real.reshape(-1)
    out = _admm_methods(generator, b, torch.as_tensor(beams), flags, cfg,
                        admm_cfg)
    for name in _LIFTED:
        if getattr(flags, name):
            if name not in recovered:
                raise ValueError(
                    f"{name} enabled but absent from `recovered`; "
                    "Recover_Channel_bf reuses earlier estimates for the "
                    "lifted methods")
            out[name] = recovered[name]
    return out


def recover_sparse(generator: Optional[torch.Generator], measurements,
                   measurement_mat, flags: MethodFlags, s: int,
                   noise_power: float = 1.0, measurements_perfect=None,
                   measurements_noisy=None,
                   pl_cfg: PhaseLiftConfig = PhaseLiftConfig(),
                   ts_cfg: TwoStageConfig = TwoStageConfig(),
                   info: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The simulation tree's dispatcher over the sparse (z-domain)
    baselines (ref: MyCPR.m:74-190): {method name: (P,) z estimate}.

    ``measurements``: (m,) intensities |y|^2; ``measurement_mat``: (m, P)
    = FW @ AD.  PhaseLift is the lifted FISTA on the z domain; PRGAMP
    takes the magnitudes; PLOMP and PLGAMP share one two-stage recovery;
    the perfect- and noisy-phase complex measurements, when given, each
    get a conventional CS solve.  ``generator`` is unused: these
    baselines draw nothing.

    ``info``, when given, receives the two-stage compression size under
    ``"mcs"`` and, under ``"seconds"``, the host seconds of each group
    that ran (``"phaselift (z)"``, ``"cprl"``, ``"prgamp"``,
    ``"sparse_pl"``, ``"plomp+plgamp"``, ``"perfect+noisy CS"``), each
    read once the device has finished.
    """
    del generator
    out: Dict[str, torch.Tensor] = {}
    b2 = torch.as_tensor(measurements).real.reshape(-1)
    a = torch.as_tensor(measurement_mat)
    seconds = {}

    def timed(group, fn):
        t0 = time.perf_counter()
        res = fn()
        if info is not None:
            seconds[group] = synced_seconds(t0, a.device)
        return res

    if flags.phaselift:
        out["phaselift"] = timed("phaselift (z)",
                                 lambda: phaselift_fista(a, b2, pl_cfg).x)
    if flags.cprl:
        out["cprl"] = timed("cprl", lambda: cprl(b2, a))
    if flags.prgamp:
        out["prgamp"] = timed("prgamp", lambda: prgamp(torch.sqrt(b2), a))
    if flags.sparse_pl:
        out["sparse_pl"] = timed("sparse_pl", lambda: sparse_phaselift(
            b2, a, cfg=pl_cfg))
    if flags.plomp or flags.plgamp:
        ts = timed("plomp+plgamp", lambda: two_stage_recovery(
            b2, a, s, noise_power, ts_cfg, run_plomp=flags.plomp,
            run_plgamp=flags.plgamp))
        if flags.plomp:
            out["plomp"] = ts.plomp
        if flags.plgamp:
            out["plgamp"] = ts.plgamp
        if info is not None:
            info["mcs"] = ts.mcs
    t0 = time.perf_counter()
    for name, y in (("perfect_phase_cs", measurements_perfect),
                    ("noisy_phase_cs", measurements_noisy)):
        if y is not None:
            out[name] = conventional_cs(y.reshape(-1), a, s, noise_power)
    if info is not None and (measurements_perfect is not None
                             or measurements_noisy is not None):
        seconds["perfect+noisy CS"] = synced_seconds(t0, a.device)
    if info is not None:
        info["seconds"] = seconds
    return out
