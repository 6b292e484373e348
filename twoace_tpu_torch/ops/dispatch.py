"""Solver dispatchers (port of ``twoace_tpu.ops.dispatch``): the
framework's ``ADMM_v2`` and ``Recover_Channel``.

- :func:`admm_v2`: the version 0-4 dispatch (ref: main/src/
  my_recovery_algorithms/ADMM_v2.m:22-45; nuclear variant
  ADMM_v2_nuclear.m:32) with its out-of-range escalation;
- :func:`recover_channel` / :func:`recover_channel_bf`: testbed H-domain
  recovery over the enabled methods (ref: Recover_Channel.m:1-47,
  Recover_Channel_bf.m:1-45).

The ADMM family is ported.  The lifted baselines (PhaseLift, PLOMP,
PLGAMP) and ``recover_sparse`` wait for the baselines (ROADMAP.md, the
modules queue, item 5): their flags raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..config import AdmmConfig, ArrayConfig, MethodFlags
from ..utils.rng import fold_in
from .admm import AdmmResult, solve_lowrank_multi, solve_minl2
from .cplx import Pair
from .pair_solver import solve_lowrank_multi_pair

#: ``MethodFlags`` field -> ADMM_v2 version (ref: Recover_Channel.m:13-31)
_VERSIONS = {"admm": 0, "admm_lowrank_v1": 1, "admm_lowrank_v2": 2,
             "admm_lowrank_v3": 3, "admm_lowrank_v4": 4}
_LIFTED = ("phaselift", "plomp", "plgamp")


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


def _refuse_lifted(flags: MethodFlags) -> None:
    for name in _LIFTED:
        if getattr(flags, name):
            raise NotImplementedError(
                f"{name} is a lifted baseline, not ported yet (ROADMAP.md, "
                "modules queue item 5, the baselines)")


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
                    ad=None, admm_cfg: AdmmConfig = AdmmConfig()
                    ) -> Dict[str, torch.Tensor]:
    """Run every enabled method; returns {method name: vec_h estimate}
    (ref: Recover_Channel.m:1-47, Recover_Channel_nuclear.m).

    ``measurements`` are linear amplitudes
    (:func:`..utils.units.dbm_to_amplitude`).  Method ``version`` draws
    from ``fold_in(generator, version)``, the nuclear variant from
    ``fold_in(generator, 14)``.  ``s`` and ``ad`` (the sparse dictionary)
    serve the lifted baselines, which raise until they are ported.
    """
    del s, ad
    _refuse_lifted(flags)
    b = torch.as_tensor(measurements).real.reshape(-1)
    return _admm_methods(generator, b, torch.as_tensor(beams), flags, cfg,
                         admm_cfg)


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
