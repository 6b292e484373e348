"""Carry state from numpy (and the JAX package's configs) into the port.

Imports no jax: the JAX side hands over numpy arrays and
``dataclasses.asdict`` of its configs.  The complex-dtype solver family
has no learned weights: what carries a JAX run across is its configs
(``AdmmConfig``, ``MethodFlags``, ``CampaignConfig``) and its numpy
codebooks, channels and RSS traces.  The converters put tensors on the
card by default, where the port's entry points run; a caller that wants
the CPU (the tests) says ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import AdmmConfig, ArrayConfig, MethodFlags, SpectralProfileConfig
from .ops.cplx import LadderArrays, Pair


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises for "cuda" where there is no card
    instead of quietly staying on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "device='cpu' to build CPU tensors")
    return dev


def pair_from_numpy(re, im, device="cuda") -> Pair:
    """A float32 Pair from two numpy arrays (or one complex array as
    ``re`` with ``im=None``) on ``device``."""
    device = resolve_device(device)
    if im is None:
        re, im = np.real(re), np.imag(re)
    return Pair(torch.as_tensor(np.asarray(re, np.float32), device=device),
                torch.as_tensor(np.asarray(im, np.float32), device=device))


def ladder_from_numpy(ranks, fracs, device="cuda") -> LadderArrays:
    device = resolve_device(device)
    return LadderArrays(
        torch.as_tensor(np.asarray(ranks, np.float32), device=device),
        torch.as_tensor(np.asarray(fracs, np.float32), device=device))


def admm_config_from_dict(d: dict) -> AdmmConfig:
    """The port's AdmmConfig from ``dataclasses.asdict`` of the JAX
    package's ``AdmmConfig``."""
    d = dict(d)
    prof = d.pop("profile", None)
    if isinstance(prof, dict):
        prof = SpectralProfileConfig(
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in prof.items()})
    return AdmmConfig(**d, **({} if prof is None else {"profile": prof}))


def complex_from_numpy(x, device="cuda") -> torch.Tensor:
    """A complex tensor on ``device`` from a numpy array: complex64 and
    complex128 keep their type, real float64 becomes complex128 and any
    other real type complex64."""
    device = resolve_device(device)
    x = np.asarray(x)
    if not np.iscomplexobj(x):
        x = x.astype(np.complex128 if x.dtype == np.float64 else np.complex64)
    return torch.as_tensor(x, device=device)


def method_flags_from_dict(d: dict) -> MethodFlags:
    """The port's MethodFlags from ``dataclasses.asdict`` of the JAX
    package's."""
    return MethodFlags(**d)


def campaign_config_from_dict(d: dict):
    """The port's ``pipeline.recovery.CampaignConfig`` from
    ``dataclasses.asdict`` of the JAX package's."""
    from .pipeline.recovery import CampaignConfig

    d = dict(d)
    array = ArrayConfig(**d.pop("array"))
    admm = admm_config_from_dict(d.pop("admm"))
    d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    return CampaignConfig(array=array, admm=admm, **d)
