"""Eq.-23 sparse multipath channel sampler.

Port of ``twoace_tpu.models.channel`` (ref:
main/src/generate_channel/Generate_Channel.m:64-164,
Generate_Dynamic_Channel.m:1-78,
main/src/others/construct_channel_representation.m:18-31).

Random draws come from an explicit ``torch.Generator``, drawn on the CPU
and moved to the device, so a seed gives the same channel on any device.
The deterministic cores :func:`_path_response` and :func:`_snap_to_grid`
are functions of their own, so tests can hand both packages the same
draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ArrayConfig, ChannelConfig
from ..interop import resolve_device
from .steering import _real_dtype, steering_vector, vec_channel, virtual_grid


class Channel(NamedTuple):
    """Synthetic channel instance(s); all fields carry the batch axis U."""

    aod_deg: torch.Tensor        #: (U, L) dominant-path AoD in degrees
    aoa_deg: torch.Tensor        #: (U, L) dominant-path AoA in degrees
    gains: torch.Tensor          #: (U, L) normalized complex path gains
    h_matrix: torch.Tensor       #: (U, nr, nt) CSI matrix H
    vec_h: torch.Tensor          #: (U, nt*nr) vec(H), Rx index fastest
    h_dominant: torch.Tensor     #: (U, nr, nt) LOS/dominant component
    h_undominant: torch.Tensor   #: (U, nr, nt) Rician NLOS component


def _uniform(generator, shape, rdt, lo, hi, device):
    u = torch.rand(shape, generator=generator, dtype=rdt)
    return (lo + (hi - lo) * u).to(device)


def _complex_normal(generator, shape, dtype, device):
    rdt = _real_dtype(dtype)
    re = torch.randn(shape, generator=generator, dtype=rdt)
    im = torch.randn(shape, generator=generator, dtype=rdt)
    return (torch.complex(re, im) / np.sqrt(2.0)).to(device)


def _path_response(aod_rad, aoa_rad, gains, cfg: ArrayConfig, dtype):
    """H = sqrt(Nt*Nr) * ARx diag(h) ATx^H  (ref: Generate_Channel.m:127-136)."""
    a_tx = steering_vector(torch.sin(aod_rad), cfg.nt, cfg.k_d, dtype)
    a_rx = steering_vector(torch.sin(aoa_rad), cfg.nr, cfg.k_d, dtype)
    scale = np.sqrt(cfg.nt * cfg.nr)
    return scale * torch.einsum("ulr,ul,ult->urt", a_rx, gains.to(dtype),
                                a_tx.conj())


def _snap_to_grid(angles_deg, nq: int):
    """Snap angles to the sin-space virtual grid (ref: Generate_Channel.m:85-101)."""
    grid = torch.as_tensor(virtual_grid(nq), dtype=angles_deg.dtype,
                           device=angles_deg.device)
    s = torch.sin(torch.deg2rad(angles_deg))
    idx = torch.argmin(torch.abs(grid - s[..., None]), dim=-1)
    return torch.rad2deg(torch.arcsin(grid[idx]))


def generate_channel(generator: Optional[torch.Generator], cfg: ArrayConfig,
                     ch: ChannelConfig, batch: int = 1,
                     dtype=torch.complex64, device="cuda") -> Channel:
    """Sample ``batch`` independent Eq.-23 channels on ``device``.

    ref: Generate_Channel.m:64-164.  Notes on replicated semantics:
      - AoD/AoA ~ U(-SA/2, +SA/2) degrees (ref :77-84)
      - gains CN(0,1)/sqrt(2), normalized to unit norm per instance (ref :104-108)
      - Rician NLOS paths only when L == 1, angles U(-90, 90) (ref :109-124)
      - 7 dB K-factor mixing (ref :150-157)
    """
    dev = resolve_device(device)
    n_paths = ch.n_paths
    half = ch.searching_area_deg / 2.0
    rdt = _real_dtype(dtype)

    if ch.fix_angles:
        aod = torch.zeros((batch, n_paths), dtype=rdt, device=dev)
        aoa = torch.full((batch, n_paths), 15.0, dtype=rdt, device=dev)
    else:
        aod = _uniform(generator, (batch, n_paths), rdt, -half, half, dev)
        aoa = _uniform(generator, (batch, n_paths), rdt, -half, half, dev)
    if ch.on_grid:
        aod = _snap_to_grid(aod, cfg.grid_t)
        aoa = _snap_to_grid(aoa, cfg.grid_r)

    gains = _complex_normal(generator, (batch, n_paths), dtype, dev)
    gains = gains / torch.linalg.vector_norm(gains, dim=-1, keepdim=True)

    h_dom = _path_response(torch.deg2rad(aod), torch.deg2rad(aoa), gains,
                           cfg, dtype)

    # Rician NLOS component (only for single dominant path, ref :109-114)
    rician_k = ch.rician_k if n_paths == 1 else 0
    if rician_k > 0:
        nlos = _complex_normal(generator, (batch, rician_k), dtype, dev)
        nlos = nlos / torch.linalg.vector_norm(nlos, dim=-1, keepdim=True)
        aod_n = _uniform(generator, (batch, rician_k), rdt, -np.pi / 2,
                         np.pi / 2, dev)
        aoa_n = _uniform(generator, (batch, rician_k), rdt, -np.pi / 2,
                         np.pi / 2, dev)
        h_und = _path_response(aod_n, aoa_n, nlos, cfg, dtype)
        k_factor = 10.0 ** (ch.k_factor_db / 10.0)
        h = (np.sqrt(k_factor / (k_factor + 1.0)) * h_dom
             + np.sqrt(1.0 / (k_factor + 1.0)) * h_und)
    else:
        h_und = torch.zeros_like(h_dom)
        h = h_dom

    return Channel(aod_deg=aod, aoa_deg=aoa, gains=gains, h_matrix=h,
                   vec_h=vec_channel(h), h_dominant=h_dom, h_undominant=h_und)


def perturb_channel(generator: Optional[torch.Generator], channel: Channel,
                    cfg: ArrayConfig, max_angle_change_deg: float,
                    dtype=torch.complex64) -> Channel:
    """Mobility model: jitter AoD/AoA by <= ``max_angle_change_deg``, keep
    the gains.  ref: Generate_Dynamic_Channel.m:1-78."""
    rdt, dev = channel.aod_deg.dtype, channel.aod_deg.device
    lim = max_angle_change_deg
    d_aod = _uniform(generator, channel.aod_deg.shape, rdt, -lim, lim, dev)
    d_aoa = _uniform(generator, channel.aoa_deg.shape, rdt, -lim, lim, dev)
    aod = channel.aod_deg + d_aod
    aoa = channel.aoa_deg + d_aoa
    h_dom = _path_response(torch.deg2rad(aod), torch.deg2rad(aoa),
                           channel.gains, cfg, dtype)
    return Channel(aod_deg=aod, aoa_deg=aoa, gains=channel.gains,
                   h_matrix=h_dom, vec_h=vec_channel(h_dom),
                   h_dominant=h_dom, h_undominant=torch.zeros_like(h_dom))


def from_matrix(h_matrix, normalize: bool = False) -> Channel:
    """Wrap a measured / ray-traced H trace (a complex tensor) into a
    ``Channel`` on its device.

    ref: main/src/others/construct_channel_representation.m:18-31 (which
    normalizes each entry to unit magnitude: ``H ./ abs(H)``).
    """
    h = h_matrix
    if h.dim() == 2:
        h = h[None]
    if normalize:
        h = h / torch.clamp(torch.abs(h), min=1e-30)
    batch = h.shape[0]
    zero = torch.zeros((batch, 1), dtype=h.real.dtype, device=h.device)
    czero = torch.zeros((batch, 1), dtype=h.dtype, device=h.device)
    return Channel(aod_deg=zero, aoa_deg=zero, gains=czero, h_matrix=h,
                   vec_h=vec_channel(h), h_dominant=h,
                   h_undominant=torch.zeros_like(h))
