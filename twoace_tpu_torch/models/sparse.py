"""Sparse (virtual-angle) channel representation.

Port of ``twoace_tpu.models.sparse`` (ref:
main/src/generate_channel/Sparse_Channel_Formulation.m:65-181).  The FoV
window is static (numpy, from the config); the dictionary, the
ground-truth sparse vector z and the leakage are tensors on the channel's
device, batched over U.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import ArrayConfig
from .channel import Channel
from .steering import dictionary, fov_window, virtual_grid


class SparseRepresentation(NamedTuple):
    ad: torch.Tensor         #: (nt*nr, P) FoV-reduced dictionary
    z: torch.Tensor          #: (U, P) ground-truth sparse coefficient vector
    z_leakage: torch.Tensor  #: (U, P) projection of H onto the grid (leakage)
    tx_window: np.ndarray    #: static Tx grid indices of the FoV window
    rx_window: np.ndarray    #: static Rx grid indices of the FoV window
    a_tx: torch.Tensor       #: (nt, grid_t) full Tx dictionary
    a_rx: torch.Tensor       #: (nr, grid_r) full Rx dictionary


def sparse_formulation(cfg: ArrayConfig, channel: Channel,
                       searching_area_deg: float,
                       dtype=torch.complex64) -> SparseRepresentation:
    """AD, ground-truth z and leakage for a batch of channels.

    ref: Sparse_Channel_Formulation.m:65-181.  The grid is in virtual
    angle ``k_d * sin(theta)``; the nearest grid point (the first on ties)
    gives the support of z (ref :95-116); paths outside the window are
    dropped; AD columns are ``kron(conj(a_tx[:, u]), a_rx[:, v])`` over the
    window, Rx index fastest (ref :140-148).
    """
    dev = channel.aod_deg.device
    tx_idx, rx_idx = fov_window(cfg, searching_area_deg)
    n_u, n_v = len(tx_idx), len(rx_idx)

    a_tx_full = dictionary(cfg.nt, cfg.grid_t, cfg.k_d, dtype, dev)
    a_rx_full = dictionary(cfg.nr, cfg.grid_r, cfg.k_d, dtype, dev)
    a_tx = a_tx_full[:, torch.as_tensor(tx_idx, device=dev)]
    a_rx = a_rx_full[:, torch.as_tensor(rx_idx, device=dev)]
    ad = torch.einsum("tu,rv->truv", a_tx.conj(), a_rx)
    ad = ad.reshape(cfg.nt * cfg.nr, n_u * n_v)

    rdt = channel.aod_deg.dtype
    grid_t = torch.as_tensor(virtual_grid(cfg.grid_t), dtype=rdt, device=dev)
    grid_r = torch.as_tensor(virtual_grid(cfg.grid_r), dtype=rdt, device=dev)

    # nearest grid index per path, in full-grid coordinates (ref :99-106)
    sin_aod = torch.sin(torch.deg2rad(channel.aod_deg))     # (U, L)
    sin_aoa = torch.sin(torch.deg2rad(channel.aoa_deg))
    pos_t = torch.argmin(torch.abs(grid_t - sin_aod[..., None]), dim=-1)
    pos_r = torch.argmin(torch.abs(grid_r - sin_aoa[..., None]), dim=-1)

    # reduced-window flat position (u - u1) * n_v + (v - v1) (ref :108-116,139)
    u_rel = pos_t - int(tx_idx[0])
    v_rel = pos_r - int(rx_idx[0])
    in_window = (u_rel >= 0) & (u_rel < n_u) & (v_rel >= 0) & (v_rel < n_v)
    flat = torch.where(in_window, u_rel * n_v + v_rel, 0)

    gains = torch.where(in_window, channel.gains.to(dtype), 0)
    z = torch.zeros((gains.shape[0], n_u * n_v), dtype=dtype, device=dev)
    z.scatter_add_(1, flat, gains)

    # leakage: vec(A_Rx^H H A_Tx) over the window, Rx index fastest (ref :153-160)
    leak = torch.einsum("rv,urt,tw->uwv", a_rx.conj(),
                        channel.h_matrix.to(dtype), a_tx)
    z_leakage = leak.reshape(gains.shape[0], n_u * n_v)

    return SparseRepresentation(ad=ad, z=z, z_leakage=z_leakage,
                                tx_window=tx_idx, rx_window=rx_idx,
                                a_tx=a_tx_full, a_rx=a_rx_full)
