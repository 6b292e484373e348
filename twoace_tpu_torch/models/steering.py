"""ULA steering vectors and virtual-angle (DFT-like) dictionaries.

Port of ``twoace_tpu.models.steering`` (ref:
main/src/generate_channel/Generate_Channel.m:127-148 and
Sparse_Channel_Formulation.m:76-93).  Every function is batched, returns
complex64 or complex128 tensors, and builds on an explicit device: the
device of its tensor argument, or ``device`` (the card by default) where
it builds from the config alone.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ArrayConfig
from ..interop import resolve_device


def _real_dtype(cdtype):
    return torch.float64 if cdtype == torch.complex128 else torch.float32


def steering_vector(sin_theta, n: int, k_d: float, dtype=torch.complex64):
    """a(theta)[k] = exp(-1j * k_d * sin(theta) * k) / sqrt(n), k = 0..n-1.

    ``sin_theta`` is a tensor of any batch shape; returns ``(*batch, n)``
    on its device.  ref: Generate_Channel.m:132-133.
    """
    rdt = _real_dtype(dtype)
    k = torch.arange(n, dtype=rdt, device=sin_theta.device)
    phase = -k_d * sin_theta.to(rdt)[..., None] * k
    return torch.polar(torch.ones_like(phase), phase).to(dtype) / np.sqrt(n)


def virtual_grid(nq: int) -> np.ndarray:
    """The sin-space grid ``linspace(-1,1,NQ+1)(1:end-1)`` (numpy: it
    depends only on the config).  ref: Sparse_Channel_Formulation.m:76-79.
    """
    return np.linspace(-1.0, 1.0, nq + 1)[:-1]


def dictionary(n: int, nq: int, k_d: float, dtype=torch.complex64,
               device="cuda"):
    """Tx/Rx steering dictionary over the virtual grid: shape ``(n, nq)``.

    Column u is the steering vector at virtual angle ``k_d * grid[u]``.
    ref: Sparse_Channel_Formulation.m:84-93.
    """
    virt = k_d * virtual_grid(nq)
    a = np.exp(-1j * np.outer(np.arange(n), virt)) / np.sqrt(n)
    return torch.as_tensor(a, device=resolve_device(device)).to(dtype)


def fov_window(cfg: ArrayConfig, searching_area_deg: float):
    """Static FoV restriction of the virtual grid to +-searching_area/2.

    Returns ``(tx_idx, rx_idx)`` integer numpy arrays: the contiguous index
    windows of the Tx/Rx grids nearest to the FoV edges.
    ref: Sparse_Channel_Formulation.m:119-137.
    """
    half = np.deg2rad(searching_area_deg / 2.0)
    lo, hi = -np.sin(half), np.sin(half)

    def window(nq):
        grid = virtual_grid(nq)
        i_lo = int(np.argmin(np.abs(grid - lo)))
        i_hi = int(np.argmin(np.abs(grid - hi)))
        return np.arange(i_lo, i_hi + 1)

    return window(cfg.grid_t), window(cfg.grid_r)


def angle_dictionary(cfg: ArrayConfig, searching_area_deg: float,
                     dtype=torch.complex64, device="cuda"):
    """The FoV-reduced virtual-angle dictionary AD: shape ``(nt*nr, P)``.

    Column (u, v) is ``kron(conj(a_tx[:, u]), a_rx[:, v])``: Rx index
    fastest, matching vec(H) of an (nr, nt) H in column-major order.
    ref: Sparse_Channel_Formulation.m:140-148.
    """
    tx_idx, rx_idx = fov_window(cfg, searching_area_deg)
    a_tx = dictionary(cfg.nt, cfg.grid_t, cfg.k_d, dtype, device)[:, tx_idx]
    a_rx = dictionary(cfg.nr, cfg.grid_r, cfg.k_d, dtype, device)[:, rx_idx]
    ad = torch.einsum("tu,rv->truv", a_tx.conj(), a_rx)
    return ad.reshape(cfg.nt * cfg.nr, a_tx.shape[1] * a_rx.shape[1])


def vec_channel(h_matrix):
    """vec(H) with H of shape ``(..., nr, nt)`` -> ``(..., nt*nr)``, Rx
    index fastest (ref: Generate_Channel.m:158-161)."""
    return h_matrix.transpose(-1, -2).reshape(*h_matrix.shape[:-2], -1)


def unvec_channel(vec_h, nr: int, nt: int):
    """Inverse of :func:`vec_channel`: ``(..., nt*nr)`` -> ``(..., nr, nt)``."""
    return vec_h.reshape(*vec_h.shape[:-1], nt, nr).transpose(-1, -2)
