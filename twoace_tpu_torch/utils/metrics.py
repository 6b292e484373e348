"""Recovery metrics (port of ``twoace_tpu.utils.metrics``): channel NMSE,
RSS prediction error, phase quantization, and the sparse and angle
readouts of the simulation campaigns (``angles_from_sparse``,
``sparse_projection_omp``, ``angle_error``).  ``array_response_mse`` and
``beamforming_gain`` are still to port."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..models.steering import virtual_grid


def phase_align(x_est, x_ref):
    """Globally phase-align ``x_est`` to ``x_ref`` (complex (..., n)):
    ``phaseFac = exp(1j*angle(<x_est, x_ref> / <x_ref, x_ref>))``.
    ref: Evaluation_Recovery.m:207-208.
    """
    inner = torch.sum(x_est.conj() * x_ref, dim=-1, keepdim=True)
    denom = torch.sum(x_ref.conj() * x_ref, dim=-1, keepdim=True)
    fac = torch.exp(1j * torch.angle(inner / denom))
    return x_est * fac


def nmse_h(vec_h_est, vec_h_true):
    """Phase-aligned Frobenius NMSE of the channel (ref: Evaluate_H.m:8-12)."""
    est = phase_align(vec_h_est, vec_h_true)
    err = torch.sum(torch.abs(est - vec_h_true) ** 2, dim=-1)
    ref = torch.sum(torch.abs(vec_h_true) ** 2, dim=-1)
    return err / ref


def nmse_h_projection(vec_h_est, vec_h_true):
    """Projection-invariant NMSE ``|x_gt - (x'x_gt/x'x) x|^2 / |x_gt|^2``
    of complex (..., n) tensors.

    Invariant to any complex scaling of the estimate (ref: Evaluate_H.m:14-16).
    """
    xx = torch.sum(vec_h_est.conj() * vec_h_est, dim=-1)
    xg = torch.sum(vec_h_est.conj() * vec_h_true, dim=-1)
    coeff = (xg / torch.clamp(xx.abs(), min=1e-30))[..., None]
    err = torch.sum((vec_h_true - coeff * vec_h_est).abs() ** 2, dim=-1)
    ref = torch.sum(vec_h_true.abs() ** 2, dim=-1)
    return err / ref


def nmse_db(nmse):
    return 10.0 * torch.log10(nmse)


def rss_prediction_error(vec_h_est, cb_test, rss_test):
    """``mean(| |cb*H| - rss | / rss)``, which drives mobility re-probing.

    ref: Evaluate_rss.m:1-7.  ``cb_test``: (M, n); ``rss_test``: (M,)
    linear amplitudes.
    """
    rss_eval = torch.abs(cb_test @ vec_h_est)
    return torch.mean(torch.abs(rss_eval - rss_test) / rss_test)


def quantize_ps(w, phase_bit: int):
    """Nearest-phase 2^b-PSK quantization with 1/sqrt(rows) magnitude.

    ref: main/src/generate_sensing_matrix/Quantize_PS.m:61-73: grid
    ``-pi : 2*pi/2^b : pi`` (both endpoints; -pi and pi map to the same
    phasor).
    """
    nps = 2 ** phase_bit
    rows = w.shape[-2]
    grid = torch.arange(-nps // 2, nps // 2 + 1, device=w.device,
                        dtype=w.real.dtype) * (2.0 * math.pi / nps)
    idx = torch.argmin(torch.abs(torch.angle(w)[..., None] - grid), dim=-1)
    return torch.polar(torch.ones_like(grid[idx]), grid[idx]).to(w.dtype) \
        / math.sqrt(rows)


class AngleEstimate(NamedTuple):
    aod_deg: torch.Tensor   #: (U, L) estimated AoD, sorted descending
    aoa_deg: torch.Tensor   #: (U, L) estimated AoA (paired with sorted AoD)
    aod_err: torch.Tensor   #: (U,) mean |AoD error| vs true (degrees)
    aoa_err: torch.Tensor   #: (U,) mean |AoA error| vs true (degrees)
    aoda_err: torch.Tensor  #: (U,) mean of both


def top_k_first(x, k: int):
    """Indices of the k largest entries along the last axis, the lower
    index first among equal values (``lax.top_k``'s order;
    ``torch.topk`` does not promise one)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def angles_from_sparse(z_rec, cfg, tx_window, rx_window, n_paths: int):
    """Top-L support of the recovered sparse vector -> AoD/AoA in degrees.

    ref: Evaluation_Recovery.m:85-126.  ``z_rec``: (U, P) with
    P = |tx_window| * |rx_window| and Rx index fastest.
    """
    n_v = len(rx_window)
    mag = torch.abs(z_rec)
    idx = top_k_first(mag, n_paths)                         # (U, L)
    ind_u, ind_v = idx // n_v, idx % n_v
    dev, rdt = mag.device, mag.dtype
    grid_t = torch.as_tensor(virtual_grid(cfg.grid_t), dtype=rdt, device=dev)
    grid_r = torch.as_tensor(virtual_grid(cfg.grid_r), dtype=rdt, device=dev)
    tx_w = torch.as_tensor(np.asarray(tx_window), device=dev)
    rx_w = torch.as_tensor(np.asarray(rx_window), device=dev)
    aod = torch.rad2deg(torch.arcsin(grid_t[tx_w[ind_u]]))
    aoa = torch.rad2deg(torch.arcsin(grid_r[rx_w[ind_v]]))
    return aod, aoa


def sparse_projection_omp(vec_h, ad, n_paths: int):
    """Project H-domain estimates onto the sparse dictionary: dense z with
    an ``n_paths``-column OMP support such that ``vec_h ~= AD z``, batched
    over the leading axis.

    Gives direct vec-H solvers (the A2 family) the AoD/AoA readout the
    sparse-domain baselines get from their z (Evaluation_Recovery.m:85-126
    reads angles off the top-L support).  Gram-free: step-wise products
    are O(L P n).  ``vec_h``: (U, n) complex; ``ad``: (n, P).  Each step
    takes the first column of largest correlation and solves the normal
    equations with a 1e-12 ridge.  Returns dense (U, P) z.
    """
    batch = vec_h.shape[0]
    p = ad.shape[1]
    ad_h = ad.conj().T                                      # (P, n)
    resid = vec_h
    taken = torch.zeros((batch, p), dtype=torch.bool, device=vec_h.device)
    sel = []
    for t in range(n_paths):                                # static, tiny
        corr = torch.abs(resid @ ad_h.T)                    # (U, P)
        corr = torch.where(taken, -1.0, corr)
        j = torch.argmax(corr, dim=-1)
        sel.append(j)
        taken = taken.scatter(1, j[:, None], True)
        idx = torch.stack(sel, dim=-1)                      # (U, t+1)
        cols = ad.T[idx]                                    # (U, t+1, n)
        g = cols.conj() @ cols.transpose(-1, -2) + 1e-12 * torch.eye(
            t + 1, dtype=ad.dtype, device=ad.device)
        coef = torch.linalg.solve_ex(g, cols.conj() @ vec_h[..., None])[0][..., 0]
        resid = vec_h - (coef[:, None, :] @ cols)[:, 0]
    z = torch.zeros((batch, p), dtype=ad.dtype, device=vec_h.device)
    return z.scatter(1, idx, coef)


def angle_error(aod_est, aoa_est, aod_true, aoa_true) -> AngleEstimate:
    """Sorted-pair angle errors (ref: Evaluation_Recovery.m:128-148): the
    estimate and the truth are sorted by descending AoD (a stable sort,
    as ``jnp.argsort``) before comparison."""
    def sort_pair(aod, aoa):
        order = torch.argsort(-aod, dim=-1, stable=True)
        return aod.gather(-1, order), aoa.gather(-1, order)

    aod_e, aoa_e = sort_pair(aod_est, aoa_est)
    aod_t, aoa_t = sort_pair(aod_true, aoa_true)
    aod_err = torch.mean(torch.abs(aod_e - aod_t), dim=-1)
    aoa_err = torch.mean(torch.abs(aoa_e - aoa_t), dim=-1)
    return AngleEstimate(aod_deg=aod_e, aoa_deg=aoa_e, aod_err=aod_err,
                         aoa_err=aoa_err, aoda_err=0.5 * (aod_err + aoa_err))
