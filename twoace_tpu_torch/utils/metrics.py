"""Recovery metrics (port of ``twoace_tpu.utils.metrics``): channel NMSE,
RSS prediction error and phase quantization.  The sparse and angle
readouts are still to port."""

from __future__ import annotations

import math

import torch


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
