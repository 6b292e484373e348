"""Recovery metrics (port of ``twoace_tpu.utils.metrics``)."""

from __future__ import annotations

import torch


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
