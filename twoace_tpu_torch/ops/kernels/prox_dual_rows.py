"""K5: fused magnitude prox + M-dual update on row-layout complex state
(``csrc/prox_dual_rows.cu``).

Port of ``twoace_tpu.ops.pallas.kernels.fused_prox_dual``: the Y-update
and M-dual of the complex-dtype loop (``ops.admm.infer_admm``), on
complex64 or complex128 tensors read in place, with the elementwise form
(``per_entry=True``) that the per-column pass runs.  A CPU tensor takes
the plain version :func:`prox_dual_rows_plain`; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from ..prox import magnitude_prox
from . import _build

_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def prox_dual_rows_plain(ax, b, m_dual, mu, per_entry: bool = False):
    """Plain PyTorch version: ``y = magnitude_prox(ax, b, m_dual, mu)``
    (the row norm, or each entry's with ``per_entry``) and
    ``m_dual + mu (ax - y)``, each part rounded on its own."""
    y = magnitude_prox(ax, b, m_dual, mu, scale_by_row=not per_entry)
    m_new = torch.complex(m_dual.real + mu * (ax.real - y.real),
                          m_dual.imag + mu * (ax.imag - y.imag))
    return y, m_new


def _check(ax, b, m_dual, mu) -> None:
    if ax.dtype not in _REAL:
        raise ValueError(f"ax: need complex64 or complex128, got {ax.dtype}")
    rdt = _REAL[ax.dtype]
    if ax.dim() < 2:
        raise ValueError(f"ax: need shape (..., m, r), got {tuple(ax.shape)}")
    expect = {"m_dual": (m_dual, ax.dtype, ax.shape),
              "b": (b, rdt, ax.shape[:-1]), "mu": (mu, rdt, ())}
    for name, (t, dtype, shape) in expect.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: need a tensor on {ax.device}, got "
                             f"{type(t).__name__}")
        if t.device != ax.device or t.dtype != dtype:
            raise ValueError(f"{name}: need {dtype} on {ax.device}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: need shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("ax", ax), ("m_dual", m_dual), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_prox_dual(ax, b, m_dual, mu, per_entry: bool = False):
    """y = prox(ax + M/mu) and M' = M + mu (ax - y) in one pass.

    ``ax``, ``m_dual``: contiguous complex (..., m, r); ``b``: real
    (..., m); ``mu``: a 0-d real tensor on the same device (it stays
    there: no host read).  ``per_entry=False`` takes the norm over r of
    each row (``scale_by_row=True``), ``True`` the norm of each entry.
    Returns ``(y, m_new)``.
    """
    if ax.device.type == "cpu":
        return prox_dual_rows_plain(ax, b, m_dual, mu, per_entry)
    if ax.device.type != "cuda":
        raise ValueError(f"unsupported device {ax.device}")
    _check(ax, b, m_dual, mu)
    y, m_new = torch.empty_like(ax), torch.empty_like(ax)
    r = ax.shape[-1]
    rows = ax.numel() // r if r else 0
    if rows == 0:
        return y, m_new
    lib = _build.library()
    stream = torch.cuda.current_stream(ax.device).cuda_stream
    rc = lib.twoace_prox_dual_rows(
        ax.data_ptr(), m_dual.data_ptr(), b.data_ptr(), mu.data_ptr(),
        y.data_ptr(), m_new.data_ptr(), rows, r, int(per_entry),
        int(ax.dtype == torch.complex128), stream)
    _build.check(rc, "fused_prox_dual")
    fused_prox_dual.launches += 1
    return y, m_new


fused_prox_dual.launches = 0
