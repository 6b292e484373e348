"""K5: fused magnitude prox + M-dual update on row-layout complex state
(``csrc/prox_dual_rows.cu``).

Port of ``twoace_tpu.ops.pallas.kernels.fused_prox_dual``: the Y-update
and M-dual of the complex-dtype loop (``ops.admm.infer_admm``), on
complex64 or complex128 tensors read in place, with the elementwise form
(``per_entry=True``) that the per-column pass runs.  A CPU tensor takes
the plain version :func:`prox_dual_rows_plain`; a CUDA tensor launches
the kernel or raises.  :func:`plan` is the kernel's launch geometry (the C
``twoace_prox_dual_rows_plan``), for the tests.
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


#: the kernel's geometry constants (csrc/prox_dual_rows.cu): the H100
#: SXM's SMs, a block's most warps, the most entries a lane holds in
#: registers
NUM_SMS, MAX_WARPS, MAX_HELD = 132, 8, 4


def plan(rows: int, r: int, per_entry: bool = False) -> dict:
    """The kernel's launch geometry for ``rows`` rows of ``r`` entries (the
    C ``twoace_prox_dual_rows_plan``), the same for both dtypes: one entry
    a lane.  The elementwise form (and the row form at r = 1) is one
    entry a lane and nothing else.  The row form gives a row ``lanes``
    lanes, a warp ``rows_per_warp`` rows, a lane ``chunks`` entries,
    ``held`` of them in registers (0: read twice).  A block holds
    ``threads`` (1-8 warps: as few as leave a block for each SM)."""
    elementwise = bool(per_entry) or r == 1
    if elementwise:
        lanes = rows_per_warp = 0
        chunks = held = 1
        warps = -(-rows * r // 32)
    else:
        lanes = min(r, 32)
        rows_per_warp = 32 // lanes
        chunks = -(-r // lanes)
        held = 1
        while held < chunks:
            held *= 2
        held = held if held <= MAX_HELD else 0
        warps = -(-rows // rows_per_warp)
    per_block = min(max(warps // NUM_SMS, 1), MAX_WARPS)
    return dict(elementwise=int(elementwise), lanes=lanes,
                rows_per_warp=rows_per_warp, chunks=chunks, held=held,
                threads=32 * per_block, blocks=-(-warps // per_block))


def _check(ax, b, m_dual, mu) -> None:
    """Raise unless the kernel takes these operands, saying why: one pass
    of cheap tests (devices by index, dtypes by identity), the message
    built only for the first that fails."""
    rdt = _REAL.get(ax.dtype)
    if rdt is None:
        raise ValueError(f"ax: need complex64 or complex128, got {ax.dtype}")
    shape = ax.shape
    if len(shape) < 2:
        raise ValueError(f"ax: need shape (..., m, r), got {tuple(shape)}")
    dev = ax.get_device()
    for name, t, dtype, want in (("m_dual", m_dual, ax.dtype, shape),
                                 ("b", b, rdt, shape[:-1]),
                                 ("mu", mu, rdt, ())):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: need a tensor on {ax.device}, got "
                             f"{type(t).__name__}")
        if t.dtype is not dtype or t.get_device() != dev:
            raise ValueError(f"{name}: need {dtype} on {ax.device}, got "
                             f"{t.dtype} on {t.device}")
        if t.shape != want:
            raise ValueError(f"{name}: need shape {tuple(want)}, got "
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
    if not ax.is_cuda:
        if ax.device.type == "cpu":
            return prox_dual_rows_plain(ax, b, m_dual, mu, per_entry)
        raise ValueError(f"unsupported device {ax.device}")
    _check(ax, b, m_dual, mu)
    y, m_new = torch.empty_like(ax), torch.empty_like(ax)
    r = ax.shape[-1]
    rows = ax.numel() // r if r else 0
    if rows == 0:
        return y, m_new
    # the raw stream query: torch.cuda.current_stream builds a Stream
    # object (about 4 us a call)
    rc = (_fn or _function())(
        ax.data_ptr(), m_dual.data_ptr(), b.data_ptr(), mu.data_ptr(),
        y.data_ptr(), m_new.data_ptr(), rows, r, 1 if per_entry else 0,
        1 if ax.dtype == torch.complex128 else 0,
        torch._C._cuda_getCurrentRawStream(ax.get_device()))
    if rc:
        _build.check(rc, "fused_prox_dual")
    fused_prox_dual.launches += 1
    return y, m_new


fused_prox_dual.launches = 0

_fn = None


def _function():
    """The C entry point, looked up once."""
    global _fn
    _fn = _build.library().twoace_prox_dual_rows
    return _fn
