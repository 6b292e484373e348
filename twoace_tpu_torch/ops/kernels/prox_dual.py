"""K1: fused magnitude prox + M-dual update (``csrc/prox_dual.cu``).

Port of ``twoace_tpu.ops.pallas.kernels.fused_prox_dual_t``, batched over
lanes, with the elementwise pass-2 form (``per_entry=True``) as well.
A CPU tensor takes the plain version :func:`prox_dual_t_plain`; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..cplx import Pair, magnitude_prox_cols, magnitude_prox_cols_elem
from . import _build


def prox_dual_t_plain(ax: Pair, b, m_dual: Pair, mu, per_entry: bool):
    """Plain PyTorch version: ``(y, m_dual + mu (ax - y))`` with
    ``ax``/``m_dual`` (lanes, r, m), ``b`` (lanes, m), ``mu`` (lanes,)."""
    mu3 = mu[:, None, None]
    prox = magnitude_prox_cols_elem if per_entry else magnitude_prox_cols
    y = prox(ax, b, m_dual, mu3)
    m_new = Pair(m_dual.re + mu3 * (ax.re - y.re),
                 m_dual.im + mu3 * (ax.im - y.im))
    return y, m_new


def _check(ax: Pair, b, m_dual: Pair, mu):
    lanes, r, m = ax.re.shape
    state = (lanes, r, m)
    _build.check_inputs({"ax.re": (ax.re, state), "ax.im": (ax.im, state),
                         "m_dual.re": (m_dual.re, state),
                         "m_dual.im": (m_dual.im, state),
                         "b": (b, (lanes, m)), "mu": (mu, (lanes,))},
                        ax.re.device)


def fused_prox_dual_t(ax: Pair, b, m_dual: Pair, mu,
                      per_entry: bool = False):
    """y = prox(ax + M/mu) and M' = M + mu (ax - y) in one pass.

    ``ax``, ``m_dual``: (lanes, r, m) pairs; ``b``: (lanes, m); ``mu``:
    (lanes,).  ``per_entry=False`` takes the norm over r of each column
    (``magnitude_prox_cols``), ``True`` the norm of each entry
    (``magnitude_prox_cols_elem``).  Returns ``(y, m_new)``.
    """
    if ax.re.device.type == "cpu":
        return prox_dual_t_plain(ax, b, m_dual, mu, per_entry)
    if ax.re.device.type != "cuda":
        raise ValueError(f"unsupported device {ax.re.device}")
    _check(ax, b, m_dual, mu)
    lanes, r, m = ax.re.shape
    lib = _build.library()
    outs = [torch.empty_like(ax.re) for _ in range(4)]
    stream = torch.cuda.current_stream(ax.re.device).cuda_stream
    rc = lib.twoace_prox_dual_t(
        ax.re.data_ptr(), ax.im.data_ptr(), m_dual.re.data_ptr(),
        m_dual.im.data_ptr(), b.data_ptr(), mu.data_ptr(),
        *(o.data_ptr() for o in outs), lanes, r, m, int(per_entry), stream)
    _build.check(rc, "fused_prox_dual_t")
    fused_prox_dual_t.launches += 1
    return Pair(outs[0], outs[1]), Pair(outs[2], outs[3])


fused_prox_dual_t.launches = 0
