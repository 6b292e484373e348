"""Proximal operators of the 2ACE ADMM family (port of
``twoace_tpu.ops.prox``).

- the constraint-ladder selection ``profile_ladder`` /
  ``profile_ladder_arrays`` (ref: inferLowRankV4_multi.m:437-464): plain
  Python on static shapes, the array form as float32 tensors;
- on complex (..., m, r) / (n, r) tensors, for the complex-dtype solver
  family (:mod:`.admm`): the magnitude prox ArgMinY and its mu -> inf
  limit (ref :511-559), the spectral-profile prox ArgMinZ (ref :423-485)
  and the nuclear-norm prox (ref: inferLowRank_Nuclear.m:411-439).

``eig_backend`` is accepted for the JAX package's signatures; every value
runs ``torch.linalg.eigh`` (the Jacobi solver was a TPU workaround).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from .cplx import LadderArrays


def eigh_desc(g, backend: str = "jacobi"):
    """Hermitian eigendecomposition with eigenvalues descending.
    ``backend`` is accepted for the JAX signature and ignored."""
    del backend
    w, v = torch.linalg.eigh(g)
    return w.flip(-1), v.flip(-1)


def _direction(y, scale_by_row: bool):
    """y (..., m, r) with its zero rows (or entries) filled, and its norm
    d per row (or entry): ``(yr, yi, d)``, real tensors."""
    yr, yi = y.real, y.imag
    if scale_by_row:
        d2 = torch.sum(yr * yr + yi * yi, dim=-1, keepdim=True)
        fill = 1.0 / math.sqrt(y.shape[-1])
    else:
        d2 = yr * yr + yi * yi
        fill = 1.0
    zero = d2 <= 0
    yr = torch.where(zero, fill, yr)
    yi = torch.where(zero, 0.0, yi)
    return yr, yi, torch.sqrt(torch.where(zero, 1.0, d2))


def magnitude_prox(ax, b, m_dual, mu, scale_by_row: bool):
    """ArgMinY: project Y = AX + M/mu toward the measured magnitudes B
    (ref: inferLowRankV4_multi.m:511-533).

    ``ax``, ``m_dual``: (..., m, r) complex; ``b``: (..., m) real; ``mu``:
    a real scalar or 0-d tensor.  The new magnitude is (b + mu d)/(1 + mu)
    with d the current one (the norm of each row when ``scale_by_row``,
    else of each entry), direction kept; zero rows get 1/sqrt(r) (zero
    entries 1).  Rows with b = 0 are inactive padding: their prox is 0.
    M/mu divides and each step rounds on its own, as kernel K5 does.
    """
    y = torch.complex(ax.real + m_dual.real / mu, ax.imag + m_dual.imag / mu)
    yr, yi, d = _direction(y, scale_by_row)
    coeff = (b[..., None] / d + mu) / (1 + mu) * (b[..., None] > 0)
    return torch.complex(yr * coeff, yi * coeff)


def project_rows_to_magnitude(y, b, scale_by_row: bool):
    """normalize_rows: set the row (or entry) magnitudes of Y exactly to
    B, the mu -> inf limit of :func:`magnitude_prox`
    (ref: inferLowRankV4_multi.m:538-559)."""
    yr, yi, d = _direction(y, scale_by_row)
    c = b[..., None] / d
    return torch.complex(yr * c, yi * c)


def profile_ladder(nt: int, nr: int, m: int, n: int, use_rank_one: bool,
                   rank_mults: Sequence[float] = (0.5, 0.7, 1.0, 2.0),
                   fractions: Sequence[float] = (0.8, 0.9, 0.95, 0.995),
                   mode: str = "v4") -> Tuple[Tuple[int, float], ...]:
    """Static constraint ladder C(r, f).

    ``mode``: "v1" single constraint (ref: inferLowRank.m:407-418); "v2"
    adds the m >= 3n case and rank-1 mode (ref: inferLowRankV2.m:407-431);
    "v4" the full ladder with small-size fallbacks.
    """
    sz = min(nt, nr)
    rs = [math.ceil(math.sqrt(sz) * rank_mults[0]),
          math.ceil(math.sqrt(sz) * rank_mults[1]),
          math.ceil(math.sqrt(sz) * rank_mults[2]),
          min(sz, math.ceil(math.sqrt(sz) * rank_mults[3]))]
    fs = list(fractions)
    if mode == "v1":
        return ((rs[2], fs[2]),)
    if use_rank_one:
        return ((1, 0.95),)
    if m >= 3 * n:
        return ((rs[3], fs[3]),)
    if mode == "v2":
        return ((rs[2], fs[2]),)
    if rs[1] <= 2:
        return ((rs[2], fs[2]),)
    if rs[0] <= 2:
        return tuple(zip(rs[1:], fs[1:]))
    return tuple(zip(rs, fs))


def profile_ladder_arrays(nt: int, nr: int, m: int, n: int,
                          use_rank_one: bool,
                          rank_mults: Sequence[float] = (0.5, 0.7, 1.0, 2.0),
                          fractions: Sequence[float] = (0.8, 0.9, 0.95, 0.995),
                          mode: str = "v4", length: int = 4,
                          device=None) -> LadderArrays:
    """:func:`profile_ladder` padded to ``length`` levels with no-op
    entries (f = 0 never triggers a rescale), as float32 tensors."""
    lvl = profile_ladder(nt, nr, m, n, use_rank_one, rank_mults, fractions,
                         mode=mode)
    if len(lvl) > length:
        raise ValueError(f"ladder has {len(lvl)} levels > length={length}")
    pad = length - len(lvl)
    ranks = [float(rk) for rk, _ in lvl] + [float(min(nt, nr))] * pad
    fracs = [float(f) for _, f in lvl] + [0.0] * pad
    return LadderArrays(
        torch.tensor(ranks, dtype=torch.float32, device=device),
        torch.tensor(fracs, dtype=torch.float32, device=device))


def _columns_to_panel(z, nt: int, nr: int):
    """(n, r) ADMM matrix -> (nr, nt*r) panel of per-column channel
    matrices: column c of Z is vec(H_c), Rx index fastest."""
    r = z.shape[1]
    h = z.transpose(0, 1).reshape(r, nt, nr)          # h[c, it, ir]
    return h.permute(2, 0, 1).reshape(nr, r * nt)


def _panel_to_columns(e, nt: int, nr: int, r: int):
    """Inverse of :func:`_columns_to_panel`."""
    h = e.reshape(nr, r, nt).permute(1, 2, 0)          # (r, nt, nr)
    return h.reshape(r, nt * nr).transpose(0, 1)


def spectral_profile_prox(z, nt: int, nr: int,
                          ladder: Tuple[Tuple[int, float], ...],
                          eig_backend: str = "jacobi"):
    """ArgMinZ: enforce the spectral-profile constraint ladder on Z (n, r)
    complex, n = nt*nr (ref: inferLowRankV4_multi.m:423-485).

    For each static level (rk, f): if the top-rk eigenvalues of the panel
    Gram E E^H hold less than fraction f of the total, the trailing ones
    are scaled by ``min(1, vr/(v - vr) (1/f - 1))``; the scalings compose.
    Z = E + U diag(sqrt(scale) - 1) U^H E.  The ladder loop is Python over
    the static levels; every test on the eigenvalues is a ``torch.where``
    on the device.
    """
    r = z.shape[1]
    e = _columns_to_panel(z, nt, nr)                   # (nr, nt*r)
    g = e @ e.mH
    w, u = eigh_desc(0.5 * (g + g.mH), eig_backend)
    w = torch.clamp(w, min=0.0)
    scale = torch.ones_like(w)
    v_tot = torch.sum(w)
    idx = torch.arange(w.shape[0], device=w.device)
    for rk, f in ladder:
        vr = torch.sum(w[:rk])
        s = torch.clamp(vr / torch.clamp(v_tot - vr, min=1e-30)
                        * (1.0 / f - 1.0), max=1.0)
        s = torch.where(vr < v_tot * f, s, 1.0)
        mult = torch.where(idx >= rk, s, 1.0)
        w = w * mult
        scale = scale * mult
        v_tot = torch.sum(w)
    coeff = (torch.sqrt(scale) - 1.0).to(z.dtype)
    e_new = e + u @ (coeff[:, None] * (u.mH @ e))
    return _panel_to_columns(e_new, nt, nr, r)


def nuclear_prox(z, thresh, eig_backend: str = "jacobi"):
    """SVD soft-threshold of Z (n, r) at ``thresh`` (a scalar or 0-d
    tensor): Z V diag(max(s - thresh, 0)/s) V^H through the r x r Gram
    (ref: inferLowRank_Nuclear.m:411-439)."""
    g = z.mH @ z
    w, v = eigh_desc(0.5 * (g + g.mH), eig_backend)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    ratio = (torch.clamp(s - thresh, min=0.0)
             / torch.clamp(s, min=1e-30)).to(z.dtype)
    return z @ (v * ratio[None, :]) @ v.mH
