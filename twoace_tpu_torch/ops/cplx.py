"""Pair-representation complex arithmetic on torch tensors.

Port of the parts of ``twoace_tpu.ops.cplx`` that the batched A2 solver
runs.  Complex matrices on the solver's main path stay planar
``(re, im)`` float32 pairs in the transposed, r-leading layout, so that
the hand-written kernels (``ops/kernels``) and the JAX reference see the
same arrays.  Every function broadcasts over leading lane axes.

Where the JAX package embedded a Hermitian matrix into a real symmetric
one and ran its Jacobi solver (no complex dtype on the TPU runtime), the
port calls ``torch.linalg.eigh`` on complex64 and flips to descending
order, which is the order ``eigh_jacobi`` returns.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Pair(NamedTuple):
    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape


class LadderArrays(NamedTuple):
    """Constraint ladder C(r, f) as tensors instead of a static tuple.

    ``ranks``/``fracs`` are (..., L) float32, padded with no-op levels
    f = 0 (the ladder only acts when the head holds less than fraction f
    of the variance, so f = 0 never triggers).  A leading lane axis gives
    each lane its own ladder.
    """

    ranks: torch.Tensor  #: (..., L) head sizes r_k, compared as rank < r_k
    fracs: torch.Tensor  #: (..., L) variance fractions f_k; 0 = padded no-op


def ladder_levels(ladder):
    """(rank, frac) levels of a static tuple ladder or a LadderArrays.

    LadderArrays levels keep a trailing singleton axis on the rank so they
    broadcast against a (..., k) spectrum.
    """
    if isinstance(ladder, LadderArrays):
        return [(ladder.ranks[..., i, None], ladder.fracs[..., i])
                for i in range(ladder.ranks.shape[-1])]
    return list(ladder)


def add(a: Pair, b: Pair) -> Pair:
    return Pair(a.re + b.re, a.im + b.im)


def sub(a: Pair, b: Pair) -> Pair:
    return Pair(a.re - b.re, a.im - b.im)


def scale(a: Pair, s) -> Pair:
    """Multiply by a real scalar or broadcastable tensor."""
    return Pair(a.re * s, a.im * s)


def conj(a: Pair) -> Pair:
    return Pair(a.re, -a.im)


def transpose(a: Pair) -> Pair:
    """Plain (not conjugate) transpose of the last two axes."""
    return Pair(a.re.transpose(-1, -2), a.im.transpose(-1, -2))


def to_complex(p: Pair) -> torch.Tensor:
    return torch.complex(p.re, p.im)


def from_complex(x: torch.Tensor) -> Pair:
    return Pair(x.real.contiguous(), x.imag.contiguous())


def matmul(a: Pair, b: Pair) -> Pair:
    """A @ B with 3 real matmuls (Karatsuba 3M form):
    k1 = Ar(Br+Bi); k2 = (Ar+Ai)Bi; k3 = (Ai-Ar)Br;
    re = k1 - k2, im = k1 + k3."""
    k1 = a.re @ (b.re + b.im)
    k2 = (a.re + a.im) @ b.im
    k3 = (a.im - a.re) @ b.re
    return Pair(k1 - k2, k1 + k3)


def matmul_herm_t(a: Pair, b: Pair) -> Pair:
    """A^H @ B."""
    return matmul(conj(transpose(a)), b)


def hermitian_part(g: Pair) -> Pair:
    """0.5 (G + G^H), as the JAX package symmetrises every Gram."""
    return Pair(0.5 * (g.re + g.re.transpose(-1, -2)),
                0.5 * (g.im - g.im.transpose(-1, -2)))


def eigh_desc(g: Pair):
    """Eigenpairs of a Hermitian pair, eigenvalues descending.

    Returns ``(w, v)`` with v a unitary Pair (columns are eigenvectors).
    """
    w, v = torch.linalg.eigh(to_complex(g))
    return w.flip(-1), from_complex(v.flip(-1))


def magnitude_prox_cols(ax_t: Pair, b, m_dual_t: Pair, mu) -> Pair:
    """Transposed-layout row-magnitude prox (arrays (..., r, m), b (..., m)).

    ``mu`` is a scalar or broadcasts against (..., r, m).  The norm of each
    measurement column reduces over r; a zero column takes the reference's
    constant branch 1/sqrt(r) (ref: inferLowRankV4_multi.m:516-519); a
    column with b == 0 is inactive padding and proxes to 0.
    """
    inv_mu = 1.0 / mu
    yr = ax_t.re + m_dual_t.re * inv_mu
    yi = ax_t.im + m_dual_t.im * inv_mu
    d2 = torch.sum(yr * yr + yi * yi, dim=-2, keepdim=True)
    zero = d2 <= 0
    r = yr.shape[-2]
    yr = torch.where(zero, 1.0 / math.sqrt(r), yr)
    yi = torch.where(zero, 0.0, yi)
    d = torch.sqrt(torch.where(zero, 1.0, d2))
    bb = b[..., None, :]
    coeff = (bb / d + mu) / (1.0 + mu) * (bb > 0)
    return Pair(yr * coeff, yi * coeff)


def magnitude_prox_cols_elem(ax: Pair, b, m_dual: Pair, mu) -> Pair:
    """Elementwise magnitude prox (scale_by_row=False): each column of X is
    an independent candidate, so each entry of Y is pulled toward
    |y| = b_i.  ref: inferLowRankV4_multi.m:525-533."""
    inv_mu = 1.0 / mu
    yr = ax.re + m_dual.re * inv_mu
    yi = ax.im + m_dual.im * inv_mu
    d2 = yr * yr + yi * yi
    zero = d2 <= 0
    yr = torch.where(zero, 1.0, yr)
    d = torch.sqrt(torch.where(zero, 1.0, d2))
    bb = b[..., None, :]
    coeff = (bb / d + mu) / (1.0 + mu) * (bb > 0)
    return Pair(yr * coeff, yi * coeff)


def eigh_update_perturbative_pair(g: Pair, v0: Pair, ns_steps: int = 1,
                                  rel_gap: float = 1e-3,
                                  max_norm: float = 0.7, mm=matmul):
    """Warm eigenbasis refinement of a Hermitian pair ``g`` (..., n, n).

    Rotate ``g' = v0^H g v0``, apply the first-order anti-Hermitian
    correction ``C_ij = g'_ij / (l_j - l_i)`` (masked near degeneracy,
    Frobenius-capped at ``max_norm``), ``v = v0 (I + C)``, then
    ``ns_steps`` Newton-Schulz re-unitarizations.  Returns ``(lam, v)``
    with lam the UNSORTED Rayleigh estimates aligned with v's columns.
    ``mm`` computes every product (K2's emulation passes its own).
    """
    n = g.shape[-1]
    gr = mm(conj(transpose(v0)), mm(g, v0))
    lam = torch.diagonal(gr.re, dim1=-2, dim2=-1)
    gap = lam[..., None, :] - lam[..., :, None]              # l_j - l_i
    mag = lam[..., None, :].abs() + lam[..., :, None].abs()
    ok = gap.abs() > rel_gap * torch.clamp(mag, min=1e-30)
    denom = torch.where(ok, gap, 1.0)
    c = Pair(torch.where(ok, gr.re / denom, 0.0),
             torch.where(ok, gr.im / denom, 0.0))
    c = Pair(0.5 * (c.re - c.re.transpose(-1, -2)),
             0.5 * (c.im + c.im.transpose(-1, -2)))
    fro = torch.sqrt(torch.sum(c.re * c.re + c.im * c.im, dim=(-2, -1),
                               keepdim=True))
    capped = torch.clamp(max_norm / torch.clamp(fro, min=1e-30), max=1.0)
    c = scale(c, capped)
    v = add(v0, mm(v0, c))
    eye = torch.eye(n, dtype=v.re.dtype, device=v.re.device)
    for _ in range(ns_steps):
        vtv = mm(conj(transpose(v)), v)
        v = mm(v, Pair(1.5 * eye - 0.5 * vtv.re, -0.5 * vtv.im))
    return lam, v


def ladder_scales(w, ladder):
    """Per-eigenvalue multipliers of the 2ACE constraint ladder on the
    UNSORTED spectrum ``w`` (..., k), returned in the same order.

    Each eigenvalue's rank comes from pairwise comparison (ties broken by
    index), and "head of the spectrum" is the mask rank < r_k.  The
    ``1/max(f, 1e-30)`` guard keeps a padded f = 0 level finite.
    ref: inferLowRankV4_multi.m:437-480.
    """
    k = w.shape[-1]
    gt = w[..., None, :] > w[..., :, None]
    eq = w[..., None, :] == w[..., :, None]
    idx = torch.arange(k, device=w.device)
    tie = eq & (idx[None, :] < idx[:, None])
    rank = torch.sum(gt | tie, dim=-1).to(w.dtype)            # (..., k)
    scale_ = torch.ones_like(w)
    v_tot = torch.sum(w, dim=-1)
    for rk, f in ladder_levels(ladder):
        head = rank < rk
        vr = torch.sum(torch.where(head, w, 0.0), dim=-1)
        need = vr < v_tot * f
        inv_f = 1.0 / (torch.clamp(f, min=1e-30) if torch.is_tensor(f)
                       else max(f, 1e-30))
        s = torch.clamp(vr / torch.clamp(v_tot - vr, min=1e-30)
                        * (inv_f - 1.0), max=1.0)
        s = torch.where(need, s, 1.0)
        mult = torch.where(head, 1.0, s[..., None])
        w = w * mult
        scale_ = scale_ * mult
        v_tot = torch.sum(w, dim=-1)
    return scale_


def panel_gram(e: Pair) -> Pair:
    """Hermitian Gram E E^H of a channel panel ``e`` (..., nr, cols)."""
    return hermitian_part(matmul(e, conj(transpose(e))))


def panel_gram_basis_pair(e: Pair):
    """Cold eigenbasis of the panel Gram E E^H (seeds the warm Z-prox).
    Returns ``(w, v)`` with w descending and v a unitary Pair."""
    return eigh_desc(panel_gram(e))


def _panel_spectral_prox_c(e: Pair, nr: int, ladder, v0):
    """Complex-pair spectral-profile prox on a panel ``e`` (..., nr, cols).

    ``v0``: unitary Pair basis from the previous iteration, or None for a
    cold start.  Returns ``(e_new, v)``.
    """
    if v0 is None:
        w, v = panel_gram_basis_pair(e)
    else:
        w, v = eigh_update_perturbative_pair(panel_gram(e), v0)
    scale_ = ladder_scales(torch.clamp(w, min=0.0), ladder)
    coeff = torch.sqrt(scale_) - 1.0
    vc = scale(v, coeff[..., None, :])
    delta = matmul(vc, conj(transpose(v)))                   # vc @ v^H
    return add(e, matmul(delta, e)), v
