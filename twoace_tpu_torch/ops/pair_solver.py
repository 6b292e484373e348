"""The 2ACE "A2" solver in pair (re, im) representation.

Port of ``twoace_tpu.ops.pair_solver``: the ``inferLowRankV4_multi``
scaffold (ref: main/src/my_recovery_algorithms/ADMM_v2/
inferLowRankV4_multi.m:5-109) for one recovery
(:func:`solve_lowrank_multi_pair`), its warm-started refine
(:func:`refine_lowrank_pair`), and a batch of channels measured through
one shared codebook (:func:`solve_lowrank_multi_pair_batch`).

Where JAX vmaps a ``lax.while_loop``, the port runs one loop over a lane
axis.  A lane is one (instance, restart) pair.  State tensors are laid out
(G, P, r, k): G groups share one codebook block (a restart's train split,
a retry lane's own split, or the full codebook), and P lanes ride each
group.  ``iters`` keeps JAX's meaning: the trips each lane ran, summed
over every inner solve whose result was used.

Routing of an inner solve on CUDA tensors (:func:`infer_admm_pair`):

- on the single-recovery path, a spectral-profile solve that is not
  anchored and has no warm trips runs its whole loop in the CUDA kernel
  K3 (:func:`.kernels.fused_infer_admm`), as JAX's megakernel route does;
- every other solve (anchored, ``warm_iters > 0``, nuclear, Z-free, and
  every solve of the batch solver) runs the per-op loop of
  :mod:`.admm_loop` with the kernels K4 (pair GEMM), K1 (magnitude prox
  + M-dual) and K2 (warm Z-prox), the nuclear prox in plain torch, or no
  Z-prox (the Z-free branch).

No solve on a CUDA tensor falls back to a plain version.  The setup around
the loop (Cholesky, Cholesky-QR, eigh, the quality gate, the retry gather and
scatter) is plain torch.  Only ``eig_mode="perturb"`` is ported: the Jacobi
eigensolver existed because the TPU lacked ``eigh``.

While a ``torch.profiler`` session is open, the two entries record their
spans (:mod:`..utils.profiling`): the roots ``pair.batch`` and
``pair.single``; ``setup.*`` (the active-row read, the splits,
normalisation, U, the spectral init with its CPU draw and its Cholesky-QR
steps, the column orthonormalisation, each loop's initialisation);
``stage.*`` (first pass, retry, refine); ``inner.solve`` (one a loop:
the per-op loop or one K3 launch) with the loop's ``inner.check`` reads;
and ``scaffold.*`` (quality, the host gate, the selection, the rollback).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import AdmmConfig
from ..utils.profiling import span
from .admm_loop import RowHook, admm_loop, gemm, groups, lanes, norm, where
from .cplx import (LadderArrays, Pair, from_complex, magnitude_prox_cols_elem,
                   scale, to_complex, transpose)
from .kernels import (fused_infer_admm, fused_prox_dual_t, fused_zprox_t,
                      pair_matmul, zprox_t_plain)
from .kernels.admm_trip import admm_trip
from .prox import profile_ladder_arrays

__all__ = [
    "PairAdmmResult", "precompute_u_pair", "pinv_u_pair",
    "spectral_initialize_pair",
    "project_cols_to_magnitude", "magnitude_prox_cols_elem",
    "admm_init_pair", "infer_admm_pair", "solve_lowrank_multi_pair_batch",
    "solve_lowrank_multi_pair", "refine_lowrank_pair",
]

PROX_KINDS = ("spectral_profile", "nuclear")


@contextlib.contextmanager
def no_tf32():
    """Turn ``torch.backends.cuda.matmul.allow_tf32`` off for the block and
    restore the caller's flag after it.

    Off is JAX's "float32" matmul precision, which the solvers' setup
    products (U, spectral init, quality) run under.  On the CPU the flag
    changes nothing, as JAX's precision does not.
    """
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class PairAdmmResult(NamedTuple):
    #: recovered vec(H): (n,) from the single-recovery entries, (B, n) from
    #: the batch solver
    x: Pair
    #: held-out quality 1 - ||(|A x|) - b|| / ||b|| (the refine: the fit
    #: over all the data); () or (B,)
    quality: torch.Tensor
    converged: torch.Tensor  #: bool, () or (B,)
    #: inner-ADMM trips each instance's lanes ran, summed over every solve
    #: whose result was used (both passes of every restart, the retry,
    #: and the refine); () or (B,)
    iters: torch.Tensor


# ---------------------------------------------------------------------------
# setup (plain torch: Cholesky, Cholesky-QR, eigh)

def precompute_u_pair(a: Pair, reg: float = 1.0,
                      reduce: RowHook = None) -> Pair:
    """U = inv(A^H A + reg I) of each (..., m, n) codebook block, by
    complex Cholesky and a triangular solve.  ref: inferLowRankV4_multi.m:241-247.
    With ``reduce`` (a row-sharded block) the Gram is all-reduced first.
    """
    with span("setup.precompute_u"):
        ac = to_complex(a)
        n = ac.shape[-1]
        g = ac.mH @ ac
        if reduce is not None:
            g = reduce.sum_(g)
        eye = torch.eye(n, dtype=ac.dtype, device=ac.device)
        g = 0.5 * (g + g.mH) + reg * eye
        c = torch.linalg.cholesky(g)
        w = torch.linalg.solve_triangular(c, eye.expand_as(c), upper=False)
        return from_complex(w.mH @ w)


def pinv_u_pair(a: Pair) -> Pair:
    """U = pinv(A)^H of each (..., m, n) codebook block: the Z-free
    X-update's operator, ``x = t @ conj(U)`` solving x A^T = t in least
    squares.  JAX's Z-free branch takes this (m, n) matrix from its caller
    (``u_mat``)."""
    return from_complex(torch.linalg.pinv(to_complex(a)).mH.contiguous())


def spectral_initialize_pair(a: Pair, b, r: int,
                             generator: Optional[torch.Generator] = None,
                             iters: int = 12) -> Pair:
    """Spectral init of every lane: X0^T, (G, P, r, n).

    ``a``: (G, m, n) codebook blocks; ``b``: (G, P, m).  Rows of A are
    scaled by b_i/||A_i||; the top-r eigenpairs of the scaled Gram come
    from ``iters`` steps of complex orthogonal iteration (Cholesky-QR) and
    a Rayleigh-Ritz ``eigh``, and are scaled by sqrt(eigenvalue).
    ref: inferLowRankV4_multi.m:561-574.  The start block is drawn from
    ``generator`` on the CPU, so a seed gives the same init on any device.
    """
    with span("setup.spectral_init"):
        gram = scaled_gram_pair(a, b)
        g_, p_, n, _ = gram.shape
        r = min(r, a.re.shape[-2], n)
        with span("setup.spectral_init.draw"):
            q = torch.randn((g_, p_, n, r), dtype=torch.complex64,
                            generator=generator).to(gram.device)
        return top_r_init(gram, q, iters)


def scaled_gram_pair(a: Pair, b) -> torch.Tensor:
    """The spectral init's Gram sum_i (b_i/||A_i||)^2 A_i^H A_i of every
    lane, complex (G, P, n, n), not yet made Hermitian; a row with
    ||A_i|| = 0 (a masked row) adds nothing."""
    ac = to_complex(a)
    row_norm = torch.sqrt(torch.clamp(torch.sum(ac.real ** 2 + ac.imag ** 2,
                                                dim=-1), min=1e-30))
    s = torch.where(row_norm[:, None, :] > 1e-15,
                    b / row_norm[:, None, :], 1.0)             # (G, P, m)
    return (ac.mH[:, None] * (s * s)[..., None, :]) @ ac[:, None]


def _cholqr2(z: torch.Tensor) -> torch.Tensor:
    """Orthonormal columns spanning those of complex ``z`` (..., n, r) by
    two rounds of Cholesky-QR, each batched over every leading index: the
    r x r Gram with the JAX package's shift of 1e-7 trace / r, its
    Cholesky factor C, and the solve Q C^H = z.  ``cholesky_ex`` reads no
    ``info``, so nothing waits for the device.
    ref: ``twoace_tpu.ops.pair_solver._cholqr``."""
    with span("setup.spectral_init.orth"):
        r = z.shape[-1]
        for _ in range(2):
            g = z.mH @ z
            d = torch.diagonal(g, dim1=-2, dim2=-1)
            d.add_(d.real.sum(-1, keepdim=True), alpha=1e-7 / r)
            c = torch.linalg.cholesky_ex(g).L
            z = torch.linalg.solve_triangular(c.mH, z, upper=True, left=False)
        return z


def top_r_init(gram: torch.Tensor, q: torch.Tensor, iters: int = 12) -> Pair:
    """X0^T (G, P, r, n) from the scaled Gram (G, P, n, n) and the start
    block ``q`` (G, P, n, r), complex64 on any device: orthogonal iteration
    orthonormalised by :func:`_cholqr2`, Rayleigh-Ritz ``eigh``,
    eigenvectors scaled by sqrt(eigenvalue)."""
    gram = 0.5 * (gram + gram.mH)
    q = _cholqr2(q.to(gram.device))
    for _ in range(iters):
        q = _cholqr2(gram @ q)
    rr = q.mH @ (gram @ q)
    w, v = torch.linalg.eigh(0.5 * (rr + rr.mH))
    w, v = w.flip(-1), v.flip(-1)                              # descending
    x0 = (q @ v) * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]
    return from_complex(x0.transpose(-1, -2))


def project_cols_to_magnitude(y: Pair, b, scale_by_row: bool) -> Pair:
    """Set the per-measurement magnitude of Y (..., r, m) exactly to
    b (..., m).  ref: inferLowRankV4_multi.m:538-559."""
    if scale_by_row:
        d2 = torch.sum(y.re * y.re + y.im * y.im, dim=-2, keepdim=True)
        fill = 1.0 / math.sqrt(y.re.shape[-2])
    else:
        d2 = y.re * y.re + y.im * y.im
        fill = 1.0
    zero = d2 <= 0
    yr = torch.where(zero, fill, y.re)
    yi = torch.where(zero, 0.0, y.im)
    c = b[..., None, :] / torch.sqrt(torch.where(zero, 1.0, d2))
    return Pair(yr * c, yi * c)


def _orthonormalize_cols_t(x: Pair) -> Pair:
    """X <- X * eigvec(X^H X), eigenvectors in descending order, on
    transposed x (..., r, n).  ref :263-264."""
    with span("setup.orthonormalize"):
        xc = to_complex(x)
        g = xc.conj() @ xc.transpose(-1, -2)                   # X^H X
        _, v = torch.linalg.eigh(0.5 * (g + g.mH))
        return from_complex(v.flip(-1).transpose(-1, -2) @ xc)


def _nuclear_prox_t(z: Pair, thresh) -> Pair:
    """Nuclear prox of transposed z (..., r, n): soft-threshold the
    singular values of Z = z^T by ``thresh`` (a scalar or (...,)), through
    the r x r Gram Z^H Z and ``torch.linalg.eigh``.
    ref: inferLowRank_Nuclear.m:411-439."""
    zc = to_complex(z)
    g = zc.conj() @ zc.transpose(-1, -2)                       # Z^H Z
    w, v = torch.linalg.eigh(0.5 * (g + g.mH))
    s = torch.sqrt(torch.clamp(w, min=0.0))
    th = thresh[..., None] if torch.is_tensor(thresh) else thresh
    ratio = torch.clamp(s - th, min=0.0) / torch.clamp(s, min=1e-30)
    mat = (v * ratio[..., None, :].to(v.dtype)) @ v.mH         # V ratio V^H
    # Z_new = Z (V ratio V^H)  =>  z_new = conj(V ratio V^H) z
    return from_complex(mat.conj() @ zc)


def _quality_pair(a_te: Pair, b_te, x: Pair):
    """1 - ||(|A_te x|) - b_te|| / ||b_te|| of single-column x (G, P, 1, n)
    against (G, m_te, n) blocks and b_te (G, P, m_te).  ref :68."""
    with span("scaffold.quality"):
        ax = gemm(x, transpose(a_te))
        amp = torch.sqrt(torch.clamp(ax.re ** 2 + ax.im ** 2,
                                     min=0.0))[..., 0, :]
        return 1.0 - (torch.linalg.vector_norm(amp - b_te, dim=-1)
                      / torch.clamp(torch.linalg.vector_norm(b_te, dim=-1),
                                    min=1e-30))


# ---------------------------------------------------------------------------
# the inner solve

def _lane_ladder(ladder: LadderArrays, g_: int, p_: int) -> LadderArrays:
    """A ladder broadcastable to (G, P, L) as per-lane (G*P, L) tensors."""
    levels = ladder.ranks.shape[-1]
    return LadderArrays(
        ladder.ranks.expand(g_, p_, levels).reshape(g_ * p_, levels)
        .contiguous(),
        ladder.fracs.expand(g_, p_, levels).reshape(g_ * p_, levels)
        .contiguous())


def _contiguous(p: Pair) -> Pair:
    return Pair(p.re.contiguous(), p.im.contiguous())


def admm_init_pair(a: Pair, b, x0: Pair, *, scale_by_row: bool, nt: int,
                   nr: int, ladder: Optional[LadderArrays],
                   prox_kind: str = "spectral_profile",
                   reduce: RowHook = None):
    """Initialization of every lane's InferADMM solve (ref :300-321).

    Scales x0 to the measurements, projects A x0 onto the magnitudes b,
    and seeds the Z-prox: the spectral-profile prox from a cold ``eigh``
    basis of the initial Gram, the nuclear prox at threshold 1; with no
    ladder and the spectral-profile kind (the Z-free branch) there is no
    Z.  Returns ``(y, z, v_basis)``, the state the loop starts from;
    v_basis is (G, P, nr, nr) in the E-convention (a (G, P, 1, 1)
    placeholder for the nuclear prox; z and v_basis both are for the
    Z-free branch).  With ``reduce`` (row-sharded blocks) the norms of b
    and A x0 are summed over the shards in one all-reduce.
    """
    with span("setup.admm_init"):
        g_, p_ = x0.re.shape[:2]
        a_t = transpose(a)
        ax = gemm(x0, a_t)
        if reduce is None:
            bn = torch.linalg.vector_norm(b, dim=-1)            # (G, P)
            if scale_by_row:
                nax = norm(ax)
            else:
                col2 = torch.sum(ax.re ** 2 + ax.im ** 2,
                                 dim=-1)                        # (G, P, r)
        else:
            s2 = reduce.sum_(torch.cat([
                torch.sum(b * b, dim=-1)[..., None],
                torch.sum(ax.re ** 2 + ax.im ** 2, dim=-1)], dim=-1))
            bn, col2 = torch.sqrt(s2[..., 0]), s2[..., 1:]
            nax = torch.sqrt(torch.sum(col2, dim=-1))
        if scale_by_row:
            x = scale(x0, (bn / torch.clamp(nax, min=1e-30))[..., None, None])
        else:
            col = torch.sqrt(torch.clamp(col2, min=1e-30))
            x = scale(x0, (bn[..., None] / col)[..., None])
        y = project_cols_to_magnitude(gemm(x, a_t), b, scale_by_row)
        zero = torch.zeros(g_, p_, 1, 1, dtype=torch.float32,
                           device=x.re.device)
        if prox_kind == "nuclear":
            return y, _nuclear_prox_t(x, 1.0), Pair(zero, zero)
        if ladder is None:                               # the Z-free branch
            return y, Pair(zero, zero), Pair(zero, zero)
        z, v_basis = (groups(p, g_) for p in zprox_t_plain(
            lanes(x), None, nt, nr, _lane_ladder(ladder, g_, p_)))
        return y, z, v_basis


def infer_admm_pair(a: Pair, b, x0: Pair, *, scale_by_row: bool,
                    nt: int, nr: int, ladder: Optional[LadderArrays] = None,
                    u_mat: Optional[Pair] = None,
                    prox_kind: str = "spectral_profile",
                    mu0: float = 1e-3, rho: float = 1.03,
                    tol_rel: float = 1e-4, tol_abs: float = 1e-8,
                    maxiter: int = 500, warm_iters: int = 0,
                    anchor: Optional[Pair] = None,
                    anchor_weight: float = 0.0, fused_loop: bool = True,
                    reduce: RowHook = None, m_eff: Optional[int] = None):
    """One InferADMM solve of every lane (ref: inferLowRankV4_multi.m:281-386).

    ``a``: (G, m, n) codebook blocks; ``b``: (G, P, m); ``x0``:
    (G, P, r, n); ``u_mat``: (G, n, n) = inv(A^H A + I) per block, or None
    to compute it here; ``ladder``: ranks/fracs broadcastable to
    (G, P, L), None for the nuclear prox.  A spectral-profile solve with
    no ladder is the Z-free branch (JAX's ``has_z`` false): no Z-prox, no
    N-dual, and ``u_mat`` is the (G, m, n) least-squares operator
    pinv(A)^H (:func:`pinv_u_pair`, computed here when None); on CUDA it
    runs the per-op loop with K4 and K1.

    ``anchor`` (broadcastable to (G, P, r, n)) with ``anchor_weight > 0``
    adds ``anchor_weight * ||x - anchor||^2`` to the X-subproblem (the
    tracker's proximal anchor): the pull joins the X-update's right-hand
    side and U takes the matching (1 + anchor_weight) ridge, so an anchored
    solve must not be handed ``u_mat``.

    On CUDA a spectral-profile solve without anchor and warm trips runs
    in the loop kernel K3, unless ``fused_loop`` is False (the batch
    solver's routing, kept on the per-op loop until a measurement decides
    it); other solves run the per-op loop (K4, K1, and K2 where there is
    a spectral-profile Z).  K3 computes its
    products in 3xTF32 on the tensor cores against constants split once
    per launch, K4 in 3xTF32 tensor-core tiles or split-K on the CUDA
    cores: float32-class either way.

    ``reduce`` and ``m_eff``: a row-sharded solve (:mod:`.admm_loop`):
    ``a``, ``b`` hold this shard's rows, and the solve runs the per-op
    loop, whose trips all-reduce over the shards (K3 cannot hold a
    collective); ``u_mat`` is then computed from the all-reduced Gram.

    Returns ``(opt_x, opt_y, converged, it)``: opt_x (G, P, r, n) with
    ``scale_by_row``, else the best column (G, P, 1, n); ``it`` (G, P)
    counts each lane's own trips.
    """
    if prox_kind not in PROX_KINDS:
        raise ValueError(f"prox_kind must be one of {PROX_KINDS}, got "
                         f"{prox_kind!r}")
    has_z = ladder is not None or prox_kind == "nuclear"
    anchored = anchor is not None and anchor_weight > 0.0
    if anchored and not has_z:
        raise ValueError("proximal anchor requires the Z-constrained path")
    if anchored and u_mat is not None:
        raise ValueError("anchored solves must not pass a precomputed "
                         "u_mat; the (1 + anchor_weight) ridge is folded "
                         "into U internally")
    if u_mat is None:
        u_mat = precompute_u_pair(
            a, reg=1.0 + (anchor_weight if anchored else 0.0),
            reduce=reduce) if has_z else pinv_u_pair(a)
    g_, p_ = x0.re.shape[:2]
    y, z, v_basis = admm_init_pair(a, b, x0, scale_by_row=scale_by_row,
                                   nt=nt, nr=nr, ladder=ladder,
                                   prox_kind=prox_kind, reduce=reduce)
    mu = torch.full((g_, p_), mu0, dtype=torch.float32, device=x0.re.device)
    kw = dict(scale_by_row=scale_by_row, rho=rho, tol_rel=tol_rel,
              tol_abs=tol_abs, maxiter=maxiter)
    if reduce is not None:
        kw.update(reduce=reduce, m_eff=m_eff)

    if not has_z:
        z_prox = None
    elif prox_kind == "spectral_profile":
        lad = _lane_ladder(ladder, g_, p_)
        if fused_loop and not anchored and warm_iters == 0 \
                and reduce is None:
            with span("inner.solve"):
                return fused_infer_admm(
                    _contiguous(a), b.contiguous(), _contiguous(u_mat),
                    _contiguous(y), _contiguous(z), _contiguous(v_basis), mu,
                    lad, nt=nt, nr=nr, **kw)

        def z_prox(zz, vv, mu_l):
            return fused_zprox_t(zz, vv, nt, nr, lad)
    else:
        def z_prox(zz, vv, mu_l):
            return _nuclear_prox_t(zz, 1.0 / mu_l), vv

    with span("inner.solve"):
        return admm_loop(
            a, b, u_mat, y, z, v_basis, mu, pair_gemm=pair_matmul,
            prox_dual=fused_prox_dual_t, z_prox=z_prox, trip=admm_trip,
            warm_iters=warm_iters,
            anchor=scale(anchor, anchor_weight) if anchored else None,
            zprox="nuclear" if prox_kind == "nuclear" else "k2", **kw)


# ---------------------------------------------------------------------------
# the scaffold

def _check_modes(prox_kind: str, eig_mode: str) -> None:
    if prox_kind not in PROX_KINDS:
        raise ValueError(f"prox_kind must be one of {PROX_KINDS}, got "
                         f"{prox_kind!r}")
    if eig_mode != "perturb":
        raise NotImplementedError(
            "the port runs eig_mode='perturb' only (the Jacobi eigensolver "
            "existed because the TPU lacked eigh)")


def _pass_bounds(cfg: AdmmConfig):
    """Trip bounds of the two passes (ref :649-658).  A capped pass at or
    below ``warm_iters`` would run only warm-phase trips (coarse ones in
    JAX) and return a coarse iterate, so it is refused."""
    b1 = min(cfg.stage1_maxiter, cfg.maxiter) \
        if cfg.stage1_maxiter is not None else cfg.maxiter
    b2 = min(cfg.stage2_maxiter, cfg.maxiter) \
        if cfg.stage2_maxiter is not None else cfg.maxiter
    if cfg.warm_iters > 0 and min(b1, b2) <= cfg.warm_iters:
        raise ValueError(
            f"pass caps ({b1}, {b2}) must exceed warm_iters="
            f"{cfg.warm_iters}: a pass that ends inside the warm phase "
            "returns a coarse iterate")
    return b1, b2


def _impl_pair(a: Pair, b, xs: Pair, nt: int, nr: int, cfg: AdmmConfig,
               ladder: Optional[LadderArrays], u_mat: Pair,
               prox_kind: str = "spectral_profile", fused_loop: bool = True,
               reduce: RowHook = None, m_eff: Optional[int] = None):
    """inferLowRankImpl of every lane (ref :111-271): the scale_by_row
    pass, column orthonormalization, then the per-column pass; row-sharded
    with ``reduce`` (see :func:`infer_admm_pair`).
    Returns ``(x (G, P, 1, n), converged, it (G, P, 2))``."""
    b1, b2 = _pass_bounds(cfg)
    kw = dict(nt=nt, nr=nr, ladder=ladder, u_mat=u_mat, prox_kind=prox_kind,
              mu0=cfg.mu0, rho=cfg.rho, tol_rel=cfg.tol_rel,
              tol_abs=cfg.tol_abs, warm_iters=cfg.warm_iters,
              fused_loop=fused_loop, reduce=reduce, m_eff=m_eff)
    x, _, _, it1 = infer_admm_pair(a, b, xs, scale_by_row=True, maxiter=b1,
                                   **kw)
    x = _orthonormalize_cols_t(x)
    x, _, converged, it2 = infer_admm_pair(a, b, x, scale_by_row=False,
                                           maxiter=b2, **kw)
    return x, converged, torch.stack([it1, it2], dim=-1)


def _normalize_problem_pair(a: Pair, b, tol_abs: float, m_eff=None):
    """Scale A to ||A||_F = sqrt(m_eff), each b (..., m) to unit norm
    (ref :27-38).  ``m_eff`` defaults to the ACTIVE (b > 0) row count of
    a single b: padding rows (A_i = 0, b_i = 0) then leave the
    normalization, and so the ridge in U = inv(A^H A + I), as for the
    unpadded problem.  Returns ``(a_n, b_n, a_norm, b_norm)``."""
    with span("setup.normalize"):
        if m_eff is None:
            m_eff = torch.clamp(torch.sum(b > 0), min=1).to(torch.float32)
        a_norm = norm(a) / m_eff ** 0.5
        a_norm = torch.where(a_norm < tol_abs, 1.0, a_norm)
        b_norm = torch.linalg.vector_norm(b, dim=-1)
        b_norm = torch.where(b_norm < tol_abs, 1.0, b_norm)
        return scale(a, 1.0 / a_norm), b / b_norm[..., None], a_norm, b_norm


def _rows(a: Pair, idx) -> Pair:
    return Pair(a.re[idx], a.im[idx])


def _rollback(x_max: Pair, x_ref: Pair, q_max, cfg: AdmmConfig) -> Pair:
    """Keep the refine's result unless the selected restart was good and
    the refine wandered off it: similarity |<x_max, x_ref>| /
    (||x_max|| ||x_ref||) below the threshold (ref :93-98)."""
    with span("scaffold.rollback"):
        dims = (-2, -1)
        dot_re = torch.sum(x_max.re * x_ref.re + x_max.im * x_ref.im, dim=dims)
        dot_im = torch.sum(x_max.re * x_ref.im - x_max.im * x_ref.re, dim=dims)
        similarity = (torch.sqrt(dot_re ** 2 + dot_im ** 2)
                      / torch.clamp(norm(x_max) * norm(x_ref), min=1e-30))
        rollback = ((q_max > cfg.quality_threshold)
                    & (similarity < cfg.similarity_threshold))
        return where(rollback, x_max, x_ref)


class _FirstPass(NamedTuple):
    x: Pair            #: (R, B, 1, n)
    q: torch.Tensor    #: (R, B)
    it: torch.Tensor   #: (R, B, 2)
    xs: Pair           #: (R, B, r, n) spectral init
    u_tr: Pair         #: (R, n, n)
    a_n: Pair
    b_n: torch.Tensor
    a_norm: torch.Tensor
    b_norm: torch.Tensor


def _batch_first_pass(a: Pair, b_batch, trains, tests,
                      ladder: Optional[LadderArrays], nt: int, nr: int,
                      cfg: AdmmConfig, m_eff: int,
                      generator: Optional[torch.Generator],
                      xs: Optional[Pair] = None,
                      prox_kind: str = "spectral_profile") -> _FirstPass:
    """Stage 1: normalize, then every (restart, instance) first-pass solve
    (ref: inferLowRankV4_multi.m:27-68).  Lanes are restart-major: group
    R shares its train split's codebook rows and U = inv(A^H A + I).

    ``xs``: optional spectral init (R, B, r, n), which lets a test run the
    port on exactly the JAX package's inputs.
    """
    with span("stage.first_pass"):
        n = a.re.shape[-1]
        r = min(cfg.rank, trains.shape[1], n)
        a_n, b_n, a_norm, b_norm = _normalize_problem_pair(a, b_batch,
                                                           cfg.tol_abs, m_eff)
        a_tr, a_te = _rows(a_n, trains), _rows(a_n, tests)          # (R, k, n)
        b_tr = b_n[:, trains].transpose(0, 1)                       # (R, B, k)
        b_te = b_n[:, tests].transpose(0, 1)
        u_tr = precompute_u_pair(a_tr)
        if xs is None:
            xs = spectral_initialize_pair(a_tr, b_tr, r, generator)
        x, _, it = _impl_pair(a_tr, b_tr, xs, nt, nr, cfg, ladder, u_tr,
                              prox_kind, fused_loop=False)
        q = _quality_pair(a_te, b_te, x)
        return _FirstPass(x, q, it, xs, u_tr, a_n, b_n, a_norm, b_norm)


def _batch_retry(fp: _FirstPass, rest_idx, inst_idx, trains, tests,
                 ladder_r1: LadderArrays, nt: int, nr: int, cfg: AdmmConfig):
    """Stage 2: rank-1 retry of exactly the K gathered poor
    (restart, instance) pairs (ref: inferLowRankV4_multi.m:73-77).  Each
    pair is its own group (its restart's train rows and U).
    Returns ``(x (K, n), q (K,), it (K,))``."""
    with span("stage.retry"):
        tr, te = trains[rest_idx], tests[rest_idx]                  # (K, k)
        a_tr, a_te = _rows(fp.a_n, tr), _rows(fp.a_n, te)
        b_sel = fp.b_n[inst_idx]
        b_tr = torch.gather(b_sel, 1, tr)[:, None]                  # (K, 1, k)
        b_te = torch.gather(b_sel, 1, te)[:, None]
        xs = Pair(fp.xs.re[rest_idx, inst_idx][:, None],
                  fp.xs.im[rest_idx, inst_idx][:, None])
        u = _rows(fp.u_tr, rest_idx)
        x, _, it = _impl_pair(a_tr, b_tr, xs, nt, nr, cfg, ladder_r1, u,
                              fused_loop=False)
        q = _quality_pair(a_te, b_te, x)
        return Pair(x.re[:, 0, 0], x.im[:, 0, 0]), q[:, 0], it.sum(-1)[:, 0]


def _refine_best(a_n: Pair, b_n, x: Pair, q, rank_one,
                 lad_normal: Optional[LadderArrays],
                 lad_r1: Optional[LadderArrays], nt: int, nr: int,
                 cfg: AdmmConfig, prox_kind: str, shared: bool,
                 reduce: RowHook = None, m_eff: Optional[int] = None):
    """Stage 3 of the batch scaffolds: best restart per instance (first
    max on ties), its full-data refine on the ladder the restart's
    rank-one flag picks, the similarity rollback
    (ref: inferLowRankV4_multi.m:79-101).

    ``x`` (B, R, n), ``q`` and ``rank_one`` (B, R), instance-major.
    ``shared``: the instances ride one group as lanes through one
    codebook, ``a_n`` (1, m, n) and ``b_n`` (1, B, m); else each is its
    own group, ``a_n`` (B, m, n) and ``b_n`` (B, 1, m), as a row-sharded
    solve holds them (``reduce``, ``m_eff``: see :func:`infer_admm_pair`).
    Returns ``(x (B, n) before the rescale, q_max (B,), the refine's
    trips (B,))``."""
    batch, _, n = x.re.shape
    with span("scaffold.select"):
        ar = torch.arange(batch, device=q.device)
        j = torch.argmax(q, dim=1)                                  # (B,)
        q_max = q[ar, j]
        lead = (1, batch) if shared else (batch, 1)
        x_max = Pair(x.re[ar, j].view(*lead, 1, n),
                     x.im[ar, j].view(*lead, 1, n))
    lad = None
    if prox_kind != "nuclear":
        r1 = rank_one[ar, j].view(*lead, 1)
        lad = LadderArrays(torch.where(r1, lad_r1.ranks, lad_normal.ranks),
                           torch.where(r1, lad_r1.fracs, lad_normal.fracs))
    x_ref, _, _, it_ref = infer_admm_pair(
        a_n, b_n, x_max, scale_by_row=True, nt=nt, nr=nr, ladder=lad,
        u_mat=precompute_u_pair(a_n, reduce=reduce), prox_kind=prox_kind,
        mu0=cfg.mu0, rho=cfg.rho, tol_rel=cfg.tol_rel, tol_abs=cfg.tol_abs,
        maxiter=cfg.maxiter, fused_loop=False, reduce=reduce, m_eff=m_eff)
    xo = _rollback(x_max, x_ref, q_max.view(lead), cfg)
    return (Pair(xo.re.reshape(batch, n), xo.im.reshape(batch, n)), q_max,
            it_ref.reshape(batch))


def _batch_refine(fp: _FirstPass, x: Pair, q, it_sum, rank_one,
                  lad_normal: Optional[LadderArrays],
                  lad_r1: Optional[LadderArrays],
                  nt: int, nr: int, cfg: AdmmConfig,
                  prox_kind: str = "spectral_profile") -> PairAdmmResult:
    """Stage 3 (:func:`_refine_best`) through the shared codebook, then
    the rescale (ref: inferLowRankV4_multi.m:79-107).  ``x`` (R, B, n),
    ``q`` and ``rank_one`` (R, B)."""
    with span("stage.refine"):
        a_full = Pair(fp.a_n.re[None], fp.a_n.im[None])             # (1, m, n)
        xo, q_max, it_ref = _refine_best(
            a_full, fp.b_n[None],
            Pair(x.re.transpose(0, 1), x.im.transpose(0, 1)),
            q.transpose(0, 1), rank_one.transpose(0, 1), lad_normal, lad_r1,
            nt, nr, cfg, prox_kind, shared=True)
        return PairAdmmResult(
            x=scale(xo, (fp.b_norm / fp.a_norm)[:, None]), quality=q_max,
            converged=torch.ones(q.shape[1], dtype=torch.bool,
                                 device=q.device),
            iters=it_sum + it_ref)


def _random_splits(m: int, frac: float, n_restarts: int,
                   generator: Optional[torch.Generator]):
    """Per-restart (train, test) row permutations, floor(m * frac) train
    rows, drawn on the CPU from ``generator`` (JAX's ``_split``)."""
    k = int(math.floor(m * frac))
    perms = [torch.randperm(m, generator=generator)
             for _ in range(n_restarts)]
    return (torch.stack([p[:k] for p in perms]),
            torch.stack([p[k:] for p in perms]))


def _splits(splits, m: int, cfg: AdmmConfig, n_restarts: int, generator,
            dev):
    """(trains (R, k), tests (R, m - k)) on ``dev``: drawn, or the
    test-only ``splits`` given in the JAX package's layout."""
    with span("setup.splits"):
        if splits is None:
            trains, tests = _random_splits(m, cfg.cc_frac, n_restarts,
                                           generator)
        else:
            trains, tests = (torch.tensor(np.asarray(s), dtype=torch.int64)
                             for s in splits)
        return trains.to(dev), tests.to(dev)


def _ladders(nt: int, nr: int, n: int, cfg: AdmmConfig, prox_kind: str,
             dev):
    """``ladder(m, rank_one)``: the spectral-profile ladder as tensors, or
    None for the nuclear prox."""
    pl = cfg.profile

    def ladder(mm: int, rank_one: bool):
        if prox_kind == "nuclear":
            return None
        return profile_ladder_arrays(nt, nr, mm, n, rank_one, pl.rank_mults,
                                     pl.fractions, mode=pl.ladder,
                                     device=dev)
    return ladder


def solve_lowrank_multi_pair_batch(generator: Optional[torch.Generator],
                                   a: Pair, b_batch, nt: int, nr: int,
                                   cfg: AdmmConfig = AdmmConfig(),
                                   prox_kind: str = "spectral_profile",
                                   eig_mode: str = "perturb",
                                   n_restarts: Optional[int] = None, *,
                                   splits=None, xs: Optional[Pair] = None
                                   ) -> PairAdmmResult:
    """Batch of recoveries through ONE shared probing codebook.

    ``a``: (m, n) pair; ``b_batch``: (B, m) float32, on the device the
    solve runs on.  Three stages with one host readback between them (the
    (R, B) quality gate): the first pass of every (restart, instance),
    the rank-1 retry of exactly the poor pairs, and the refine.  The
    nuclear prox has no retry (ref: JAX ``pair_solver.py:909``).  Runs with
    ``torch.backends.cuda.matmul.allow_tf32`` False (JAX's "float32"); its
    loop's products run in K4 (3xTF32 on the tensor cores at these shapes:
    float32-class).

    ``generator`` draws the train/test splits and the spectral-init start
    blocks (on the CPU).  Test-only: ``splits`` = (trains (R, k), tests
    (R, m - k)) row indices and ``xs`` = the spectral init (B, R, r, n),
    in the JAX package's layout, replace those draws.

    Returns a PairAdmmResult with a leading batch axis.
    """
    _check_modes(prox_kind, eig_mode)
    n_restarts = cfg.n_restarts if n_restarts is None else n_restarts
    batch = b_batch.shape[0]
    m, n = a.re.shape
    dev = a.re.device

    with span("pair.batch"):
        # active-row accounting: b == 0 rows are inactive padding by
        # contract; one shared codebook admits only one active count
        with span("setup.active_rows"):
            counts = torch.sum(b_batch > 0, dim=1).cpu().numpy()
        m_act = int(counts[0]) if batch else m
        if batch and not (counts == m_act).all():
            raise ValueError(
                "solve_lowrank_multi_pair_batch shares one codebook across "
                "the batch, so every instance must have the same active "
                f"(b > 0) row count; got {sorted(set(counts.tolist()))}.  "
                "b == 0 marks an INACTIVE padding row by contract (real "
                "measured amplitudes are strictly positive, "
                "A2only.m:130-139) -- if these zeros are genuine "
                "measurements, clamp them to a tiny positive floor; "
                "otherwise pad uniformly.")
        m_act = max(m_act, 1)

        trains, tests = _splits(splits, m, cfg, n_restarts, generator, dev)
        if xs is not None:
            xs = Pair(xs.re.transpose(0, 1).contiguous(),
                      xs.im.transpose(0, 1).contiguous())
        lm_tr = int(math.floor(m_act * cfg.cc_frac))
        ladder = _ladders(nt, nr, n, cfg, prox_kind, dev)

        with no_tf32():
            fp = _batch_first_pass(a, b_batch, trains, tests,
                                   ladder(lm_tr, False), nt, nr, cfg, m_act,
                                   generator, xs, prox_kind)
            x = Pair(fp.x.re[:, :, 0].clone(), fp.x.im[:, :, 0].clone())
            q, it = fp.q, fp.it.sum(-1)                             # (R, B)
            rank_one = torch.zeros_like(q, dtype=torch.bool)
            with span("scaffold.gate"):
                poor = (q < cfg.quality_threshold).cpu()            # host gate
                retry = prox_kind != "nuclear" and bool(poor.any())
            if retry:
                rest_idx, inst_idx = (i.to(dev) for i in torch.nonzero(
                    poor, as_tuple=True))
                xr, qr, itr = _batch_retry(fp, rest_idx, inst_idx, trains,
                                           tests, ladder(lm_tr, True), nt, nr,
                                           cfg)
                x.re[rest_idx, inst_idx] = xr.re
                x.im[rest_idx, inst_idx] = xr.im
                q = q.index_put((rest_idx, inst_idx), qr)
                it = it.index_put((rest_idx, inst_idx), itr, accumulate=True)
                rank_one[rest_idx, inst_idx] = True
            return _batch_refine(fp, x, q, it.sum(0), rank_one,
                                 ladder(m_act, False), ladder(m_act, True),
                                 nt, nr, cfg, prox_kind)


def solve_lowrank_multi_pair(generator: Optional[torch.Generator], a: Pair,
                             b, nt: int, nr: int,
                             cfg: AdmmConfig = AdmmConfig(),
                             prox_kind: str = "spectral_profile",
                             eig_mode: str = "perturb",
                             n_restarts: Optional[int] = None,
                             ladder_m: Optional[int] = None, *,
                             splits=None, xs: Optional[Pair] = None
                             ) -> PairAdmmResult:
    """One recovery: the 2ACE "A2" solver (ref: inferLowRankV4_multi.m:5-109).

    ``a``: (m, n) pair; ``b``: (m,) float32 magnitudes, on the device the
    solve runs on.  Normalize; run the restarts side by side (G = R
    groups, each with its own train split and U = inv(A^H A + I)):
    spectral init, the two passes, held-out quality; re-solve the poor
    restarts (quality below ``cfg.quality_threshold``) with the rank-1
    ladder, a host gate; keep the best restart (first on ties); refine it
    on all the data with that restart's ladder, full ``cfg.maxiter`` and
    no warm trips; roll back if the refine wandered off; rescale.  The
    nuclear prox has no retry.

    Rows with ``b == 0`` are inactive padding by contract (their A rows
    must be zero too): normalization follows the active count, and
    ``ladder_m`` gives the active count the constraint ladders follow
    (else the padded ``m``, as in JAX).  On CUDA, at the default cold
    config every inner solve runs in the loop kernel K3.

    ``generator`` draws the splits and the spectral-init start blocks (on
    the CPU).  Test-only: ``splits`` = (trains (R, k), tests (R, m - k))
    row indices and ``xs`` = the spectral init (R, r, n) of the normalized
    problem, in the JAX package's layout, replace those draws.

    Returns a PairAdmmResult of scalars and x (n,).
    """
    _check_modes(prox_kind, eig_mode)
    n_restarts = cfg.n_restarts if n_restarts is None else n_restarts
    m, n = a.re.shape
    dev = a.re.device
    r = min(cfg.rank, m, n)
    with span("pair.single"):
        a_n, b_n, a_norm, b_norm = _normalize_problem_pair(a, b, cfg.tol_abs)
        lm_full = m if ladder_m is None else ladder_m
        lm_tr = int(math.floor(lm_full * cfg.cc_frac))
        ladder = _ladders(nt, nr, n, cfg, prox_kind, dev)
        trains, tests = _splits(splits, m, cfg, n_restarts, generator, dev)
        a_tr, a_te = _rows(a_n, trains), _rows(a_n, tests)      # (R, k, n)
        b_tr, b_te = b_n[trains][:, None], b_n[tests][:, None]  # (R, 1, k)
        u_tr = precompute_u_pair(a_tr)

        with no_tf32():
            with span("stage.first_pass"):
                if xs is None:
                    xs = spectral_initialize_pair(a_tr, b_tr, r, generator)
                else:
                    xs = Pair(xs.re[:, None].to(dev), xs.im[:, None].to(dev))
                x, _, it = _impl_pair(a_tr, b_tr, xs, nt, nr, cfg,
                                      ladder(lm_tr, False), u_tr, prox_kind)
                q = _quality_pair(a_te, b_te, x)[:, 0]              # (R,)
                it = it.sum(-1)[:, 0]
                x = Pair(x.re[:, 0, 0].clone(), x.im[:, 0, 0].clone())
            rank_one = np.zeros(n_restarts, dtype=bool)
            if prox_kind != "nuclear":
                with span("scaffold.gate"):
                    poor = (q < cfg.quality_threshold).cpu().numpy()
                if poor.any():
                    # JAX re-solves every restart and keeps the poor ones;
                    # solving only the poor ones gives the same x, q and
                    # iters
                    with span("stage.retry"):
                        idx = torch.as_tensor(np.nonzero(poor)[0],
                                              device=dev)
                        xr, _, itr = _impl_pair(
                            _rows(a_tr, idx), b_tr[idx], _rows(xs, idx), nt,
                            nr, cfg, ladder(lm_tr, True), _rows(u_tr, idx))
                        q[idx] = _quality_pair(_rows(a_te, idx), b_te[idx],
                                               xr)[:, 0]
                        x.re[idx] = xr.re[:, 0, 0]
                        x.im[idx] = xr.im[:, 0, 0]
                        it[idx] += itr.sum(-1)[:, 0]
                    rank_one = poor

            with span("stage.refine"):
                with span("scaffold.select"):
                    j = int(torch.argmax(q))                        # first max
                    q_max = q[j]
                    x_max = Pair(x.re[j][None, None, None],
                                 x.im[j][None, None, None])
                a_full = Pair(a_n.re[None], a_n.im[None])           # (1, m, n)
                x_ref, _, _, it_ref = infer_admm_pair(
                    a_full, b_n[None, None], x_max, scale_by_row=True, nt=nt,
                    nr=nr, ladder=ladder(lm_full, bool(rank_one[j])),
                    prox_kind=prox_kind, mu0=cfg.mu0, rho=cfg.rho,
                    tol_rel=cfg.tol_rel, tol_abs=cfg.tol_abs,
                    maxiter=cfg.maxiter)
                xo = _rollback(x_max, x_ref, q_max, cfg)
        s = b_norm / a_norm
        return PairAdmmResult(
            x=Pair(xo.re[0, 0, 0] * s, xo.im[0, 0, 0] * s), quality=q_max,
            converged=torch.ones((), dtype=torch.bool, device=dev),
            iters=it.sum() + it_ref[0, 0])


def refine_lowrank_pair(a: Pair, b, x0: Pair, nt: int, nr: int,
                        cfg: AdmmConfig = AdmmConfig(),
                        prox_kind: str = "spectral_profile",
                        ladder_m: Optional[int] = None,
                        use_rank_one: bool = False,
                        anchor_weight: float = 0.0) -> PairAdmmResult:
    """Warm-started refine: the full-data refinement step
    (ref: inferLowRankV4_multi.m:89-101) as an entry of its own, seeded by
    ``x0`` (n,) instead of the spectral init (the mobility tracker's
    window-to-window warm start).

    ``anchor_weight > 0`` adds ``anchor_weight * ||x - x0||^2`` to the
    X-subproblem, so directions the current rows do not measure stay at
    the previous estimate.  The solve runs ``cfg.maxiter`` trips at most,
    with the warm-phase reset after the first ``cfg.warm_iters``.
    ``quality`` is the fit 1 - ||(|A x|) - b|| / ||b|| over all the data.
    On CUDA an anchored or warm refine runs the per-op loop (K4, K1, K2),
    a plain one the loop kernel K3.
    """
    _check_modes(prox_kind, "perturb")
    m, n = a.re.shape
    a_n, b_n, a_norm, b_norm = _normalize_problem_pair(a, b, cfg.tol_abs)
    lm = m if ladder_m is None else ladder_m
    x0n = scale(Pair(x0.re[None, None, None], x0.im[None, None, None]),
                a_norm / b_norm)                                # (1, 1, 1, n)
    ladder = _ladders(nt, nr, n, cfg, prox_kind, a.re.device)(lm,
                                                              use_rank_one)
    a_full = Pair(a_n.re[None], a_n.im[None])
    b_full = b_n[None, None]
    with no_tf32():
        x, _, converged, it = infer_admm_pair(
            a_full, b_full, x0n, scale_by_row=True, nt=nt, nr=nr,
            ladder=ladder, prox_kind=prox_kind, mu0=cfg.mu0, rho=cfg.rho,
            tol_rel=cfg.tol_rel, tol_abs=cfg.tol_abs, maxiter=cfg.maxiter,
            warm_iters=cfg.warm_iters,
            anchor=x0n if anchor_weight > 0.0 else None,
            anchor_weight=anchor_weight)
        q = _quality_pair(a_full, b_full, x)[0, 0]
    s = b_norm / a_norm
    return PairAdmmResult(x=Pair(x.re[0, 0, 0] * s, x.im[0, 0, 0] * s),
                          quality=q, converged=converged[0, 0],
                          iters=it[0, 0])
