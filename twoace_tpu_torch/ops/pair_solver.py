"""The batched 2ACE "A2" solver in pair (re, im) representation.

Port of the batch path of ``twoace_tpu.ops.pair_solver``
(``solve_lowrank_multi_pair_batch`` and what it runs), the
``inferLowRankV4_multi`` scaffold (ref:
main/src/my_recovery_algorithms/ADMM_v2/inferLowRankV4_multi.m:5-109) for
a batch of channels measured through one shared codebook.

Where JAX vmaps a ``lax.while_loop``, the port runs one loop over a lane
axis.  A lane is one (instance, restart) pair.  State tensors are laid out
(G, P, r, k): G groups share one codebook block (a restart's train split,
a retry lane's own split, or the full codebook), and P lanes ride each
group, so the three pair GEMMs of a trip fold (P, r) into the rows of one
batched ``torch.matmul`` over groups.  Each lane carries a ``converged``
mask; a finished lane's state is frozen with ``torch.where`` and its trip
count ``it`` stops, so ``iters`` keeps JAX's meaning (the trips each lane
ran).
Whether any lane is still active is read on the host once every
``CHECK_EVERY`` trips; the extra frozen trips change nothing.

The magnitude prox with its dual update and the warm Z-prox run through
the hand-written kernels of :mod:`.kernels` on CUDA tensors.  The setup
around the loop (Cholesky, eigh, QR, the quality gate, the retry gather and
scatter) is plain torch.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import AdmmConfig
from .cplx import (LadderArrays, Pair, add, conj, from_complex,
                   magnitude_prox_cols_elem, matmul, scale, sub,
                   to_complex, transpose)
from .kernels import fused_prox_dual_t, fused_zprox_t, zprox_t_plain
from .prox import profile_ladder_arrays

__all__ = [
    "PairAdmmResult", "precompute_u_pair", "spectral_initialize_pair",
    "project_cols_to_magnitude", "magnitude_prox_cols_elem",
    "infer_admm_pair", "solve_lowrank_multi_pair_batch",
    "solve_lowrank_multi_pair", "refine_lowrank_pair",
]

#: trips between host reads of the lanes' converged masks
CHECK_EVERY = 8


class PairAdmmResult(NamedTuple):
    x: Pair                 #: (B, n) recovered vec(H)
    quality: torch.Tensor   #: (B,) held-out quality 1 - ||(|A x|) - b|| / ||b||
    converged: torch.Tensor  #: (B,) bool
    #: (B,) inner-ADMM trips each instance's lanes ran, summed over every
    #: solve whose result was used (both passes of every restart, the
    #: retry, and the refine)
    iters: torch.Tensor


@contextlib.contextmanager
def _tf32(enabled: bool):
    """Set ``torch.backends.cuda.matmul.allow_tf32`` for the block.

    False is JAX's "float32" matmul precision; True is the port's
    stand-in for the single-pass "default" of the ``warm_iters`` phase.
    On the CPU the flag changes nothing, as JAX's precision does not.
    """
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# small helpers on (G, P, r, k) pairs

def _fro2(p: Pair):
    return torch.sum(p.re * p.re + p.im * p.im, dim=(-2, -1))


def _norm(p: Pair):
    return torch.sqrt(_fro2(p))


def _gemm(x: Pair, mat: Pair) -> Pair:
    """(G, P, r, k) @ (G, k, l) -> (G, P, r, l), folding (P, r) into the
    rows of one batched Karatsuba product per group."""
    g, p, r, k = x.re.shape
    out = matmul(Pair(x.re.reshape(g, p * r, k), x.im.reshape(g, p * r, k)),
                 mat)
    return Pair(out.re.view(g, p, r, -1), out.im.view(g, p, r, -1))


def _lanes(p: Pair) -> Pair:
    """(G, P, ...) -> (G*P, ...) view."""
    return Pair(p.re.flatten(0, 1), p.im.flatten(0, 1))


def _groups(p: Pair, g: int) -> Pair:
    """(G*P, ...) -> (G, P, ...) view."""
    return Pair(p.re.unflatten(0, (g, -1)), p.im.unflatten(0, (g, -1)))


def _where(mask, new, old):
    """Per-lane select; ``mask`` is (G, P), values (G, P, ...)."""
    if isinstance(new, Pair):
        return Pair(_where(mask, new.re, old.re), _where(mask, new.im, old.im))
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 2)),
                       new, old)


# ---------------------------------------------------------------------------
# setup (plain torch: Cholesky, QR, eigh)

def precompute_u_pair(a: Pair, reg: float = 1.0) -> Pair:
    """U = inv(A^H A + reg I) of each (..., m, n) codebook block, by
    complex Cholesky and a triangular solve.  ref: inferLowRankV4_multi.m:241-247.
    """
    ac = to_complex(a)
    n = ac.shape[-1]
    g = ac.mH @ ac
    eye = torch.eye(n, dtype=ac.dtype, device=ac.device)
    g = 0.5 * (g + g.mH) + reg * eye
    c = torch.linalg.cholesky(g)
    w = torch.linalg.solve_triangular(c, eye.expand_as(c), upper=False)
    return from_complex(w.mH @ w)


def spectral_initialize_pair(a: Pair, b, r: int,
                             generator: Optional[torch.Generator] = None,
                             iters: int = 12) -> Pair:
    """Spectral init of every lane: X0^T, (G, P, r, n).

    ``a``: (G, m, n) codebook blocks; ``b``: (G, P, m).  Rows of A are
    scaled by b_i/||A_i||; the top-r eigenpairs of the scaled Gram come
    from ``iters`` steps of complex orthogonal iteration (QR) and a
    Rayleigh-Ritz ``eigh``, and are scaled by sqrt(eigenvalue).
    ref: inferLowRankV4_multi.m:561-574.  The start block is drawn from
    ``generator`` on the CPU, so a seed gives the same init on any device.
    """
    ac = to_complex(a)
    g_, m, n = ac.shape
    p_ = b.shape[1]
    r = min(r, m, n)
    row_norm = torch.sqrt(torch.clamp(torch.sum(ac.real ** 2 + ac.imag ** 2,
                                                dim=-1), min=1e-30))
    s = torch.where(row_norm[:, None, :] > 1e-15,
                    b / row_norm[:, None, :], 1.0)             # (G, P, m)
    gram = (ac.mH[:, None] * (s * s)[..., None, :]) @ ac[:, None]
    gram = 0.5 * (gram + gram.mH)                              # (G, P, n, n)
    q = torch.randn((g_, p_, n, r), dtype=torch.complex64,
                    generator=generator).to(ac.device)
    q = torch.linalg.qr(q).Q
    for _ in range(iters):
        q = torch.linalg.qr(gram @ q).Q
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
    xc = to_complex(x)
    g = xc.conj() @ xc.transpose(-1, -2)                       # X^H X
    _, v = torch.linalg.eigh(0.5 * (g + g.mH))
    return from_complex(v.flip(-1).transpose(-1, -2) @ xc)


def _quality_pair(a_te: Pair, b_te, x: Pair):
    """1 - ||(|A_te x|) - b_te|| / ||b_te|| of single-column x (G, P, 1, n)
    against (G, m_te, n) blocks and b_te (G, P, m_te).  ref :68."""
    ax = _gemm(x, transpose(a_te))
    amp = torch.sqrt(torch.clamp(ax.re ** 2 + ax.im ** 2, min=0.0))[..., 0, :]
    return 1.0 - (torch.linalg.vector_norm(amp - b_te, dim=-1)
                  / torch.clamp(torch.linalg.vector_norm(b_te, dim=-1),
                                min=1e-30))


# ---------------------------------------------------------------------------
# the inner solve

class _State(NamedTuple):
    y: Pair
    z: Pair
    m_dual: Pair
    n_dual: Pair
    aty: Pair
    v_basis: Pair
    mu: torch.Tensor
    last_res: torch.Tensor
    opt_obj: torch.Tensor
    opt_x: Pair
    opt_y: Pair
    it: torch.Tensor
    converged: torch.Tensor


def infer_admm_pair(a: Pair, b, x0: Pair, *, scale_by_row: bool,
                    nt: int, nr: int, ladder: LadderArrays, u_mat: Pair,
                    mu0: float = 1e-3, rho: float = 1.03,
                    tol_rel: float = 1e-4, tol_abs: float = 1e-8,
                    maxiter: int = 500, warm_iters: int = 0):
    """One InferADMM solve of every lane (ref: inferLowRankV4_multi.m:281-386).

    ``a``: (G, m, n) codebook blocks; ``b``: (G, P, m); ``x0``:
    (G, P, r, n); ``u_mat``: (G, n, n) = inv(A^H A + I) per block;
    ``ladder``: ranks/fracs broadcastable to (G, P, L).

    X-update against U, magnitude prox (kernel K1), warm spectral-profile
    Z-prox (kernel K2), dual updates, best-so-far tracking, the three
    residual tests and mu adaptation.  With ``warm_iters > 0`` the first
    ``min(warm_iters, maxiter)`` trips run with TF32 GEMMs, then
    ``converged`` (which also marks a lane done) and the best-so-far
    objective are reset for every lane and the float32 tail continues
    from the carried state.

    Returns ``(opt_x, opt_y, converged, it)``: opt_x (G, P, r, n) with
    ``scale_by_row``, else the best column (G, P, 1, n); ``it`` (G, P)
    counts each lane's own trips.
    """
    g_, p_, r, n = x0.re.shape
    m = a.re.shape[-2]
    lanes = g_ * p_
    levels = ladder.ranks.shape[-1]
    lad = LadderArrays(
        ladder.ranks.expand(g_, p_, levels).reshape(lanes, levels).contiguous(),
        ladder.fracs.expand(g_, p_, levels).reshape(lanes, levels).contiguous())
    a_t = transpose(a)                                          # (G, n, m)
    a_conj = conj(a)                                            # (G, m, n)
    u_conj = conj(u_mat)                                        # U^T
    b_lanes = b.reshape(lanes, m)

    def a_mul(x):
        return _gemm(x, a_t)

    def ah_mul(y):
        return _gemm(y, a_conj)

    # --- initialization (ref :300-321)
    x = x0
    ax = a_mul(x)
    bn = torch.linalg.vector_norm(b, dim=-1)                    # (G, P)
    if scale_by_row:
        x = scale(x, (bn / torch.clamp(_norm(ax), min=1e-30))[..., None, None])
    else:
        col = torch.sqrt(torch.clamp(torch.sum(ax.re ** 2 + ax.im ** 2,
                                               dim=-1), min=1e-30))
        x = scale(x, (bn[..., None] / col)[..., None])
    ax = a_mul(x)
    y = project_cols_to_magnitude(ax, b, scale_by_row)
    aty = ah_mul(y)
    # cold eigenbasis of the initial Gram, by eigh, once per solve
    z, v_basis = (_groups(p, g_)
                  for p in zprox_t_plain(_lanes(x), None, nt, nr, lad))

    dev, f32 = x0.re.device, torch.float32

    def zeros(*shape):
        return Pair(torch.zeros(shape, dtype=f32, device=dev),
                    torch.zeros(shape, dtype=f32, device=dev))

    def full(val, dtype=f32):
        return torch.full((g_, p_), val, dtype=dtype, device=dev)

    k_opt = r if scale_by_row else 1
    state = _State(
        y=y, z=z, m_dual=zeros(g_, p_, r, m), n_dual=zeros(g_, p_, r, n),
        aty=aty, v_basis=v_basis, mu=full(mu0), last_res=full(math.inf),
        opt_obj=full(math.inf), opt_x=zeros(g_, p_, k_opt, n),
        opt_y=zeros(g_, p_, k_opt, m), it=full(0, torch.int32),
        converged=full(False, torch.bool))

    def body(c: _State) -> _State:
        mu = c.mu
        mu4 = mu[..., None, None]
        inv4 = 1.0 / mu4
        # X-update (ref :401-409)
        t = Pair(c.y.re - c.m_dual.re * inv4, c.y.im - c.m_dual.im * inv4)
        rhs = add(ah_mul(t), Pair(c.z.re - c.n_dual.re * inv4,
                                  c.z.im - c.n_dual.im * inv4))
        x = _gemm(rhs, u_conj)
        ax = a_mul(x)
        # Y-update fused with the M-dual update (ref :511-533, :336-337)
        y, m_dual = fused_prox_dual_t(_lanes(ax), b_lanes, _lanes(c.m_dual),
                                      mu.reshape(lanes),
                                      per_entry=not scale_by_row)
        y, m_dual = _groups(y, g_), _groups(m_dual, g_)
        aty = ah_mul(y)
        # Z-update (ref :423-485)
        z_in = Pair(x.re + c.n_dual.re * inv4, x.im + c.n_dual.im * inv4)
        z, v_basis = fused_zprox_t(_lanes(z_in), _lanes(c.v_basis), nt, nr,
                                   lad)
        z, v_basis = _groups(z, g_), _groups(v_basis, g_)
        # N-dual update (ref :336-341)
        j_m = sub(ax, y)
        j_n = sub(x, z)
        n_dual = Pair(c.n_dual.re + mu4 * j_n.re, c.n_dual.im + mu4 * j_n.im)

        # best-so-far (ref :343-361)
        if scale_by_row:
            amp = torch.sqrt(torch.clamp(
                torch.sum(ax.re ** 2 + ax.im ** 2, dim=-2), min=0.0))
            obj = torch.linalg.vector_norm(amp - b, dim=-1)     # (G, P)
            x_best, y_best = x, y
        else:
            amp = torch.sqrt(torch.clamp(ax.re ** 2 + ax.im ** 2, min=0.0))
            objs = torch.linalg.vector_norm(amp - b[..., None, :], dim=-1)
            j = torch.argmin(objs, dim=-1, keepdim=True)      # first on ties
            obj = torch.gather(objs, -1, j)[..., 0]

            def pick(p: Pair) -> Pair:
                idx = j[..., None].expand(g_, p_, 1, p.re.shape[-1])
                return Pair(torch.gather(p.re, 2, idx),
                            torch.gather(p.im, 2, idx))

            x_best, y_best = pick(x), pick(y)
        better = obj < c.opt_obj
        opt_x = _where(better, x_best, c.opt_x)
        opt_y = _where(better, y_best, c.opt_y)
        opt_obj = torch.minimum(obj, c.opt_obj)

        # convergence tests (ref :363-375)
        nax, ny, naty = _norm(ax), _norm(y), _norm(aty)
        nx, nz = _norm(x), _norm(z)
        res_prim = torch.sqrt(_fro2(j_m) + _fro2(j_n))
        dz2 = _fro2(sub(z, c.z))
        res_dual = mu * torch.sqrt(_fro2(sub(aty, c.aty)) + dz2)
        res_comb = torch.sqrt(res_prim ** 2 + _fro2(sub(y, c.y)) + dz2)
        big = torch.maximum(nax, ny) ** 2 + torch.maximum(nx, nz) ** 2
        t_prim = tol_abs * math.sqrt((m + n) * r) + tol_rel * torch.sqrt(big)
        t_dual = (tol_abs * math.sqrt(n * r * 2)
                  + tol_rel * torch.sqrt(naty ** 2 + nz ** 2))
        t_comb = (tol_abs * math.sqrt((m + n) * r * 2)
                  + tol_rel * torch.sqrt(big + ny ** 2 + nz ** 2))
        converged = (((res_prim < t_prim) & (res_dual < t_dual))
                     | (res_comb < t_comb))
        mu = torch.where(res_comb > c.last_res * 0.9, mu * rho, mu)
        return _State(y=y, z=z, m_dual=m_dual, n_dual=n_dual, aty=aty,
                      v_basis=v_basis, mu=mu, last_res=res_comb,
                      opt_obj=opt_obj, opt_x=opt_x, opt_y=opt_y,
                      it=c.it + 1, converged=converged)

    def run(c: _State, bound: int) -> _State:
        for trip in range(bound):
            active = (c.it < bound) & ~c.converged
            if trip % CHECK_EVERY == 0 and not bool(active.any()):
                break
            new = body(c)
            c = _State(*(_where(active, nv, ov) for nv, ov in zip(new, c)))
        return c

    if warm_iters > 0:
        with _tf32(True):
            state = run(state, min(warm_iters, maxiter))
        # coarse residuals must not certify convergence, and the coarse
        # best-so-far objective must not block the float32 tail's better
        # states: reset both at the phase switch (ref :571-578)
        state = state._replace(converged=torch.zeros_like(state.converged),
                               opt_obj=torch.full_like(state.opt_obj,
                                                       math.inf))
    state = run(state, maxiter)
    return state.opt_x, state.opt_y, state.converged, state.it


# ---------------------------------------------------------------------------
# the scaffold

def _pass_bounds(cfg: AdmmConfig):
    """Trip bounds of the two passes (ref :649-658).  A capped pass at or
    below ``warm_iters`` would run only coarse trips and return a coarse
    iterate, so it is refused."""
    b1 = min(cfg.stage1_maxiter, cfg.maxiter) \
        if cfg.stage1_maxiter is not None else cfg.maxiter
    b2 = min(cfg.stage2_maxiter, cfg.maxiter) \
        if cfg.stage2_maxiter is not None else cfg.maxiter
    if cfg.warm_iters > 0 and min(b1, b2) <= cfg.warm_iters:
        raise ValueError(
            f"pass caps ({b1}, {b2}) must exceed warm_iters="
            f"{cfg.warm_iters}: a pass that ends inside the TF32 warm phase "
            "returns a coarse iterate")
    return b1, b2


def _impl_pair(a: Pair, b, xs: Pair, nt: int, nr: int, cfg: AdmmConfig,
               ladder: LadderArrays, u_mat: Pair):
    """inferLowRankImpl of every lane (ref :111-271): the scale_by_row
    pass, column orthonormalization, then the per-column pass.
    Returns ``(x (G, P, 1, n), converged, it (G, P, 2))``."""
    b1, b2 = _pass_bounds(cfg)
    kw = dict(nt=nt, nr=nr, ladder=ladder, u_mat=u_mat, mu0=cfg.mu0,
              rho=cfg.rho, tol_rel=cfg.tol_rel, tol_abs=cfg.tol_abs,
              warm_iters=cfg.warm_iters)
    x, _, _, it1 = infer_admm_pair(a, b, xs, scale_by_row=True, maxiter=b1,
                                   **kw)
    x = _orthonormalize_cols_t(x)
    x, _, converged, it2 = infer_admm_pair(a, b, x, scale_by_row=False,
                                           maxiter=b2, **kw)
    return x, converged, torch.stack([it1, it2], dim=-1)


def _rows(a: Pair, idx) -> Pair:
    return Pair(a.re[idx], a.im[idx])


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


def _batch_first_pass(a: Pair, b_batch, trains, tests, ladder: LadderArrays,
                      nt: int, nr: int, cfg: AdmmConfig, m_eff: int,
                      generator: Optional[torch.Generator],
                      xs: Optional[Pair] = None) -> _FirstPass:
    """Stage 1: normalize, then every (restart, instance) first-pass solve
    (ref: inferLowRankV4_multi.m:27-68).  Lanes are restart-major: group
    R shares its train split's codebook rows and U = inv(A^H A + I).

    ``xs``: optional spectral init (R, B, r, n), which lets a test run the
    port on exactly the JAX package's inputs.
    """
    n = a.re.shape[-1]
    r = min(cfg.rank, trains.shape[1], n)
    a_norm = _norm(a) / math.sqrt(m_eff)
    a_norm = torch.where(a_norm < cfg.tol_abs, 1.0, a_norm)
    a_n = scale(a, 1.0 / a_norm)
    b_norm = torch.linalg.vector_norm(b_batch, dim=-1)
    b_norm = torch.where(b_norm < cfg.tol_abs, 1.0, b_norm)
    b_n = b_batch / b_norm[:, None]

    a_tr, a_te = _rows(a_n, trains), _rows(a_n, tests)          # (R, k, n)
    b_tr = b_n[:, trains].transpose(0, 1)                       # (R, B, k)
    b_te = b_n[:, tests].transpose(0, 1)
    u_tr = precompute_u_pair(a_tr)
    if xs is None:
        xs = spectral_initialize_pair(a_tr, b_tr, r, generator)
    x, _, it = _impl_pair(a_tr, b_tr, xs, nt, nr, cfg, ladder, u_tr)
    q = _quality_pair(a_te, b_te, x)
    return _FirstPass(x, q, it, xs, u_tr, a_n, b_n, a_norm, b_norm)


def _batch_retry(fp: _FirstPass, rest_idx, inst_idx, trains, tests,
                 ladder_r1: LadderArrays, nt: int, nr: int, cfg: AdmmConfig):
    """Stage 2: rank-1 retry of exactly the K gathered poor
    (restart, instance) pairs (ref: inferLowRankV4_multi.m:73-77).  Each
    pair is its own group (its restart's train rows and U).
    Returns ``(x (K, n), q (K,), it (K,))``."""
    tr, te = trains[rest_idx], tests[rest_idx]                  # (K, k)
    a_tr, a_te = _rows(fp.a_n, tr), _rows(fp.a_n, te)
    b_sel = fp.b_n[inst_idx]
    b_tr = torch.gather(b_sel, 1, tr)[:, None]                  # (K, 1, k)
    b_te = torch.gather(b_sel, 1, te)[:, None]
    xs = Pair(fp.xs.re[rest_idx, inst_idx][:, None],
              fp.xs.im[rest_idx, inst_idx][:, None])
    u = _rows(fp.u_tr, rest_idx)
    x, _, it = _impl_pair(a_tr, b_tr, xs, nt, nr, cfg, ladder_r1, u)
    q = _quality_pair(a_te, b_te, x)
    return Pair(x.re[:, 0, 0], x.im[:, 0, 0]), q[:, 0], it.sum(-1)[:, 0]


def _batch_refine(fp: _FirstPass, x: Pair, q, it_sum, rank_one,
                  lad_normal: LadderArrays, lad_r1: LadderArrays,
                  nt: int, nr: int, cfg: AdmmConfig) -> PairAdmmResult:
    """Stage 3: best restart per instance (first max on ties), full-data
    refinement with similarity rollback, rescale
    (ref: inferLowRankV4_multi.m:79-107).  ``x`` (R, B, n), ``q`` and
    ``rank_one`` (R, B).  The rank-one flag of the selected restart picks
    that instance's ladder."""
    batch = q.shape[1]
    ar = torch.arange(batch, device=q.device)
    j = torch.argmax(q, dim=0)                                  # (B,)
    q_max = q[j, ar]
    r1 = rank_one[j, ar][:, None]
    lad = LadderArrays(torch.where(r1, lad_r1.ranks, lad_normal.ranks)[None],
                       torch.where(r1, lad_r1.fracs, lad_normal.fracs)[None])
    a_full = Pair(fp.a_n.re[None], fp.a_n.im[None])             # (1, m, n)
    x_max = Pair(x.re[j, ar][None, :, None],
                 x.im[j, ar][None, :, None])                    # (1, B, 1, n)
    x_ref, _, _, it_ref = infer_admm_pair(
        a_full, fp.b_n[None], x_max, scale_by_row=True, nt=nt, nr=nr,
        ladder=lad, u_mat=precompute_u_pair(a_full), mu0=cfg.mu0,
        rho=cfg.rho, tol_rel=cfg.tol_rel, tol_abs=cfg.tol_abs,
        maxiter=cfg.maxiter)
    # similarity |<x_max, x_ref>| / (||x_max|| ||x_ref||)  (ref :93-98)
    dims = (-2, -1)
    dot_re = torch.sum(x_max.re * x_ref.re + x_max.im * x_ref.im, dim=dims)
    dot_im = torch.sum(x_max.re * x_ref.im - x_max.im * x_ref.re, dim=dims)
    similarity = (torch.sqrt(dot_re ** 2 + dot_im ** 2)
                  / torch.clamp(_norm(x_max) * _norm(x_ref), min=1e-30))
    rollback = ((q_max[None] > cfg.quality_threshold)
                & (similarity < cfg.similarity_threshold))      # (1, B)
    xo = _where(rollback, x_max, x_ref)
    s = (fp.b_norm / fp.a_norm)[:, None]
    return PairAdmmResult(
        x=scale(Pair(xo.re[0, :, 0], xo.im[0, :, 0]), s), quality=q_max,
        converged=torch.ones(batch, dtype=torch.bool, device=q.device),
        iters=it_sum + it_ref[0])


def _random_splits(m: int, frac: float, n_restarts: int,
                   generator: Optional[torch.Generator]):
    """Per-restart (train, test) row permutations, floor(m * frac) train
    rows, drawn on the CPU from ``generator``."""
    k = int(math.floor(m * frac))
    perms = [torch.randperm(m, generator=generator)
             for _ in range(n_restarts)]
    return (torch.stack([p[:k] for p in perms]),
            torch.stack([p[k:] for p in perms]))


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
    the rank-1 retry of exactly the poor pairs, and the refine.  Runs with
    ``torch.backends.cuda.matmul.allow_tf32`` False (JAX's "float32")
    except the ``cfg.warm_iters`` trips of each first-pass solve.

    ``generator`` draws the train/test splits and the spectral-init start
    blocks (on the CPU).  Test-only: ``splits`` = (trains (R, k), tests
    (R, m - k)) row indices and ``xs`` = the spectral init (B, R, r, n),
    in the JAX package's layout, replace those draws.

    Returns a PairAdmmResult with a leading batch axis.
    """
    if prox_kind != "spectral_profile" or eig_mode != "perturb":
        raise NotImplementedError(
            "the port's batch solver runs prox_kind='spectral_profile' with "
            "eig_mode='perturb' only")
    n_restarts = cfg.n_restarts if n_restarts is None else n_restarts
    batch = b_batch.shape[0]
    m, n = a.re.shape
    dev = a.re.device
    pl = cfg.profile

    # active-row accounting: b == 0 rows are inactive padding by contract;
    # one shared codebook admits only one active count
    counts = torch.sum(b_batch > 0, dim=1).cpu().numpy()
    m_act = int(counts[0]) if batch else m
    if batch and not (counts == m_act).all():
        raise ValueError(
            "solve_lowrank_multi_pair_batch shares one codebook across the "
            "batch, so every instance must have the same active (b > 0) row "
            f"count; got {sorted(set(counts.tolist()))}.  b == 0 marks an "
            "INACTIVE padding row by contract (real measured amplitudes "
            "are strictly positive, A2only.m:130-139) -- if these zeros are "
            "genuine measurements, clamp them to a tiny positive floor; "
            "otherwise pad uniformly.")
    m_act = max(m_act, 1)

    if splits is None:
        trains, tests = _random_splits(m, cfg.cc_frac, n_restarts, generator)
    else:
        trains, tests = (torch.tensor(np.asarray(s), dtype=torch.int64)
                         for s in splits)
    trains, tests = trains.to(dev), tests.to(dev)
    if xs is not None:
        xs = Pair(xs.re.transpose(0, 1).contiguous(),
                  xs.im.transpose(0, 1).contiguous())
    lm_tr = int(math.floor(m_act * cfg.cc_frac))

    def ladder(mm, rank_one):
        return profile_ladder_arrays(nt, nr, mm, n, rank_one, pl.rank_mults,
                                     pl.fractions, mode=pl.ladder,
                                     device=dev)

    with _tf32(False):
        fp = _batch_first_pass(a, b_batch, trains, tests,
                               ladder(lm_tr, False), nt, nr, cfg, m_act,
                               generator, xs)
        x = Pair(fp.x.re[:, :, 0].clone(), fp.x.im[:, :, 0].clone())
        q, it = fp.q, fp.it.sum(-1)                             # (R, B)
        rank_one = torch.zeros_like(q, dtype=torch.bool)
        poor = (q < cfg.quality_threshold).cpu()                # host gate
        if bool(poor.any()):
            rest_idx, inst_idx = (i.to(dev) for i in torch.nonzero(
                poor, as_tuple=True))
            xr, qr, itr = _batch_retry(fp, rest_idx, inst_idx, trains, tests,
                                       ladder(lm_tr, True), nt, nr, cfg)
            x.re[rest_idx, inst_idx] = xr.re
            x.im[rest_idx, inst_idx] = xr.im
            q = q.index_put((rest_idx, inst_idx), qr)
            it = it.index_put((rest_idx, inst_idx), itr, accumulate=True)
            rank_one[rest_idx, inst_idx] = True
        return _batch_refine(fp, x, q, it.sum(0), rank_one,
                             ladder(m_act, False), ladder(m_act, True),
                             nt, nr, cfg)


def solve_lowrank_multi_pair(*args, **kwargs):
    """The single-solve scaffold is not ported yet."""
    raise NotImplementedError(
        "solve_lowrank_multi_pair is not ported yet; use "
        "solve_lowrank_multi_pair_batch with a batch of one")


def refine_lowrank_pair(*args, **kwargs):
    """The warm-started refine (and its proximal anchor) is not ported
    yet."""
    raise NotImplementedError("refine_lowrank_pair is not ported yet")
