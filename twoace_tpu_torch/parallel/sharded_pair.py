"""Row- and batch-sharded A2 in pair representation (port of
``twoace_tpu.parallel.sharded_pair``).

Each rank of a (batch x rows) mesh (:mod:`.mesh`) holds its contiguous
block of the global problem (:func:`.mesh.problem_sharding`): B/batch
instances, m/rows measurement rows of each.  X, Z, the N-dual, U, the
Z-prox basis and mu are replicated over a rows group; Y and the M-dual
keep their rows.  Collectives (all over the rows group):

- setup: the normalization sums, the Gram of U = inv(A^H A + I) and the
  spectral init's scaled Gram, one all-reduce each;
- each ADMM trip: two all-reduces (``ops/admm_loop.py``): the X-update's
  partial A^H (...), and one flat buffer of the partial A^H Y with every
  sum of squares over the rows; the any-active flag every
  ``CHECK_EVERY`` trips (MAX);
- the held-out quality, and the retry gate (MAX).

K3 cannot hold a per-trip collective, so every sharded solve runs the
per-op loop: K4 for the three products, K1 for the Y-update and M-dual,
K2 for the warm Z-prox (replicated on every rank of a rows group).  U
comes from a complex Cholesky and the spectral init from complex
orthogonal iteration and ``eigh`` (the JAX package's real embeddings and
Jacobi solver were TPU workarounds).

Random draws (the train/test splits, the spectral-init start blocks) are
made on the CPU from one ``torch.Generator`` for the global batch on
every rank, and each rank keeps its instances' draws, so a seed gives
the same solve on any mesh.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import AdmmConfig
from ..ops.admm_loop import fro2, gemm
from ..ops.cplx import Pair, scale, transpose
from ..ops.pair_solver import (PairAdmmResult, _check_modes, _impl_pair,
                               _ladders, _orthonormalize_cols_t,
                               _refine_best, infer_admm_pair, no_tf32,
                               precompute_u_pair, scaled_gram_pair,
                               top_r_init)
from .mesh import Mesh, RowReduce


def _check(mesh: Mesh, a: Pair, b):
    if not mesh.member:
        raise ValueError("this rank lies outside the mesh")
    if a.re.device != mesh.device or b.device != mesh.device:
        raise ValueError(f"the problem lies on {a.re.device}, the mesh's "
                         f"device is {mesh.device}")
    b_loc, m_loc, n = a.re.shape
    return b_loc, m_loc, n, m_loc * mesh.rows


def _normalize(a: Pair, b, m: int, tol_abs: float, red: RowReduce):
    """Scale each instance's A to ||A||_F = sqrt(m) and b to unit norm
    over the global rows (ref: inferLowRankV4_multi.m:27-38).  Returns
    ``(a_n, b_n, a_norm, b_norm)``, norms (B_loc,)."""
    s2 = red.sum_(torch.stack([fro2(a), torch.sum(b * b, dim=-1)], dim=-1))
    a_norm = torch.sqrt(s2[:, 0] / m)
    a_norm = torch.where(a_norm < tol_abs, 1.0, a_norm)
    b_norm = torch.sqrt(s2[:, 1])
    b_norm = torch.where(b_norm < tol_abs, 1.0, b_norm)
    return (scale(a, 1.0 / a_norm[:, None, None]), b / b_norm[:, None],
            a_norm, b_norm)


def _spectral_init(a: Pair, b, q, red: RowReduce) -> Pair:
    """Spectral init X0^T (G, P, r, n) of row-sharded blocks: the scaled
    Gram all-reduced, then the replicated orthogonal iteration from the
    start block ``q`` (G, P, n, r)."""
    return top_r_init(red.sum_(scaled_gram_pair(a, b)), q)


def _quality(a_te: Pair, b_te, x: Pair, red: RowReduce):
    """1 - ||(|A_te x|) - b_te|| / ||b_te|| over the masked test rows
    (b_te > 0) of every shard (ref :68): (G, P)."""
    ax = gemm(x, transpose(a_te))
    amp = torch.sqrt(torch.clamp(ax.re ** 2 + ax.im ** 2, min=0.0))[..., 0, :]
    s2 = red.sum_(torch.stack([
        torch.sum((amp - b_te) ** 2 * (b_te > 0), dim=-1),
        torch.sum(b_te * b_te, dim=-1)], dim=-1))
    return 1.0 - (torch.sqrt(s2[..., 0])
                  / torch.clamp(torch.sqrt(s2[..., 1]), min=1e-30))


def _global_draws(generator, batch: int, n_restarts: int, m: int, k: int,
                  n: int, r: int):
    """The global batch's splits and start blocks, on the CPU: per
    (instance, restart) a permutation of the m rows, its first k the
    train rows, then the start blocks (B, R, n, r) complex64."""
    trains = torch.stack([torch.stack([
        torch.randperm(m, generator=generator)[:k]
        for _ in range(n_restarts)]) for _ in range(batch)])
    q = torch.randn((batch, n_restarts, n, r), dtype=torch.complex64,
                    generator=generator)
    return trains, q


def _train_masks(trains, m: int, rows: slice):
    """0/1 float32 masks (B_loc, R, m_loc) of this shard's train rows."""
    mask = torch.zeros(trains.shape[:-1] + (m,), dtype=torch.float32)
    mask.scatter_(-1, trains, 1.0)
    return mask[..., rows]


def _rows_pair(p: Pair, idx) -> Pair:
    return Pair(p.re[idx], p.im[idx])


def solve_lowrank_multi_sharded_pair(mesh: Mesh,
                                     generator: Optional[torch.Generator],
                                     a: Pair, b, nt: int, nr: int,
                                     cfg: AdmmConfig = AdmmConfig(),
                                     prox_kind: str = "spectral_profile",
                                     *, splits=None,
                                     xs: Optional[Pair] = None
                                     ) -> PairAdmmResult:
    """Batch of production-scaffold recoveries over a (batch x rows) mesh:
    the row-sharded twin of :func:`..ops.pair_solver.solve_lowrank_multi_pair`
    (ref: inferLowRankV4_multi.m:5-109).

    ``a``: this rank's (B/batch, m/rows, n) pair; ``b``: (B/batch,
    m/rows) float32, both on ``mesh.device`` (:func:`.mesh.problem_sharding`
    cuts them).  Normalize over the global rows; run every (instance,
    restart) side by side as G = B_loc x R groups, each with its own train
    split as a 0/1 row mask (masked rows have A_i = 0 and b_i = 0 and add
    nothing to a sum, so each shard keeps its rows) and its own U: the
    spectral init, the two passes (the first ``cfg.warm_iters`` trips of
    each with the warm-phase reset; the batch solver's pass caps), the
    held-out quality; re-solve the poor groups with the rank-1 ladder (a
    host gate on all-reduced values that gathers them, as the batch
    solver does); keep each instance's best restart (first on ties);
    refine it on all its rows with the ladder its rank-one flag picks,
    ``cfg.maxiter`` trips and no warm phase; roll back if the refine
    wandered off; rescale.  The nuclear prox has no retry.

    ``generator`` draws the global batch's splits and start blocks on the
    CPU (pass one seeded alike on every rank).  Test-only: ``splits`` =
    (trains (B, R, k), tests) global row indices, tests unused (the test
    rows are the rest), and ``xs`` = the spectral init (B, R, r, n), in
    the JAX package's layout, replace those draws.

    Contract (as in JAX): the problems are unpadded, every row active.
    Returns a PairAdmmResult over this rank's instances: x (B_loc, n),
    replicated over the rows group; ``iters`` the trips each instance's
    lanes ran, summed over every solve whose result was used.
    """
    _check_modes(prox_kind, "perturb")
    b_loc, m_loc, n, m = _check(mesh, a, b)
    red = mesh.reduce
    dev = mesh.device
    n_restarts = cfg.n_restarts
    r = min(cfg.rank, m, n)
    lm_tr = int(math.floor(m * cfg.cc_frac))
    if generator is None:
        raise ValueError("pass a torch.Generator, seeded alike on every "
                         "rank: its draws must agree over the mesh")
    ladder = _ladders(nt, nr, n, cfg, prox_kind, dev)
    b0 = mesh.coords[0] * b_loc
    inst = slice(b0, b0 + b_loc)
    rows = slice(mesh.coords[1] * m_loc, (mesh.coords[1] + 1) * m_loc)
    g_ = b_loc * n_restarts

    trains, q = _global_draws(generator, b_loc * mesh.batch, n_restarts, m,
                              lm_tr, n, r)
    if splits is not None:
        trains = torch.as_tensor(splits[0], dtype=torch.int64)
    tr = _train_masks(trains[inst], m, rows).to(dev)      # (B_loc, R, m_loc)

    with no_tf32():
        a_n, b_n, a_norm, b_norm = _normalize(a, b, m, cfg.tol_abs, red)

        def masked(mask):
            w = mask[..., None]
            return (Pair((a_n.re[:, None] * w).reshape(g_, m_loc, n),
                         (a_n.im[:, None] * w).reshape(g_, m_loc, n)),
                    (b_n[:, None] * mask).reshape(g_, 1, m_loc))

        a_tr, b_tr = masked(tr)
        a_te, b_te = masked(1.0 - tr)
        u_tr = precompute_u_pair(a_tr, reduce=red)
        if xs is None:
            x0 = _spectral_init(a_tr, b_tr, q[inst].reshape(g_, 1, n, r), red)
        else:
            x0 = Pair(*(torch.as_tensor(t, dtype=torch.float32)[inst]
                        .reshape(g_, 1, r, n).to(dev) for t in xs))
        kw = dict(prox_kind=prox_kind, reduce=red, m_eff=lm_tr)
        x, _, it = _impl_pair(a_tr, b_tr, x0, nt, nr, cfg,
                              ladder(lm_tr, False), u_tr, **kw)
        q_g = _quality(a_te, b_te, x, red)[:, 0]                # (G,)
        x = Pair(x.re[:, 0, 0].clone(), x.im[:, 0, 0].clone())  # (G, n)
        it = it.sum(-1)[:, 0]
        rank_one = torch.zeros(g_, dtype=torch.bool, device=dev)
        if prox_kind != "nuclear":
            # the host gate, on a mask all-reduced with MAX: every rank of
            # the rows group re-solves the same groups
            poor = red.max_((q_g < cfg.quality_threshold).to(torch.int32))
            idx = torch.nonzero(poor.cpu()).flatten().to(dev)
            if idx.numel():
                xr, _, itr = _impl_pair(
                    _rows_pair(a_tr, idx), b_tr[idx], _rows_pair(x0, idx),
                    nt, nr, cfg, ladder(lm_tr, True), _rows_pair(u_tr, idx),
                    **kw)
                q_g[idx] = _quality(_rows_pair(a_te, idx), b_te[idx], xr,
                                    red)[:, 0]
                x.re[idx] = xr.re[:, 0, 0]
                x.im[idx] = xr.im[:, 0, 0]
                it[idx] += itr.sum(-1)[:, 0]
                rank_one[idx] = True

        xo, q_max, it_ref = _refine_best(
            a_n, b_n[:, None], Pair(x.re.view(b_loc, n_restarts, n),
                                    x.im.view(b_loc, n_restarts, n)),
            q_g.view(b_loc, n_restarts), rank_one.view(b_loc, n_restarts),
            ladder(m, False), ladder(m, True), nt, nr, cfg, prox_kind,
            shared=False, reduce=red, m_eff=m)
    return PairAdmmResult(
        x=scale(xo, (b_norm / a_norm)[:, None]), quality=q_max,
        converged=torch.ones(b_loc, dtype=torch.bool, device=dev),
        iters=it.view(b_loc, n_restarts).sum(1) + it_ref)


def solve_lowrank_sharded_pair(mesh: Mesh, a: Pair, b, nt: int, nr: int,
                               cfg: AdmmConfig = AdmmConfig(),
                               prox_kind: str = "spectral_profile") -> Pair:
    """Batch of pair-form recoveries over a (batch x rows) mesh: the
    reduced scaffold (no restarts, quality gate, retry or rollback; ref
    :111-271 and the full-data polish of :89-101), as the JAX package's
    ``solve_lowrank_sharded_pair``: spectral init (every instance from the
    same start block, seed 29, as JAX's fixed key), the scale_by_row pass,
    column orthonormalization, the per-column pass, then one scale_by_row
    polish; each pass ``cfg.maxiter`` trips at most, no warm phase.

    ``a``: this rank's (B/batch, m/rows, n) pair, ``b`` (B/batch, m/rows),
    on ``mesh.device``.  Returns x (B_loc, n), replicated over the rows
    group.
    """
    _check_modes(prox_kind, "perturb")
    b_loc, m_loc, n, m = _check(mesh, a, b)
    red = mesh.reduce
    dev = mesh.device
    r = min(cfg.rank, m, n)
    lad = _ladders(nt, nr, n, cfg, prox_kind, dev)(m, False)
    q = torch.randn((1, 1, n, r), dtype=torch.complex64,
                    generator=torch.Generator().manual_seed(29))
    kw = dict(nt=nt, nr=nr, ladder=lad, prox_kind=prox_kind, mu0=cfg.mu0,
              rho=cfg.rho, tol_rel=cfg.tol_rel, tol_abs=cfg.tol_abs,
              maxiter=cfg.maxiter, reduce=red, m_eff=m)
    with no_tf32():
        a_n, b_n, a_norm, b_norm = _normalize(a, b, m, cfg.tol_abs, red)
        b_n = b_n[:, None]
        kw["u_mat"] = precompute_u_pair(a_n, reduce=red)
        x = _spectral_init(a_n, b_n, q.expand(b_loc, 1, n, r), red)
        x = infer_admm_pair(a_n, b_n, x, scale_by_row=True, **kw)[0]
        x = _orthonormalize_cols_t(x)
        x = infer_admm_pair(a_n, b_n, x, scale_by_row=False, **kw)[0]
        x = infer_admm_pair(a_n, b_n, x, scale_by_row=True, **kw)[0]
    return scale(Pair(x.re[:, 0, 0], x.im[:, 0, 0]),
                 (b_norm / a_norm)[:, None])
