"""The InferADMM loop of every lane, after its initialization.

One body serves two callers (ref: inferLowRankV4_multi.m:281-386):

- the per-op route of :func:`.pair_solver.infer_admm_pair`, which hands
  it the CUDA kernels K4 (pair GEMM), K1 (magnitude prox + M-dual) and
  K2 (warm Z-prox), the nuclear prox, or no Z-prox at all (the Z-free
  branch: K4 and K1 only);
- the plain version of the loop kernel K3
  (:func:`.kernels.infer_admm.infer_admm_plain`), which hands it K4's,
  K1's and K2's plain versions.

Lanes are laid out (G, P, ...): G groups share one codebook block and its
U, P lanes ride each group, so each pair GEMM folds (P, r) into the rows
of one batched product per group.  Each lane carries a
``converged`` mask; a finished lane's state is frozen with
``torch.where`` and its trip count ``it`` stops, so ``it`` keeps JAX's
meaning (the trips each lane ran).  Whether any lane is still active is
read on the host once every ``CHECK_EVERY`` trips; the extra frozen trips
change nothing.

With a row-reduction hook (``reduce``) the lanes' measurement rows are
sharded over processes (:mod:`..parallel.sharded_pair`): A, b, Y and the
M-dual hold this shard's rows, while X, Z, the N-dual, the basis and mu
are replicated.  Each trip then makes two all-reduces over the shards:
the X-update's partial A^H (Y - M/mu), and one flat buffer holding the
partial A^H Y with every sum of squares over the rows (||AX||^2,
||Y||^2, ||J_m||^2, ||Y - Y0||^2 and the objective's squared residuals,
per lane, or per column in the per-column pass); the square roots are
taken after the sum.  The any-active flag read every ``CHECK_EVERY``
trips is all-reduced with MAX, so no shard leaves the loop alone.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..utils import profiling
from .cplx import Pair, add, conj, matmul, sub, transpose

#: trips between host reads of the lanes' converged masks
CHECK_EVERY = 8


# ---------------------------------------------------------------------------
# small helpers on (G, P, r, k) pairs

def fro2(p: Pair):
    return torch.sum(p.re * p.re + p.im * p.im, dim=(-2, -1))


def norm(p: Pair):
    return torch.sqrt(fro2(p))


def gemm(x: Pair, mat: Pair, pair_gemm: Callable = matmul) -> Pair:
    """(G, P, r, k) @ (G, k, l) -> (G, P, r, l), folding (P, r) into the
    rows of one batched Karatsuba product ``pair_gemm`` per group."""
    g, p, r, k = x.re.shape
    out = pair_gemm(Pair(x.re.reshape(g, p * r, k),
                         x.im.reshape(g, p * r, k)), mat)
    return Pair(out.re.view(g, p, r, -1), out.im.view(g, p, r, -1))


def lanes(p: Pair) -> Pair:
    """(G, P, ...) -> (G*P, ...) view."""
    return Pair(p.re.flatten(0, 1), p.im.flatten(0, 1))


def groups(p: Pair, g: int) -> Pair:
    """(G*P, ...) -> (G, P, ...) view."""
    return Pair(p.re.unflatten(0, (g, -1)), p.im.unflatten(0, (g, -1)))


def where(mask, new, old):
    """Per-lane select; ``mask`` is (G, P), values (G, P, ...)."""
    if isinstance(new, Pair):
        return Pair(where(mask, new.re, old.re), where(mask, new.im, old.im))
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 2)),
                       new, old)


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


#: ``pair_gemm(a, b) -> a @ b`` on contiguous (G, M, K), (G, K, N) pairs
PairGemm = Callable
#: ``prox_dual(ax, b, m_dual, mu, per_entry) -> (y, m_new)`` on lanes
ProxDual = Callable
#: ``z_prox(z_in, v_basis, mu) -> (z_new, v_new)`` on lanes; None for
#: the Z-free loop
ZProx = Optional[Callable]
#: the row-reduction hook of a row-sharded solve: ``sum_(t)`` and
#: ``max_(t)`` all-reduce a tensor in place over the row shards and
#: return it; ``trips`` counts the loop trips run with it
#: (:class:`..parallel.mesh.RowReduce`); None for a solve on one shard
RowHook = Optional[object]


def any_active(active: torch.Tensor, reduce: RowHook) -> bool:
    """Whether any lane is still active, read on the host; with a hook
    the flag is all-reduced with MAX over the shards first."""
    if reduce is None:
        return bool(active.any())
    return bool(reduce.max_(active.any().to(torch.int32).reshape(1)))


def fused_row_sums(reduce, aty, res2, sq):
    """All-reduce (b) of a row-sharded trip, for the per-op and the
    complex loop: one flat float buffer holding the partial A^H Y (the
    real tensors ``aty``: a pair's planes, or a complex tensor seen as
    real), the objective's squared residuals ``res2``, already summed
    over this shard's rows, and the squared norms ``sq``.  Returns
    ``(aty, obj, sums)``: the summed tensors of ``aty``, obj the square
    root of the summed ``res2``, sums those of ``sq``."""
    parts = (*aty, *sq, res2)
    buf = reduce.sum_(torch.cat([t.reshape(-1) for t in parts]))
    out = torch.split(buf, [t.numel() for t in parts])
    out = [o.view(t.shape) for o, t in zip(out, parts)]
    k = len(aty)
    return tuple(out[:k]), torch.sqrt(out[-1]), tuple(out[k:-1])


def _contiguous(p: Pair) -> Pair:
    return Pair(p.re.contiguous(), p.im.contiguous())


def admm_loop(a: Pair, b, u_mat: Pair, y: Pair, z: Pair, v_basis: Pair,
              mu0, *, scale_by_row: bool, pair_gemm: PairGemm,
              prox_dual: ProxDual, z_prox: ZProx, rho: float, tol_rel: float,
              tol_abs: float, maxiter: int, warm_iters: int = 0,
              anchor: Optional[Pair] = None, reduce: RowHook = None,
              m_eff: Optional[int] = None, path: str = "per-op",
              zprox: str = "k2"):
    """The loop of every lane from its prepared state.

    ``a``: (G, m, n); ``b``: (G, P, m); ``u_mat``: (G, n, n), the inverse
    of A^H A + reg I; ``y``/``z``: (G, P, r, m)/(G, P, r, n), the state
    after initialization; ``v_basis``: (G, P, ...) carried by ``z_prox``;
    ``mu0``: (G, P).  With ``z_prox`` None the loop is Z-free (ref
    :301-321 with no Z): ``u_mat`` is then (G, m, n), pinv(A)^H, the
    X-update solves against Y alone, and Z, the N-dual and v_basis stay
    as given.  ``anchor``: the proximal anchor's pull
    ``anchor_weight * anchor``, broadcastable to (G, P, r, n), added to
    the X-update's right-hand side (U must carry the matching ridge).
    ``reduce``: the row-reduction hook of a row-sharded solve (see the
    module's docstring), with ``m_eff`` the active global row count of
    the residual thresholds (default: this shard's m); not with the
    Z-free loop, whose X-update solves over the rows.

    Each trip: X-update against conj(U), magnitude prox with the M-dual
    update, Z-prox, N-dual update, best-so-far tracking, the three
    residual tests and the mu update.  The trip's three products (A^H Y,
    the X-update, A X) go through ``pair_gemm``, whose B operands
    (A^T, conj(A), conj(U)) are made contiguous once per solve.  With
    ``warm_iters > 0``, after the first ``min(warm_iters, maxiter)`` trips
    ``converged`` and the best-so-far objective are reset for every lane
    and the tail continues from the carried state (ref :571-578); every
    trip runs in float32 (JAX's single-pass "default" for the warm trips
    has no counterpart yet).

    ``path`` and ``zprox`` name the loop and its Z-prox in the loop's
    lane-trip record (:func:`..utils.profiling.record_trips`: both phases
    of a warm loop in one record; ``zprox`` reads "none" without one).

    Returns ``(opt_x, opt_y, converged, it)``: opt_x (G, P, r, n) with
    ``scale_by_row``, else the best column (G, P, 1, n); ``it`` (G, P).
    """
    g_, p_, r, m = y.re.shape
    n = z.re.shape[-1]
    n_lanes = g_ * p_
    has_z = z_prox is not None
    if reduce is not None and not has_z:
        raise ValueError("the Z-free loop has no row-sharded form")
    m_thr = m if m_eff is None else m_eff
    a_t = _contiguous(transpose(a))                             # (G, n, m)
    a_conj = _contiguous(conj(a))                               # (G, m, n)
    u_conj = _contiguous(conj(u_mat))                           # U^T
    b_lanes = b.reshape(n_lanes, m)
    dev, f32 = y.re.device, torch.float32

    def a_mul(x):
        return gemm(x, a_t, pair_gemm)

    def ah_mul(yy):
        return gemm(yy, a_conj, pair_gemm)

    def ah_sum(yy):
        """A^H Y summed over the row shards: all-reduce (a)."""
        part = ah_mul(yy)
        if reduce is None:
            return part
        buf = reduce.sum_(torch.stack([part.re, part.im]))
        return Pair(buf[0], buf[1])

    def zeros(*shape):
        return Pair(torch.zeros(shape, dtype=f32, device=dev),
                    torch.zeros(shape, dtype=f32, device=dev))

    def full(val, dtype=f32):
        return torch.full((g_, p_), val, dtype=dtype, device=dev)

    k_opt = r if scale_by_row else 1
    state = _State(
        y=y, z=z, m_dual=zeros(g_, p_, r, m), n_dual=zeros(g_, p_, r, n),
        aty=ah_sum(y), v_basis=v_basis, mu=mu0,
        last_res=full(math.inf), opt_obj=full(math.inf),
        opt_x=zeros(g_, p_, k_opt, n), opt_y=zeros(g_, p_, k_opt, m),
        it=full(0, torch.int32), converged=full(False, torch.bool))

    def body(c: _State) -> _State:
        mu = c.mu
        mu4 = mu[..., None, None]
        inv4 = 1.0 / mu4
        # X-update (ref :401-409); the anchor's pull joins the rhs
        t = Pair(c.y.re - c.m_dual.re * inv4, c.y.im - c.m_dual.im * inv4)
        if has_z:
            rhs = add(ah_sum(t), Pair(c.z.re - c.n_dual.re * inv4,
                                      c.z.im - c.n_dual.im * inv4))
            if anchor is not None:
                rhs = add(rhs, anchor)
        else:
            rhs = t                                    # U = pinv(A)^H
        x = gemm(rhs, u_conj, pair_gemm)
        ax = a_mul(x)
        # Y-update fused with the M-dual update (ref :511-533, :336-337)
        yn, m_dual = prox_dual(lanes(ax), b_lanes, lanes(c.m_dual),
                               mu.reshape(n_lanes), not scale_by_row)
        yn, m_dual = groups(yn, g_), groups(m_dual, g_)
        aty = ah_mul(yn)
        j_m = sub(ax, yn)
        # the objective's residuals over the rows (ref :343-361)
        if scale_by_row:
            amp = torch.sqrt(torch.clamp(
                torch.sum(ax.re ** 2 + ax.im ** 2, dim=-2), min=0.0))
            res = amp - b                                       # (G, P, m)
        else:
            amp = torch.sqrt(torch.clamp(ax.re ** 2 + ax.im ** 2, min=0.0))
            res = amp - b[..., None, :]                         # (G, P, r, m)
        if reduce is None:
            obj_all = torch.linalg.vector_norm(res, dim=-1)
            nax2, ny2, njm2, ndy2 = (fro2(ax), fro2(yn), fro2(j_m),
                                     fro2(sub(yn, c.y)))
        else:
            aty, obj_all, (nax2, ny2, njm2, ndy2) = fused_row_sums(
                reduce, aty, torch.sum(res * res, dim=-1),
                [fro2(p) for p in (ax, yn, j_m, sub(yn, c.y))])
            aty = Pair(*aty)
        if has_z:
            # Z-update (ref :423-485)
            z_in = Pair(x.re + c.n_dual.re * inv4, x.im + c.n_dual.im * inv4)
            zn, v_new = z_prox(lanes(z_in), lanes(c.v_basis),
                               mu.reshape(n_lanes))
            zn, v_new = groups(zn, g_), groups(v_new, g_)
            # N-dual update (ref :336-341)
            j_n = sub(x, zn)
            n_dual = Pair(c.n_dual.re + mu4 * j_n.re,
                          c.n_dual.im + mu4 * j_n.im)
        else:
            zn, v_new, n_dual = c.z, c.v_basis, c.n_dual

        # best-so-far (ref :343-361)
        if scale_by_row:
            obj = obj_all                                       # (G, P)
            x_best, y_best = x, yn
        else:
            objs = obj_all
            j = torch.argmin(objs, dim=-1, keepdim=True)      # first on ties
            obj = torch.gather(objs, -1, j)[..., 0]

            def pick(p: Pair) -> Pair:
                idx = j[..., None].expand(g_, p_, 1, p.re.shape[-1])
                return Pair(torch.gather(p.re, 2, idx),
                            torch.gather(p.im, 2, idx))

            x_best, y_best = pick(x), pick(yn)
        better = obj < c.opt_obj
        opt_x = where(better, x_best, c.opt_x)
        opt_y = where(better, y_best, c.opt_y)
        opt_obj = torch.minimum(obj, c.opt_obj)

        # convergence tests (ref :363-375); the row sums are global
        nax, ny, naty = torch.sqrt(nax2), torch.sqrt(ny2), norm(aty)
        if has_z:
            nx, nz = norm(x), norm(zn)
            res_prim = torch.sqrt(njm2 + fro2(j_n))
            dz2 = fro2(sub(zn, c.z))
            res_dual = mu * torch.sqrt(fro2(sub(aty, c.aty)) + dz2)
            res_comb = torch.sqrt(res_prim ** 2 + ndy2 + dz2)
            big = torch.maximum(nax, ny) ** 2 + torch.maximum(nx, nz) ** 2
            t_prim = (tol_abs * math.sqrt((m_thr + n) * r)
                      + tol_rel * torch.sqrt(big))
            t_dual = (tol_abs * math.sqrt(n * r * 2)
                      + tol_rel * torch.sqrt(naty ** 2 + nz ** 2))
            t_comb = (tol_abs * math.sqrt((m_thr + n) * r * 2)
                      + tol_rel * torch.sqrt(big + ny ** 2 + nz ** 2))
        else:
            res_prim = torch.sqrt(njm2)
            res_dual = mu * norm(sub(aty, c.aty))
            res_comb = torch.sqrt(res_prim ** 2 + ndy2)
            big = torch.maximum(nax, ny)
            t_prim = tol_abs * math.sqrt(m * r) + tol_rel * big
            t_dual = tol_abs * math.sqrt(n * r) + tol_rel * naty
            t_comb = (tol_abs * math.sqrt(m * r * 2)
                      + tol_rel * torch.sqrt(big ** 2 + ny ** 2))
        converged = (((res_prim < t_prim) & (res_dual < t_dual))
                     | (res_comb < t_comb))
        mu = torch.where(res_comb > c.last_res * 0.9, mu * rho, mu)
        return _State(y=yn, z=zn, m_dual=m_dual, n_dual=n_dual, aty=aty,
                      v_basis=v_new, mu=mu, last_res=res_comb,
                      opt_obj=opt_obj, opt_x=opt_x, opt_y=opt_y,
                      it=c.it + 1, converged=converged)

    trips = 0

    def run(c: _State, bound: int) -> _State:
        nonlocal trips
        for trip in range(bound):
            active = (c.it < bound) & ~c.converged
            if trip % CHECK_EVERY == 0:
                with profiling.span("inner.check"):
                    go = any_active(active, reduce)
                if not go:
                    break
            if reduce is not None:
                reduce.trips += 1
            new = body(c)
            c = _State(*(where(active, nv, ov) for nv, ov in zip(new, c)))
            trips += 1
        return c

    if warm_iters > 0:
        state = run(state, min(warm_iters, maxiter))
        # the warm phase's residuals must not certify convergence, and its
        # best-so-far objective must not block the tail's better states:
        # reset both at the phase switch, as JAX does after its coarse
        # single-pass trips (ref :571-578)
        state = state._replace(converged=torch.zeros_like(state.converged),
                               opt_obj=torch.full_like(state.opt_obj,
                                                       math.inf))
    state = run(state, maxiter)
    profiling.record_trips(path, r, m, n, zprox if has_z else "none",
                           n_lanes, trips, state.it)
    return state.opt_x, state.opt_y, state.converged, state.it
