"""K7: one trip of the per-op loop around K4, K1 and K2, its glue in CUDA
passes (``csrc/admm_trip.cu``).

Replaces no TPU kernel: XLA fused this glue inside the jitted loop body.
:func:`admm_trip` runs one trip of :func:`..admm_loop.admm_loop`: the
X-update, the magnitude prox with the M-dual update, the Z-prox, the
N-dual update, the best-so-far, the residual tests and the mu update,
then the freeze of every lane that was not active.  A CPU state takes the
plain version :func:`trip_plain`, the loop body as PyTorch ops; a CUDA
state runs the passes between the loop's products and proxes, or raises:

- ``trip_shift``: T = Y - M/mu before K4's A^H T, and Z_in = X + N/mu
  before the Z-prox;
- ``trip_rhs``: the X-update's right-hand side A^H T + Z - N/mu, plus the
  anchor's pull (not in the Z-free loop, whose right-hand side is T);
- ``trip_rows``: one read of AX, Y_new, Y_old and b gives every sum over
  the rows (the objective's too) into a small scratch buffer; with a
  row-reduction hook it is all-reduced with A^H Y_new, in one call;
- ``trip_n_dual``: the N-dual update and the sums over the columns;
- ``trip_commit``: the residual tests, mu, the best-so-far and the small
  fields of each lane, then the new best-so-far (the trip's X and Y_new
  on the lanes that improved, the old one on the others) and the restore
  of the lanes that were not active.

Neither route writes into the state it is given: every field a trip
computes is a new tensor (the CUDA route's scratch, ``Loop.work``, holds
only what the trip uses up itself).  Each pass
wrapper counts its launches in ``.launches``; the plain version counts
none.  A trip launches ``trip_shift`` twice and each other pass once (the
Z-free loop: one shift, rows, n_dual and commit).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..admm_loop import (Loop, LoopState, fro2, fused_row_sums, gemm, groups,
                         lanes, norm, where)
from ..cplx import Pair, add, sub
from . import _build

#: threads of a block of every pass (the kernels' THREADS)
THREADS = 256
#: entries a block of the elementwise passes takes, at most
PART = 16 * THREADS
#: columns a block of the row sums takes (4 a thread)
ROW_COLS = 4 * THREADS
#: entries a block of the commit copies, at most
COPY_PART = 32 * THREADS
#: slots of a block's partial column sums (the kernels' COL_SLOTS)
COL_SLOTS = 6


def admm_trip(c: LoopState, loop: Loop, bound: int) -> LoopState:
    """One trip of every lane of ``c``; lanes whose ``it`` reached
    ``bound`` or that converged keep their state."""
    dev = c.y.re.device
    if dev.type == "cpu":
        return trip_plain(c, loop, bound)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _trip_cuda(c, loop, bound)


# ---------------------------------------------------------------------------
# the plain version

def trip_plain(c: LoopState, loop: Loop, bound: int) -> LoopState:
    """Plain PyTorch version of :func:`admm_trip`: the body, then the
    freeze of the lanes that were not active with ``torch.where``."""
    active = (c.it < bound) & ~c.converged
    new = _body(c, loop)
    return LoopState(*(where(active, nv, ov) for nv, ov in zip(new, c)))


def _body(c: LoopState, loop: Loop) -> LoopState:
    g_, p_, r, m = c.y.re.shape
    n_lanes = g_ * p_
    has_z, scale_by_row, reduce = loop.has_z, loop.scale_by_row, loop.reduce
    b = loop.b_lanes.view(g_, p_, m)
    mu = c.mu
    mu4 = mu[..., None, None]
    inv4 = 1.0 / mu4
    # X-update (ref :401-409); the anchor's pull joins the rhs
    t = Pair(c.y.re - c.m_dual.re * inv4, c.y.im - c.m_dual.im * inv4)
    if has_z:
        rhs = add(loop.ah_sum(t), Pair(c.z.re - c.n_dual.re * inv4,
                                       c.z.im - c.n_dual.im * inv4))
        if loop.anchor is not None:
            rhs = add(rhs, loop.anchor)
    else:
        rhs = t                                    # U = pinv(A)^H
    x = gemm(rhs, loop.u_conj, loop.pair_gemm)
    ax = loop.a_mul(x)
    # Y-update fused with the M-dual update (ref :511-533, :336-337)
    yn, m_dual = loop.prox_dual(lanes(ax), loop.b_lanes, lanes(c.m_dual),
                                mu.reshape(n_lanes), not scale_by_row)
    yn, m_dual = groups(yn, g_), groups(m_dual, g_)
    aty = loop.ah_mul(yn)
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
        zn, v_new = loop.z_prox(lanes(z_in), lanes(c.v_basis),
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
    tol_rel, _, c_prim, c_dual, c_comb = loop.test_constants()
    nax, ny, naty = torch.sqrt(nax2), torch.sqrt(ny2), norm(aty)
    if has_z:
        nx, nz = norm(x), norm(zn)
        res_prim = torch.sqrt(njm2 + fro2(j_n))
        dz2 = fro2(sub(zn, c.z))
        res_dual = mu * torch.sqrt(fro2(sub(aty, c.aty)) + dz2)
        res_comb = torch.sqrt(res_prim ** 2 + ndy2 + dz2)
        big = torch.maximum(nax, ny) ** 2 + torch.maximum(nx, nz) ** 2
        t_prim = c_prim + tol_rel * torch.sqrt(big)
        t_dual = c_dual + tol_rel * torch.sqrt(naty ** 2 + nz ** 2)
        t_comb = c_comb + tol_rel * torch.sqrt(big + ny ** 2 + nz ** 2)
    else:
        res_prim = torch.sqrt(njm2)
        res_dual = mu * norm(sub(aty, c.aty))
        res_comb = torch.sqrt(res_prim ** 2 + ndy2)
        big = torch.maximum(nax, ny)
        t_prim = c_prim + tol_rel * big
        t_dual = c_dual + tol_rel * naty
        t_comb = c_comb + tol_rel * torch.sqrt(big ** 2 + ny ** 2)
    converged = (((res_prim < t_prim) & (res_dual < t_dual))
                 | (res_comb < t_comb))
    mu = torch.where(res_comb > c.last_res * 0.9, mu * loop.rho, mu)
    return LoopState(y=yn, z=zn, m_dual=m_dual, n_dual=n_dual, aty=aty,
                     v_basis=v_new, mu=mu, last_res=res_comb,
                     opt_obj=opt_obj, opt_x=opt_x, opt_y=opt_y,
                     it=c.it + 1, converged=converged)


# ---------------------------------------------------------------------------
# the CUDA route

def _parts(per: int, size: int) -> int:
    return max(1, -(-per // size))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if contiguous on a 16-byte boundary, else a copy that is:
    what the passes' 16-byte moves take."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous().clone()


def _aligned_pair(p: Pair) -> Pair:
    return Pair(_aligned(p.re), _aligned(p.im))


def _check(name: str, tensors: dict, device) -> None:
    _build.check_inputs(tensors, device)
    for key, (t, _) in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start on a 16-byte "
                             f"boundary")


def _ptr(p) -> int:
    return 0 if p is None else p.data_ptr()


def _stream(dev) -> int:
    return torch._C._cuda_getCurrentRawStream(dev.index)


def trip_shift(a: Pair, b: Pair, mu, sign: float, out: Pair) -> Pair:
    """out = a + sign * b / mu on (lanes, ...) pairs, ``mu`` (lanes,),
    ``sign`` +1 or -1, each entry rounded as ``a - b * (1 / mu)``."""
    nl = mu.shape[0]
    per = a.re.numel() // max(nl, 1)
    shape = (nl, per)
    _check("trip_shift", {"a.re": (a.re.view(shape), shape),
                          "a.im": (a.im.view(shape), shape),
                          "b.re": (b.re.view(shape), shape),
                          "b.im": (b.im.view(shape), shape),
                          "out.re": (out.re.view(shape), shape),
                          "out.im": (out.im.view(shape), shape),
                          "mu": (mu, (nl,))}, a.re.device)
    rc = _build.library().twoace_trip_shift(
        a.re.data_ptr(), a.im.data_ptr(), b.re.data_ptr(), b.im.data_ptr(),
        mu.data_ptr(), out.re.data_ptr(), out.im.data_ptr(), nl, per,
        _parts(per, PART), float(sign), _stream(a.re.device))
    _build.check(rc, "trip_shift")
    trip_shift.launches += 1
    return out


def trip_rhs(aht: Pair, z: Pair, n_dual: Pair, mu, anchor: Optional[Pair],
             out: Pair) -> Pair:
    """out = A^H T + (Z - N / mu) [+ anchor] on (lanes, ...) pairs."""
    nl = mu.shape[0]
    per = aht.re.numel() // max(nl, 1)
    shape = (nl, per)
    ts = {"aht.re": aht.re, "aht.im": aht.im, "z.re": z.re, "z.im": z.im,
          "n.re": n_dual.re, "n.im": n_dual.im, "out.re": out.re,
          "out.im": out.im}
    if anchor is not None:
        ts.update({"anchor.re": anchor.re, "anchor.im": anchor.im})
    checks = {k: (t.view(shape), shape) for k, t in ts.items()}
    checks["mu"] = (mu, (nl,))
    _check("trip_rhs", checks, aht.re.device)
    rc = _build.library().twoace_trip_rhs(
        aht.re.data_ptr(), aht.im.data_ptr(), z.re.data_ptr(),
        z.im.data_ptr(), n_dual.re.data_ptr(), n_dual.im.data_ptr(),
        _ptr(anchor and anchor.re), _ptr(anchor and anchor.im),
        mu.data_ptr(), out.re.data_ptr(), out.im.data_ptr(), nl, per,
        _parts(per, PART), _stream(aht.re.device))
    _build.check(rc, "trip_rhs")
    trip_rhs.launches += 1
    return out


def row_slots(r: int, per_column: bool) -> int:
    """Slots of a lane's row sums: ||AX||^2, ||Y_new||^2, ||AX - Y_new||^2,
    ||Y_new - Y_old||^2, then the objective's squared residuals, one a lane
    or one a column r."""
    return 4 + (r if per_column else 1)


def trip_rows(ax: Pair, yn: Pair, y_old: Pair, b, per_column: bool, out):
    """The sums over the rows of (lanes, r, m) pairs into ``out``
    (lanes, parts, :func:`row_slots`), one row of partials a block."""
    nl, r, m = ax.re.shape
    state = (nl, r, m)
    parts = _parts(m, ROW_COLS)
    _check("trip_rows", {"ax.re": (ax.re, state), "ax.im": (ax.im, state),
                         "yn.re": (yn.re, state), "yn.im": (yn.im, state),
                         "y_old.re": (y_old.re, state),
                         "y_old.im": (y_old.im, state), "b": (b, (nl, m)),
                         "out": (out, (nl, parts, row_slots(r, per_column)))},
           ax.re.device)
    rc = _build.library().twoace_trip_rows(
        ax.re.data_ptr(), ax.im.data_ptr(), yn.re.data_ptr(),
        yn.im.data_ptr(), y_old.re.data_ptr(), y_old.im.data_ptr(),
        b.data_ptr(), out.data_ptr(), nl, r, m, parts, int(per_column),
        _stream(ax.re.device))
    _build.check(rc, "trip_rows")
    trip_rows.launches += 1
    return out


def trip_n_dual(x: Optional[Pair], zn: Optional[Pair], z_old: Optional[Pair],
                n_dual: Optional[Pair], n_new: Optional[Pair], aty: Pair,
                aty_old: Pair, mu, it, converged, bound: int, out):
    """n_new = N + mu (X - Z_new) on the active lanes (N on the others),
    and the sums over the columns into ``out`` (lanes, parts, COL_SLOTS);
    the Z-free loop passes X, Z and both N as None and gets the sums of
    A^H Y alone."""
    nl = mu.shape[0]
    per = aty.re.numel() // max(nl, 1)
    shape = (nl, per)
    parts = _parts(per, PART)
    ts = {"aty.re": aty.re, "aty.im": aty.im, "aty_old.re": aty_old.re,
          "aty_old.im": aty_old.im}
    if x is not None:
        ts.update({"x.re": x.re, "x.im": x.im, "zn.re": zn.re,
                   "zn.im": zn.im, "z_old.re": z_old.re,
                   "z_old.im": z_old.im, "n.re": n_dual.re,
                   "n.im": n_dual.im, "n_new.re": n_new.re,
                   "n_new.im": n_new.im})
    checks = {k: (t.view(shape), shape) for k, t in ts.items()}
    checks.update(mu=(mu, (nl,)), out=(out, (nl, parts, COL_SLOTS)))
    _check("trip_n_dual", checks, aty.re.device)
    if it.dtype != torch.int32 or converged.dtype != torch.bool:
        raise ValueError("trip_n_dual: it must be int32, converged bool")
    rc = _build.library().twoace_trip_n_dual(
        _ptr(x and x.re), _ptr(x and x.im), _ptr(zn and zn.re),
        _ptr(zn and zn.im), _ptr(z_old and z_old.re),
        _ptr(z_old and z_old.im), _ptr(n_dual and n_dual.re),
        _ptr(n_dual and n_dual.im), _ptr(n_new and n_new.re),
        _ptr(n_new and n_new.im), aty.re.data_ptr(), aty.im.data_ptr(),
        aty_old.re.data_ptr(), aty_old.im.data_ptr(), mu.data_ptr(),
        it.data_ptr(), converged.data_ptr(), out.data_ptr(), nl, per, parts,
        bound, _stream(aty.re.device))
    _build.check(rc, "trip_n_dual")
    trip_n_dual.launches += 1
    return out


class Small(NamedTuple):
    """The per-lane fields of a trip's state, (lanes,) each."""
    mu: torch.Tensor
    last_res: torch.Tensor
    opt_obj: torch.Tensor
    it: torch.Tensor
    converged: torch.Tensor


def _void_array(ptrs):
    return (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)


def trip_commit(rows, cols, small: Small, out: Small, tests, restore,
                x: Pair, yn: Pair, opt: tuple, opt_new: tuple, *, r: int,
                per_column: bool, has_z: bool, bound: int):
    """The epilogue of each lane's trip: the residual tests, mu and the
    best-so-far from the partial sums ``rows`` and ``cols``; ``small``'s
    next values into ``out`` (a lane that was not active keeps its own);
    the new best-so-far ``opt_new`` (opt_x, opt_y) from ``x`` and ``yn``
    (lanes, r, ...) on the lanes that improved, from the old ``opt`` on
    the others; and on the lanes that were not active each ``(old, new)``
    plane of ``restore`` copied back into ``new``.  ``tests``:
    :meth:`Loop.test_constants`."""
    nl, _, n = x.re.shape
    m = yn.re.shape[-1]
    k_opt = 1 if per_column else r
    dev = x.re.device
    checks = {"rows": (rows, (nl, rows.shape[1], row_slots(r, per_column))),
              "cols": (cols, (nl, cols.shape[1], COL_SLOTS)),
              "x.re": (x.re, (nl, r, n)), "x.im": (x.im, (nl, r, n)),
              "yn.re": (yn.re, (nl, r, m)), "yn.im": (yn.im, (nl, r, m))}
    for tag, (ox, oy) in (("opt", opt), ("opt_new", opt_new)):
        for part, t in (("x.re", ox.re), ("x.im", ox.im)):
            checks[f"{tag}_{part}"] = (t, (nl, k_opt, n))
        for part, t in (("y.re", oy.re), ("y.im", oy.im)):
            checks[f"{tag}_{part}"] = (t, (nl, k_opt, m))
    for name, (old, new) in enumerate(restore):
        per = old.numel() // max(nl, 1)
        checks[f"restore{name}.old"] = (old.view(nl, per), (nl, per))
        checks[f"restore{name}.new"] = (new.view(nl, per), (nl, per))
    _check("trip_commit", checks, dev)
    for t in (*small, *out):
        if t.shape != (nl,) or not t.is_contiguous() or t.device != dev:
            raise ValueError("trip_commit: the small fields must be "
                             "contiguous (lanes,) tensors on the card")
    per_max = max([old.numel() // max(nl, 1) for old, _ in restore]
                  + [k_opt * max(m, n)])
    rc = _build.library().twoace_trip_commit(
        rows.data_ptr(), cols.data_ptr(),
        _void_array([t.data_ptr() for t in small]),
        _void_array([t.data_ptr() for t in out]),
        (ctypes.c_float * 5)(*tests),
        _void_array([old.data_ptr() for old, _ in restore]),
        _void_array([new.data_ptr() for _, new in restore]),
        (ctypes.c_longlong * max(len(restore), 1))(
            *(old.numel() // max(nl, 1) for old, _ in restore)),
        len(restore), x.re.data_ptr(), x.im.data_ptr(), yn.re.data_ptr(),
        yn.im.data_ptr(), *(t.data_ptr() for p in (*opt, *opt_new)
                            for t in p), nl, r, m, n,
        rows.shape[1], cols.shape[1], _parts(per_max, COPY_PART),
        int(per_column), int(has_z), bound, _stream(dev))
    _build.check(rc, "trip_commit")
    trip_commit.launches += 1


for _fn in (trip_shift, trip_rhs, trip_rows, trip_n_dual, trip_commit):
    _fn.launches = 0

#: the passes, in the order of :data:`..KERNELS`
PASSES = (trip_shift, trip_rhs, trip_rows, trip_n_dual, trip_commit)


class _Work(NamedTuple):
    """Scratch of the CUDA route, made at a loop's first trip."""
    t: Pair
    rhs: Optional[Pair]
    z_in: Optional[Pair]
    rows: torch.Tensor
    cols: torch.Tensor
    anchor: Optional[Pair]
    tests: tuple


def _flat(p: Pair, nl: int) -> Pair:
    return Pair(p.re.reshape(nl, *p.re.shape[2:]),
                p.im.reshape(nl, *p.im.shape[2:]))


def _empty_like(p: Pair) -> Pair:
    return Pair(torch.empty_like(p.re), torch.empty_like(p.im))


def _small(c: LoopState) -> Small:
    return Small(c.mu.reshape(-1), c.last_res.reshape(-1),
                 c.opt_obj.reshape(-1), c.it.reshape(-1),
                 c.converged.reshape(-1))


def _work(c: LoopState, loop: Loop) -> _Work:
    g_, p_, r, m = c.y.re.shape
    nl = g_ * p_
    n = loop.a_conj.re.shape[-1]
    dev, f32 = c.y.re.device, torch.float32

    def pair(*shape):
        return Pair(torch.empty(shape, dtype=f32, device=dev),
                    torch.empty(shape, dtype=f32, device=dev))

    anchor = None
    if loop.anchor is not None:
        anchor = Pair(*(_aligned(t.expand(g_, p_, r, n).contiguous())
                        for t in loop.anchor))
    per_x = r * n
    return _Work(
        t=pair(g_, p_, r, m),
        rhs=pair(g_, p_, r, n) if loop.has_z else None,
        z_in=pair(g_, p_, r, n) if loop.has_z else None,
        rows=torch.empty((nl, _parts(m, ROW_COLS),
                          row_slots(r, not loop.scale_by_row)),
                         dtype=f32, device=dev),
        cols=torch.empty((nl, _parts(per_x, PART), COL_SLOTS), dtype=f32,
                         device=dev),
        anchor=anchor, tests=loop.test_constants())


def _trip_cuda(c: LoopState, loop: Loop, bound: int) -> LoopState:
    if loop.work is None:
        c = LoopState(*(_aligned_pair(f) if isinstance(f, Pair) else
                        _aligned(f) for f in c))
        loop.work = _work(c, loop)
    w = loop.work
    g_, p_, r, m = c.y.re.shape
    nl = g_ * p_
    has_z, per_column = loop.has_z, not loop.scale_by_row
    mu = c.mu.reshape(nl)
    y_l, md_l = _flat(c.y, nl), _flat(c.m_dual, nl)

    # X-update
    trip_shift(c.y, c.m_dual, mu, -1.0, w.t)
    if has_z:
        trip_rhs(_aligned_pair(loop.ah_sum(w.t)), c.z, c.n_dual, mu,
                 w.anchor, w.rhs)
        rhs = w.rhs
    else:
        rhs = w.t
    x = gemm(rhs, loop.u_conj, loop.pair_gemm)
    ax = loop.a_mul(x)
    # Y-update with the M-dual update (K1), then A^H Y_new
    yn_l, md_new_l = loop.prox_dual(_flat(ax, nl), loop.b_lanes, md_l, mu,
                                    per_column)
    yn, m_dual = groups(yn_l, g_), groups(md_new_l, g_)
    aty = loop.ah_mul(yn)
    rows = trip_rows(_flat(ax, nl), yn_l, y_l, loop.b_lanes, per_column,
                     w.rows)
    if loop.reduce is not None:
        # all-reduce (b): A^H Y_new and the row sums in one buffer
        parts = (aty.re, aty.im, rows)
        buf = loop.reduce.sum_(torch.cat([t.reshape(-1) for t in parts]))
        got = [_aligned(o.view(t.shape)) for o, t in zip(
            torch.split(buf, [t.numel() for t in parts]), parts)]
        aty, rows = Pair(got[0], got[1]), got[2]
    if has_z:
        trip_shift(x, c.n_dual, mu, 1.0, w.z_in)
        zn_l, v_l = loop.z_prox(_flat(w.z_in, nl), _flat(c.v_basis, nl), mu)
        zn, v_new = groups(zn_l, g_), groups(v_l, g_)
        n_dual = _empty_like(c.n_dual)
        trip_n_dual(x, zn, c.z, c.n_dual, n_dual, aty, c.aty, mu,
                    c.it.reshape(nl), c.converged.reshape(nl), bound, w.cols)
    else:
        zn, v_new, n_dual = c.z, c.v_basis, c.n_dual
        trip_n_dual(None, None, None, None, None, aty, c.aty, mu,
                    c.it.reshape(nl), c.converged.reshape(nl), bound, w.cols)

    # the epilogue, the best-so-far and the freeze
    small = _small(c)
    nxt = Small(*(torch.empty_like(t) for t in small))
    restore = [(old, new) for olds, news in ((c.y, yn), (c.m_dual, m_dual),
                                             (c.z, zn), (c.aty, aty),
                                             (c.v_basis, v_new))
               for old, new in zip(olds, news)
               if new.data_ptr() != old.data_ptr()]
    opt_x, opt_y = _empty_like(c.opt_x), _empty_like(c.opt_y)
    trip_commit(rows, w.cols, small, nxt, w.tests, restore, _flat(x, nl),
                yn_l, (_flat(c.opt_x, nl), _flat(c.opt_y, nl)),
                (_flat(opt_x, nl), _flat(opt_y, nl)), r=r,
                per_column=per_column, has_z=has_z, bound=bound)
    shape = c.mu.shape
    return LoopState(y=yn, z=zn, m_dual=m_dual, n_dual=n_dual, aty=aty,
                     v_basis=v_new, mu=nxt.mu.view(shape),
                     last_res=nxt.last_res.view(shape),
                     opt_obj=nxt.opt_obj.view(shape), opt_x=opt_x,
                     opt_y=opt_y, it=nxt.it.view(shape),
                     converged=nxt.converged.view(shape))
