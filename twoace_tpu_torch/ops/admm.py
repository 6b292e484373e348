"""The 2ACE ADMM solver family on complex tensors (port of
``twoace_tpu.ops.admm``).

- :func:`infer_admm`: the InferADMM loop (ref: main/src/my_recovery_algorithms/
  ADMM_v2/inferLowRankV4_multi.m:281-386), with a Z-prox or without one
  (the inferMinL2 loop, ref: inferMinL2.m:229-326);
- ``_impl``: over-parameterized solve, column orthonormalization, per-column
  solve (ref :111-271);
- :func:`solve_lowrank_multi`: restarts with train/test splits, spectral
  init, the quality-gated rank-1 retry, the full-data refine with
  similarity rollback, rescale (ref :5-109); with ``n_restarts=1`` and
  ``prox_kind="nuclear"`` the inferLowRank_Nuclear scaffold;
- :func:`solve_minl2`: the prox-free version-0 solver (ref: inferMinL2.m:1-65).

State is complex64 on the card (complex128 in the CPU parity tests) in
the JAX package's (m, r) / (n, r) row layout.  Each trip's Y-update and
M-dual are one call of kernel K5 (:func:`.kernels.fused_prox_dual`); the
three products a trip (A^H., U., A.) are ``torch.matmul``, as JAX leaves
them to XLA, with TF32 off under ``cfg.matmul_precision == "float32"``.
The spectral-profile prox runs ``torch.linalg.eigh``, which waits for the
card each trip.

The JAX loop stops at its first converged trip.  Here a finished solve's
state is frozen with ``torch.where`` and ``done`` is read on the host once
every ``CHECK_EVERY`` trips, so the extra frozen trips change nothing.
:attr:`infer_admm.trips` adds up the trips each call ran (one host read at
the end of the call).

Random draws (splits, spectral-init start blocks) come from
``torch.Generator``s derived with :func:`..utils.rng.fold_in` where JAX
folds and splits keys, so a seed gives the same solve on any device, but
not JAX's draws.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..config import AdmmConfig
from ..utils.rng import fold_in
from .admm_loop import CHECK_EVERY, RowHook, any_active, fused_row_sums
from .kernels import fused_prox_dual
from .pair_solver import no_tf32
from .prox import (eigh_desc, nuclear_prox, profile_ladder,
                   project_rows_to_magnitude, spectral_profile_prox)
from .spectral_init import spectral_initialize


class AdmmResult(NamedTuple):
    x: torch.Tensor          #: (n,) recovered vec(H)
    y: torch.Tensor          #: (m,) recovered complex measurements
    quality: torch.Tensor    #: held-out quality 1 - ||(|A x|) - b|| / ||b||
    converged: torch.Tensor  #: bool


def _fro2(x):
    return torch.sum(x.real * x.real + x.imag * x.imag) if x.is_complex() \
        else torch.sum(x * x)


def _norm(x):
    return torch.sqrt(_fro2(x))


def _precision(cfg: AdmmConfig):
    """TF32 off for JAX's "float32" matmul precision, else the caller's."""
    return no_tf32() if cfg.matmul_precision == "float32" \
        else contextlib.nullcontext()


def _precompute_u(a, reg: float = 1.0):
    """U = inv(A^H A + reg I) by Cholesky and a triangular solve
    (ref: inferLowRankV4_multi.m:241-247)."""
    n = a.shape[1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    g = a.mH @ a + reg * eye
    c = torch.linalg.cholesky(0.5 * (g + g.mH))
    w = torch.linalg.solve_triangular(c, eye, upper=False)
    return w.mH @ w


def _pinv(a):
    """Minimum-norm pseudo-inverse of the v0 solver (ref: inferMinL2.m:166)."""
    m, n = a.shape
    if m >= n:
        g = a.mH @ a
        g = g + 1e-12 * torch.trace(g).real * torch.eye(
            n, dtype=a.dtype, device=a.device) / n
        return torch.linalg.solve(g, a.mH)
    g = a @ a.mH
    eye = torch.eye(m, dtype=a.dtype, device=a.device)
    g = g + 1e-12 * torch.trace(g).real * eye / m
    return a.mH @ torch.linalg.solve(g, eye)


_STATE = ("y", "z", "m_dual", "n_dual", "aty", "mu", "last_res", "opt_obj",
          "opt_x", "opt_y", "it", "done")


def infer_admm(a, b, x0, *, scale_by_row: bool,
               prox: Optional[Callable] = None,
               u_mat=None, mu0: float = 1e-3, rho: float = 1.03,
               tol_rel: float = 1e-4, tol_abs: float = 1e-8,
               maxiter: int = 500, reduce: RowHook = None,
               m_eff: Optional[int] = None):
    """One InferADMM solve of complex ``a`` (m, n), real ``b`` (m,) from
    ``x0`` (n, r).  Returns ``(x, y, converged)``: the best-so-far x (n, r)
    and y (m, r) with ``scale_by_row``, else the best column (n,), (m,).

    ``prox``: the Z-prox ``(z, mu) -> z`` or None (no Z constraint: the
    inferMinL2 loop).  The X-update uses ``u_mat = inv(A^H A + I)`` with a
    prox and ``pinv(A)`` without; either is computed here when not given.
    Each trip: X-update, the Y-update and M-dual in K5, Z-prox, N-dual,
    best-so-far, the three residual tests, and ``mu *= rho`` when the
    combined residual shrank by less than 10%.

    ``reduce``: the row-reduction hook of a row-sharded solve
    (:mod:`..parallel.sharded_admm`; see :mod:`.admm_loop`): ``a``, ``b``
    hold this shard's rows, ``u_mat`` (required) is built from the
    all-reduced Gram, and each trip all-reduces the X-update's partial
    A^H (Y - M/mu) and one buffer of the partial A^H Y with the sums of
    squares over the rows; ``m_eff`` is the global row count of the
    thresholds.  Not with the prox-free loop.
    """
    m, n = a.shape
    r = x0.shape[1]
    has_z = prox is not None
    if reduce is not None and (not has_z or u_mat is None):
        raise ValueError("a row-sharded solve needs a Z-prox and u_mat")
    m_thr = m if m_eff is None else m_eff
    rdt = a.real.dtype
    dev = a.device
    ah = a.mH
    b = b.to(rdt).contiguous()
    if u_mat is None:
        u_mat = _precompute_u(a) if has_z else _pinv(a)

    def ah_sum(yy):
        """A^H Y summed over the row shards: all-reduce (a)."""
        part = ah @ yy
        return part if reduce is None else reduce.sum_(part)

    x = x0
    ax = a @ x
    if reduce is None:
        bn = _norm(b)
        if scale_by_row:
            nax = _norm(ax)
        else:
            col = torch.linalg.vector_norm(ax, dim=0)
    else:
        s2 = reduce.sum_(torch.cat([_fro2(b)[None], torch.sum(
            ax.real ** 2 + ax.imag ** 2, dim=0)]))
        bn, col = torch.sqrt(s2[0]), torch.sqrt(s2[1:])
        nax = torch.sqrt(torch.sum(s2[1:]))
    if scale_by_row:
        x = x * (bn / torch.clamp(nax, min=1e-30)).to(a.dtype)
    else:
        x = x * (bn / torch.clamp(col, min=1e-30)).to(a.dtype)[None, :]
    ax = a @ x
    y = project_rows_to_magnitude(ax, b, scale_by_row)

    def zeros(*shape):
        return torch.zeros(shape, dtype=a.dtype, device=dev)

    def scalar(v, dtype=rdt):
        return torch.full((), v, dtype=dtype, device=dev)

    k_opt = (r,) if scale_by_row else ()
    c = dict(y=y, z=prox(x, scalar(1.0)) if has_z else None,
             m_dual=zeros(m, r), n_dual=zeros(n, r) if has_z else None,
             aty=ah_sum(y), mu=scalar(mu0), last_res=scalar(math.inf),
             opt_obj=scalar(math.inf), opt_x=zeros(n, *k_opt),
             opt_y=zeros(m, *k_opt), it=scalar(0, torch.int32),
             done=scalar(False, torch.bool))

    def body(c):
        y0, z0, aty0, mu = c["y"], c["z"], c["aty"], c["mu"]
        # X-update (ref :401-409 / inferMinL2.m:337-345)
        if has_z:
            x = u_mat @ (ah_sum(y0 - c["m_dual"] / mu)
                         + (z0 - c["n_dual"] / mu))
        else:
            x = u_mat @ (y0 - c["m_dual"] / mu)
        ax = a @ x
        # Y-update and M-dual in one K5 call (ref :511-533, :336-337)
        y, m_dual = fused_prox_dual(ax, b, c["m_dual"], mu,
                                    per_entry=not scale_by_row)
        aty = ah @ y
        j_m = ax - y
        # the objective's residuals over the rows (ref :343-361)
        if scale_by_row:
            amp = torch.sqrt(torch.sum(ax.real ** 2 + ax.imag ** 2, dim=1))
            res = amp - b                                       # (m,)
        else:
            res = torch.abs(ax) - b[:, None]                    # (m, r)
        if reduce is None:
            obj_all = _norm(res) if scale_by_row \
                else torch.linalg.vector_norm(res, dim=0)
            nax2, ny2, njm2, ndy2 = _fro2(ax), _fro2(y), _fro2(j_m), \
                _fro2(y - y0)
        else:
            (aty,), obj_all, sums = fused_row_sums(
                reduce, (torch.view_as_real(aty),),
                torch.sum(res * res, dim=0),
                [torch.stack([_fro2(p) for p in (ax, y, j_m, y - y0)])])
            aty = torch.view_as_complex(aty)
            nax2, ny2, njm2, ndy2 = sums[0]
        if has_z:
            # Z-update (ref :423-485) and N-dual (ref :338-341)
            z = prox(x + c["n_dual"] / mu, mu)
            j_n = x - z
            n_dual = c["n_dual"] + mu * j_n
        else:
            z, n_dual = z0, None

        # best-so-far (ref :343-361)
        if scale_by_row:
            obj = obj_all
            x_best, y_best = x, y
        else:
            objs = obj_all
            j = torch.argmin(objs)                       # first on ties
            obj = objs[j]
            x_best = x.index_select(1, j[None])[:, 0]
            y_best = y.index_select(1, j[None])[:, 0]
        better = obj < c["opt_obj"]

        # convergence tests (ref :363-375 / inferMinL2.m:303-315); the
        # row sums are global
        nax, ny, naty = torch.sqrt(nax2), torch.sqrt(ny2), _norm(aty)
        if has_z:
            nx, nz = _norm(x), _norm(z)
            dz2 = _fro2(z - z0)
            res_prim = torch.sqrt(njm2 + _fro2(j_n))
            res_dual = mu * torch.sqrt(_fro2(aty - aty0) + dz2)
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
            res_dual = mu * _norm(aty - aty0)
            res_comb = torch.sqrt(res_prim ** 2 + ndy2)
            t_prim = (tol_abs * math.sqrt(m * r)
                      + tol_rel * torch.maximum(nax, ny))
            t_dual = tol_abs * math.sqrt(n * r) + tol_rel * naty
            t_comb = (tol_abs * math.sqrt(m * r * 2)
                      + tol_rel * torch.sqrt(torch.maximum(nax, ny) ** 2
                                             + ny ** 2))
        converged = ((res_prim < t_prim) & (res_dual < t_dual)) \
            | (res_comb < t_comb)
        # mu adaptation (ref :377-382)
        mu_new = torch.where(res_comb > c["last_res"] * 0.9, mu * rho, mu)
        return dict(y=y, z=z, m_dual=m_dual, n_dual=n_dual, aty=aty,
                    mu=mu_new, last_res=res_comb,
                    opt_obj=torch.minimum(obj, c["opt_obj"]),
                    opt_x=torch.where(better, x_best, c["opt_x"]),
                    opt_y=torch.where(better, y_best, c["opt_y"]),
                    it=c["it"] + 1, done=converged)

    for trip in range(maxiter):
        if trip and trip % CHECK_EVERY == 0 and _all_done(c["done"], reduce):
            break
        if reduce is not None:
            reduce.trips += 1
        new = body(c)
        keep = c["done"]
        c = {k: None if new[k] is None else torch.where(keep, c[k], new[k])
             for k in _STATE}
    infer_admm.trips += int(c["it"])
    return c["opt_x"], c["opt_y"], c["done"]


infer_admm.trips = 0


def _all_done(done, reduce: RowHook) -> bool:
    """The loop's exit test, read on the host; a row-sharded solve
    all-reduces its any-active flag with MAX first."""
    if reduce is None:
        return bool(done)
    return not any_active(~done, reduce)


def _quality(a_test, b_test, x):
    """1 - ||(|A_test x|) - B_test|| / ||B_test||  (ref :68)."""
    return 1.0 - _norm(torch.abs(a_test @ x) - b_test) / _norm(b_test)


def _make_prox(kind: str, nt: int, nr: int, m: int, n: int,
               use_rank_one: bool, cfg: AdmmConfig, eig_backend: str):
    if kind == "nuclear":
        return lambda z, mu: nuclear_prox(z, 1.0 / mu, eig_backend)
    ladder = profile_ladder(nt, nr, m, n, use_rank_one,
                            cfg.profile.rank_mults, cfg.profile.fractions,
                            mode=cfg.profile.ladder)
    return lambda z, mu: spectral_profile_prox(z, nt, nr, ladder, eig_backend)


def _loop_kw(cfg: AdmmConfig) -> dict:
    return dict(mu0=cfg.mu0, rho=cfg.rho, tol_rel=cfg.tol_rel,
                tol_abs=cfg.tol_abs, maxiter=cfg.maxiter)


def _orthonormalize(x, eig_backend: str = "jacobi"):
    """X <- X eigvec(X^H X), eigenvectors descending (ref :263-264)."""
    g = x.mH @ x
    _, v = eigh_desc(0.5 * (g + g.mH), eig_backend)
    return x @ v


def _impl(a, b, xs, nt, nr, use_rank_one: bool, cfg: AdmmConfig,
          prox_kind: str, eig_backend: str, ladder_m=None):
    """inferLowRankImpl: over-parameterized solve, orthonormalize, per-column
    solve (ref: inferLowRankV4_multi.m:111-271).  ``ladder_m`` overrides
    the row count of the ladder selection.  Returns ``(x (n,), y (m,),
    converged)``.

    The ridge lambda is folded into U (exact at mu = 1; the reference
    re-inverts inv(A^H A + (1 + lambda/mu) I) each trip, but every
    reference call site passes lambda = 0 except the version > 4
    escalation, see :mod:`.dispatch`), as in the JAX package.
    """
    m, n = a.shape
    lm = m if ladder_m is None else ladder_m
    prox = _make_prox(prox_kind, nt, nr, lm, n, use_rank_one, cfg,
                      eig_backend)
    u_mat = _precompute_u(a, reg=1.0 + cfg.lam)
    kw = _loop_kw(cfg)
    x, _, _ = infer_admm(a, b, xs, scale_by_row=True, prox=prox,
                         u_mat=u_mat, **kw)
    x = _orthonormalize(x, eig_backend)
    return infer_admm(a, b, x, scale_by_row=False, prox=prox, u_mat=u_mat,
                      **kw)


def _refine_cond(a, b, x0, nt, nr, rank_one_flag: bool, cfg: AdmmConfig,
                 prox_kind: str, eig_backend: str, ladder_m=None):
    """Full-data refinement on the ladder that ``rank_one_flag`` picks
    (ref :92, :100).  Returns ``(x (n, 1), y (m, 1))``."""
    m, n = a.shape
    lm = m if ladder_m is None else ladder_m
    prox = _make_prox(prox_kind, nt, nr, lm, n, rank_one_flag, cfg,
                      eig_backend)
    x, y, _ = infer_admm(a, b, x0, scale_by_row=True, prox=prox,
                         **_loop_kw(cfg))
    return x, y


def _normalize_problem(a, b, tol_abs):
    """Scale A to ||A||_F = sqrt(m_eff), b to unit norm (ref :27-38).

    ``m_eff`` counts the ACTIVE rows (b > 0): padding rows (A_i = 0,
    b_i = 0) leave the normalization, and so the ridge in U, as for the
    unpadded problem (the tracker pads its window to a fixed shape).
    """
    rdt = a.real.dtype
    b = b.to(rdt)
    m_eff = torch.clamp(torch.sum(b > 0), min=1).to(rdt)
    a_norm = _norm(a) / torch.sqrt(m_eff)
    a_norm = torch.where(a_norm < tol_abs, 1.0, a_norm)
    b_norm = _norm(b)
    b_norm = torch.where(b_norm < tol_abs, 1.0, b_norm)
    return a / a_norm.to(a.dtype), b / b_norm, a_norm, b_norm


def _split(generator, m, frac, use_floor=True, device=None):
    """(train, test) rows: a random permutation drawn on the CPU from
    ``generator``, floor (or ceil) of m * frac train rows."""
    k = int(math.floor(m * frac)) if use_floor else int(math.ceil(m * frac))
    perm = torch.randperm(m, generator=generator).to(device)
    return perm[:k], perm[k:]


def _similarity(x_a, x_b):
    return (torch.abs(torch.vdot(x_a, x_b))
            / torch.clamp(_norm(x_a) * _norm(x_b), min=1e-30))


def solve_lowrank_multi(generator: Optional[torch.Generator], a, b,
                        nt: int, nr: int, cfg: AdmmConfig = AdmmConfig(),
                        prox_kind: str = "spectral_profile",
                        eig_backend: str = "jacobi",
                        n_restarts: Optional[int] = None,
                        ladder_m: Optional[int] = None,
                        x_seed=None) -> AdmmResult:
    """The 2ACE "A2" solver (ADMMLowRankV4, ref: inferLowRankV4_multi.m:5-109)
    on complex ``a`` (m, n) and real ``b`` (m,), on a's device.

    Per restart i (``fold_in(generator, i)``): a train/test split, the
    spectral init, ``_impl``, the held-out quality and, below
    ``cfg.quality_threshold``, a re-solve with the rank-1 ladder (a host
    gate; the nuclear prox has none).  The best restart (first on ties) is
    refined on all the data on its ladder and rolled back if the refine
    wandered off (similarity below ``cfg.similarity_threshold`` while the
    restart was good); the result is rescaled.  As in the JAX package the
    refine gate uses the best restart's quality, and on rollback y is the
    full-codebook prediction A x.

    Rows with ``b == 0`` are inactive padding by contract (their A rows are
    zero too); ``ladder_m`` gives the active row count the ladders follow.
    ``x_seed`` (n,) is planted in column 0 of every restart's init, scaled
    to the spectral columns' norm.
    """
    n_restarts = cfg.n_restarts if n_restarts is None else n_restarts
    m, n = a.shape
    r = min(cfg.rank, m, n)
    lm_full = m if ladder_m is None else ladder_m
    lm_tr = int(math.floor(lm_full * cfg.cc_frac))
    thr = cfg.quality_threshold
    with _precision(cfg):
        a, b, a_norm, b_norm = _normalize_problem(a, b, cfg.tol_abs)
        best = None
        for i in range(n_restarts):
            gi = fold_in(generator, i)
            train, test = _split(fold_in(gi, 0), m, cfg.cc_frac,
                                 device=a.device)
            a_tr, b_tr, a_te, b_te = a[train], b[train], a[test], b[test]
            xs = spectral_initialize(a_tr, b_tr, r, generator=fold_in(gi, 1))
            if x_seed is not None:
                seed = x_seed.to(xs.dtype)
                seed = seed / torch.clamp(torch.linalg.vector_norm(seed),
                                          min=1e-30)
                col = torch.linalg.vector_norm(xs, dim=0).mean()
                xs = xs.clone()
                xs[:, 0] = seed * col.to(xs.dtype)
            x, y, _ = _impl(a_tr, b_tr, xs, nt, nr, False, cfg, prox_kind,
                            eig_backend, ladder_m=lm_tr)
            q = _quality(a_te, b_te, x)
            # rank-1 retry when the quality is poor (ref :73-77); the
            # nuclear prox ignores the ladder, so it has no retry
            rank_one = prox_kind != "nuclear" and float(q) < thr
            if rank_one:
                x, y, _ = _impl(a_tr, b_tr, xs, nt, nr, True, cfg, prox_kind,
                                eig_backend, ladder_m=lm_tr)
                q = _quality(a_te, b_te, x)
            if best is None or float(q) > float(best[2]):
                best = (x, y, q, rank_one)
        x_max, _, q_max, rank_one = best

        # full-data refinement with similarity rollback (ref :89-101)
        x_ref, y_ref = _refine_cond(a, b, x_max[:, None], nt, nr, rank_one,
                                    cfg, prox_kind, eig_backend,
                                    ladder_m=lm_full)
        x_ref, y_ref = x_ref[:, 0], y_ref[:, 0]
        rollback = (q_max > thr) & (_similarity(x_max, x_ref)
                                    < cfg.similarity_threshold)
        x = torch.where(rollback, x_max, x_ref)
        y = torch.where(rollback, a @ x_max, y_ref)
    scale = (b_norm / a_norm).to(a.dtype)
    return AdmmResult(x=x * scale, y=y * scale, quality=q_max,
                      converged=torch.ones((), dtype=torch.bool,
                                           device=a.device))


def solve_minl2(generator: Optional[torch.Generator], a, b,
                cfg: AdmmConfig = AdmmConfig()) -> AdmmResult:
    """Version-0 ADMM without the low-rank constraint (inferMinL2,
    ref: inferMinL2.m:1-65): one ceil(0.95 m) split, the pinv(A) X-update,
    a quality-gated refine with similarity rollback."""
    m, n = a.shape
    r = min(cfg.rank, m, n)
    kw = _loop_kw(cfg)
    with _precision(cfg):
        a, b, a_norm, b_norm = _normalize_problem(a, b, cfg.tol_abs)
        train, test = _split(fold_in(generator, 0), m, 0.95, use_floor=False,
                             device=a.device)
        a_tr, b_tr, a_te, b_te = a[train], b[train], a[test], b[test]
        xs = spectral_initialize(a_tr, b_tr, r,
                                 generator=fold_in(generator, 1))
        u_tr = _pinv(a_tr)
        x, _, _ = infer_admm(a_tr, b_tr, xs, scale_by_row=True, u_mat=u_tr,
                             **kw)
        x = _orthonormalize(x)
        x, y, converged = infer_admm(a_tr, b_tr, x, scale_by_row=False,
                                     u_mat=u_tr, **kw)
        q = _quality(a_te, b_te, x)
        if float(q) > cfg.quality_threshold:
            xr, yr, _ = infer_admm(a, b, x[:, None], scale_by_row=True, **kw)
            xr, yr = xr[:, 0], yr[:, 0]
            keep = _similarity(x, xr) < cfg.similarity_threshold
            # on rollback: the full-codebook prediction A x (see above)
            x, y = torch.where(keep, x, xr), torch.where(keep, a @ x, yr)
        else:
            y = a @ x
    scale = (b_norm / a_norm).to(a.dtype)
    return AdmmResult(x=x * scale, y=y * scale, quality=q,
                      converged=converged)
