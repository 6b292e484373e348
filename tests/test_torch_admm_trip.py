"""K7, the per-op loop's trip glue (``ops/kernels/admm_trip.py``,
``csrc/admm_trip.cu``).

On the CPU a trip takes the plain version, which counts no launch and
freezes the lanes that were not active.  The ``gpu``-marked tests hold the CUDA passes against
the plain version on the card, one trip at a time, at the batch cells'
lane shapes and at ragged ones.  Imports no JAX: the ``gpu`` tests run on
the card.
"""

import math

import numpy as np
import pytest
import torch

from twoace_tpu_torch.config import AdmmConfig
from twoace_tpu_torch.ops import kernels
from twoace_tpu_torch.ops import pair_solver as tps
from twoace_tpu_torch.ops.admm_loop import LoopState, _contiguous, admm_loop
from twoace_tpu_torch.ops.cplx import LadderArrays, Pair, conj, transpose
from twoace_tpu_torch.ops.kernels import admm_trip as k7
from twoace_tpu_torch.ops.kernels import (fused_prox_dual_t, fused_zprox_t,
                                          pair_matmul, pair_matmul_plain,
                                          prox_dual_t_plain, zprox_t_plain)
from twoace_tpu_torch.ops.prox import profile_ladder_arrays

NT = NR = 4
N = NT * NR


# ---------------------------------------------------------------------------
# small problems, on the CPU or the card

def _problem(variant, *, g_=2, p_=2, r=3, nt=NT, nr=NR, m=40, seed=0,
             device="cpu", kernels_on_card=False):
    """``(args, kw)`` of :func:`admm_loop` for one of the loop's forms:
    "row" (scale_by_row), "column", "zfree" (no Z-prox), "r1" (one
    column), "anchor" (a proximal anchor), "masked" (b = 0, A_i = 0 on 5
    rows) or "nuclear".  Two-path channels through random-phase blocks,
    one a group; the state from the solver's own initialization."""
    rng = np.random.default_rng(seed)
    n = nt * nr
    r = 1 if variant == "r1" else r
    a = np.exp(1j * np.pi / 2 * rng.integers(0, 4, (g_, m, n))) / np.sqrt(n)
    h = (rng.normal(size=(g_, p_, 2, n))
         + 1j * rng.normal(size=(g_, p_, 2, n))).sum(2)
    b = np.abs(np.einsum("gmn,gpn->gpm", a, h))
    if variant == "masked":
        a[:, :5] = 0.0
        b[..., :5] = 0.0
    x0 = rng.normal(size=(g_, p_, r, n)) + 1j * rng.normal(size=(g_, p_, r, n))

    def pair(v):
        return Pair(torch.tensor(v.real, dtype=torch.float32, device=device),
                    torch.tensor(v.imag, dtype=torch.float32, device=device))

    at, x0t = pair(a), pair(x0)
    bt = torch.tensor(b, dtype=torch.float32, device=device)
    scale_by_row = variant != "column"
    prox_kind = "nuclear" if variant == "nuclear" else "spectral_profile"
    lad = None
    if variant not in ("zfree", "nuclear"):
        one = profile_ladder_arrays(nt, nr, m, n, variant == "r1",
                                    device=device)
        lad = LadderArrays(one.ranks.expand(g_, p_, -1),
                           one.fracs.expand(g_, p_, -1))
    weight = 0.5 if variant == "anchor" else 0.0
    with tps.no_tf32():
        if variant == "zfree":
            u = tps.pinv_u_pair(at)
        else:
            u = tps.precompute_u_pair(at, reg=1.0 + weight)
        y, z, v = tps.admm_init_pair(at, bt, x0t, scale_by_row=scale_by_row,
                                     nt=nt, nr=nr, ladder=lad,
                                     prox_kind=prox_kind)
    lane_lad = None if lad is None else LadderArrays(
        lad.ranks.reshape(g_ * p_, -1).contiguous(),
        lad.fracs.reshape(g_ * p_, -1).contiguous())
    on_card = kernels_on_card
    if variant == "zfree":
        z_prox = None
    elif variant == "nuclear":
        def z_prox(zz, vv, mu_l):
            return tps._nuclear_prox_t(zz, 1.0 / mu_l), vv
    else:
        def z_prox(zz, vv, mu_l):
            fn = fused_zprox_t if on_card else zprox_t_plain
            return fn(zz, vv, nt, nr, lane_lad)
    mu0 = torch.full((g_, p_), 1e-3, device=device)
    kw = dict(scale_by_row=scale_by_row,
              pair_gemm=pair_matmul if on_card else pair_matmul_plain,
              prox_dual=fused_prox_dual_t if on_card else prox_dual_t_plain,
              z_prox=z_prox, trip=k7.admm_trip if on_card else k7.trip_plain,
              rho=1.03, tol_rel=1e-3, tol_abs=1e-8)
    if weight:
        kw["anchor"] = Pair(x0t.re * weight, x0t.im * weight)
    return (at, bt, u, y, z, v, mu0), kw


def _loop_of(args, kw):
    a, b, u, y, z, v, mu0 = args
    anchor = kw.get("anchor")
    return k7.Loop(_contiguous(transpose(a)), _contiguous(conj(a)),
                   _contiguous(conj(u)), b.reshape(-1, b.shape[-1]),
                   pair_gemm=kw["pair_gemm"], prox_dual=kw["prox_dual"],
                   z_prox=kw["z_prox"], anchor=anchor, reduce=None,
                   scale_by_row=kw["scale_by_row"], rho=kw["rho"],
                   tol_rel=kw["tol_rel"], tol_abs=kw["tol_abs"],
                   m=y.re.shape[-1], n=z.re.shape[-1], r=y.re.shape[2],
                   m_thr=y.re.shape[-1])


def _fields(c):
    out = {}
    for name, f in zip(LoopState._fields, c):
        if isinstance(f, Pair):
            out[name + ".re"], out[name + ".im"] = f.re, f.im
        else:
            out[name] = f
    return out


VARIANTS = ("row", "column", "zfree", "r1", "anchor", "masked", "nuclear")


def _launches():
    return sum(fn.launches for fn in k7.PASSES)


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_loop_gives_what_the_loop_gave(variant):
    """On the CPU :func:`admm_loop` runs each trip through the plain
    version and counts no K7 launch.  One plain trip from a drawn state
    (some lanes at their bound, some converged) leaves that state as it
    was, keeps every field of the lanes that were not active bit for bit,
    and on the active ones counts the trip, keeps the least objective and
    either keeps mu or grows it by rho."""
    args, kw = _problem(variant)
    warm = 4 if variant in ("row", "column") else 0
    before = _launches()
    got = admm_loop(*args, maxiter=30, warm_iters=warm, **kw)
    assert int(got[3].min()) > 0 and int(got[3].max()) <= 30 + warm
    loop = _loop_of(args, kw)
    start = _state(loop, *args[3:7], seed=7)
    kept = {k: v.clone() for k, v in _fields(start).items()}
    new = k7.trip_plain(start, loop, 12)
    assert _launches() == before
    active = (start.it < 12) & ~start.converged
    assert 0 < int(active.sum()) < active.numel()
    s, g = _fields(start), _fields(new)
    for name, t in s.items():
        assert torch.equal(t, kept[name]), name
        assert torch.equal(g[name][~active], t[~active]), name
    assert torch.equal(new.it[active], start.it[active] + 1)
    assert bool((new.opt_obj[active] <= start.opt_obj[active]).all())
    mu, mu0 = new.mu[active], start.mu[active]
    assert bool(((mu == mu0) | (mu == mu0 * kw["rho"])).all())


def test_cpu_trip_takes_the_plain_version():
    """One trip of a CPU state through :func:`admm_trip` is the plain
    version's, bit for bit, and counts no launch; another device
    raises."""
    args, kw = _problem("column")
    loop = _loop_of(args, kw)
    state = _state(loop, *args[3:7])
    before = kernels.launch_counts()
    got = k7.admm_trip(state, loop, 5)
    want = k7.trip_plain(state, loop, 5)
    assert kernels.launch_counts() == before
    assert loop.work is None
    for g, w in zip(got, want):
        for gt, wt in (zip(g, w) if isinstance(g, Pair) else [(g, w)]):
            assert torch.equal(gt, wt)
    meta = LoopState(*(Pair(f.re.to("meta"), f.im.to("meta"))
                       if isinstance(f, Pair) else f.to("meta")
                       for f in state))
    with pytest.raises(ValueError, match="unsupported device"):
        k7.admm_trip(meta, loop, 5)


def test_passes_are_in_launch_counts():
    """Every K7 pass counts its launches in ``launch_counts()``."""
    counts = kernels.launch_counts()
    for fn in k7.PASSES:
        assert fn in kernels.KERNELS and fn.__name__ in counts


def _state(loop, y, z, v, mu0, seed=None):
    """The loop's state after its initialization (as :func:`admm_loop`
    makes it), or with ``seed`` a drawn one: duals, mu, the best-so-far,
    ``it`` and ``converged`` at random, a third of the lanes not
    active."""
    g_, p_, r, m = y.re.shape
    n = z.re.shape[-1]
    dev = y.re.device
    k_opt = r if loop.scale_by_row else 1
    nx = loop.a_conj.re.shape[-1]
    if seed is None:
        def zeros(*shape):
            return Pair(torch.zeros(shape, device=dev),
                        torch.zeros(shape, device=dev))
        return LoopState(
            y=y, z=z, m_dual=zeros(g_, p_, r, m), n_dual=zeros(g_, p_, r, n),
            aty=loop.ah_sum(y), v_basis=v, mu=mu0,
            last_res=torch.full((g_, p_), math.inf, device=dev),
            opt_obj=torch.full((g_, p_), math.inf, device=dev),
            opt_x=zeros(g_, p_, k_opt, nx), opt_y=zeros(g_, p_, k_opt, m),
            it=torch.zeros((g_, p_), dtype=torch.int32, device=dev),
            converged=torch.zeros((g_, p_), dtype=torch.bool, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def rpair(*shape, scale=1.0):
        return Pair(randn(*shape, scale=scale), randn(*shape, scale=scale))

    lanes_ = g_ * p_
    it = torch.randint(0, 12, (g_, p_), generator=gen, device=dev,
                       dtype=torch.int32)
    converged = torch.rand((g_, p_), generator=gen, device=dev) < 0.2
    it.view(-1)[0], converged.view(-1)[0] = 12, False       # it at the bound
    it.view(-1)[1], converged.view(-1)[1] = 3, True
    it.view(-1)[2], converged.view(-1)[2] = 3, False
    opt_obj = torch.rand((g_, p_), generator=gen, device=dev) * 2.0
    opt_obj.view(-1)[: lanes_ // 4] = math.inf
    b_scale = float(loop.b_lanes.abs().max())
    # masked rows (b = 0) keep Y and the M-dual at 0, as the loop keeps them
    live = (loop.b_lanes > 0).view(g_, p_, 1, m).float()
    md = rpair(g_, p_, r, m, scale=1e-3)
    return LoopState(
        y=Pair(y.re + randn(*y.re.shape, scale=0.1 * b_scale) * live,
               y.im + randn(*y.re.shape, scale=0.1 * b_scale) * live),
        z=z, m_dual=Pair(md.re * live, md.im * live),
        n_dual=rpair(g_, p_, r, n, scale=1e-3),
        aty=loop.ah_sum(y), v_basis=v,
        mu=torch.rand((g_, p_), generator=gen, device=dev) * 0.5 + 1e-3,
        last_res=torch.rand((g_, p_), generator=gen, device=dev),
        opt_obj=opt_obj, opt_x=rpair(g_, p_, k_opt, nx),
        opt_y=rpair(g_, p_, k_opt, m), it=it, converged=converged)


# ---------------------------------------------------------------------------
# on the card

def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


#: (G, P, r, nt, m): the batch cells' lane shapes, lanes cut, batch256's
#: first pass (m 972) and batch32's (m 3891, 3 past a multiple of 4); and
#: rows 1 and 2 past a multiple of 4 over more than one block of the row
#: sums, with r m and r n not multiples of 4, so that the lanes' state
#: starts off a 16-byte boundary
CARD_SHAPES = ((3, 16, 20, 16, 972), (3, 2, 20, 32, 3891),
               (2, 3, 3, 5, 1029), (2, 3, 5, 3, 2050))
#: the sums' relative tolerance: the passes add in another order than
#: torch's reductions, over up to 20 x 3891 float32 terms
SUM_RTOL = 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=("batch256", "batch32", "ragged1", "ragged2"))
@pytest.mark.parametrize("variant", VARIANTS[:6])
def test_trip_matches_plain_on_card(variant, shape):
    """One trip from a drawn state (some lanes at their bound, some
    converged): the CUDA passes against the plain version on the card.
    The fields the passes compute elementwise, and every field the kernels
    K4, K1 and K2 give, agree bit for bit; the small fields built from sums
    agree within SUM_RTOL, and the flags exactly; the lanes that were not
    active keep every field bit for bit; neither route writes into the
    state it is given; one trip launches at most 8 K7 passes."""
    _require_cuda()
    g_, p_, r, nt, m = shape
    args, kw = _problem(variant, g_=g_, p_=p_, r=r, nt=nt, nr=nt, m=m,
                        device="cuda", kernels_on_card=True)
    loop = _loop_of(args, kw)
    start = _state(loop, *args[3:7], seed=7)
    before_trip = {k: v.clone() for k, v in _fields(start).items()}
    want = k7.trip_plain(start, loop, 12)
    before = _launches()
    got = k7.admm_trip(start, loop, 12)
    torch.cuda.synchronize()
    assert _launches() - before <= 8
    for name, t in _fields(start).items():
        assert torch.equal(t, before_trip[name]), name
    active = ((start.it < 12) & ~start.converged).reshape(-1)
    assert 0 < int(active.sum()) < active.numel()
    g, w, s = _fields(got), _fields(want), _fields(start)
    for name in g:
        gl = g[name].reshape(active.numel(), -1)
        wl = w[name].reshape(active.numel(), -1)
        if name in ("last_res", "opt_obj"):
            torch.testing.assert_close(gl, wl, rtol=SUM_RTOL, atol=0.0)
        else:
            assert torch.equal(gl, wl), name
        sl = s[name].reshape(active.numel(), -1)
        if sl.shape == gl.shape:
            assert torch.equal(gl[~active], sl[~active]), name


@pytest.mark.gpu
def test_commit_takes_the_first_least_column_on_card():
    """The per-column argmin: where columns tie (and where one is NaN)
    the commit pass takes the first, as ``torch.argmin`` does."""
    _require_cuda()
    nl, r, m, n = 4, 5, 12, 8
    dev = "cuda"
    rows = torch.ones((nl, 1, k7.row_slots(r, True)), device=dev)
    rows[..., 4:] = torch.tensor([[4.0, 1.0, 1.0, 2.0, 1.0],
                                  [1.0, 1.0, 1.0, 1.0, 1.0],
                                  [9.0, 3.0, 2.0, 2.0, 5.0],
                                  [9.0, 9.0, math.nan, 1.0, math.nan]],
                                 device=dev)[:, None]
    cols = torch.ones((nl, 1, k7.COL_SLOTS), device=dev)
    x = Pair(torch.arange(nl * r * n, dtype=torch.float32,
                          device=dev).view(nl, r, n),
             -torch.arange(nl * r * n, dtype=torch.float32,
                           device=dev).view(nl, r, n))
    yn = Pair(torch.arange(nl * r * m, dtype=torch.float32,
                           device=dev).view(nl, r, m),
              torch.zeros((nl, r, m), device=dev))
    small = k7.Small(torch.full((nl,), 0.1, device=dev),
                     torch.ones(nl, device=dev),
                     torch.full((nl,), math.inf, device=dev),
                     torch.zeros(nl, dtype=torch.int32, device=dev),
                     torch.zeros(nl, dtype=torch.bool, device=dev))
    out = k7.Small(*(torch.empty_like(t) for t in small))
    old = (Pair(torch.zeros((nl, 1, n), device=dev),
                torch.zeros((nl, 1, n), device=dev)),
           Pair(torch.zeros((nl, 1, m), device=dev),
                torch.zeros((nl, 1, m), device=dev)))
    opt_x, opt_y = (Pair(torch.full_like(p.re, 7.0),
                         torch.full_like(p.im, 7.0)) for p in old)
    k7.trip_commit(rows, cols, small, out, (1e-4, 1.03, 0.0, 0.0, 0.0), [],
                   x, yn, old, (opt_x, opt_y), r=r, per_column=True,
                   has_z=True, bound=10)
    torch.cuda.synchronize()
    want_j = torch.argmin(rows[:, 0, 4:].sqrt(), dim=-1)
    assert want_j.tolist() == [1, 0, 2, 2]
    for lane, j in enumerate(want_j.tolist()[:3]):
        assert torch.equal(opt_x.re[lane, 0], x.re[lane, j])
        assert torch.equal(opt_y.re[lane, 0], yn.re[lane, j])
    # a NaN objective is no improvement (the lane keeps its old best-so-far),
    # but it is the best-so-far's value
    assert not opt_x.re[3].any() and not opt_y.re[3].any()
    assert not any(t.any() for p in old for t in p)
    assert torch.isnan(out.opt_obj[3]) and out.it.tolist() == [1] * nl


def _batch_problem(device, seed=3):
    rng = np.random.default_rng(seed)
    m, batch = 3 * N, 3
    a = np.exp(1j * np.pi / 2 * rng.integers(0, 4, (m, N))) / np.sqrt(N)
    h = (rng.normal(size=(batch, 2, N))
         + 1j * rng.normal(size=(batch, 2, N))).sum(1)
    b = np.abs(h @ a.T)
    at = Pair(torch.tensor(a.real, dtype=torch.float32, device=device),
              torch.tensor(a.imag, dtype=torch.float32, device=device))
    return at, torch.tensor(b, dtype=torch.float32, device=device), h


#: the port's float32 bar for a noiseless small batch solve, NMSE in dB
BATCH_DB_BAR = -60.0


@pytest.mark.gpu
def test_batch_solve_on_card_matches_plain_and_cpu(monkeypatch):
    """A whole small batch solve (4x4, m 48, 3 channels, 2 restarts) from
    the same draws on the CPU, on the card, and on the card with every
    trip through the plain version: the card's loops ran K7, at most 8
    launches a lockstep trip; each instance's trips within one a loop it
    ran (two passes a restart and the refine) of the plain version's on
    the card, whose products are the same; every recovery under
    BATCH_DB_BAR.  The CPU's trip counts are not held: its products round
    otherwise than K4's 3xTF32 and the loop amplifies that (with the glue
    in torch ops on the card as well, the card's counts differ from the
    CPU's by up to 11 on these draws, and by 141 on one instance of
    another)."""
    _require_cuda()
    cfg = AdmmConfig(rank=3, maxiter=200, n_restarts=2, warm_iters=8,
                     stage1_maxiter=60, stage2_maxiter=80)
    out = {}
    for route in ("cpu", "k7", "plain"):
        device = "cpu" if route == "cpu" else "cuda"
        if route == "plain":
            monkeypatch.setattr(tps, "admm_trip", k7.trip_plain)
        at, bt, h = _batch_problem(device)
        before = _launches()
        k4 = pair_matmul.launches
        res = tps.solve_lowrank_multi_pair_batch(
            torch.Generator().manual_seed(5), at, bt, NT, NR, cfg)
        x = torch.complex(res.x.re, res.x.im).cpu().numpy().astype(complex)
        phase = np.exp(-1j * np.angle(np.sum(np.conj(h) * x, axis=-1)))
        err = np.sum(np.abs(x * phase[:, None] - h) ** 2, -1)
        db = 10 * np.log10(err / np.sum(np.abs(h) ** 2, -1))
        out[route] = (res.iters.cpu(), db, _launches() - before,
                      (pair_matmul.launches - k4) // 4)
    it_k7, _, k7_launches, trips = out["k7"]
    assert 0 < k7_launches <= 8 * trips
    assert out["plain"][2] == 0
    assert (it_k7 - out["plain"][0]).abs().max() <= cfg.n_restarts * 2 + 1
    for route, (_, db, _, _) in out.items():
        assert db.max() < BATCH_DB_BAR, route
