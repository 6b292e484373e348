"""K3, the loop kernel (``twoace_tpu_torch.ops.kernels.infer_admm``).

On the CPU its wrapper runs the plain version, which is held against the
Pallas megakernel it replaces (``fused_infer_admm`` in interpret mode, as
``tests/test_pallas.py`` runs it) lane by lane, and against JAX's XLA
``infer_admm_pair``.  The CUDA kernel is held against the plain version on
the card by the ``gpu``-marked tests (and by chip_smoke.py).
"""

import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_parity import (codebook, jpair, nmse_db, np_pair, require_cuda,
                          steer, tpair)
from twoace_tpu.ops import pair_solver as jps
from twoace_tpu.ops.pallas.solver_kernel import fused_infer_admm as pallas_k3
from twoace_tpu.ops.prox import profile_ladder
from twoace_tpu_torch.ops import kernels
from twoace_tpu_torch.ops import pair_solver as tps
from twoace_tpu_torch.ops.cplx import LadderArrays, Pair
from twoace_tpu_torch.ops.kernels import infer_admm as k3
from twoace_tpu_torch.ops.prox import profile_ladder_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NT = NR = 4
N = NT * NR
M = 2 * N
R = 6
LOOP = dict(rho=1.03, tol_rel=0.1, tol_abs=1e-8)   # stops lanes early


def _problem(seed=0, lanes=2, nt=NT, nr=NR, m=M):
    """One codebook, ``lanes`` channels, and the prepared state of each
    lane (the port's own initialization, handed to both packages).  Lane
    0 carries the train-split ladder, lane 1 the rank-1 ladder; both are
    padded with f = 0 levels."""
    n = nt * nr
    rng = np.random.default_rng(seed)
    a = codebook(rng, m, n)
    xs = [np.outer(steer(nr, 0.3 + 0.4 * i), steer(nt, -0.2).conj()).T
          .reshape(-1) + 0.4 * np.outer(steer(nr, -0.7), steer(nt, 0.5 * i)
                                        .conj()).T.reshape(-1)
          for i in range(lanes)]
    b = np.abs(np.stack(xs) @ a.T).astype(np.float32)            # (P, m)
    x0 = (rng.normal(size=(lanes, R, n))
          + 1j * rng.normal(size=(lanes, R, n))).astype(np.complex64)
    static = [profile_ladder(nt, nr, m, n, i % 2 == 1) for i in range(lanes)]
    lads = [profile_ladder_arrays(nt, nr, m, n, i % 2 == 1)
            for i in range(lanes)]
    lad = LadderArrays(torch.stack([l.ranks for l in lads]),
                       torch.stack([l.fracs for l in lads]))
    assert float(lad.fracs.min()) == 0.0                       # padded
    at, bt = tpair(a[None]), torch.tensor(b[None])
    u = tps.precompute_u_pair(at)
    return a, b, x0, static, at, bt, u, lad


def _prepared(at, bt, x0, lad, scale_by_row):
    """The port's initialization of every lane: (y0, z0, v0)."""
    return tps.admm_init_pair(at, bt, tpair(x0[None]),
                              scale_by_row=scale_by_row, nt=NT, nr=NR,
                              ladder=lad)


@pytest.fixture(scope="module", params=[True, False],
                ids=["scale_by_row", "per_column"])
def k3_vs_pallas(request):
    sbr = request.param
    a, b, x0, static, at, bt, u, lad = _problem()
    y0, z0, v0 = _prepared(at, bt, x0, LadderArrays(lad.ranks[None],
                                                    lad.fracs[None]), sbr)
    mu0 = torch.full((1, 2), 1e-3)
    got = kernels.fused_infer_admm(at, bt, u, y0, z0, v0, mu0, lad, nt=NT,
                                   nr=NR, scale_by_row=sbr, maxiter=30, **LOOP)
    uj = jpair(np_pair(u)[0][0], np_pair(u)[1][0])
    want = []
    for i in range(2):
        def lane(p):
            return jpair(np_pair(p)[0][0, i], np_pair(p)[1][0, i])
        want.append(pallas_k3(
            jpair(a), jnp.asarray(b[i]), uj, lane(y0), lane(z0), lane(v0),
            1e-3, nt=NT, nr=NR, ladder=static[i], scale_by_row=sbr,
            maxiter=30, interpret=True, **LOOP))
    return sbr, got, want


def test_plain_matches_pallas_interpret(k3_vs_pallas):
    """K3's plain version against the Pallas megakernel lane by lane, with
    the padded per-lane ladders: the same trip count and converged bit,
    and opt_x / opt_y within atol 2e-4 of their scale (float32 rounding in
    another order over up to 30 trips)."""
    sbr, (ox, oy, conv, it), want = k3_vs_pallas
    its = []
    for i, (wx, wy, wconv, wit) in enumerate(want):
        assert int(it[0, i]) == int(wit)
        assert bool(conv[0, i]) == bool(wconv)
        its.append(int(wit))
        for got_p, want_p in ((ox, wx), (oy, wy)):
            g = np_pair(got_p)
            w = np_pair(want_p)
            for gg, ww in zip(g, w):
                ww = np.asarray(ww).reshape(gg[0, i].shape)
                np.testing.assert_allclose(gg[0, i], ww, rtol=0,
                                           atol=2e-4 * np.abs(ww).max())
    # the tolerance makes at least one lane stop before the cap
    assert min(its) < 30


@pytest.mark.parametrize("scale_by_row", [True, False])
def test_plain_matches_xla_infer_admm(scale_by_row):
    """The K3 route of the port's infer_admm_pair (on the CPU, the plain
    version) against JAX's XLA loop from the same x0 and U: the same trip
    count and iterate.  The per-column pass starts here from a random x0,
    far from its fixed point, where rounding in another order moves the
    iterate most (-54 dB between the two after 60 trips), so it is held
    to -50 dB; the first pass to 1e-4 of the scale of sum_k x_k x_k^H."""
    a, b, x0, static, at, bt, u, lad = _problem(seed=1)
    kw = dict(nt=NT, nr=NR, mu0=1e-3, rho=1.03, tol_rel=1e-4, tol_abs=1e-8,
              maxiter=60)
    got = tps.infer_admm_pair(at, bt, tpair(x0[None]),
                              scale_by_row=scale_by_row,
                              ladder=LadderArrays(lad.ranks[None],
                                                  lad.fracs[None]),
                              u_mat=u, **kw)
    uj = jpair(np_pair(u)[0][0], np_pair(u)[1][0])
    for i in range(2):
        xj, _, _, itj = jps.infer_admm_pair(
            jpair(a), jnp.asarray(b[i]), jpair(x0[i]),
            scale_by_row=scale_by_row, ladder=static[i], u_mat=uj,
            use_pallas=False, **kw)
        assert int(got[3][0, i]) == int(itj)
        xt = np_pair(got[0])
        xt = (xt[0][0, i] + 1j * xt[1][0, i]).reshape(-1, N)
        xw = np_pair(xj)
        xw = (xw[0] + 1j * xw[1]).reshape(-1, N)
        if scale_by_row:
            pt, pj = xt.T @ xt.conj(), xw.T @ xw.conj()
            np.testing.assert_allclose(pt, pj, atol=1e-4 * np.abs(pj).max())
        else:
            assert nmse_db(xt[0], xw[0]) < -50


def test_cpu_calls_count_no_launches():
    kernels.reset_launch_counts()
    a, b, x0, static, at, bt, u, lad = _problem()
    y0, z0, v0 = _prepared(at, bt, x0, LadderArrays(lad.ranks[None],
                                                    lad.fracs[None]), True)
    kernels.fused_infer_admm(at, bt, u, y0, z0, v0, torch.full((1, 2), 1e-3),
                             lad, nt=NT, nr=NR, scale_by_row=True,
                             maxiter=3, **LOOP)
    assert kernels.launch_counts()["fused_infer_admm"] == 0


def test_other_devices_raise_instead_of_falling_back():
    meta = lambda *s: torch.empty(s, device="meta")
    p = lambda *s: Pair(meta(*s), meta(*s))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.fused_infer_admm(
            p(1, M, N), meta(1, 2, M), p(1, N, N), p(1, 2, R, M),
            p(1, 2, R, N), p(1, 2, NR, NR), meta(1, 2),
            LadderArrays(meta(2, 4), meta(2, 4)), nt=NT, nr=NR,
            scale_by_row=True, maxiter=3, **LOOP)


def test_wrapper_checks_reject_what_the_kernel_does_not_take():
    a, b, x0, static, at, bt, u, lad = _problem()
    y0, z0, v0 = _prepared(at, bt, x0, LadderArrays(lad.ranks[None],
                                                    lad.fracs[None]), True)
    mu0 = torch.full((1, 2), 1e-3)
    good = (at, bt, u, y0, z0, v0, mu0, lad)
    k3._check(*good, NT, NR)
    with pytest.raises(ValueError, match="nt\\*nr"):
        k3._check(*good, 2, NR)
    with pytest.raises(ValueError, match="shape"):
        k3._check(at, bt[..., :-1], *good[2:], NT, NR)
    with pytest.raises(ValueError, match="shape"):
        k3._check(*good[:7], LadderArrays(lad.ranks[:1], lad.fracs[:1]),
                  NT, NR)
    big = Pair(torch.zeros(1, 2, 40, M), torch.zeros(1, 2, 40, M))
    with pytest.raises(ValueError, match="r <= 32"):
        k3._check(at, bt, u, big, z0, v0, mu0, lad, NT, NR)
    with pytest.raises(ValueError, match="float32"):
        k3._check(at, bt.double(), *good[2:], NT, NR)


def _meta_args(nt, nr, m, r=R, g=1, p=2):
    """Arguments of the wrapper's checks at a shape, as meta tensors."""
    n = nt * nr
    meta = lambda *s: torch.empty(s, device="meta")
    pair = lambda *s: Pair(meta(*s), meta(*s))
    return (pair(g, m, n), meta(g, p, m), pair(g, n, n), pair(g, p, r, m),
            pair(g, p, r, n), pair(g, p, nr, nr), meta(g, p),
            LadderArrays(meta(g * p, 4), meta(g * p, 4)))


#: shapes the 16-CTA kernel runs: the solver's 16x16 at m 1024, Vs_M's m
#: 3 (most CTAs own no row), two slices a CTA at nt 32, and the tests' 4x4
#: (most CTAs own no column)
RUN_SHAPES = [(16, 16, 1024), (16, 16, 3), (32, 8, 4096), (4, 4, 32)]
#: shapes it cannot take: five slices a CTA, 32x32 (249 KB a CTA), r 40
REJECTED = [(80, 16, R, "own 80 columns"), (32, 32, R, "shared memory"),
            (16, 16, 40, "r <= 32")]


@pytest.mark.parametrize("nt, nr, m", RUN_SHAPES)
def test_wrapper_takes_the_shapes_the_16_cta_kernel_runs(nt, nr, m):
    """The shapes the kernel runs pass the wrapper's checks of its
    arguments; whether a CTA's share fits is the kernel's own count,
    held on the card by ``test_kernel_layout_fits_the_card``."""
    k3._check(*_meta_args(nt, nr, m), nt, nr)
    k3._check(*_meta_args(nt, nr, m, r=32), nt, nr)


@pytest.mark.gpu
@pytest.mark.parametrize("nt, nr, m", RUN_SHAPES)
def test_kernel_layout_fits_the_card(nt, nr, m):
    """The kernel's own shared-memory count (C ``twoace_infer_admm_smem``)
    fits its limit at these shapes, at r 20 and r 32."""
    require_cuda()
    for r in (R, 32):
        assert 0 < k3.smem_bytes(r, nt, nr) <= k3.smem_limit()
        k3._check_fits(r, nt, nr)


@pytest.mark.gpu
@pytest.mark.parametrize("nt, nr, r, match", REJECTED)
def test_wrapper_rejects_what_the_16_cta_kernel_cannot_take(nt, nr, r, match):
    """What the kernel cannot hold is refused before a launch, by the
    argument checks (r) or by the kernel's own count of a CTA's columns
    and shared memory."""
    require_cuda()
    with pytest.raises(ValueError, match=match):
        k3._check(*_meta_args(nt, nr, 64, r=r), nt, nr)
        k3._check_fits(r, nt, nr)


def test_workspace_holds_lane_state_then_split_constants_per_group():
    """The workspace: each lane's Y, M-dual, Y - M/mu for both of the
    next trip's mu, X and rhs, then one set of
    split constants (TF32 halves of A's re, im, re + im, re - im and of
    U's re, im, re - im) per group of lanes, not per lane."""
    assert k3.CLUSTER == 16
    assert k3.lane_floats(R, M, N) == 8 * R * M + 4 * R * N
    assert k3.lane_floats(3, 5, 16) == 8 * 3 * 5 + 4 * 3 * 16   # 312
    assert k3.lane_floats(3, 5, 15) % 4 == 0                   # 16-B aligned
    assert k3.split_floats(M, N) == 2 * (4 * M * N + 3 * N * N)
    assert k3.split_floats(3, 5) == 2 * (4 * 15 + 3 * 25) + 2  # rounded to 4
    # the single solve: 3 groups of one lane; a batch of 64 lanes sharing
    # one codebook needs one split, not 64
    assert k3.workspace_floats(3, 3, 20, 972, 256) == (
        3 * k3.lane_floats(20, 972, 256) + 3 * k3.split_floats(972, 256))
    assert k3.workspace_floats(64, 1, 20, 1024, 256) == (
        64 * k3.lane_floats(20, 1024, 256) + k3.split_floats(1024, 256))
    # at the solver's shape the split constants are 10 MB a group
    assert 4 * k3.split_floats(1024, 256) == 9961472


@pytest.mark.parametrize("need, match", [
    (-1, "own 80 columns"), (232448 + 4, "shared memory"),
    (232448, None)], ids=["columns", "shared_memory", "fits"])
def test_fit_check_raises_on_what_the_kernel_counts(monkeypatch, need,
                                                    match):
    """``_check_fits`` turns the kernel's own count (C
    ``twoace_infer_admm_smem``: bytes, or -1 where a CTA would own too
    many columns) into the wrapper's errors; here a stand-in library
    reports it."""
    lib = types.SimpleNamespace(
        twoace_infer_admm_smem=lambda r, nt, nr: need,
        twoace_infer_admm_smem_limit=lambda: 232448)
    monkeypatch.setattr(k3._build, "library", lambda: lib)
    if match is None:
        k3._check_fits(R, 80, 16)
    else:
        with pytest.raises(ValueError, match=match):
            k3._check_fits(R, 80, 16)


@pytest.fixture(scope="module")
def witness():
    """scripts/torch_k3_witness.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "torch_k3_witness", os.path.join(ROOT, "scripts",
                                         "torch_k3_witness.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("m", chip_smoke.K3_COLUMN_MS)
def test_per_column_pass_is_reproducible_over_the_held_trips(witness, m):
    """chip_smoke.py holds K3's per-column pass at m 80 and m 3 over
    K3_COLUMN_TRIPS trips only, where float32 reproduces the loop: from
    phase 2's warm state (here on the CPU), the plain version and the
    plain version with 3xTF32 products both stay within half of K3_RTOL
    of the loop run in float64, with the same trips and converged
    flags."""
    cs = chip_smoke
    (_, args, kw), = [c for c in cs.k3_cases(m, device="cpu")
                      if not c[2]["scale_by_row"]]
    kw = dict(kw, maxiter=cs.K3_COLUMN_TRIPS)
    f64 = k3.infer_admm_plain(*cs.cast_args(args, torch.float64), **kw)
    for run in (k3.infer_admm_plain(*args, **kw),
                witness.emulated(*args, **kw)):
        assert torch.equal(run[3], f64[3]) and torch.equal(run[2], f64[2])
        assert cs.rel_err(run, f64) <= cs.K3_RTOL / 2


@pytest.mark.parametrize("nt, m", chip_smoke.K3_COLUMN_CASES[
    len(chip_smoke.K3_COLUMN_MS):], ids=lambda v: str(v))
def test_per_column_pass_is_reproducible_at_the_simulations_shapes(nt, m):
    """The same at the shapes the trace sweep (16x16, m 529) and the VS_SR
    campaign (12x12, m 196 and 4) give K3, where after K3_TRIPS trips
    float32 stands 8e-5 to 1.7 from float64: over K3_COLUMN_TRIPS trips
    the plain version stays within half of K3_RTOL of the float64 run,
    with the same trips and converged flags, in both passes."""
    cs = chip_smoke
    for _, args, kw in cs.k3_cases(m, device="cpu", nt=nt, nr=nt):
        kw = dict(kw, maxiter=cs.K3_COLUMN_TRIPS)
        f64 = k3.infer_admm_plain(*cs.cast_args(args, torch.float64), **kw)
        run = k3.infer_admm_plain(*args, **kw)
        assert torch.equal(run[3], f64[3]) and torch.equal(run[2], f64[2])
        assert cs.rel_err(run, f64) <= cs.K3_RTOL / 2


@pytest.mark.gpu
@pytest.mark.parametrize("scale_by_row, nt, nr, m, trips", [
    (True, NT, NR, M, 30), (False, NT, NR, M, 30), (True, 16, 2, 8, 30),
    (False, 16, 2, 8, 30), (True, 16, 4, 96, 30), (False, 16, 4, 96, 4)],
    ids=["scale_by_row-4x4_m32", "per_column-4x4_m32",
         "scale_by_row-nt16_m8", "per_column-nt16_m8",
         "scale_by_row-nt16_m96", "per_column-nt16_m96"])
def test_k3_kernel_matches_plain_on_card(scale_by_row, nt, nr, m, trips):
    """K3 against its plain version on the card, two groups of two lanes
    (G = 2, P = 2), a tolerance that stops some lanes early: at the
    tests' 4x4 (12 of the 16 CTAs own no column), at nt 16 (one slice a
    CTA) with m 8 below the cluster's 16 CTAs (half of them own no row),
    and at nt 16 with m 96 (six rows a CTA).  The per-column pass at m
    96 is held over its first trips: from this cold start it amplifies
    float32 rounding, so that later the plain version on the CPU and on
    the card part too."""
    require_cuda()
    a, b, x0, static, at, bt, u, lad = _problem(lanes=2, nt=nt, nr=nr, m=m)
    a2, b2, x02, *_ = _problem(seed=3, lanes=2, nt=nt, nr=nr, m=m)
    cat = lambda p, q: Pair(torch.cat([p.re, q.re]), torch.cat([p.im, q.im]))
    at = cat(at, tpair(a2[None]))
    bt = torch.cat([bt, torch.tensor(b2[None])])
    u = tps.precompute_u_pair(at)
    x0t = tpair(np.stack([x0, x02]))
    lad4 = LadderArrays(torch.cat([lad.ranks, lad.ranks]),
                        torch.cat([lad.fracs, lad.fracs]))
    y0, z0, v0 = tps.admm_init_pair(
        at, bt, x0t, scale_by_row=scale_by_row, nt=nt, nr=nr,
        ladder=LadderArrays(lad4.ranks.view(2, 2, -1),
                            lad4.fracs.view(2, 2, -1)))
    cuda = lambda p: Pair(p.re.cuda().contiguous(), p.im.cuda().contiguous())
    args = [cuda(at), bt.cuda(), cuda(u), cuda(y0), cuda(z0), cuda(v0),
            torch.full((2, 2), 1e-3, device="cuda"),
            LadderArrays(lad4.ranks.cuda(), lad4.fracs.cuda())]
    kw = dict(nt=nt, nr=nr, scale_by_row=scale_by_row, maxiter=trips,
              **LOOP)
    before = kernels.fused_infer_admm.launches
    ox, oy, conv, it = kernels.fused_infer_admm(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.fused_infer_admm.launches == before + 1
    ox0, oy0, conv0, it0 = kernels.infer_admm_plain(*args, **kw)
    assert torch.equal(it, it0) and torch.equal(conv, conv0)
    for g, w in ((ox, ox0), (oy, oy0)):
        for gg, ww in ((g.re, w.re), (g.im, w.im)):
            torch.testing.assert_close(gg, ww, rtol=0,
                                       atol=2e-4 * float(ww.abs().max()))


@pytest.mark.gpu
def test_a_16_cta_cluster_is_placed_on_card():
    """The card places at least one 16-CTA cluster at the solver's
    shape (the launch raises otherwise, and never runs fewer CTAs)."""
    require_cuda()
    assert k3.active_clusters(20, 16, 16) >= 1
