"""The port's mobility tracker (``twoace_tpu_torch.pipeline.mobility``) and
its per-op loop against the JAX package's.

- The host-side tracking loops (``track``, ``track_simulated``) and their helpers
  with one deterministic fake solver shared by both packages: identical
  errors, budgets, estimates and solver calls.
- The tracking loops' default solver (the complex A2 solver,
  ``make_complex_solver``) on one padded window against JAX's default.
- The warm pair tracker at 4x4, window by window, each window started
  from JAX's own estimate of the window before.
- The per-op loop with K4's plain version as its ``pair_gemm``, trip for
  trip against the products it ran before K4 (``cplx.matmul`` on the
  transposed views of A and U).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import codebook, nmse_db, steer, tpair
from twoace_tpu import config as jcfg
from twoace_tpu.pipeline import mobility as jmob
from twoace_tpu_torch import config as tcfg
from twoace_tpu_torch.ops import pair_solver as tps
from twoace_tpu_torch.ops.admm_loop import admm_loop
from twoace_tpu_torch.ops.cplx import LadderArrays, Pair, matmul
from twoace_tpu_torch.ops.kernels import pair_matmul_plain, prox_dual_t_plain
from twoace_tpu_torch.ops.kernels import zprox_t_plain
from twoace_tpu_torch.ops.prox import profile_ladder_arrays
from twoace_tpu_torch.pipeline import mobility as tmob

NT = NR = 4
N = NT * NR


def _chan(a_rx, a_tx):
    return np.outer(steer(NR, a_rx), steer(NT, a_tx).conj()).T.reshape(-1)


def _kron_stream(seed, n_windows, p, drift=0.02):
    """Fresh (w, f) kron probe pairs, p a window, through a rank-1 channel
    drifting by ``drift`` rad a window (scripts/bench_mobility_r05.py's
    fresh-pair stream at 4x4)."""
    rng = np.random.default_rng(seed)

    def beam(nn):
        return np.exp(1j * rng.integers(0, 4, nn) * (np.pi / 2)) / np.sqrt(nn)

    rows = np.stack([np.kron(beam(NT), beam(NR))
                     for _ in range(n_windows * p)]).astype(np.complex64)
    vhs = np.stack([1.5 * np.exp(0.3j) * _chan(0.4 + drift * t,
                                               -0.7 - drift * t)
                    for t in range(n_windows)])
    amps = np.concatenate([np.abs(rows[t * p:(t + 1) * p] @ vhs[t])
                           for t in range(n_windows)]).astype(np.float32)
    return rows, amps, vhs


def _fake_solver(x_true, calls):
    """Deterministic stand-in: the true channel, 1.5x too large when the
    window's active row count is an odd multiple of 20, so the budget
    both grows and resets."""
    def solver(key, a, b, ladder_m=None):
        calls.append((np.asarray(a).copy(), np.asarray(b).copy(), ladder_m))
        k = int(np.sum(np.asarray(b) > 0))
        return x_true * (1.5 if (k // 20) % 2 else 1.0)

    solver.cc_frac = 0.95
    return solver


def test_pad_window_and_ladder_snap_match_jax():
    rng = np.random.default_rng(0)
    cb = (rng.normal(size=(50, N)) + 1j * rng.normal(size=(50, N))
          ).astype(np.complex64)
    rss = rng.uniform(0.1, 1.0, 50).astype(np.float32)
    for window in ([3, 4, 5], list(range(10, 40))):
        for got, want in zip(tmob._pad_window(cb, rss, window, 40),
                             jmob._pad_window(cb, rss, window, 40)):
            np.testing.assert_array_equal(got, want)
    for m_active in range(1, 260, 7):
        for m_padded in (80, 256):
            for frac in (0.95, 0.8):
                assert (tmob._ladder_m_for_window(m_active, m_padded, 64,
                                                  frac)
                        == jmob._ladder_m_for_window(m_active, m_padded, 64,
                                                     frac))
    np.testing.assert_equal(tmob._relative_rss_error(rss[:5], rss[5:10]),
                            jmob._relative_rss_error(rss[:5], rss[5:10]))


@pytest.mark.parametrize("static_pad", [True, False])
def test_track_matches_jax_with_a_shared_fake_solver(static_pad):
    rows, amps, vhs = _kron_stream(1, 8, 20)
    runs = []
    for mod, key in ((jmob, jax.random.PRNGKey(0)),
                     (tmob, torch.Generator().manual_seed(0))):
        calls = []
        mob = mod.MobilityConfig(window_probes=20, max_window=60)
        cfg = (jcfg if mod is jmob else tcfg).ArrayConfig(nt=NT, nr=NR)
        trace = mod.track(key, rows, amps, cfg, mob,
                          solver=_fake_solver(vhs[0], calls),
                          static_pad=static_pad)
        runs.append((trace, calls))
    (tj, cj), (tt, ct) = runs
    for f in ("rss_error", "probe_budget", "estimates"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f))
    assert len(ct) == len(cj) == 8
    for (a1, b1, l1), (a2, b2, l2) in zip(ct, cj):
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(b1, b2)
        assert l1 == l2
    budgets = tt.probe_budget[1:]
    assert (budgets == 0).any() and (budgets > 0).any()   # both branches
    if static_pad:
        assert {c[2] for c in ct} == {47, None}           # the ladder snap


def test_track_simulated_matches_jax_with_a_shared_fake_solver():
    smob_j = jmob.SimulatedMobilityConfig(window_probes=30, max_window=60,
                                          m_init=20, m_max=25)
    smob_t = tmob.SimulatedMobilityConfig(window_probes=30, max_window=60,
                                          m_init=20, m_max=25)
    rows, amps, vhs = _kron_stream(2, 6, 30)
    cj, ct = [], []
    tj = jmob.track_simulated(jax.random.PRNGKey(0), rows, amps,
                              jcfg.ArrayConfig(nt=NT, nr=NR), smob_j,
                              solver=_fake_solver(vhs[0], cj))
    tt = tmob.track_simulated(None, torch.tensor(rows), torch.tensor(amps),
                              tcfg.ArrayConfig(nt=NT, nr=NR), smob_t,
                              solver=_fake_solver(vhs[0], ct))
    for f in ("rss_error", "probe_budget", "estimates"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f))
    assert [c[2] for c in ct] == [c[2] for c in cj]


def test_default_solver_and_window_generators():
    """The tracking loops' default solver is JAX's, the complex A2 solver
    (``make_complex_solver``): on a padded window of a static 4x4 channel
    (48 active rows of 64, ladder_m snapped to 3n) it recovers the channel
    as JAX's default solver does, both below -60 dB (the random streams
    differ).  ``solver=None`` runs it on the card, and raises where there
    is none.  Each window's generator is a function of the run's seed and
    the window only."""
    rows, amps, vhs = _kron_stream(3, 2, 24, drift=0.0)
    rows, amps = rows.astype(np.complex128), amps.astype(np.float64)
    window = list(range(48))
    a_w, b_w = tmob._pad_window(rows, amps, window, 64)
    lm = tmob._ladder_m_for_window(48, 64, N)
    assert lm == jmob._ladder_m_for_window(48, 64, N) == 3 * N
    admm = dict(maxiter=150, n_restarts=1)
    xj = jmob.solve_lowrank_multi(
        jax.random.PRNGKey(1), jnp.asarray(a_w), jnp.asarray(b_w), NT, NR,
        jcfg.AdmmConfig(**admm), ladder_m=lm).x
    cfg = tcfg.ArrayConfig(nt=NT, nr=NR)
    solver = tmob.make_complex_solver(cfg, tcfg.AdmmConfig(**admm),
                                      device="cpu")
    assert tmob._solver_takes_ladder_m(solver) and solver.cc_frac == 0.95
    xt = solver(tmob.fold_in(torch.Generator().manual_seed(1), 1), a_w, b_w,
                ladder_m=lm)
    assert isinstance(xt, np.ndarray) and xt.dtype == np.complex128
    assert nmse_db(np.asarray(xj), vhs[0]) < -60.0
    assert nmse_db(xt, vhs[0]) < -60.0
    if not torch.cuda.is_available():
        for run in (tmob.track, tmob.track_simulated):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                run(None, rows, amps, cfg)
    g = torch.Generator().manual_seed(5)
    draw = lambda t: torch.rand(3, generator=tmob.fold_in(g, t))
    assert torch.equal(draw(2), draw(2))
    assert not torch.equal(draw(2), draw(3))


def _warm_windows(admm, n_windows=4, p=32, max_window=64):
    """The padded windows and ladder_m of track() on a 4x4 fresh-pair
    stream, with JAX's warm tracker's estimate of each."""
    rows, amps, vhs = _kron_stream(4, n_windows, p)
    cfg = jcfg.ArrayConfig(nt=NT, nr=NR)
    solver = jmob.make_warm_pair_solver(cfg, admm, use_rank_one=True)
    window, out = [], []
    for t in range(n_windows):
        window = (window + list(range(t * p, (t + 1) * p)))[-max_window:]
        a_w, b_w = jmob._pad_window(rows, amps, window, max_window)
        lm = jmob._ladder_m_for_window(len(window), max_window, N,
                                       admm.cc_frac)
        kw = {"ladder_m": lm} if lm is not None else {}
        x = solver(jax.random.PRNGKey(t), a_w, b_w, **kw)
        out.append((a_w, b_w, kw, x, vhs[t]))
    return out


def test_warm_pair_tracker_matches_jax_window_by_window():
    """Windows 1-3 (the anchored refine; window 0 is a random cold start):
    the port's warm solver, started from JAX's estimate of the window
    before, against JAX's estimate.  Measured on this workload: the two
    agree to -130 to -134 dB NMSE of each other; held at -60 dB, the
    float32 band of the refine tests (test_torch_single_solve.py)."""
    admm_j = jcfg.AdmmConfig(maxiter=200)
    admm_t = tcfg.AdmmConfig(maxiter=200)
    windows = _warm_windows(admm_j)
    solver = tmob.make_warm_pair_solver(tcfg.ArrayConfig(nt=NT, nr=NR),
                                        admm_t, use_rank_one=True,
                                        device="cpu")
    for t in range(1, len(windows)):
        a_w, b_w, kw, x_jax, x_true = windows[t]
        solver.state["x"] = windows[t - 1][3]
        x = solver(torch.Generator().manual_seed(t), a_w, b_w, **kw)
        assert x.shape == (N,) and np.all(np.isfinite(x))
        assert nmse_db(x, x_jax) < -60, (t, nmse_db(x, x_jax))
        assert nmse_db(x, x_true) < -20, (t, nmse_db(x, x_true))
    solver.reset()
    assert solver.state["x"] is None


def test_pair_solvers_on_the_cpu_run_and_reset():
    """make_pair_solver and the warm solver's cold start (rank-1 and
    generic) give finite estimates of the window; reset() clears the
    warm state, so the next call is a cold start again."""
    rows, amps, vhs = _kron_stream(5, 1, 64)
    cfg = tcfg.ArrayConfig(nt=NT, nr=NR)
    admm = tcfg.AdmmConfig(maxiter=60, n_restarts=2)
    gen = torch.Generator().manual_seed(0)
    cold = tmob.make_pair_solver(cfg, admm, device="cpu")
    assert cold.cc_frac == admm.cc_frac
    for solver in (cold,
                   tmob.make_warm_pair_solver(cfg, admm, device="cpu"),
                   tmob.make_warm_pair_solver(cfg, admm, use_rank_one=True,
                                              device="cpu")):
        x = solver(gen, rows, amps)
        assert x.shape == (N,) and np.all(np.isfinite(x))
        assert nmse_db(x, vhs[0]) < -10
        if solver is not cold:
            assert solver.state["x"] is x
            solver.reset()
            assert solver.state["x"] is None


# ---------------------------------------------------------------------------
# the per-op loop with K4's plain version

def _loop_problem(seed=0, lanes=3, m=2 * N, r=6):
    rng = np.random.default_rng(seed)
    a = codebook(rng, m, N)
    xs = np.stack([_chan(0.3 * i, -0.2 + 0.1 * i) for i in range(lanes)])
    b = np.abs(xs @ a.T).astype(np.float32)
    x0 = (rng.normal(size=(lanes, r, N))
          + 1j * rng.normal(size=(lanes, r, N))).astype(np.complex64)
    at, bt = tpair(a[None]), torch.tensor(b[None])
    lad = profile_ladder_arrays(NT, NR, m, N, False)
    lad3 = LadderArrays(lad.ranks[None, None], lad.fracs[None, None])
    y0, z0, v0 = tps.admm_init_pair(at, bt, tpair(x0[None]),
                                    scale_by_row=True, nt=NT, nr=NR,
                                    ladder=lad3)
    lanes_lad = LadderArrays(lad.ranks.expand(lanes, -1),
                             lad.fracs.expand(lanes, -1))
    return (at, bt, tps.precompute_u_pair(at), y0, z0, v0,
            torch.full((1, lanes), 1e-3)), lanes_lad


def _legacy_gemm(x: Pair, mat: Pair) -> Pair:
    """The loop's products before K4: cplx.matmul with B in the strided
    layout of the transposed views it was handed."""
    view = Pair(mat.re.mT.contiguous().mT, mat.im.mT.contiguous().mT)
    return matmul(x, view)


@pytest.mark.parametrize("warm_iters", [0, 6])
def test_loop_with_plain_k4_matches_the_loop_before_k4(warm_iters):
    """Trip for trip (maxiter 1, 2, 5, 12, 40): the same trip counts and
    converged masks, opt_x and opt_y within 1e-5 of the largest entry.  The
    spy also pins that every product gets contiguous operands and the
    same three B operands on every trip (built once per solve)."""
    args, lad = _loop_problem()
    seen = []

    def spy(x, mat):
        assert x.re.is_contiguous() and x.im.is_contiguous()
        assert mat.re.is_contiguous() and mat.im.is_contiguous()
        seen.append(mat.re.data_ptr())
        return pair_matmul_plain(x, mat)

    def z_prox(z, v, mu):
        return zprox_t_plain(z, v, NT, NR, lad)

    kw = dict(scale_by_row=True, prox_dual=prox_dual_t_plain, z_prox=z_prox,
              rho=1.03, tol_rel=1e-2, tol_abs=1e-8, warm_iters=warm_iters)
    for maxiter in (1, 2, 5, 12, 40):
        seen.clear()
        got = admm_loop(*args, pair_gemm=spy, maxiter=maxiter, **kw)
        want = admm_loop(*args, pair_gemm=_legacy_gemm, maxiter=maxiter, **kw)
        assert len(set(seen)) == 3, len(set(seen))
        assert torch.equal(got[3], want[3]) and torch.equal(got[2], want[2])
        for gp, wp in zip(got[:2], want[:2]):
            for g, w in zip(gp, wp):
                assert float((g - w).abs().max() / w.abs().max()) < 1e-5
    assert int(got[3].max()) < 40                  # the lanes converged
    assert math.isfinite(float(got[0].re.abs().max()))
