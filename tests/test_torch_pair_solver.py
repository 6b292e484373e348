"""The port's batched A2 solver against the JAX package's.

The inner solve is compared from an identical x0 and U at float32
tolerance.  Whole solves are compared on the workloads of
``tests/test_pair_solver.py`` given JAX's own train/test splits and
spectral init (the two packages' random streams differ): the same
quality-gate and retry decisions, the same accuracy class.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (codebook, jax_first_pass, jpair, nmse_db, np_pair,
                          steer, tpair)
from twoace_tpu.config import AdmmConfig as JConfig
from twoace_tpu.ops import pair_solver as jps
from twoace_tpu.ops.prox import profile_ladder_arrays as j_ladder
from twoace_tpu_torch import interop
from twoace_tpu_torch.config import AdmmConfig
from twoace_tpu_torch.ops import pair_solver as tps
from twoace_tpu_torch.ops.cplx import LadderArrays
from twoace_tpu_torch.ops.prox import profile_ladder_arrays


def _channels(rng, nt, nr, paths):
    """vec(H) of each list of (aoa, aod, gain) paths."""
    xs = []
    for p in paths:
        h = sum(g * np.outer(steer(nr, a1), steer(nt, a2).conj())
                for a1, a2, g in p)
        xs.append(h.T.reshape(-1))
    return np.stack(xs)


def _inner_problem(m_mult):
    nt = nr = 8
    n = 64
    rng = np.random.default_rng(21)
    a = codebook(rng, m_mult * n, n)
    x = _channels(rng, nt, nr, [
        [(0.3, -0.5, 1.0), (0.9, 0.2, 0.6 - 0.3j)],
        [(-0.2, 0.4, 0.8j), (0.7, -0.6, 0.5)]])
    b = np.abs(x @ a.T).astype(np.float32)            # (2, m)
    return nt, nr, a, b


def _inner_pair(m_mult, scale_by_row, warm_iters):
    """JAX's and the port's inner solve of two lanes from the same x0 and
    U: JAX's spectral init for the first pass, JAX's orthonormalized
    first-pass result for the second.  The port runs both lanes in one
    batched loop, JAX each alone."""
    nt, nr, a, b = _inner_problem(m_mult)
    m, n = a.shape
    lad = j_ladder(nt, nr, m, n, False)
    u = jps.precompute_u_pair(jpair(a))
    kw = dict(nt=nt, nr=nr, mu0=1e-3, rho=1.03, tol_rel=1e-4,
              tol_abs=1e-8, maxiter=600)
    x0 = [jps.spectral_initialize_pair(jpair(a), jnp.asarray(b[i]), 6,
                                       key=jax.random.PRNGKey(i))
          for i in range(2)]
    if not scale_by_row:
        x0 = [jps._orthonormalize_cols_t(jps.infer_admm_pair(
            jpair(a), jnp.asarray(b[i]), x0[i], scale_by_row=True,
            ladder=lad, u_mat=u, use_pallas=False, **kw)[0])
            for i in range(2)]
    kw["warm_iters"] = warm_iters
    want = [jps.infer_admm_pair(jpair(a), jnp.asarray(b[i]), x0[i],
                                scale_by_row=scale_by_row, ladder=lad,
                                u_mat=u, use_pallas=False, **kw)
            for i in range(2)]
    got = tps.infer_admm_pair(
        tpair(a[None]), torch.tensor(b)[None],
        tpair(np.stack([np_pair(x)[0] for x in x0])[None],
              np.stack([np_pair(x)[1] for x in x0])[None]),
        scale_by_row=scale_by_row,
        ladder=LadderArrays(torch.tensor(np.asarray(lad.ranks)),
                            torch.tensor(np.asarray(lad.fracs))),
        u_mat=tpair(*(np_pair(u)[k][None] for k in range(2))), **kw)
    x_t, _, conv_t, it_t = got
    for i, (x_j, _, conv_j, it_j) in enumerate(want):
        xt = np_pair(x_t)
        xt = (xt[0][0, i] + 1j * xt[1][0, i]).reshape(-1, n)
        xj = np_pair(x_j)
        xj = (xj[0] + 1j * xj[1]).reshape(-1, n)
        assert 0 < int(it_j) < 600          # converged before the cap
        assert bool(conv_t[0, i]) and bool(conv_j)
        yield int(it_t[0, i]), int(it_j), xt, xj


@pytest.mark.parametrize("warm_iters", [0, 40])
def test_infer_admm_pair_first_pass_matches_jax(warm_iters):
    """The over-parameterized first pass from the same x0 and U: the same
    trip count and the same iterate.  The solve is invariant to a unitary
    mixing of X's columns, so X is compared through sum_k x_k x_k^H, to
    1e-4 of its scale (float32 rounding in another order)."""
    for it_t, it_j, xt, xj in _inner_pair(2, True, warm_iters):
        assert it_t == it_j
        pt, pj = xt.T @ xt.conj(), xj.T @ xj.conj()
        np.testing.assert_allclose(pt, pj, atol=1e-4 * np.abs(pj).max())


@pytest.mark.parametrize("warm_iters", [0, 40])
def test_infer_admm_pair_second_pass_matches_jax(warm_iters):
    """The per-column pass from JAX's own orthonormalized first-pass
    result.  It lands on the same recovery, to -80 dB gauge-invariant
    NMSE between the two.  Its trip count agrees within 5 (3%): the mu
    update is a discrete test on the residual, and float32 rounding in
    another order flips it now and then, which moves the trip where the
    slowly falling residual crosses its tolerance (JAX against itself,
    with x0 perturbed by 1e-7, moves it as far)."""
    for it_t, it_j, xt, xj in _inner_pair(4, False, warm_iters):
        assert abs(it_t - it_j) <= 5, (it_t, it_j)
        assert nmse_db(xt[0], xj[0]) < -80


def _workload_shared_codebook():
    nt = nr = 8
    rng = np.random.default_rng(11)
    a = codebook(rng, 256, 64)
    paths = []
    for u in range(2):
        g1, g2 = (rng.normal() + 1j * rng.normal() for _ in range(2))
        paths.append([(0.2 + 0.1 * u, -0.4, g1), (0.8, 0.3 - 0.2 * u, g2)])
    return nt, nr, a, _channels(rng, nt, nr, paths), JConfig(maxiter=150)


def _workload_pass_caps():
    nt = nr = 8
    rng = np.random.default_rng(17)
    a = codebook(rng, 256, 64)
    paths = []
    for u in range(2):
        g1, g2 = (rng.normal() + 1j * rng.normal() for _ in range(2))
        paths.append([(0.25 + 0.1 * u, -0.45, g1), (0.85, 0.35, g2)])
    return (nt, nr, a, _channels(rng, nt, nr, paths),
            JConfig(maxiter=300, stage1_maxiter=60, stage2_maxiter=80))


def _workload_forced_retry():
    nt = nr = 8
    rng = np.random.default_rng(5)
    a = codebook(rng, 256, 64)
    paths = [[(0.1 + 0.2 * u, -0.3, 1.0)] for u in range(3)]
    return (nt, nr, a, _channels(rng, nt, nr, paths),
            JConfig(maxiter=120, n_restarts=2, quality_threshold=2.0))


WORKLOADS = {"shared_codebook": (_workload_shared_codebook, 0),
             "pass_caps": (_workload_pass_caps, 3),
             "forced_retry": (_workload_forced_retry, 2)}


def _port_solve(a, b, nt, nr, cfg, **kw):
    return tps.solve_lowrank_multi_pair_batch(
        torch.Generator().manual_seed(0), tpair(a), torch.tensor(b), nt, nr,
        cfg, **kw)


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_batch_solver_matches_jax_given_its_splits_and_init(name):
    """Given JAX's splits and spectral init, the port's first pass makes
    the same quality-gate decisions, and the whole solve lands within
    2e-2 quality and 1 dB NMSE of JAX's (the envelope of
    test_pallas.py's full-solve parity), below -35 dB.  Where both sit
    below -60 dB, the port's recovery is instead held within -60 dB NMSE
    of JAX's own."""
    build, seed = WORKLOADS[name]
    nt, nr, a, x_true, jcfg = build()
    b = np.abs(x_true @ a.T).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    splits, xs_np, q_j = jax_first_pass(key, a, b, nt, nr, jcfg)
    cfg = interop.admm_config_from_dict(dataclasses.asdict(jcfg))
    xs = tpair(*xs_np)

    # the quality gate, from the same first-pass inputs
    trains, tests = (torch.tensor(s) for s in splits)
    m_act = a.shape[0]
    lad = profile_ladder_arrays(nt, nr, int(np.floor(m_act * cfg.cc_frac)),
                                a.shape[1], False)
    with tps.no_tf32():
        fp = tps._batch_first_pass(
            tpair(a), torch.tensor(b), trains, tests, lad, nt, nr, cfg, m_act,
            None, tps.Pair(xs.re.transpose(0, 1).contiguous(),
                           xs.im.transpose(0, 1).contiguous()),
            fused_loop=False)
    q_t = fp.q.numpy().T                                      # (B, R)
    np.testing.assert_array_equal(q_t < cfg.quality_threshold,
                                  q_j < jcfg.quality_threshold)
    np.testing.assert_allclose(q_t, q_j, atol=2e-2)

    res_j = jps.solve_lowrank_multi_pair_batch(
        key, jpair(a), jnp.asarray(b), nt, nr, jcfg)
    res_t = _port_solve(a, b, nt, nr, cfg, splits=splits, xs=xs)
    assert res_t.x.re.shape == (b.shape[0], a.shape[1])
    for u in range(b.shape[0]):
        xt = res_t.x.re[u].numpy() + 1j * res_t.x.im[u].numpy()
        xj = np.asarray(res_j.x.re[u]) + 1j * np.asarray(res_j.x.im[u])
        db_t, db_j = nmse_db(xt, x_true[u]), nmse_db(xj, x_true[u])
        assert db_t < -35, (u, db_t)
        # deep in the float32 floor a dB gap measures rounding, not the
        # solver: there the two recoveries are held to each other
        assert (abs(db_t - db_j) < 1.0
                or nmse_db(xt, xj) < -60), (u, db_t, db_j, nmse_db(xt, xj))
        np.testing.assert_allclose(float(res_t.quality[u]),
                                   float(res_j.quality[u]), atol=2e-2)


def test_pass_caps_cut_iterations():
    nt, nr, a, x_true, jcfg = _workload_pass_caps()
    b = np.abs(x_true @ a.T).astype(np.float32)
    res0 = _port_solve(a, b, nt, nr, AdmmConfig(maxiter=300))
    res = _port_solve(a, b, nt, nr, AdmmConfig(
        maxiter=300, stage1_maxiter=60, stage2_maxiter=80))
    for u in range(b.shape[0]):
        xe = res.x.re[u].numpy() + 1j * res.x.im[u].numpy()
        assert nmse_db(xe, x_true[u]) < -35, u
        assert float(res.quality[u]) > 0.98
        assert int(res.iters[u]) < int(res0.iters[u]), u


def test_forced_retry_adds_iterations():
    """quality_threshold = 2.0 makes every (restart, instance) pair poor:
    the retry runs for all of them, stays accurate on single-path
    channels, and its trips are counted."""
    nt, nr, a, x_true, _ = _workload_forced_retry()
    b = np.abs(x_true @ a.T).astype(np.float32)
    res = _port_solve(a, b, nt, nr, AdmmConfig(
        maxiter=120, n_restarts=2, quality_threshold=2.0))
    res0 = _port_solve(a, b, nt, nr, AdmmConfig(maxiter=120, n_restarts=2))
    for u in range(b.shape[0]):
        xe = res.x.re[u].numpy() + 1j * res.x.im[u].numpy()
        assert nmse_db(xe, x_true[u]) < -35, u
        assert int(res.iters[u]) > int(res0.iters[u]), u


def test_pass_caps_at_or_below_warm_iters_raise():
    """A capped pass that ends inside the warm phase would return
    a coarse iterate; the port refuses the configuration."""
    nt, nr, a, x_true, _ = _workload_forced_retry()
    b = np.abs(x_true @ a.T).astype(np.float32)
    with pytest.raises(ValueError, match="warm_iters"):
        _port_solve(a, b, nt, nr, AdmmConfig(maxiter=120, warm_iters=60,
                                             stage2_maxiter=60))


def test_active_row_contract_and_unported_paths_raise():
    """The batch solver's one-active-count contract; the Jacobi eig_mode
    (a TPU workaround) is the one mode left unported, and an unknown
    prox_kind is refused, in both solvers."""
    nt, nr, a, x_true, _ = _workload_forced_retry()
    b = np.abs(x_true @ a.T).astype(np.float32)
    b[0, :3] = 0.0                        # instance 0 has 3 inactive rows
    with pytest.raises(ValueError, match="same active"):
        _port_solve(a, b, nt, nr, AdmmConfig(maxiter=20))
    with pytest.raises(NotImplementedError, match="perturb"):
        _port_solve(a, b[1:], nt, nr, AdmmConfig(maxiter=20),
                    eig_mode="jacobi")
    with pytest.raises(NotImplementedError, match="perturb"):
        tps.solve_lowrank_multi_pair(None, tpair(a), torch.tensor(b[1]),
                                     nt, nr, eig_mode="jacobi")
    with pytest.raises(ValueError, match="prox_kind"):
        tps.solve_lowrank_multi_pair(None, tpair(a), torch.tensor(b[1]),
                                     nt, nr, prox_kind="none")


def test_solver_restores_the_tf32_flag():
    nt, nr, a, x_true, _ = _workload_forced_retry()
    b = np.abs(x_true @ a.T).astype(np.float32)[:1]
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        _port_solve(a, b, nt, nr, AdmmConfig(maxiter=30, n_restarts=1,
                                             warm_iters=10))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
