"""The port's single-recovery path against the JAX package's.

``solve_lowrank_multi_pair`` is compared given JAX's own splits and
spectral init (the two packages' random streams differ); the refine and
the nuclear inner solve from the same x0.  Recoveries are compared
gauge-invariantly (NMSE up to a global phase).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (codebook, jax_single_draws, jpair, nmse_db,
                          np_pair, steer, tpair)
from twoace_tpu.config import AdmmConfig as JConfig
from twoace_tpu.ops import pair_solver as jps
from twoace_tpu_torch import interop
from twoace_tpu_torch.ops import pair_solver as tps
from twoace_tpu_torch.ops.prox import profile_ladder_arrays

NT = NR = 8
N = NT * NR


def _channel(rng, paths):
    h = sum(g * np.outer(steer(NR, a1), steer(NT, a2).conj())
            for a1, a2, g in paths)
    return h.T.reshape(-1)


def _case_normal():
    rng = np.random.default_rng(31)
    a = codebook(rng, 4 * N, N)
    x = _channel(rng, [(0.3, -0.5, 1.0), (0.9, 0.2, 0.6 - 0.4j)])
    return a, x, JConfig(maxiter=150), None


def _case_forced_retry():
    rng = np.random.default_rng(32)
    a = codebook(rng, 4 * N, N)
    x = _channel(rng, [(0.2, -0.3, 1.0)])
    return a, x, JConfig(maxiter=120, n_restarts=2,
                         quality_threshold=2.0), None


def _case_padded():
    """160 active rows padded to 256 with zero rows and b == 0; the
    ladders follow ladder_m = 160 (< 3n) while the padded m is >= 3n."""
    rng = np.random.default_rng(33)
    a = codebook(rng, 4 * N, N)
    a[160:] = 0.0
    x = _channel(rng, [(0.4, -0.2, 1.0), (-0.6, 0.5, 0.5j)])
    return a, x, JConfig(maxiter=150), 160


CASES = {"normal": _case_normal, "forced_retry": _case_forced_retry,
         "padded_ladder_m": _case_padded}


@pytest.fixture(scope="module", params=list(CASES))
def single_pair(request):
    """JAX's and the port's solve of one case, given JAX's draws."""
    a, x_true, jcfg, ladder_m = CASES[request.param]()
    b = np.abs(a @ x_true).astype(np.float32)
    key = jax.random.PRNGKey(7)
    splits, xs = jax_single_draws(key, a, b, jcfg)
    res_j = jps.solve_lowrank_multi_pair(key, jpair(a), jnp.asarray(b), NT,
                                         NR, jcfg, ladder_m=ladder_m)
    cfg = interop.admm_config_from_dict(dataclasses.asdict(jcfg))
    res_t = tps.solve_lowrank_multi_pair(
        None, tpair(a), torch.tensor(b), NT, NR, cfg, ladder_m=ladder_m,
        splits=splits, xs=tpair(*xs))
    return request.param, x_true, res_j, res_t


def test_single_solver_matches_jax_given_its_splits_and_init(single_pair):
    """Same accuracy class as JAX: quality within 2e-2; NMSE within 1 dB
    of JAX's above -60 dB, and below it both under -60 dB and held to each
    other (ROADMAP §3); the trip count within 5 per pass-2 solve of
    JAX's (the per-column pass's stopping trip moves with rounding, see
    test_torch_pair_solver.py), the other solves trip for trip."""
    name, x_true, res_j, res_t = single_pair
    assert res_t.x.re.shape == (N,)
    xt = res_t.x.re.numpy() + 1j * res_t.x.im.numpy()
    xj = np.asarray(res_j.x.re) + 1j * np.asarray(res_j.x.im)
    db_t, db_j = nmse_db(xt, x_true), nmse_db(xj, x_true)
    if db_j > -60:
        assert abs(db_t - db_j) < 1.0, (name, db_t, db_j)
    else:
        assert db_t < -60 and nmse_db(xt, xj) < -60, (name, db_t, db_j)
    np.testing.assert_allclose(float(res_t.quality), float(res_j.quality),
                               atol=2e-2)
    pass2_solves = 4 if name == "forced_retry" else 3
    assert abs(int(res_t.iters) - int(res_j.iters)) <= 5 * pass2_solves, (
        name, int(res_t.iters), int(res_j.iters))
    assert bool(res_t.converged)


def _refine_problem():
    rng = np.random.default_rng(41)
    a = codebook(rng, 3 * N, N)
    x = _channel(rng, [(0.1, 0.4, 1.0), (0.7, -0.3, 0.4 + 0.2j)])
    x0 = (x + 0.05 * (rng.normal(size=N) + 1j * rng.normal(size=N))
          ).astype(np.complex64)
    return a, np.abs(a @ x).astype(np.float32), x, x0


@pytest.mark.parametrize("anchor_weight", [0.0, 0.5])
def test_refine_matches_jax(anchor_weight):
    """The warm-started refine from the same x0, with and without the
    proximal anchor: the same recovery (-60 dB between the two), the
    same full-data quality to 1e-3, trips within 5."""
    a, b, x_true, x0 = _refine_problem()
    jcfg = JConfig(maxiter=200)
    res_j = jps.refine_lowrank_pair(jpair(a), jnp.asarray(b), jpair(x0), NT,
                                    NR, jcfg, anchor_weight=anchor_weight)
    res_t = tps.refine_lowrank_pair(
        tpair(a), torch.tensor(b), tpair(x0), NT, NR,
        interop.admm_config_from_dict(dataclasses.asdict(jcfg)),
        anchor_weight=anchor_weight)
    xt = res_t.x.re.numpy() + 1j * res_t.x.im.numpy()
    xj = np.asarray(res_j.x.re) + 1j * np.asarray(res_j.x.im)
    assert nmse_db(xt, xj) < -60
    assert nmse_db(xt, x_true) < -40
    np.testing.assert_allclose(float(res_t.quality), float(res_j.quality),
                               atol=1e-3)
    assert abs(int(res_t.iters) - int(res_j.iters)) <= 5
    assert bool(res_t.converged) == bool(res_j.converged)


def test_nuclear_inner_solve_matches_jax():
    """The nuclear prox's inner solve (first pass) from the same x0 and U:
    the same trip count and the same iterate, compared through
    sum_k x_k x_k^H to 1e-4 of its scale."""
    a, b, _, _ = _refine_problem()
    u = jps.precompute_u_pair(jpair(a))
    x0 = jps.spectral_initialize_pair(jpair(a), jnp.asarray(b), 6,
                                      key=jax.random.PRNGKey(3))
    kw = dict(nt=NT, nr=NR, mu0=1e-3, rho=1.03, tol_rel=1e-4, tol_abs=1e-8,
              maxiter=80, prox_kind="nuclear")
    x_j, _, _, it_j = jps.infer_admm_pair(
        jpair(a), jnp.asarray(b), x0, scale_by_row=True, ladder=None,
        u_mat=u, use_pallas=False, **kw)
    x_t, _, _, it_t = tps.infer_admm_pair(
        tpair(a[None]), torch.tensor(b)[None, None],
        tpair(*(p[None, None] for p in np_pair(x0))), scale_by_row=True,
        u_mat=tpair(*(p[None] for p in np_pair(u))), **kw)
    assert int(it_t[0, 0]) == int(it_j)
    xt = np_pair(x_t)
    xt = xt[0][0, 0] + 1j * xt[1][0, 0]
    xj = np_pair(x_j)
    xj = xj[0] + 1j * xj[1]
    pt, pj = xt.T @ xt.conj(), xj.T @ xj.conj()
    np.testing.assert_allclose(pt, pj, atol=1e-4 * np.abs(pj).max())


@pytest.mark.parametrize("prox_kind", ["nuclear", "spectral_profile"])
def test_single_and_batch_of_one_agree(prox_kind):
    """Both entry points end to end on the same draws (JAX's): a batch of
    one runs the single solve's scaffold, the single on K3's route (its
    plain version on the CPU) and the batch on the per-op loop, so the two
    land on the same recovery (-60 dB between them), quality and trip
    count.  The nuclear inner solve itself is held to JAX's above."""
    a, b, x_true, _ = _refine_problem()
    cfg = tps.AdmmConfig(maxiter=100, n_restarts=2)
    splits, xs = jax_single_draws(jax.random.PRNGKey(5), a, b, JConfig(
        maxiter=100, n_restarts=2))
    res_s = tps.solve_lowrank_multi_pair(
        None, tpair(a), torch.tensor(b), NT, NR, cfg, prox_kind=prox_kind,
        splits=splits, xs=tpair(*xs))
    res_b = tps.solve_lowrank_multi_pair_batch(
        None, tpair(a), torch.tensor(b[None]), NT, NR, cfg,
        prox_kind=prox_kind, splits=splits,
        xs=tpair(*(p[None] for p in xs)))
    xs_ = res_s.x.re.numpy() + 1j * res_s.x.im.numpy()
    xb = res_b.x.re[0].numpy() + 1j * res_b.x.im[0].numpy()
    assert nmse_db(xs_, xb) < -60
    assert abs(float(res_s.quality) - float(res_b.quality[0])) < 1e-5
    assert int(res_s.iters) == int(res_b.iters[0])
    assert np.all(np.isfinite(xs_)) and float(res_s.quality) > 0.0


def test_anchor_errors():
    """An anchor needs the Z path, and an anchored solve takes no u_mat
    (its (1 + w) ridge is folded into U here)."""
    a, b, _, x0 = _refine_problem()
    args = (tpair(a[None]), torch.tensor(b)[None, None],
            tpair(x0[None, None, None]))
    anchor = tpair(x0[None, None, None])
    with pytest.raises(ValueError, match="Z-constrained"):
        tps.infer_admm_pair(*args, scale_by_row=True, nt=NT, nr=NR,
                            ladder=None, anchor=anchor, anchor_weight=0.5)
    lad = profile_ladder_arrays(NT, NR, 3 * N, N, False)
    u = tps.precompute_u_pair(args[0])
    with pytest.raises(ValueError, match="u_mat"):
        tps.infer_admm_pair(*args, scale_by_row=True, nt=NT, nr=NR,
                            ladder=lad, u_mat=u, anchor=anchor,
                            anchor_weight=0.5)
