"""The port's ``parallel`` package (``torch.distributed``, gloo on the
CPU) against itself across meshes and against the JAX package.

Three worlds are spawned once for the session (``spawn_ranks``, a
timeout per world, one thread a rank): two ranks (rows 2, a
batch-sharded solve, the scaling benchmark), two ranks on JAX's inputs
(the JAX-parity pieces on rows 2), and four ranks (the mesh shapes,
batch 2 x rows 2).  The rows-1 references and the one-rank hook checks
run in the test process on a one-rank gloo world.  JAX computes its
pieces on the full rows (``_psum_helpers(None)``) and its two sharded
scaffolds on a (1, 2) mesh of virtual CPU devices under one jit.  The
expensive results are shared by every xdist worker (``shared_once``);
the tests that start them come first, each asking for its slowest
fixture first, so that the workers build them side by side.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_worker as W
from torch_parity import nmse_db, shared_once, spawn_one_thread
from twoace_tpu_torch.ops.cplx import Pair
from twoace_tpu_torch.parallel import (Mesh, RowReduce, batch_sharding,
                                       make_mesh, problem_sharding)
from twoace_tpu_torch.parallel.distributed import free_port

#: seconds a spawned world may take before it fails
WORLD_TIMEOUT = 300.0


def _jax_pieces():
    """JAX's inputs and pieces, numpy: instance 0 normalized, U^T from
    ``_precompute_u_sharded``, ``_make_admm``'s two passes over
    PASS_TRIPS trips from its spectral init, and the production
    scaffold's splits and spectral inits (``_solve_multi_one_pair``'s key
    derivation)."""
    import jax
    import jax.numpy as jnp
    from twoace_tpu.config import AdmmConfig as JConfig
    from twoace_tpu.ops.cplx import Pair as JPair
    from twoace_tpu.ops.prox import profile_ladder
    from twoace_tpu.parallel import sharded_pair as jsp

    a, b, _ = W.problem()
    psum, psum_p, gnorm2 = jsp._psum_helpers(None)
    r = min(W.CFG_JAX.rank, W.M, W.N)
    k_tr = int(np.floor(W.M * W.CFG_JAX.cc_frac))
    keys = _jax_keys()

    def normalized(u, a_re, a_im, bb):
        a_u = JPair(a_re[u], a_im[u])
        a_norm = jnp.sqrt(gnorm2(a_u) / W.M)
        b_norm = jnp.sqrt(jnp.sum(bb[u] ** 2))
        return JPair(a_u.re / a_norm, a_u.im / a_norm), bb[u] / b_norm

    @jax.jit
    def pieces(a_re, a_im, bb):
        a_n, b_n = normalized(0, a_re, a_im, bb)
        u_conj = jsp._precompute_u_sharded(a_n, psum_p)
        x0 = jsp._spectral_init_sharded(a_n, b_n, r, psum_p)
        run = jsp._make_admm(a_n, b_n, u_conj,
                             profile_ladder(W.NT, W.NR, W.M, W.N, False),
                             JConfig(maxiter=W.PASS_TRIPS), psum, psum_p,
                             gnorm2, W.M, W.NT, W.NR, "spectral_profile")
        x_rows, _ = run(x0, True)
        x0_cols = jsp._orthonormalize_sharded(x_rows)
        x_cols, _ = run(x0_cols, False)
        trains, xs = [], []
        for u in range(W.BATCH):
            k_split, k_init = jax.random.split(jax.random.fold_in(keys[u], 0))
            train = jax.random.permutation(k_split, W.M)[:k_tr]
            mask = jnp.zeros((W.M,), jnp.float32).at[train].set(1.0)
            a_u, b_u = normalized(u, a_re, a_im, bb)
            trains.append(train)
            xs.append(jsp._spectral_init_sharded(
                JPair(a_u.re * mask[:, None], a_u.im * mask[:, None]),
                b_u * mask, r, psum_p, key=k_init))
        return (a_n, b_n, u_conj, x0, x_rows, x0_cols, x_cols,
                jnp.stack(trains), JPair(jnp.stack([x.re for x in xs]),
                                         jnp.stack([x.im for x in xs])))

    out = pieces(jnp.asarray(a.real, jnp.float32),
                 jnp.asarray(a.imag, jnp.float32), jnp.asarray(b, jnp.float32))
    cplx = [np.asarray(p.re) + 1j * np.asarray(p.im) for p in
            (out[0], out[2], out[3], out[4], out[5], out[6], out[8])]
    return dict(a_n=cplx[0][None], b_n=np.asarray(out[1])[None],
                u_conj=cplx[1], x0_rows=cplx[2], x_rows=cplx[3],
                x0_cols=cplx[4], x_cols=cplx[5],
                trains=np.asarray(out[7])[:, None], xs=cplx[6][:, None])


def _jax_keys():
    import jax

    return jax.random.split(jax.random.PRNGKey(3), W.BATCH)


def _jax_sharded():
    """JAX's production scaffold (one restart) and complex twin on a
    (1, 2) mesh of virtual CPU devices, in one jit."""
    import jax
    import jax.numpy as jnp
    from twoace_tpu.config import AdmmConfig as JConfig
    from twoace_tpu.ops.cplx import Pair as JPair
    from twoace_tpu.parallel import make_mesh as j_mesh
    from twoace_tpu.parallel import solve_lowrank_sharded as j_cplx
    from twoace_tpu.parallel.sharded_pair import (
        solve_lowrank_multi_sharded_pair as j_multi)

    a, b, _ = W.problem()
    mesh = j_mesh(batch=1, rows=2, devices=jax.devices()[:2])
    keys = _jax_keys()

    @jax.jit
    def both(a_re, a_im, bf, ac, bc):
        xm, qm = j_multi(mesh, keys, JPair(a_re, a_im), bf,
                         W.NT, W.NR, JConfig(maxiter=200, n_restarts=1))
        xc = j_cplx(mesh, ac, bc, W.NT, W.NR,
                    JConfig(maxiter=W.CFG_COMPLEX.maxiter))
        return xm, qm, xc

    xm, qm, xc = both(jnp.asarray(a.real, jnp.float32),
                      jnp.asarray(a.imag, jnp.float32),
                      jnp.asarray(b, jnp.float32), jnp.asarray(a),
                      jnp.asarray(b))
    return dict(multi_x=np.asarray(xm.re) + 1j * np.asarray(xm.im),
                multi_q=np.asarray(qm), complex=np.asarray(xc))


@pytest.fixture(scope="module")
def jax_pieces(tmp_path_factory):
    return shared_once(tmp_path_factory, "parallel_jax_pieces", _jax_pieces)


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    return shared_once(tmp_path_factory, "parallel_jax_sharded", _jax_sharded)


@pytest.fixture(scope="module")
def rows2(tmp_path_factory):
    return shared_once(tmp_path_factory, "parallel_rows2",
                       lambda: spawn_one_thread(W.rows2_rank, 2, (),
                                                WORLD_TIMEOUT))


@pytest.fixture(scope="module")
def jax_rows2(tmp_path_factory, jax_pieces):
    return shared_once(tmp_path_factory, "parallel_jax_rows2",
                       lambda: spawn_one_thread(W.jax_rank, 2, (jax_pieces,),
                                                WORLD_TIMEOUT))


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return shared_once(tmp_path_factory, "parallel_grid",
                       lambda: spawn_one_thread(W.grid_rank, 4, (),
                                                WORLD_TIMEOUT))


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo world in this process and its (1, 1) mesh."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        yield make_mesh(batch=1, rows=1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def rows1(tmp_path_factory, one_rank):
    return shared_once(tmp_path_factory, "parallel_rows1",
                       lambda: W.solves(one_rank))


@pytest.fixture(scope="module")
def hook_gaps(tmp_path_factory, one_rank):
    return shared_once(tmp_path_factory, "parallel_hook_gaps",
                       lambda: W.one_rank_loops(one_rank))


def _assemble(outs, key, sub=None):
    """The global (B, ...) result of ``key`` from the ranks' blocks: each
    rows group's replicas must agree bit for bit."""
    blocks = {}
    for out in outs:
        if out is None or "coords" not in out or out["coords"] is None:
            continue
        v = out[key] if sub is None else out[key][sub]
        bi = out["coords"][0]
        if bi in blocks:
            np.testing.assert_array_equal(v, blocks[bi])
        blocks[bi] = v
    return np.concatenate([blocks[k] for k in sorted(blocks)])


def _rel(x, ref):
    """Phase-aligned relative distance of each row of x from ref's."""
    c = np.sum(x.conj() * ref, axis=-1) / np.sum(np.abs(x) ** 2, axis=-1)
    return (np.linalg.norm(ref - c[:, None] * x, axis=-1)
            / np.linalg.norm(ref, axis=-1))


def test_complex_twin_matches_jax(jax_sharded, rows2):
    """The complex twin on rows 2 against JAX's ``solve_lowrank_sharded``
    (both complex128, rows 2), phase-aligned: each instance within 1e-6
    (measured 2.1e-7; JAX's Z-prox runs Jacobi sweeps, the port
    ``eigh``)."""
    got = _assemble(rows2, "complex")
    assert (_rel(got, jax_sharded["complex"]) < 1e-6).all()


def test_precompute_u_matches_jax(jax_rows2, jax_pieces):
    """U from the row-sharded Gram against JAX's ``_precompute_u_sharded``
    (U^T, from the real embedding's Cholesky) at float32 tolerance
    (measured 1.8e-7 of its largest entry)."""
    want = jax_pieces["u_conj"]
    for out in jax_rows2:
        np.testing.assert_allclose(out["u"][0].T, want,
                                   atol=1e-5 * np.abs(want).max())


def test_rows_and_batch_agree_with_rows_one_complex_twin(rows2, grid, rows1):
    """The complex twin in complex128: the same solve on any mesh, to
    1e-6 (the JAX package's own rows-2 against rows-1 bar)."""
    for outs in (rows2, grid):
        got = _assemble(outs, "complex")
        err = np.linalg.norm(got - rows1["complex"]) / np.linalg.norm(
            rows1["complex"])
        assert err < 1e-6, err


def test_mesh_shapes(grid):
    """A four-rank world: rows 2 leaves batch 2 (JAX's (4, 2) on eight
    devices), batch 4 x rows 1; a (1, 2) mesh leaves ranks 2 and 3 out."""
    for rank, out in enumerate(grid):
        assert out["shapes"]["default"] == (2, 2)
        assert out["shapes"]["batch4"] == (4, 1)
        assert out["shapes"]["member"] == (rank < 2)
        assert out["coords"] == (rank // 2, rank % 2)


@pytest.mark.parametrize("loop", ["pair_rows", "pair_cols", "complex_rows",
                                  "complex_cols"])
def test_one_rank_hook_matches_the_plain_loop(hook_gaps, loop):
    """On one rank every all-reduce is a copy: the hooked loop takes the
    trips of the hook-less one (``infer_admm_pair(fused_loop=False)``, 40
    warm trips; the complex loop), and its result differs only by the
    square roots taken after the sums.  Measured gaps: 0 (float32 pair
    loop, both passes) and 0 (complex128 loop); held at 1e-6 and 1e-12."""
    gap, trips_hooked, trips_plain = hook_gaps[loop]
    assert trips_hooked == trips_plain
    assert gap <= (1e-6 if loop.startswith("pair") else 1e-12), gap


@pytest.mark.parametrize("name", ["multi", "retry"])
def test_rows_and_batch_agree_with_rows_one_pair_scaffold(rows1, rows2, grid,
                                                          name):
    """The production scaffold on rows 2 and on batch 2 x rows 2 against
    rows 1, the normal config, and every group re-solved with the rank-1
    ladder (one-path channels):
    the rows are summed in another order and the loop amplifies float32
    rounding, so the recoveries are compared by class: quality within
    1e-3, NMSE both below -60 dB or within 1 dB."""
    _, _, x = W.problem(paths=1 if name == "retry" else 2)
    want_x, want_q = rows1[name]["x"], rows1[name]["q"]
    for outs in (rows2, grid):
        got_x = _assemble(outs, name, "x")
        np.testing.assert_allclose(_assemble(outs, name, "q"), want_q,
                                   atol=1e-3)
        for u in range(W.BATCH):
            d1, d2 = nmse_db(want_x[u], x[u]), nmse_db(got_x[u], x[u])
            assert (d1 < -60 and d2 < -60) or abs(d1 - d2) < 1.0, (d1, d2)


@pytest.mark.parametrize("kind", ["rows", "cols"])
def test_rows2_pass_matches_jax(jax_rows2, jax_pieces, kind):
    """A rows-2 pass of the hooked loop against JAX's ``_make_admm`` with
    ``_psum_helpers(None)`` from the same x0, U, A and b, over 30 trips:
    the scale_by_row pass's X through sum_k x_k x_k^H (gauge-invariant)
    within 1e-4 of its scale, the per-column pass's best column within
    1e-4 relative (measured 9.0e-7 and 4.9e-7)."""
    want = jax_pieces[f"x_{kind}"]
    for out in jax_rows2:
        got = out[f"pass_{kind}"]
        if kind == "rows":
            pg, pw = got.T @ got.conj(), want.T @ want.conj()
            np.testing.assert_allclose(pg, pw, atol=1e-4 * np.abs(pw).max())
        else:
            assert _rel(got[None], want[None])[0] < 1e-4


def test_rows_and_batch_agree_with_rows_one_reduced_scaffold(rows1, rows2,
                                                             grid):
    _, _, x = W.problem()
    for outs in (rows2, grid):
        got = _assemble(outs, "reduced")
        for u in range(W.BATCH):
            d1, d2 = nmse_db(rows1["reduced"][u], x[u]), nmse_db(got[u], x[u])
            assert (d1 < -60 and d2 < -60) or abs(d1 - d2) < 1.0, (d1, d2)
        assert np.isfinite(_assemble(outs, "nuclear")).all()


def test_hooked_loops_make_two_all_reduces_a_trip(rows2):
    """Two all-reduces a trip, the any-active flag every 8 trips, and a
    few in the setup and the gates."""
    for out in rows2:
        for calls, trips in ((out["multi"]["calls"], out["multi"]["trips"]),
                             out["complex_counts"]):
            assert trips > 0
            assert 2 * trips < calls < 2.2 * trips, (calls, trips)


def test_two_process_initialize_multihost_solve(rows2):
    """Two processes joined by ``initialize_multihost``: a batch-sharded
    solve, one instance a rank, and the batch's NMSE all-reduced across
    them (``tests/distributed_worker.py``'s checks)."""
    vals = [out["batch_nmse_db"] for out in rows2]
    assert vals[0] == vals[1] and np.isfinite(vals[0]) and vals[0] < -20


def test_scaling_benchmark_skips_counts_above_the_world(rows2):
    for out in rows2:
        assert sorted(out["scaling"]) == [1, 2]
        pt = out["scaling"][1]
        assert pt["efficiency"] == pytest.approx(1.0)
        assert pt["recoveries_per_s"] > 0


def test_forced_retry_runs_every_group_again(rows1, one_rank):
    """Every group re-solved: more trips than the gated solve of the same
    channels, which retries none of them."""
    gated = W.multi(one_rank, W.CFG_MULTI, paths=1)
    assert (gated.quality.numpy() > W.CFG_MULTI.quality_threshold).all()
    assert (rows1["retry"]["iters"] > gated.iters.numpy()).all()


def test_multi_scaffold_matches_jax(jax_sharded, jax_rows2):
    """The production scaffold on rows 2 against JAX's
    ``solve_lowrank_multi_sharded_pair`` on the same instances, given
    JAX's splits and spectral init: quality within 0.05, NMSE both
    deep-converged (below -40 dB) or within 6 dB (tests/test_parallel.py's
    bars for the sharded scaffold against the single-chip one)."""
    _, _, x = W.problem()
    got_x = _assemble(jax_rows2, "multi", "x")
    got_q = _assemble(jax_rows2, "multi", "q")
    np.testing.assert_allclose(got_q, jax_sharded["multi_q"], atol=0.05)
    for u in range(W.BATCH):
        d_t = nmse_db(got_x[u], x[u])
        d_j = nmse_db(jax_sharded["multi_x"][u], x[u])
        assert d_t < -40 or abs(d_t - d_j) < 6.0, (u, d_t, d_j)


def test_spawn_ranks_fails_fast_when_a_rank_raises():
    """A rank that raises fails the world at once, though its peer waits
    in a collective, and no process is left behind."""
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        spawn_one_thread(W.failing_rank, 2, (), WORLD_TIMEOUT)


def test_problem_sharding_cuts_contiguous_blocks():
    mesh = Mesh(batch=2, rows=2, coords=(1, 0), rows_group=None,
                device=torch.device("cpu"))
    a = torch.arange(4 * 6 * 3).reshape(4, 6, 3)
    b = torch.arange(4 * 6).reshape(4, 6)
    al, bl = problem_sharding(mesh, a, b)
    assert torch.equal(al, a[2:4, 0:3]) and torch.equal(bl, b[2:4, 0:3])
    pl, _ = problem_sharding(mesh, Pair(a, -a), b)
    assert torch.equal(pl.im, -a[2:4, 0:3])
    assert torch.equal(batch_sharding(mesh, b), b[2:4])
    with pytest.raises(ValueError, match="row count m 5"):
        problem_sharding(mesh, a[:, :5], b[:, :5])
    with pytest.raises(ValueError, match="batch size 3"):
        problem_sharding(mesh, a[:3], b[:3])
    with pytest.raises(ValueError, match="outside the mesh"):
        batch_sharding(Mesh(1, 1, None, None, None, torch.device("cpu")), b)


def test_make_mesh_checks_its_world(one_rank):
    with pytest.raises(ValueError, match="does not fit"):
        make_mesh(batch=2, rows=1, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(rows=2, device="cpu")
    assert one_rank.shape == (1, 1) and one_rank.member


def test_one_rank_all_reduce_is_a_copy(one_rank):
    red = RowReduce(one_rank.rows_group)
    t = torch.arange(5, dtype=torch.float32)
    assert torch.equal(red.sum_(t.clone()), t)
    assert torch.equal(red.max_(t.clone()), t) and red.calls == 2
