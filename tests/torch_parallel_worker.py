"""Rank functions of the ``torch.distributed`` tests
(``tests/test_torch_parallel.py``), run in processes that
``twoace_tpu_torch.parallel.spawn_ranks`` spawns (gloo on the CPU), and
in the test process itself for the one-rank references.

This module imports torch, numpy and the port only (no jax), so a rank
starts in seconds.  Each rank returns numpy arrays with its mesh
coordinates; the tests put the blocks together.  Not collected by pytest
(no ``test_`` prefix).
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from twoace_tpu_torch.config import AdmmConfig
from twoace_tpu_torch.ops import admm, pair_solver
from twoace_tpu_torch.ops.cplx import LadderArrays, Pair
from twoace_tpu_torch.ops.prox import profile_ladder_arrays
from twoace_tpu_torch.parallel import (make_mesh, problem_sharding,
                                       scaling_benchmark,
                                       solve_lowrank_multi_sharded_pair,
                                       solve_lowrank_sharded,
                                       solve_lowrank_sharded_pair)

NT = NR = 4
N = NT * NR
M = 64
BATCH = 2
#: the production scaffold; every group re-solved with the rank-1 ladder
#: (no quality reaches 1.1, so none rolls back either: run on one-path
#: channels, which the rank-1 ladder fits); the reduced scaffold; the
#: complex twin (maxiter as test_parallel.py's rows test)
CFG_MULTI = AdmmConfig(maxiter=200, n_restarts=2, warm_iters=20)
CFG_RETRY = dataclasses.replace(CFG_MULTI, quality_threshold=1.1)
CFG_REDUCED = AdmmConfig(maxiter=150)
CFG_COMPLEX = AdmmConfig(maxiter=120)
#: JAX parity: one restart (JAX's sharded scaffold compiles each restart
#: into its graph), the pass of ``_make_admm`` over PASS_TRIPS trips
CFG_JAX = AdmmConfig(maxiter=200, n_restarts=1)
PASS_TRIPS = 30


def steer(nn, ang):
    return np.exp(1j * np.pi * np.arange(nn) * np.sin(ang)) / np.sqrt(nn)


def problem(seed=0, batch=BATCH, m=M, paths=2):
    """``batch`` 4x4 channels of ``paths`` paths, each through its own
    2-bit codebook: ``(a (B, m, n) complex128, b (B, m), x (B, n))``."""
    rng = np.random.default_rng(seed)
    a = np.exp(1j * rng.integers(0, 4, (batch, m, N)) * np.pi / 2) / np.sqrt(N)
    xs = []
    for _ in range(batch):
        ang = rng.uniform(-1.2, 1.2, 2 * paths)
        h = sum((rng.normal() + 1j * rng.normal())
                * np.outer(steer(NR, ang[2 * i]),
                           steer(NT, ang[2 * i + 1]).conj())
                for i in range(paths))
        xs.append(h.T.reshape(-1))
    x = np.stack(xs)
    return a, np.abs(np.einsum("umn,un->um", a, x)), x


def _pair(a):
    return Pair(torch.tensor(a.real, dtype=torch.float32),
                torch.tensor(a.imag, dtype=torch.float32))


def _np(p):
    return np.asarray(p.re) + 1j * np.asarray(p.im)


def multi(mesh, cfg, paths=2, seed=0):
    """This rank's production-scaffold solve of ``problem(seed, paths)``."""
    a, b, _ = problem(seed, paths=paths)
    al, bl = problem_sharding(mesh, _pair(a),
                              torch.tensor(b, dtype=torch.float32))
    return solve_lowrank_multi_sharded_pair(
        mesh, torch.Generator().manual_seed(7), al, bl, NT, NR, cfg)


def solves(mesh, seed=0):
    """Every sharded solve of this rank on ``problem(seed)``: the
    production scaffold (the normal config, and every group retried on
    one-path channels), the reduced pair scaffold, its nuclear form, and
    the complex twin in complex128.  Returns this rank's blocks as numpy,
    with the loop's all-reduce counters."""
    a, b, _ = problem(seed)
    al, bl = problem_sharding(mesh, _pair(a),
                              torch.tensor(b, dtype=torch.float32))
    out = dict(coords=mesh.coords, shape=mesh.shape)
    for name, cfg, paths in (("multi", CFG_MULTI, 2), ("retry", CFG_RETRY, 1)):
        mesh.reduce.calls = mesh.reduce.trips = 0
        res = multi(mesh, cfg, paths, seed)
        out[name] = dict(x=_np(res.x), q=res.quality.numpy(),
                         iters=res.iters.numpy(), calls=mesh.reduce.calls,
                         trips=mesh.reduce.trips)
    out["reduced"] = _np(solve_lowrank_sharded_pair(mesh, al, bl, NT, NR,
                                                    CFG_REDUCED))
    out["nuclear"] = _np(solve_lowrank_sharded_pair(
        mesh, al, bl, NT, NR, AdmmConfig(maxiter=60), prox_kind="nuclear"))
    ac, bc = problem_sharding(mesh, torch.tensor(a), torch.tensor(b))
    mesh.reduce.calls = mesh.reduce.trips = 0
    out["complex"] = solve_lowrank_sharded(mesh, ac, bc, NT, NR,
                                           CFG_COMPLEX).numpy()
    out["complex_counts"] = (mesh.reduce.calls, mesh.reduce.trips)
    return out


def jax_parity(mesh, ref):
    """The port's pieces on JAX's inputs (``ref``, numpy, from the JAX
    package on the full rows): U from the row-sharded Gram; the pass of
    ``_make_admm`` from x0 over PASS_TRIPS trips, both pass kinds; the
    production scaffold given JAX's splits and spectral init."""
    a, b, _ = problem()
    rows = slice(mesh.coords[1] * (M // mesh.rows),
                 (mesh.coords[1] + 1) * (M // mesh.rows))
    a0 = _pair(ref["a_n"][:, rows])                        # (1, m_loc, n)
    b0 = torch.tensor(ref["b_n"][:, rows], dtype=torch.float32)
    out = dict(u=_np(pair_solver.precompute_u_pair(a0, reduce=mesh.reduce)))
    lad = profile_ladder_arrays(NT, NR, M, N, False)
    u_mat = _pair(np.conj(ref["u_conj"])[None])
    for kind, scale_by_row in (("rows", True), ("cols", False)):
        x0 = _pair(ref[f"x0_{kind}"][None, None])
        x = pair_solver.infer_admm_pair(
            a0, b0[:, None], x0, scale_by_row=scale_by_row, nt=NT, nr=NR,
            ladder=LadderArrays(*lad), u_mat=u_mat, maxiter=PASS_TRIPS,
            fused_loop=False, reduce=mesh.reduce, m_eff=M)[0]
        out[f"pass_{kind}"] = _np(x)[0, 0]
    al, bl = problem_sharding(mesh, _pair(a),
                              torch.tensor(b, dtype=torch.float32))
    res = solve_lowrank_multi_sharded_pair(
        mesh, torch.Generator().manual_seed(0), al, bl, NT, NR, CFG_JAX,
        splits=(ref["trains"], None), xs=(ref["xs"].real, ref["xs"].imag))
    out["multi"] = dict(x=_np(res.x), q=res.quality.numpy())
    return out


def batch_sharded_nmse(mesh):
    """The two-process solve of ``tests/distributed_worker.py``'s kind:
    the complex twin with one instance a rank, then the batch's mean
    NMSE summed over the ranks by an all-reduce."""
    a, b, x = problem(seed=3)
    ac, bc = problem_sharding(mesh, torch.tensor(a), torch.tensor(b))
    xe = solve_lowrank_sharded(mesh, ac, bc, NT, NR, CFG_COMPLEX)
    xt = torch.tensor(x)[mesh.coords[0] * len(xe):][:len(xe)]
    c = torch.sum(xe.conj() * xt, dim=1) / torch.sum(xe.abs() ** 2, dim=1)
    err = (torch.sum((xt - c[:, None] * xe).abs() ** 2, dim=1)
           / torch.sum(xt.abs() ** 2, dim=1))
    total = torch.sum(err).reshape(1)
    dist.all_reduce(total)
    return float(10 * torch.log10(total / BATCH))


def rows2_rank(rank, world):
    """The two-rank world: every solve on a (1, 2) mesh, a batch-sharded
    (2, 1) solve, and the scaling benchmark."""
    assert (dist.get_rank(), dist.get_world_size()) == (rank, world) == (
        rank, 2)
    out = solves(make_mesh(batch=1, rows=2, device="cpu"))
    out["batch_nmse_db"] = batch_sharded_nmse(
        make_mesh(batch=2, rows=1, device="cpu"))
    pts = scaling_benchmark(nt=NT, nr=NR, m=M, batch_per_device=1,
                            device_counts=[1, 2, 4],
                            cfg=AdmmConfig(maxiter=20), reps=1, device="cpu")
    out["scaling"] = {d: dataclasses.asdict(p) for d, p in pts.items()}
    return out


def jax_rank(rank, world, ref):
    """A second two-rank world: the JAX-parity pieces on a (1, 2) mesh
    (it waits for JAX's inputs; the first world does not)."""
    mesh = make_mesh(batch=1, rows=2, device="cpu")
    return dict(coords=mesh.coords, **jax_parity(mesh, ref))


def grid_rank(rank, world):
    """The four-rank world: the mesh shapes, then every solve on a (2, 2)
    mesh; ranks 2 and 3 lie outside a (1, 2) mesh."""
    shapes = dict(default=make_mesh(rows=2, device="cpu").shape,
                  batch4=make_mesh(batch=4, rows=1, device="cpu").shape)
    part = make_mesh(batch=1, rows=2, device="cpu")
    shapes["member"] = part.member
    out = solves(make_mesh(batch=2, rows=2, device="cpu"))
    out["shapes"] = shapes
    return out


def failing_rank(rank, world):
    """Rank 1 raises while rank 0 waits in a collective for it."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def one_rank_loops(mesh):
    """The hooked loops on a one-rank mesh against the hook-less ones on
    the same inputs: the pair loop (``infer_admm_pair(fused_loop=False)``,
    both pass kinds, with warm trips) and the complex loop.  Returns the
    largest |difference| over the largest |value| of each result, and
    both trip counts."""
    a, b, _ = problem()
    a0, b0 = _pair(a[:1]), torch.tensor(b[:1, None], dtype=torch.float32)
    lad = profile_ladder_arrays(NT, NR, M, N, False)
    x0 = pair_solver.spectral_initialize_pair(
        a0, b0, 6, torch.Generator().manual_seed(0))
    out = {}
    for kind, scale_by_row in (("rows", True), ("cols", False)):
        kw = dict(scale_by_row=scale_by_row, nt=NT, nr=NR, ladder=lad,
                  maxiter=300, warm_iters=40, fused_loop=False)
        plain = pair_solver.infer_admm_pair(a0, b0, x0, **kw)
        hooked = pair_solver.infer_admm_pair(a0, b0, x0, reduce=mesh.reduce,
                                             m_eff=M, **kw)
        out[f"pair_{kind}"] = (_gap(_np(hooked[0]), _np(plain[0])),
                               int(hooked[3]), int(plain[3]))
    ac, bc = torch.tensor(a[0]), torch.tensor(b[0])
    prox = admm._make_prox("spectral_profile", NT, NR, M, N, False,
                           CFG_COMPLEX, "xla")
    u = admm._precompute_u(ac)
    xs = torch.tensor(_np(x0)[0, 0].T).to(torch.complex128)
    for kind, scale_by_row in (("rows", True), ("cols", False)):
        runs = []
        for reduce in (None, mesh.reduce):
            admm.infer_admm.trips = 0
            x = admm.infer_admm(ac, bc, xs, scale_by_row=scale_by_row,
                                prox=prox, u_mat=u, maxiter=300,
                                reduce=reduce, m_eff=M)[0]
            runs.append((x.numpy(), admm.infer_admm.trips))
        (xh, th), (xp, tp) = runs[1], runs[0]
        out[f"complex_{kind}"] = (_gap(xh, xp), th, tp)
    return out


def _gap(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())
