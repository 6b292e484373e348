"""The recorder of ``twoace_tpu_torch.utils.profiling`` inside the A2
solvers: spans and lane-trip records of the batch and single entries at
4x4 on the CPU, nothing kept without a profiler, and on the card (``gpu``)
a CUDA-only profiler session turning recording on with one K3 record a
launch, and the spectral init's orthonormalisation steps as batched
launches with a span each.  Imports no JAX: the ``gpu`` tests run on the
card."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from twoace_tpu_torch.config import AdmmConfig
from twoace_tpu_torch.ops import kernels
from twoace_tpu_torch.ops import pair_solver as tps
from twoace_tpu_torch.ops.cplx import Pair
from twoace_tpu_torch.utils import profiling

NT = NR = 4
N = NT * NR
M, BATCH, R = 48, 3, 3
#: a quality above any restart's forces the rank-1 retry of every one
CFG = AdmmConfig(rank=R, maxiter=60, n_restarts=2, warm_iters=8,
                 stage1_maxiter=30, stage2_maxiter=40, quality_threshold=2.0)
SINGLE_CFG = AdmmConfig(rank=R, maxiter=60, n_restarts=2,
                        quality_threshold=2.0)
#: the span names each entry opens under its root, a retry included
SETUP = {"setup.splits", "setup.normalize", "setup.precompute_u",
         "setup.spectral_init", "setup.spectral_init.draw",
         "setup.spectral_init.orth", "setup.orthonormalize",
         "setup.admm_init"}
NAMES = {
    "batch": SETUP | {"setup.active_rows", "stage.first_pass", "stage.retry",
                      "stage.refine", "inner.solve", "inner.check",
                      "scaffold.quality", "scaffold.gate", "scaffold.select",
                      "scaffold.rollback"},
    "single": SETUP | {"stage.first_pass", "stage.retry", "stage.refine",
                       "inner.solve", "inner.check", "scaffold.quality",
                       "scaffold.gate", "scaffold.select",
                       "scaffold.rollback"},
}


def _problem(device="cpu", seed=3):
    """A 2-bit codebook (M, N) and the magnitudes of BATCH two-path
    channels through it."""
    rng = np.random.default_rng(seed)
    a = np.exp(1j * rng.integers(0, 4, (M, N)) * np.pi / 2) / np.sqrt(N)
    h = sum(rng.normal(size=(BATCH, N, 1)) * np.exp(
        1j * np.arange(N) * rng.uniform(-1, 1, (BATCH, 1, 1)))
        for _ in range(2))[..., 0]
    b = np.abs(h @ a.T).astype(np.float32)
    pair = Pair(torch.tensor(a.real, dtype=torch.float32, device=device),
                torch.tensor(a.imag, dtype=torch.float32, device=device))
    return pair, torch.tensor(b, device=device)


def _solve(kind, device="cpu", given=False):
    """One entry call; ``given`` hands it splits and a spectral init."""
    a, b = _problem(device)
    gen = torch.Generator().manual_seed(11)
    kw = {}
    if given:
        rng = np.random.default_rng(5)
        perms = [rng.permutation(M) for _ in range(2)]
        k = int(np.floor(M * 0.95))
        kw["splits"] = (np.stack([p[:k] for p in perms]),
                        np.stack([p[k:] for p in perms]))
        lead = (BATCH, 2) if kind == "batch" else (2,)
        kw["xs"] = Pair(*(torch.tensor(rng.normal(size=lead + (R, N)),
                                       dtype=torch.float32)
                          for _ in range(2)))
    if kind == "batch":
        return tps.solve_lowrank_multi_pair_batch(gen, a, b, NT, NR, CFG,
                                                  **kw)
    return tps.solve_lowrank_multi_pair(gen, a, b[0], NT, NR, SINGLE_CFG,
                                        **kw)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def test_nothing_recorded_without_a_profiler():
    assert not profiling.recording()
    assert profiling.span("pair.batch") is profiling.span("inner.check")
    for kind in ("batch", "single"):
        _solve(kind)
    assert profiling.snapshot() == ([], [])


@pytest.mark.parametrize("kind", ["batch", "single"])
def test_spans_nest_under_one_root_per_solve(kind):
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        for _ in range(2):
            _solve(kind)
    spans, trips = profiling.snapshot()
    roots = [i for i, sp in enumerate(spans) if sp.parent < 0]
    assert [spans[i].name for i in roots] == [f"pair.{kind}"] * 2
    for root, end in zip(roots, roots[1:] + [len(spans)]):
        mine = spans[root + 1:end]
        assert {sp.call for sp in mine} == {root}
        assert {sp.name for sp in mine} == NAMES[kind]
        for sp in mine:            # inside its parent, on the host clock
            up = spans[sp.parent]
            assert up.start_ns <= sp.start_ns <= sp.end_ns <= up.end_ns
        # one inner loop a pass (two passes, the retry's two) and the refine
        solves = [root + 1 + i for i, sp in enumerate(mine)
                  if sp.name == "inner.solve"]
        assert len(solves) == 5
        assert sorted(t.span for t in trips if t.call == root) == solves
        draws = [sp for sp in mine if sp.name == "setup.spectral_init.draw"]
        assert [spans[sp.parent].name for sp in draws] == [
            "setup.spectral_init"]
        orths = [sp for sp in mine if sp.name == "setup.spectral_init.orth"]
        assert [spans[sp.parent].name for sp in orths] == [
            "setup.spectral_init"] * 13           # the start block, 12 trips
        checks = [sp for sp in mine if sp.name == "inner.check"]
        assert {spans[sp.parent].name for sp in checks} == {"inner.solve"}


@pytest.mark.parametrize("kind", ["batch", "single"])
def test_lane_trips_sum_to_iters(kind):
    """Every lane trip counted once: the records' active trips sum to the
    result's iters, a retry and the refine included."""
    with profile(activities=[ProfilerActivity.CPU]):
        res = _solve(kind, given=True)
    _, trips = profiling.snapshot()
    assert len(trips) == 5
    assert sum(t.active for t in trips) == int(res.iters.sum())
    path = "per-op" if kind == "batch" else "k3-plain"
    assert {(t.path, t.zprox, t.n) for t in trips} == {(path, "k2", N)}
    mt = int(np.floor(M * 0.95))
    assert [(t.r, t.m) for t in trips] == [(R, mt)] * 4 + [(1, M)]
    for t in trips:            # lockstep trips carry every lane
        assert t.active <= t.trips * t.lanes
    lanes = [t.lanes for t in trips]
    if kind == "batch":        # (restart, instance) lanes, then instances
        assert lanes == [2 * BATCH] * 4 + [BATCH]
    else:
        assert lanes == [2] * 4 + [1]


@pytest.mark.gpu
def test_cuda_profiler_records_one_k3_entry_a_launch():
    """A CUDA-only profiler session (the benchmark's tracer) turns
    recording on; each K3 launch of a single solve leaves one record of
    its lanes' trips, and they sum to the solve's iters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    _solve("single", device="cuda")                  # builds the kernels
    torch.cuda.synchronize()
    profiling.reset()
    before = kernels.fused_infer_admm.launches
    with profile(activities=[ProfilerActivity.CUDA]):
        assert profiling.recording()
        res = _solve("single", device="cuda")
        torch.cuda.synchronize()
    launches = kernels.fused_infer_admm.launches - before
    spans, trips = profiling.snapshot()
    assert launches == 5
    assert [t.path for t in trips] == ["k3"] * launches
    assert all(t.trips is None for t in trips)
    assert sum(t.active for t in trips) == int(res.iters.sum())
    assert [sp.name for sp in spans].count("inner.solve") == launches


#: cuSOLVER's Householder QR kernels (geqrf's geqr2 and larft, ungqr/orgqr)
HOUSEHOLDER = ("geqr", "larft", "ungqr", "orgqr")


def _device_kernels(prof) -> list:
    """Names of the device events of a finished CUDA-only session."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    return [e.name() for e in results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()]


@pytest.mark.gpu
def test_spectral_init_orthonormalises_in_batched_launches_on_card():
    """The batch scaffold's spectral init at 16x16 (3 groups, m 972, r 20)
    on the card, at 1 lane a group and at 256: no Householder QR kernel
    runs, each of the 13 orthonormalisations leaves one span, and one
    orthonormalisation launches as many kernels at 256 lanes as at 1 (its
    Cholesky and triangular solve are batched launches, not a loop over
    the lanes).  The count is taken on the step itself: cuBLAS picks its
    GEMM kernels by size, one more for the init's products at 256 lanes
    than at 1 on torch 2.11."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(12)
    g_, m, n, r = 3, 972, 256, 20
    a = np.exp(1j * rng.integers(0, 4, (g_, m, n)) * np.pi / 2) / np.sqrt(n)
    a_t = Pair(torch.tensor(a.real, dtype=torch.float32, device="cuda"),
               torch.tensor(a.imag, dtype=torch.float32, device="cuda"))
    counts = {}
    for p_ in (1, 256):
        h = rng.normal(size=(g_, p_, n)) + 1j * rng.normal(size=(g_, p_, n))
        b = torch.tensor(np.abs(np.einsum("gmn,gpn->gpm", a, h)),
                         dtype=torch.float32, device="cuda")

        def init():
            with tps.no_tf32():
                return tps.spectral_initialize_pair(
                    a_t, b, r, torch.Generator().manual_seed(p_))

        z = torch.randn((g_, p_, n, r), dtype=torch.complex64,
                        device="cuda")
        init()                                  # handles, workspaces
        tps._cholqr2(z)
        torch.cuda.synchronize()
        profiling.reset()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            x0 = init()
            torch.cuda.synchronize()
        assert x0.re.shape == (g_, p_, r, n)
        assert bool(torch.isfinite(x0.re).all() & torch.isfinite(x0.im).all())
        names = _device_kernels(prof)
        assert not [k for k in names if any(h in k for h in HOUSEHOLDER)]
        spans, _ = profiling.snapshot()
        assert [sp.name for sp in spans].count(
            "setup.spectral_init.orth") == 13
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tps._cholqr2(z)
            torch.cuda.synchronize()
        counts[p_] = collections.Counter(_device_kernels(prof))
    assert sum(counts[1].values()) == sum(counts[256].values()), (
        counts[1] - counts[256], counts[256] - counts[1])
