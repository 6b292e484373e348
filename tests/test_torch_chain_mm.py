"""K6, the port's renormalised chain of batched complex products
(``twoace_tpu_torch.ops.kernels.chain_mm``).

On the CPU the wrapper runs its plain PyTorch version, which is held
against the Pallas kernel it replaces (``chain_kernel`` of
``scripts/bench_pallas_mm.py``, in interpret mode, in both of its
contraction layouts) and against the numpy complex128 chain the script
checks itself with.  The CUDA kernel is held against the plain version on
the card by the ``gpu``-marked test (and by chip_smoke.py).
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import torch_parity  # noqa: F401  (one torch thread per worker)
from torch_parity import require_cuda
from twoace_tpu_torch.ops import kernels
from twoace_tpu_torch.ops.cplx import Pair

k6 = importlib.import_module("twoace_tpu_torch.ops.kernels.chain_mm")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def script():
    """scripts/bench_pallas_mm.py as a module.  Importing it points the
    JAX compilation cache at the repo root's .jax_cache: the conftest's
    settings are put back afterwards."""
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        "bench_pallas_mm", os.path.join(ROOT, "scripts", "bench_pallas_mm.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)
    return mod


def _pallas_chain(mod, planes, mode):
    """One launch of the TPU kernel in interpret mode, in the script's grid
    (B // TB blocks of TB instances on the lanes), in contraction ``mode``."""
    n, b, tb = mod.N, mod.B, mod.TB
    spec = pl.BlockSpec((n, n, tb), lambda t: (0, 0, t))
    mod.MODE = mode                       # read when the kernel is traced
    try:
        f = pl.pallas_call(
            mod.chain_kernel, grid=(b // tb,), in_specs=[spec] * 4,
            out_specs=[spec] * 2,
            out_shape=[jax.ShapeDtypeStruct((n, n, b), np.float32)] * 2,
            interpret=True)
        return [np.asarray(o) for o in f(*planes)]
    finally:
        mod.MODE = "mid"


@pytest.mark.parametrize("mode", ["mid", "kfirst"])
def test_plain_matches_pallas_interpret(script, mode):
    """The plain version against one launch of ``chain_kernel`` (8 steps,
    B = 256 in blocks of TB 128) in each contraction layout, on the
    script's own inputs: within 1e-6 absolute (entries of order 0.06,
    float32 sums of 16 products in different orders)."""
    assert (script.B, script.N, script.TB, script.CHAIN) == (
        k6.B, k6.N, 128, k6.CHAIN)
    planes = k6.lane_inputs(seed=0)
    want = _pallas_chain(script, planes, mode)
    v = k6.from_lanes(Pair(*(torch.tensor(p) for p in planes[:2])))
    g = k6.from_lanes(Pair(*(torch.tensor(p) for p in planes[2:])))
    got = k6.to_lanes(kernels.pair_chain_mm(v, g))
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), w, atol=1e-6, rtol=0)


def test_hundred_launches_match_numpy_complex128():
    """100 launches of the plain chain (800 products) against the numpy
    complex128 chain of bench_pallas_mm.py:111-122, and the library
    chain's complex64 ``torch.matmul`` the same: the chain converges to a
    dominant direction, so float32 rounding stays near 1e-6."""
    planes = k6.lane_inputs(seed=1, b=32)
    v = k6.from_lanes(Pair(*(torch.tensor(p) for p in planes[:2])))
    g = k6.from_lanes(Pair(*(torch.tensor(p) for p in planes[2:])))
    vc, gc = torch.complex(*v), torch.complex(*g)
    for _ in range(k6.REPS):
        v = kernels.pair_chain_mm(v, g)
        vc = k6.library_chain(vc, gc)
    want = k6.numpy_chain(np.transpose(planes[0] + 1j * planes[1], (2, 0, 1)),
                          np.transpose(planes[2] + 1j * planes[3], (2, 0, 1)),
                          k6.REPS * k6.CHAIN)
    assert np.abs(v.re.numpy() + 1j * v.im.numpy() - want).max() < 2e-5
    assert np.abs(vc.numpy() - want).max() < 2e-5


def test_wrapper_checks_reject_what_the_kernel_does_not_take():
    rng = np.random.default_rng(2)
    p = Pair(*(torch.tensor(rng.normal(size=(3, 4, 4)), dtype=torch.float32)
               for _ in range(2)))
    k6._check(p, p)
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        k6._check(Pair(p.re[:, :3], p.im[:, :3]), p)
    with pytest.raises(ValueError, match="shape"):
        k6._check(p, Pair(p.re[:2], p.im[:2]))
    with pytest.raises(ValueError, match="float32"):
        k6._check(p, Pair(p.re.double(), p.im.double()))
    with pytest.raises(ValueError, match="contiguous"):
        k6._check(p, Pair(p.re.transpose(1, 2), p.im))
    big = torch.zeros(1, 33, 33)
    with pytest.raises(ValueError, match="n <= 32"):
        k6._check(Pair(big, big), Pair(big, big))
    meta = Pair(torch.empty(2, 4, 4, device="meta"),
                torch.empty(2, 4, 4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.pair_chain_mm(meta, meta)
    kernels.reset_launch_counts()
    out = kernels.pair_chain_mm(p, p, steps=0)
    assert kernels.pair_chain_mm.launches == 0       # the CPU runs the plain
    assert torch.equal(out.re, p.re) and torch.equal(out.im, p.im)
    assert kernels.launch_counts()["pair_chain_mm"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [256, 100])
def test_chain_kernel_matches_plain_on_card(batch):
    """K6 against its plain version at the benchmark's (256, 16, 16) and a
    ragged batch: max |K6 - plain| over max |plain| within 1e-5
    (chip_smoke.py's tolerance)."""
    require_cuda()
    planes = k6.lane_inputs(seed=3, b=batch)
    v = k6.from_lanes(Pair(*(torch.tensor(p, device="cuda")
                             for p in planes[:2])))
    g = k6.from_lanes(Pair(*(torch.tensor(p, device="cuda")
                             for p in planes[2:])))
    before = kernels.pair_chain_mm.launches
    got = kernels.pair_chain_mm(v, g)
    torch.cuda.synchronize()
    assert kernels.pair_chain_mm.launches == before + 1
    want = kernels.pair_chain_mm_plain(v, g)
    for x, w in zip(got, want):
        assert float((x - w).abs().max() / w.abs().max()) <= 1e-5
