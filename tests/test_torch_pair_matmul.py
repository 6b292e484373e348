"""K4, the port's batched pair GEMM (``twoace_tpu_torch.ops.kernels.pair_matmul``).

On the CPU the wrapper runs its plain PyTorch version, which is held
against the Pallas kernel it replaces (``twoace_tpu.ops.pallas.pair_matmul``
in interpret mode, as ``tests/test_pallas.py`` runs it), per g of a batch,
and against complex128 numpy.  The tensor-core route's 3xTF32 arithmetic
is held here through its plain torch emulation, and the route a shape
takes is a pure function of the shape.  The CUDA kernel is held against
the plain version on the card by the ``gpu``-marked test (and by
chip_smoke.py).
"""

import importlib

import numpy as np
import pytest
import torch

from torch_parity import (jpair, np_pair, rand_pair_np, require_cuda,
                          tpair)
from twoace_tpu.ops.pallas import pair_matmul as pallas_pair_matmul
from twoace_tpu_torch.ops import kernels
from twoace_tpu_torch.ops.cplx import Pair
from twoace_tpu_torch.ops.pair_solver import no_tf32

# the package exports the function under the module's name
k4 = importlib.import_module("twoace_tpu_torch.ops.kernels.pair_matmul")


def _operands(g, m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return rand_pair_np(rng, g, m, k), rand_pair_np(rng, g, k, n)


@pytest.mark.parametrize("shape,tiles", [
    ((2, 256, 192, 160), dict(tm=128, tn=128, tk=64)),
    # ragged for K4's 64 x 64 x 16 tiling; one Pallas block per operand
    ((2, 70, 97, 51), {}),
])
def test_plain_matches_pallas_interpret_per_g(shape, tiles):
    """The plain version against the Pallas kernel, g by g.  atol 1e-3 is
    test_pallas.py's envelope for the kernel at K = 192 (float32 sums of
    normal products in different orders)."""
    a, b = _operands(*shape)
    got = np_pair(kernels.pair_matmul(tpair(*a), tpair(*b)))
    for g in range(shape[0]):
        want = np_pair(pallas_pair_matmul(jpair(a[0][g], a[1][g]),
                                          jpair(b[0][g], b[1][g]),
                                          interpret=True, **tiles))
        for x, w in zip(got, want):
            np.testing.assert_allclose(x[g], w, atol=1e-3)


def test_plain_matches_complex128():
    """The plain version against the exact product in complex128, at the
    warm tracker's (1, 1, 80) @ (1, 80, 256) (the anchored refine's seed
    is one row) and a ragged batch: relative to the largest entry, within
    1e-5 (float32 rounding over K terms)."""
    for shape in ((1, 1, 80, 256), (3, 70, 97, 51)):
        a, b = _operands(*shape, seed=1)
        got = np_pair(kernels.pair_matmul(tpair(*a), tpair(*b)))
        exact = ((a[0] + 1j * a[1]).astype(np.complex128)
                 @ (b[0] + 1j * b[1]).astype(np.complex128))
        scale = np.abs(exact).max()
        assert np.abs(got[0] + 1j * got[1] - exact).max() / scale < 1e-5


def test_wrapper_checks_reject_what_the_kernel_does_not_take():
    a, b = (tpair(*p) for p in _operands(2, 8, 5, 6))
    k4._check(a, b)
    with pytest.raises(ValueError, match="shape"):
        k4._check(a, Pair(b.re[:, :-1], b.im[:, :-1]))
    with pytest.raises(ValueError, match="float32"):
        k4._check(a, Pair(b.re.double(), b.im.double()))
    with pytest.raises(ValueError, match="contiguous"):
        k4._check(Pair(a.re.transpose(1, 2).contiguous().transpose(1, 2),
                       a.im), b)
    with pytest.raises(ValueError, match=r"\(G, M, K\)"):
        k4._check(Pair(a.re[0], a.im[0]), b)
    meta = Pair(torch.empty(2, 8, 5, device="meta"),
                torch.empty(2, 8, 5, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.pair_matmul(meta, meta)
    kernels.reset_launch_counts()
    kernels.pair_matmul(a, b)
    assert kernels.pair_matmul.launches == 0         # the CPU runs the plain


def test_round_tf32_keeps_ten_mantissa_bits():
    """cvt.rna.tf32.f32: the low 13 bits cleared, within half a TF32 ulp
    (2^-11 relative), ties rounded away from zero."""
    x = torch.tensor(np.random.default_rng(3).normal(size=4096)
                     .astype(np.float32))
    r = k4.round_tf32(x)
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11
    one = 1.0 + 2.0 ** -10                    # the next TF32 after 1
    ties = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                         1 + 3 * 2.0 ** -12])
    assert k4.round_tf32(ties).tolist() == [one, -one, 1.0, one]


@pytest.mark.parametrize("karatsuba", [True, False])
@pytest.mark.parametrize("k", [972, 256])
def test_emulated_3xtf32_keeps_float32_accuracy(k, karatsuba):
    """At the solver's depths (K 972, 256), the tensor-core route's 3xTF32
    arithmetic stays within chip_smoke.py's K4_RTOL (1e-5, max |error|
    over max |reference|) of the complex128 product, in both complex
    forms; plain TF32 (one big*big term) does not, so the split is
    needed."""
    a, b = _operands(1, 64, k, 32, seed=4)
    exact = ((a[0] + 1j * a[1]).astype(np.complex128)
             @ (b[0] + 1j * b[1]).astype(np.complex128))
    scale = np.abs(exact).max()

    def rel(terms):
        got = np_pair(k4.pair_matmul_tf32_emulated(
            tpair(*a), tpair(*b), terms=terms, karatsuba=karatsuba))
        return np.abs(got[0] + 1j * got[1] - exact).max() / scale

    assert rel(3) <= 1e-5
    assert rel(1) > 1e-4


@pytest.mark.parametrize("shape,want", [
    # chip_smoke.py's K4_SHAPES: the batch solver's three products
    ((3, 1280, 972, 256), "tc"), ((3, 1280, 256, 256), "tc"),
    ((3, 1280, 256, 972), "tc"),
    # the anchored refine's one-row products
    ((1, 1, 80, 256), "rows"), ((1, 1, 256, 256), "rows"),
    ((1, 1, 256, 80), "rows"), ((1, 1, 1024, 256), "rows"),
    ((1, 1, 256, 1024), "rows"),
    # ragged, and the edges of the threshold
    ((2, 70, 97, 51), "tc"), ((2, 3, 97, 51), "rows"),
    ((1, k4.ROWS_MAX_M, 256, 256), "rows"),
    ((1, k4.ROWS_MAX_M + 1, 256, 256), "tc")])
def test_route_is_a_function_of_the_shape(shape, want):
    assert k4.route(*shape) == want
    g, m, k, _ = shape
    y, z = k4._grid_yz(want, g, m, k)
    if want == "tc":
        assert (y, z) == (-(-m // 64), g)
    else:
        assert 1 <= y == k4.ksplit(k) <= 8
        assert z == g * -(-m // k4._rows_mr(m))


def test_route_grids_and_counts():
    """The split-K grid's z axis is G times the row blocks: the wrapper
    raises above 65535; the route follows M alone; resetting the launch
    counts resets K4's."""
    big = Pair(torch.zeros(65536, 1, 1), torch.zeros(65536, 1, 1))
    with pytest.raises(ValueError, match="rows route"):
        k4._check(big, big)
    assert [k4.ksplit(k) for k in (1, 80, 256, 1024, 10 ** 6)] == [
        1, 2, 4, 8, 8]
    assert [k4.route(3, m, 972, 256) for m in (1, k4.ROWS_MAX_M,
                                                k4.ROWS_MAX_M + 1, 1280)] == [
        "rows", "rows", "tc", "tc"]
    kernels.pair_matmul.launches = 5
    kernels.reset_launch_counts()
    assert kernels.pair_matmul.launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    # the batch solver's three products
    (3, 1280, 972, 256), (3, 1280, 256, 256), (3, 1280, 256, 972),
    # the anchored refine's: one row, the warm tracker's m 80 and phase 4's
    # m 1024 against n 256
    (1, 1, 80, 256), (1, 1, 256, 256), (1, 1, 256, 80), (1, 1, 1024, 256),
    (1, 1, 256, 1024),
    # ragged for both routes
    (2, 70, 97, 51), (2, 3, 97, 51)])
def test_pair_matmul_kernel_matches_plain_on_card(shape):
    """K4 against its plain version with TF32 off: max |K4 - plain| over
    max |plain| within 1e-5 (chip_smoke.py's tolerance), through the
    route the shape picks."""
    require_cuda()
    a, b = (tpair(*p, device="cuda") for p in _operands(*shape, seed=2))
    which = k4.route(*shape)
    with no_tf32():
        before = kernels.pair_matmul.launches
        got = kernels.pair_matmul(a, b)
        torch.cuda.synchronize()
        assert kernels.pair_matmul.launches == before + 1
        assert which == ("rows" if shape[1] <= k4.ROWS_MAX_M else "tc")
        want = kernels.pair_matmul_plain(a, b)
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-5
