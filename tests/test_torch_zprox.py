"""K2's arithmetic and its shared-memory plan (``ops/kernels/zprox.py``).

The kernel (``csrc/zprox.cu``) runs the Gram, the chain's products and the
apply in 3xTF32 on the tensor cores; ``zprox_t_emulated`` repeats that
arithmetic in plain torch (each k8 step's three TF32 products flushed into
float32, the Gram's K slices summed in order).  Here, on the CPU, the
emulation is held against the plain version, the loop in float64 and
the JAX Pallas kernel (interpret mode); ``plan`` (how the kernel stages a
lane's W) is checked for what the kernel needs of it.  The kernel itself
is held against its plain version on the card by the ``gpu``-marked
tests here and in ``test_torch_kernels.py``, and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from torch_parity import (assert_pair_close, jpair, rand_pair_np,
                          require_cuda, tpair)
from twoace_tpu.ops.pallas import fused_zprox_t as pallas_zprox_t
from twoace_tpu.ops.prox import profile_ladder
from twoace_tpu_torch.ops.cplx import (LadderArrays, Pair, conj,
                                       hermitian_part, matmul, transpose)
from twoace_tpu_torch.ops.kernels import zprox as k2
from twoace_tpu_torch.ops.kernels.pair_matmul import round_tf32
from twoace_tpu_torch.ops.prox import profile_ladder_arrays

#: (lanes, r, nt, nr): nr 8, 16 and 32, and two ragged rows (24: not a
#: multiple of 16; 15: not of 8)
SHAPES = [(3, 12, 8, 8), (2, 20, 16, 16), (2, 6, 32, 32), (3, 3, 8, 8),
          (3, 5, 3, 8)]
#: the emulation against the plain version: test_pallas.py's envelope for
#: the Pallas kernel against the XLA chain (at most 5.9e-6 on these inputs)
EMU_ATOL = 2e-5
#: the emulation and the plain version against the loop in float64: a
#: fifth of chip_smoke.py's K2_ATOL (at most 3.5e-6 and 4.6e-6 on these
#: inputs)
F64_ATOL = 1e-5


def _inputs(lanes, r, nt, nr, seed=0):
    """z, a warm basis from a cold eigh of a perturbed z, and the normal,
    rank-1 and full-data ladders mixed over the lanes (chip_smoke.k2_case
    on the CPU, from numpy)."""
    rng = np.random.default_rng(seed)
    n = nt * nr
    z = tpair(*rand_pair_np(rng, lanes, r, n))
    dz = tpair(*rand_pair_np(rng, lanes, r, n))
    zp = Pair(z.re + 0.05 * dz.re, z.im + 0.05 * dz.im)
    m = 4 * n
    m_train = int(np.floor(m * 0.95))
    ladders = [profile_ladder_arrays(nt, nr, m_train, n, False),
               profile_ladder_arrays(nt, nr, m_train, n, True),
               profile_ladder_arrays(nt, nr, m, n, False)]
    pick = torch.arange(lanes) % 3
    lad = LadderArrays(torch.stack([l.ranks for l in ladders])[pick],
                       torch.stack([l.fracs for l in ladders])[pick])
    _, v0 = k2.zprox_t_plain(zp, None, nt, nr, lad)
    return z, v0, lad


def _up(x, m):
    return -(-x // m) * m


def _f64(p):
    return Pair(p.re.double(), p.im.double())


def _dist(a, b):
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b))


@pytest.mark.parametrize("m, k, n", [
    (16, 320, 16), (32, 640, 32), (16, 16, 16), (8, 15, 8)])
def test_emulated_3xtf32_product_keeps_float32_accuracy(m, k, n):
    """The chain's and the apply's product (3xTF32, Karatsuba 3M, flushed
    each k8 step) stands within 3x the float32 product's error of
    complex128, where one TF32 product alone is a thousand times further
    off."""
    rng = np.random.default_rng(1)
    a = tpair(*rand_pair_np(rng, 3, m, k))
    b = tpair(*rand_pair_np(rng, 3, k, n))
    exact = (torch.complex(*_f64(a)) @ torch.complex(*_f64(b)))
    scale = float(exact.abs().max())

    def err(p):
        return float((torch.complex(*_f64(p)) - exact).abs().max()) / scale

    big = Pair(round_tf32(a.re), round_tf32(a.im))
    one = matmul(big, Pair(round_tf32(b.re), round_tf32(b.im)))
    got, plain = err(k2.matmul_3xtf32(a, b)), err(matmul(a, b))
    assert got <= 3 * plain and got < 1e-6
    assert err(one) > 1e-4


@pytest.mark.parametrize("rows, nr, slices", [
    (320, 16, 8), (640, 32, 2), (16, 16, 2), (15, 8, 2), (24, 8, 3)])
def test_emulated_gram_is_hermitian_and_keeps_float32_accuracy(rows, nr,
                                                               slices):
    """The kernel's Gram (RR, II, RI in 3xTF32 over its K slices) made
    Hermitian stands within 3x the float32 Gram's error of complex128."""
    rng = np.random.default_rng(3)
    w = tpair(*rand_pair_np(rng, 2, rows, nr))
    wc = torch.complex(*_f64(w))
    exact = wc.conj().transpose(-1, -2) @ wc
    scale = float(exact.abs().max())

    def err(p):
        return float((torch.complex(*_f64(p)) - exact).abs().max()) / scale

    got = hermitian_part(k2.gram_3xtf32(w, slices))
    plain = hermitian_part(matmul(conj(transpose(w)), w))
    assert err(got) <= 3 * err(plain) and err(got) < 1e-6
    assert torch.equal(got.re, got.re.transpose(-1, -2))
    assert torch.equal(got.im, -got.im.transpose(-1, -2))


@pytest.mark.parametrize("lanes, r, nt, nr", SHAPES)
def test_emulated_kernel_matches_plain_and_float64(lanes, r, nt, nr):
    """The kernel's arithmetic, emulated, against the plain version and
    against the plain version run in float64 (the ladders act: z moves)."""
    z, v0, lad = _inputs(lanes, r, nt, nr)
    got = k2.zprox_t_emulated(z, v0, nt, nr, lad)
    plain = k2.zprox_t_plain(z, v0, nt, nr, lad)
    exact = k2.zprox_t_plain(_f64(z), _f64(v0), nt, nr,
                             LadderArrays(lad.ranks.double(),
                                          lad.fracs.double()))
    for g, p, e in zip(got, plain, exact):
        assert _dist(g, p) <= EMU_ATOL
        assert _dist(g, e) <= F64_ATOL
        assert _dist(p, e) <= F64_ATOL
    assert float((got[0].re - z.re).abs().max()) > 1e-2


def test_emulated_kernel_matches_pallas_interpret():
    """The emulation against the TPU kernel it replaces (``fused_zprox_t``
    in interpret mode, a static ladder), lane by lane, at
    test_pallas.py's envelope."""
    nt = nr = 8
    r, n = 12, 64
    z, v0, _ = _inputs(3, r, nt, nr, seed=2)
    lad = profile_ladder_arrays(nt, nr, 4 * n, n, False)
    lad_t = LadderArrays(lad.ranks.expand(3, -1).contiguous(),
                         lad.fracs.expand(3, -1).contiguous())
    zn, vn = k2.zprox_t_emulated(z, v0, nt, nr, lad_t)
    for i in range(3):
        z_w, v_w = pallas_zprox_t(
            jpair(z.re[i].numpy(), z.im[i].numpy()),
            jpair(v0.re[i].numpy(), v0.im[i].numpy()), nt, nr,
            profile_ladder(nt, nr, 4 * n, n, False), interpret=True)
        assert_pair_close(Pair(zn.re[i], zn.im[i]), z_w, atol=EMU_ATOL)
        assert_pair_close(Pair(vn.re[i], vn.im[i]), v_w, atol=EMU_ATOL)


def test_plan_at_the_main_path_shapes():
    """The batch solve's W (r 20, 16x16: 320 rows) stays resident in four
    80-row chunks in at most 110 KB, so two blocks share an SM (192 lanes
    on 132 SMs); the warm trackers' 16 rows in one chunk, in under 20 KB;
    the 32x32
    point's 640 rows (160 KB a lane, 180 KB padded) stream in 64-row
    chunks; the ragged 24 rows take two 16-row chunks."""
    main = k2.plan(20 * 16, 16)
    assert main["resident"] and (main["chunk"], main["chunks"]) == (80, 4)
    assert main["stride"] == 20 and main["smem"] <= 110 * 1024
    assert 2 * (main["smem"] + 1024) <= 228 * 1024
    warm = k2.plan(16, 16)
    assert warm["resident"] and warm["chunks"] == 1
    assert warm["smem"] < 20 * 1024          # partials for its 2 K slices
    full32 = k2.plan(20 * 32, 32)
    assert not full32["resident"] and full32["stages"] == 2
    assert (full32["chunk"], full32["chunks"]) == (k2.STREAM_ROWS, 10)
    assert full32["stride"] == 36 and full32["smem"] <= k2.MAX_SMEM
    ragged = k2.plan(24, 8)
    assert ragged["resident"] and (ragged["chunk"], ragged["chunks"]) == (16, 2)


@pytest.mark.parametrize("nr", [1, 3, 4, 6, 8, 12, 16, 17, 20, 24, 31, 32])
def test_plan_fits_every_shape_the_wrapper_takes(nr):
    """For every nr the wrapper takes and rows from 0 to 10^4: a staged
    row holds nr floats at a stride of 4 mod 8, the chunks cover the rows
    in multiples of 16, the block's shared memory fits the card, and W
    streams only where the resident layout would not fit."""
    for rows in (0, 1, 7, 15, 16, 24, 63, 320, 640, 1000, 3000, 10000):
        p = k2.plan(rows, nr)
        assert p["stride"] >= nr and p["stride"] % 8 == 4
        assert p["chunk"] % 16 == 0 and p["chunk"] * p["chunks"] >= rows
        assert p["smem"] <= k2.MAX_SMEM
        assert p["scratch"] == (k2.gram_slices(nr, rows) * 3 * nr
                                * (nr + 1))
        if p["resident"]:
            assert p["stages"] == max(p["chunks"], 1) <= k2.MAX_CHUNKS
        else:
            chunk = max(16, _up(_up(rows, k2.MAX_CHUNKS) // k2.MAX_CHUNKS,
                                16))
            resident = 4 * (2 * _up(rows, chunk) * p["stride"] + p["scratch"]
                            + _up(k2.chain_floats(nr), 4))
            assert resident > k2.MAX_SMEM and p["stages"] == 2


@pytest.mark.parametrize("nr, rows, slices", [
    (16, 320, 8), (16, 16, 2), (16, 3, 1), (8, 24, 3), (32, 640, 2),
    (20, 8, 1), (32, 0, 1)])
def test_gram_slices_follow_the_rows(nr, rows, slices):
    """The Gram's m16 x n16 blocks take a warp each (1 block up to nr 16,
    else 4) and the other warps split K with them, into no more slices
    than W has k8 steps."""
    assert k2.gram_slices(nr, rows) == slices
    assert k2.gram_units(nr) * k2.gram_slices(nr, rows) <= 8


@pytest.mark.gpu
def test_plan_matches_the_kernel():
    """The Python plan is the kernel's own (C ``twoace_zprox_plan``)."""
    import ctypes

    require_cuda()
    from twoace_tpu_torch.ops.kernels import _build

    lib = _build.library()
    out = (ctypes.c_int * 7)()
    keys = ("stride", "chunk", "chunks", "stages", "resident", "scratch",
            "smem")
    for nr in (1, 6, 8, 16, 20, 32):
        for rows in (0, 15, 24, 320, 640, 3200):
            assert lib.twoace_zprox_plan(rows, nr, out) == 0
            want = k2.plan(rows, nr)
            assert {k: int(v) for k, v in zip(keys, out)} == {
                k: int(want[k]) for k in keys}
