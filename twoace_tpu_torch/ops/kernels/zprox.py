"""K2: warm spectral-profile Z-prox, one CUDA block per lane
(``csrc/zprox.cu``).

Port of ``twoace_tpu.ops.pallas.kernels.fused_zprox_t`` and its batched
form ``fused_zprox_batch``, with the ladder as per-lane runtime tensors.
A CPU tensor takes the plain version :func:`zprox_t_plain`; a CUDA tensor
launches the kernel or raises.

The kernel stages a lane's W in shared memory once (streamed in 64-row
chunks where it does not fit, :func:`plan`) and runs the Gram, the
chain's products and the apply in 3xTF32 on the tensor cores;
:func:`zprox_t_emulated` repeats that arithmetic in plain torch.
"""

from __future__ import annotations

import torch

from ..cplx import (Pair, LadderArrays, add, conj, eigh_desc,
                    eigh_update_perturbative_pair, hermitian_part,
                    ladder_scales, matmul, scale, transpose)
from . import _build
from .pair_matmul import round_tf32

#: the kernel keeps one thread's ladder state in 32-entry registers
MAX_NR = 32
#: the kernel's block (csrc/zprox.cu): threads, and the shared memory a
#: block may opt into on the H100
THREADS = 256
MAX_SMEM = 232448
#: a resident W is staged in at most this many chunks (commit groups); a
#: W that does not fit streams in chunks of STREAM_ROWS rows, two at once
MAX_CHUNKS = 4
STREAM_ROWS = 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def gram_units(nr: int) -> int:
    """The Gram's m16 x n16 blocks, a warp each (``csrc/zprox.cu``)."""
    b = -(-nr // 16)
    return b * b


def gram_slices(nr: int, rows: int) -> int:
    """K slices of the Gram: the block's other warps split K with the
    units' warps, no more slices than W has k8 steps."""
    return max(1, min((THREADS // 32) // gram_units(nr), -(-rows // 8)))


def chain_floats(nr: int) -> int:
    """Floats of the chain's shared memory (``zprox_smem_floats``): eight
    nr x nr matrices, two nr-vectors, one partial sum a warp."""
    return 8 * nr * nr + 2 * nr + THREADS // 32


def plan(rows: int, nr: int) -> dict:
    """How the kernel stages a lane's W (rows x nr, both planes), as
    ``make_plan`` in ``csrc/zprox.cu`` computes it: a row's stride in
    floats (at least nr, 4 mod 8: no bank conflicts), the chunk's rows (a
    multiple of 16), the chunks, the chunks held at once, whether W stays
    resident (read once, kept for the apply) or streams through two
    stages and is read again for the apply, the floats of the Gram's
    partial sums RR, II and RI (one set for each K slice,
    :func:`gram_slices`, rows padded to nr + 1) and the bytes of shared
    memory a block."""
    stride = (nr + 3) // 8 * 8 + 4
    scratch = gram_slices(nr, rows) * 3 * nr * (nr + 1)
    fixed = scratch + _round_up(chain_floats(nr), 4)
    chunk = max(16, _round_up(-(-rows // MAX_CHUNKS), 16))
    chunks = -(-rows // chunk)
    stages, resident = max(chunks, 1), True
    if 4 * (2 * stages * chunk * stride + fixed) > MAX_SMEM:
        chunk, chunks = STREAM_ROWS, -(-rows // STREAM_ROWS)
        stages, resident = 2, False
    return dict(stride=stride, chunk=chunk, chunks=chunks, stages=stages,
                resident=resident, scratch=scratch,
                smem=4 * (2 * stages * chunk * stride + fixed))


def _zprox_t(z: Pair, v0, nr: int, ladder: LadderArrays, mm, gram):
    lanes = z.re.shape[0]
    w = Pair(z.re.reshape(lanes, -1, nr), z.im.reshape(lanes, -1, nr))
    g = hermitian_part(gram(w))
    if v0 is None:
        lam, v = eigh_desc(g)
    else:
        lam, v = eigh_update_perturbative_pair(g, conj(v0), mm=mm)
    coeff = torch.sqrt(ladder_scales(torch.clamp(lam, min=0.0), ladder)) - 1.0
    delta = mm(scale(v, coeff[..., None, :]), conj(transpose(v)))
    w_new = add(w, mm(w, delta))
    return (Pair(w_new.re.reshape(z.re.shape), w_new.im.reshape(z.im.shape)),
            conj(v))


def zprox_t_plain(z: Pair, v0, nt: int, nr: int, ladder: LadderArrays):
    """Batched ``_panel_spectral_prox_c`` on the W form.

    W = z.reshape(lanes, r*nt, nr) is a free view of the transposed state;
    its Gram W^H W is the conjugate of the panel Gram E E^H, so the basis
    is conjugated between the E- and W-conventions at entry and exit.
    ``v0`` (lanes, nr, nr) E-convention, or None for the cold start from
    ``eigh``.  Returns ``(z_new, v_new)`` with v_new in the E-convention.
    """
    return _zprox_t(z, v0, nr, ladder, matmul,
                    lambda w: matmul(conj(transpose(w)), w))


def _steps_3xtf32(x: torch.Tensor, y: torch.Tensor, s: int,
                  slices: int) -> torch.Tensor:
    """x @ y over the k8 steps s, s + slices, ... as the tensor cores form
    it in 3xTF32: each operand split into TF32 big + small, each step's
    small*big + big*small + big*big summed from zero and flushed into a
    float32 sum."""
    shape = (*torch.broadcast_shapes(x.shape[:-2], y.shape[:-2]),
             x.shape[-2], y.shape[-1])
    acc = x.new_zeros(shape)
    for k0 in range(8 * s, x.shape[-1], 8 * slices):
        xk, yk = x[..., k0:k0 + 8], y[..., k0:k0 + 8, :]
        xb, yb = round_tf32(xk), round_tf32(yk)
        xs, ys = round_tf32(xk - xb), round_tf32(yk - yb)
        acc = acc + ((xs @ yb + xb @ ys) + xb @ yb)
    return acc


def matmul_3xtf32(a: Pair, b: Pair) -> Pair:
    """A B as the kernel's chain and apply form it: the Karatsuba 3M terms
    A.re (B.re + B.im), (A.re + A.im) B.im and (A.im - A.re) B.re, each in
    3xTF32 with every k8 step flushed."""
    k1 = _steps_3xtf32(a.re, b.re + b.im, 0, 1)
    k2 = _steps_3xtf32(a.re + a.im, b.im, 0, 1)
    k3 = _steps_3xtf32(a.im - a.re, b.re, 0, 1)
    return Pair(k1 - k2, k1 + k3)


def gram_3xtf32(w: Pair, slices: int) -> Pair:
    """W^H W as the kernel's Gram forms it, before it is made Hermitian:
    the real products RR = Xr^T Xr, II = Xi^T Xi and RI = Xr^T Xi of
    W = Xr + i Xi, each in 3xTF32 with every k8 step flushed, the k8 steps
    dealt round robin to ``slices`` partial sums added in slice order;
    then Re = RR + II and Im = RI - RI^T."""
    xr, xi = w.re.transpose(-1, -2), w.im.transpose(-1, -2)
    rr, ii, ri = (sum(_steps_3xtf32(x, y, s, slices)
                      for s in range(slices))
                  for x, y in ((xr, w.re), (xi, w.im), (xr, w.im)))
    return Pair(rr + ii, ri - ri.transpose(-1, -2))


def zprox_t_emulated(z: Pair, v0, nt: int, nr: int, ladder: LadderArrays):
    """:func:`zprox_t_plain` with the kernel's arithmetic: the Gram
    (:func:`gram_3xtf32`, over its K slices), the chain's products and the
    apply (:func:`matmul_3xtf32`) in 3xTF32 with each k8 step flushed."""
    return _zprox_t(z, v0, nr, ladder, matmul_3xtf32,
                    lambda w: gram_3xtf32(w, gram_slices(nr, w.re.shape[-2])))


def _check(z: Pair, v0: Pair, nt: int, nr: int, ladder: LadderArrays):
    lanes, r, n = z.re.shape
    if n != nt * nr:
        raise ValueError(f"z has {n} columns, need nt*nr = {nt * nr}")
    if not 1 <= nr <= MAX_NR:
        raise ValueError(f"the kernel takes 1 <= nr <= {MAX_NR}, got {nr}")
    levels = ladder.ranks.shape[-1]
    _build.check_inputs({"z.re": (z.re, (lanes, r, n)),
                         "z.im": (z.im, (lanes, r, n)),
                         "v0.re": (v0.re, (lanes, nr, nr)),
                         "v0.im": (v0.im, (lanes, nr, nr)),
                         "ladder.ranks": (ladder.ranks, (lanes, levels)),
                         "ladder.fracs": (ladder.fracs, (lanes, levels))},
                        z.re.device)


def fused_zprox_t(z: Pair, v0: Pair, nt: int, nr: int,
                  ladder: LadderArrays):
    """Warm spectral-profile Z-prox of every lane.

    ``z``: (lanes, r, nt*nr) pair; ``v0``: (lanes, nr, nr) unitary pair in
    the E-convention of ``cplx.panel_gram_basis_pair``; ``ladder``: ranks
    and fracs (lanes, L), padded levels with f = 0.  Returns
    ``(z_new, v_new)``, v_new in the E-convention, so the kernel and the
    plain version are interchangeable inside the solver loop.
    """
    if z.re.device.type == "cpu":
        return zprox_t_plain(z, v0, nt, nr, ladder)
    if z.re.device.type != "cuda":
        raise ValueError(f"unsupported device {z.re.device}")
    _check(z, v0, nt, nr, ladder)
    lanes, r, _ = z.re.shape
    lib = _build.library()
    zn = [torch.empty_like(z.re) for _ in range(2)]
    vn = [torch.empty_like(v0.re) for _ in range(2)]
    stream = torch.cuda.current_stream(z.re.device).cuda_stream
    rc = lib.twoace_zprox_t(
        z.re.data_ptr(), z.im.data_ptr(), v0.re.data_ptr(), v0.im.data_ptr(),
        ladder.ranks.data_ptr(), ladder.fracs.data_ptr(),
        zn[0].data_ptr(), zn[1].data_ptr(), vn[0].data_ptr(),
        vn[1].data_ptr(), lanes, r * nt, nr, ladder.ranks.shape[-1], stream)
    _build.check(rc, "fused_zprox_t")
    fused_zprox_t.launches += 1
    return Pair(*zn), Pair(*vn)


fused_zprox_t.launches = 0
