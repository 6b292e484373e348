"""K4: batched pair-complex GEMM (``csrc/pair_matmul.cu``).

Port of ``twoace_tpu.ops.pallas.kernels.pair_matmul``, batched over an
outer axis G: C[g] = A[g] @ B[g] with A (G, M, K), B (G, K, N), on planar
float32 (re, im) pairs, in the Karatsuba 3M form with float32
accumulation.  A CPU tensor takes the plain version
:func:`pair_matmul_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..cplx import Pair, matmul
from . import _build

#: the kernel's grid: 64-row tiles on gridDim.y, G on gridDim.z
_MAX_GRID_YZ = 65535
_TILE_M = 64


def pair_matmul_plain(a: Pair, b: Pair) -> Pair:
    """Plain PyTorch version: ``cplx.matmul`` (three real batched
    products) of (G, M, K) and (G, K, N) pairs."""
    return matmul(a, b)


def _check(a: Pair, b: Pair):
    if a.re.dim() != 3 or b.re.dim() != 3:
        raise ValueError(f"need (G, M, K) and (G, K, N) pairs, got "
                         f"{tuple(a.re.shape)} and {tuple(b.re.shape)}")
    g_, m, k = a.re.shape
    n = b.re.shape[-1]
    if g_ > _MAX_GRID_YZ or -(-m // _TILE_M) > _MAX_GRID_YZ:
        raise ValueError(f"the kernel takes G <= {_MAX_GRID_YZ} and M <= "
                         f"{_MAX_GRID_YZ * _TILE_M}, got G {g_}, M {m}")
    _build.check_inputs({"a.re": (a.re, (g_, m, k)), "a.im": (a.im, (g_, m, k)),
                         "b.re": (b.re, (g_, k, n)), "b.im": (b.im, (g_, k, n))},
                        a.re.device)


def pair_matmul(a: Pair, b: Pair) -> Pair:
    """C[g] = A[g] @ B[g] of contiguous float32 pairs A (G, M, K) and
    B (G, K, N); returns the (G, M, N) pair."""
    if a.re.device.type == "cpu":
        return pair_matmul_plain(a, b)
    if a.re.device.type != "cuda":
        raise ValueError(f"unsupported device {a.re.device}")
    _check(a, b)
    g_, m, k = a.re.shape
    n = b.re.shape[-1]
    lib = _build.library()
    out = [torch.empty(g_, m, n, dtype=torch.float32, device=a.re.device)
           for _ in range(2)]
    stream = torch.cuda.current_stream(a.re.device).cuda_stream
    rc = lib.twoace_pair_matmul(
        a.re.data_ptr(), a.im.data_ptr(), b.re.data_ptr(), b.im.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), g_, m, k, n, stream)
    _build.check(rc, "pair_matmul")
    pair_matmul.launches += 1
    return Pair(*out)


pair_matmul.launches = 0
