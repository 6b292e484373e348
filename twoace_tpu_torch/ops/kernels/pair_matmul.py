"""K4: batched pair-complex GEMM (``csrc/pair_matmul.cu``).

Port of ``twoace_tpu.ops.pallas.kernels.pair_matmul``, batched over an
outer axis G: C[g] = A[g] @ B[g] with A (G, M, K), B (G, K, N), on planar
float32 (re, im) pairs, at float32 accuracy.  A CPU tensor takes the
plain version :func:`pair_matmul_plain`; a CUDA tensor launches one of
the kernel's two routes, picked from the shape alone (:func:`route`), or
raises:

- ``"tc"``: 3xTF32 tensor-core tiles (``mma.sync``, a cp.async ring),
  for the batch solver's products;
- ``"rows"``: split-K over a thread-block cluster on the CUDA cores, for
  the one-row products of the anchored refine and the warm trackers.

``pair_matmul.launches`` counts every launch.  :func:`round_tf32` and
:func:`pair_matmul_tf32_emulated` repeat the tensor-core route's
arithmetic in plain torch for the CPU tests; nothing else calls them.
"""

from __future__ import annotations

import torch

from ..cplx import Pair, matmul
from . import _build

_MAX_GRID_YZ = 65535
#: the split-K route runs every product with M at or below this, the
#: tensor-core route the rest: at (K, N) = (1024, 256), (256, 1024) and
#: (256, 256) the split-K route is faster through M = 32 at all three,
#: the tensor-core route at M = 64 at (256, 1024) (PERF.md;
#: scripts/torch_k4_routes.py)
ROWS_MAX_M = 32
#: the split-K route: rows of A a block (the kernel's RS_MR), K-rows a
#: slice before the cap of one portable cluster
_RS_MR = 8
_RS_SLICE = 64
_RS_MAX_SPLIT = 8
#: the tensor-core route's rows of C a block (its tiles are 64 x 64)
_TC_BM = 64


def pair_matmul_plain(a: Pair, b: Pair) -> Pair:
    """Plain PyTorch version: ``cplx.matmul`` (three real batched
    products) of (G, M, K) and (G, K, N) pairs."""
    return matmul(a, b)


def route(g: int, m: int, k: int, n: int) -> str:
    """The route a (G, M, K) @ (G, K, N) product takes: ``"rows"`` for
    M <= ROWS_MAX_M, else ``"tc"``."""
    return "rows" if m <= ROWS_MAX_M else "tc"


def ksplit(k: int) -> int:
    """The split-K route's K slices (one cluster of that many blocks)."""
    return min(_RS_MAX_SPLIT, max(1, -(-k // _RS_SLICE)))


def _rows_mr(m: int) -> int:
    """Rows of A a split-K block: the kernel's instantiation for M."""
    return 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else _RS_MR


def _grid_yz(which: str, g: int, m: int, k: int):
    """The route's grid on y and z."""
    if which == "tc":
        return -(-m // _TC_BM), g
    return ksplit(k), g * -(-m // _rows_mr(m))


def _check(a: Pair, b: Pair):
    """Raise on what the kernel does not take; return (G, M, K, N)."""
    if a.re.dim() != 3 or b.re.dim() != 3:
        raise ValueError(f"need (G, M, K) and (G, K, N) pairs, got "
                         f"{tuple(a.re.shape)} and {tuple(b.re.shape)}")
    g_, m, k = a.re.shape
    n = b.re.shape[-1]
    which = route(g_, m, k, n)
    y, z = _grid_yz(which, g_, m, k)
    if y > _MAX_GRID_YZ or z > _MAX_GRID_YZ:
        raise ValueError(f"the {which} route's grid is ({y}, {z}) on y and "
                         f"z, above {_MAX_GRID_YZ}: G {g_}, M {m}")
    _build.check_inputs({"a.re": (a.re, (g_, m, k)), "a.im": (a.im, (g_, m, k)),
                         "b.re": (b.re, (g_, k, n)), "b.im": (b.im, (g_, k, n))},
                        a.re.device)
    return g_, m, k, n


_fns = None


def _functions():
    """The two C entry points, looked up once."""
    global _fns
    if _fns is None:
        lib = _build.library()
        _fns = {"tc": lib.twoace_pair_matmul_tc,
                "rows": lib.twoace_pair_matmul_rows}
    return _fns


def launch(a: Pair, b: Pair, which: str) -> Pair:
    """One launch of route ``which`` on checked CUDA pairs (the wrapper
    passes the shape's route; scripts/torch_k4_routes.py also the other,
    to measure where the two cross)."""
    g_, m, k = a.re.shape
    n = b.re.shape[-1]
    dev = a.re.device
    c_re = torch.empty((g_, m, n), dtype=torch.float32, device=dev)
    c_im = torch.empty((g_, m, n), dtype=torch.float32, device=dev)
    ptrs = (a.re.data_ptr(), a.im.data_ptr(), b.re.data_ptr(),
            b.im.data_ptr(), c_re.data_ptr(), c_im.data_ptr())
    # the raw query: torch.cuda.current_stream builds a Stream object, about
    # 4 us of the ~30 us a one-row call takes (scripts/torch_k4_host.py)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if which == "tc":
        rc = _functions()["tc"](*ptrs, g_, m, k, n, stream)
    elif which == "rows":
        rc = _functions()["rows"](*ptrs, g_, m, k, n, ksplit(k), stream)
    else:
        raise ValueError(f"unknown route {which!r}")
    _build.check(rc, f"pair_matmul ({which})")
    pair_matmul.launches += 1
    return Pair(c_re, c_im)


def pair_matmul(a: Pair, b: Pair) -> Pair:
    """C[g] = A[g] @ B[g] of contiguous float32 pairs A (G, M, K) and
    B (G, K, N); returns the (G, M, N) pair."""
    if a.re.device.type == "cpu":
        return pair_matmul_plain(a, b)
    if a.re.device.type != "cuda":
        raise ValueError(f"unsupported device {a.re.device}")
    g_, m, k, n = _check(a, b)
    return launch(a, b, route(g_, m, k, n))


pair_matmul.launches = 0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32: round to nearest (ties away from
    zero) at 10 mantissa bits, on the bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pair_matmul_tf32_emulated(a: Pair, b: Pair, terms: int = 3,
                              karatsuba: bool = True) -> Pair:
    """The tensor-core route's arithmetic in plain torch: each float32
    operand split into TF32 big + small, each real product summed from
    small*big + big*small + big*big (``terms=3``, 3xTF32) or big*big alone
    (``terms=1``, plain TF32); TF32 products are exact in float32.  The
    complex product in the Karatsuba 3M or the direct 4M form."""
    def mm(x, y):
        xb, yb = round_tf32(x), round_tf32(y)
        if terms == 1:
            return xb @ yb
        xs, ys = round_tf32(x - xb), round_tf32(y - yb)
        return xs @ yb + xb @ ys + xb @ yb

    if karatsuba:
        k1 = mm(a.re, b.re + b.im)
        k2 = mm(a.re + a.im, b.im)
        k3 = mm(a.im - a.re, b.re)
        return Pair(k1 - k2, k1 + k3)
    return Pair(mm(a.re, b.re) - mm(a.im, b.im),
                mm(a.re, b.im) + mm(a.im, b.re))
