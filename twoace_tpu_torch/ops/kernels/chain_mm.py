"""K6: a chain of batched complex n x n products, renormalised each step
(``csrc/chain_mm.cu``).

Port of ``scripts/bench_pallas_mm.py::run_pallas`` (body ``chain_kernel``),
the microbenchmark behind the Z-prox's batched nr x nr product chain:
``steps`` times V <- V G in the Karatsuba 3M form, then V <- V
rsqrt(sum |V|^2 + 1e-30) per instance.

Layout: the wrapper takes batch-major (B, n, n) float32 pairs.  The TPU
kernel kept the instances on the lanes, (n, n, B);
:func:`from_lanes` / :func:`to_lanes` transpose once at the boundary
(:func:`chain_benchmark` does so for its JAX-layout inputs).

A CPU tensor takes the plain version :func:`pair_chain_mm_plain`; a CUDA
tensor launches the kernel or raises.  :func:`chain_benchmark` is the body
of ``scripts/torch_bench_pallas_mm.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cplx import Pair
from . import _build

#: the TPU benchmark's sizes (bench_pallas_mm.py:28-29)
B, N, CHAIN, REPS = 256, 16, 8, 100
#: the kernel puts one thread on each of the n * n entries of an instance
MAX_N = 32


def from_lanes(p: Pair) -> Pair:
    """(n, n, B) lane-layout planes -> contiguous (B, n, n)."""
    return Pair(*(t.permute(2, 0, 1).contiguous() for t in p))


def to_lanes(p: Pair) -> Pair:
    """(B, n, n) -> contiguous (n, n, B) lane-layout planes."""
    return Pair(*(t.permute(1, 2, 0).contiguous() for t in p))


def pair_chain_mm_plain(v: Pair, g: Pair, steps: int = CHAIN) -> Pair:
    """Plain PyTorch version, in the TPU kernel's order: the Karatsuba
    products, then the scale rsqrt(sum + 1e-30) (not a division by the
    norm)."""
    vr, vi = v
    gs = g.re + g.im
    for _ in range(steps):
        k1 = vr @ gs
        k2 = (vr + vi) @ g.im
        k3 = (vi - vr) @ g.re
        vr, vi = k1 - k2, k1 + k3
        scale = torch.rsqrt(torch.sum(vr * vr + vi * vi, dim=(-2, -1),
                                      keepdim=True) + 1e-30)
        vr, vi = vr * scale, vi * scale
    return Pair(vr, vi)


def _check(v: Pair, g: Pair) -> None:
    if v.re.dim() != 3 or v.re.shape[-1] != v.re.shape[-2]:
        raise ValueError(f"need (B, n, n) pairs, got {tuple(v.re.shape)}")
    b, n, _ = v.re.shape
    if n > MAX_N:
        raise ValueError(f"the kernel takes n <= {MAX_N}, got {n}")
    shape = (b, n, n)
    _build.check_inputs({"v.re": (v.re, shape), "v.im": (v.im, shape),
                         "g.re": (g.re, shape), "g.im": (g.im, shape)},
                        v.re.device)


def pair_chain_mm(v: Pair, g: Pair, steps: int = CHAIN) -> Pair:
    """``steps`` renormalised products V <- V G of contiguous float32
    (B, n, n) pairs, n <= 32; returns the (B, n, n) pair."""
    if v.re.device.type == "cpu":
        return pair_chain_mm_plain(v, g, steps)
    if v.re.device.type != "cuda":
        raise ValueError(f"unsupported device {v.re.device}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    _check(v, g)
    b, n, _ = v.re.shape
    out = [torch.empty_like(v.re) for _ in range(2)]
    if b == 0:
        return Pair(*out)
    lib = _build.library()
    stream = torch.cuda.current_stream(v.re.device).cuda_stream
    rc = lib.twoace_chain_mm(
        v.re.data_ptr(), v.im.data_ptr(), g.re.data_ptr(), g.im.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), b, n, steps, stream)
    _build.check(rc, "pair_chain_mm")
    pair_chain_mm.launches += 1
    return Pair(*out)


pair_chain_mm.launches = 0


def library_chain(v, g, steps: int = CHAIN):
    """The library route of ``scripts/bench_smallmm.py``'s batch-major
    chain (:31-56): complex ``torch.matmul`` of (B, n, n) tensors, with
    the same renormalisation.  A yardstick only: the port never calls it."""
    for _ in range(steps):
        v = v @ g
        v = v * torch.rsqrt(torch.sum(v.real * v.real + v.imag * v.imag,
                                      dim=(-2, -1), keepdim=True) + 1e-30)
    return v


def numpy_chain(v, g, products: int):
    """The numpy complex128 reference of bench_pallas_mm.py:111-122:
    ``products`` steps of v <- v g / ||v g|| on (B, n, n) arrays."""
    v, g = np.asarray(v, np.complex128), np.asarray(g, np.complex128)
    for _ in range(products):
        v = np.einsum("bik,bkj->bij", v, g)
        v = v / np.linalg.norm(v, axis=(1, 2), keepdims=True)
    return v


def lane_inputs(seed: int = 0, b: int = B, n: int = N):
    """The TPU benchmark's inputs (bench_pallas_mm.py:97-99): four
    (n, n, b) float32 planes rng.normal / 4 in the order vr, vi, gr, gi."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, n, b)) / 4).astype(np.float32)
            for _ in range(4)]


def _events_ms(fn) -> float:
    """CUDA-event milliseconds of one call of ``fn`` (its launches back to
    back, no host sync between them), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def chain_benchmark() -> dict:
    """``scripts/bench_pallas_mm.py`` on the card: REPS back-to-back
    launches of the CHAIN-step chain at B instances of N x N (K6, its
    plain version, and the complex64 ``torch.matmul`` chain), each timed
    with CUDA events, in microseconds per batched complex product; then
    the max abs error of each route's REPS * CHAIN products against the
    numpy complex128 chain.  Needs a card; TF32 stays off."""
    from ..pair_solver import no_tf32

    if not torch.cuda.is_available():
        raise RuntimeError("chain_benchmark times the card: it needs CUDA")
    planes = lane_inputs()
    vr, vi, gr, gi = (torch.as_tensor(p, device="cuda") for p in planes)
    v, g = from_lanes(Pair(vr, vi)), from_lanes(Pair(gr, gi))
    vc, gc = torch.complex(*v), torch.complex(*g)
    products = CHAIN * REPS

    def run(step, x0):
        x = x0
        for _ in range(REPS):
            x = step(x)
        return x

    routes = {
        "kernel": (lambda x: pair_chain_mm(x, g), v),
        "plain": (lambda x: pair_chain_mm_plain(x, g), v),
        "library": (lambda x: library_chain(x, gc), vc),
    }
    out = dict(b=B, n=N, chain=CHAIN, reps=REPS)
    finals = {}
    with no_tf32():
        for name, (step, x0) in routes.items():
            ms = _events_ms(lambda: run(step, x0))
            out[f"{name}_us_per_product"] = ms * 1e3 / products
            finals[name] = run(step, x0)
    torch.cuda.synchronize()
    want = numpy_chain(np.transpose(planes[0] + 1j * planes[1], (2, 0, 1)),
                       np.transpose(planes[2] + 1j * planes[3], (2, 0, 1)),
                       products)
    for name, x in finals.items():
        got = (x.cpu().numpy() if isinstance(x, torch.Tensor)
               else x.re.cpu().numpy() + 1j * x.im.cpu().numpy())
        out[f"{name}_max_abs_err"] = float(np.abs(got - want).max())
    return out
