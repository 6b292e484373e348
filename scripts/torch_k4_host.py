#!/usr/bin/env python3
"""The host's cost of one K4 call at the one-row shapes, where the warm
trackers launch K4 about 1500 times a window, on one GPU.

    python3 scripts/torch_k4_host.py [BASE_DIR] [--reps 2000]

1. The pieces of a call in this checkout, each timed on the host clock
   over ``--reps`` calls (ending in ``torch.cuda.synchronize()``):
   ``pair_matmul``'s checks, the two output planes as two
   ``torch.empty`` or as one viewed twice, the current stream through
   ``torch.cuda.current_stream`` or the raw query, the ctypes launch of
   the split-K route alone (one block a slice, and a cluster of 2), and
   the whole call.
2. With BASE_DIR (another checkout, e.g. the parent unpacked with
   ``git archive`` into a git-ignored directory): the CUDA-event time a
   call of ``pair_matmul`` (``--reps`` back-to-back calls between two
   events) at the anchored refine's five one-row shapes, in one worker
   process per checkout, in the order base, head, head, base.

Prints one line per measurement and a JSON summary as the last line.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HEAD_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(1, 1, 80, 256), (1, 1, 256, 256), (1, 1, 256, 80),
          (1, 1, 1024, 256), (1, 1, 256, 1024)]


def operands(g, m, k, n):
    import torch

    from twoace_tpu_torch.ops.cplx import Pair

    gen = torch.Generator(device="cuda").manual_seed(4)
    return [Pair(*(torch.randn(g, rows, cols, generator=gen, device="cuda")
                   for _ in range(2))) for rows, cols in ((m, k), (k, n))]


def event_ms(reps):
    """{shape: CUDA-event ms a call of pair_matmul} in this process."""
    import torch

    from twoace_tpu_torch.ops.kernels import pair_matmul

    out = {}
    for shape in SHAPES:
        a, b = operands(*shape)
        for _ in range(20):
            pair_matmul(a, b)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            pair_matmul(a, b)
        stop.record()
        torch.cuda.synchronize()
        out[str(shape)] = start.elapsed_time(stop) / reps
    return out


def host_us(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def pieces(reps):
    """Host microseconds a call of each piece of a K4 call."""
    import importlib

    import torch

    sys.path.insert(0, HEAD_DIR)
    k4 = importlib.import_module("twoace_tpu_torch.ops.kernels.pair_matmul")
    from twoace_tpu_torch.ops.kernels import pair_matmul

    a, b = operands(1, 1, 256, 256)
    dev = a.re.device
    fn = k4._functions()["rows"]
    c = [torch.empty(1, 1, 256, device=dev) for _ in range(2)]
    ptrs = (a.re.data_ptr(), a.im.data_ptr(), b.re.data_ptr(),
            b.im.data_ptr(), c[0].data_ptr(), c[1].data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream

    def two_empty():
        return (torch.empty((1, 1, 256), device=dev),
                torch.empty((1, 1, 256), device=dev))

    def one_empty_viewed():
        o = torch.empty((2, 1, 1, 256), device=dev)
        return o[0], o[1]

    out = {
        "checks": host_us(lambda: k4._check(a, b), reps),
        "two torch.empty": host_us(two_empty, reps),
        "one torch.empty viewed twice": host_us(one_empty_viewed, reps),
        "torch.cuda.current_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream, reps),
        "raw stream query": host_us(
            lambda: torch._C._cuda_getCurrentRawStream(dev.index), reps),
        "ctypes launch, 1 slice": host_us(
            lambda: fn(*ptrs, 1, 1, 256, 256, 1, stream), reps),
        "ctypes launch, cluster of 2": host_us(
            lambda: fn(*ptrs, 1, 1, 256, 256, 2, stream), reps),
        "pair_matmul": host_us(lambda: pair_matmul(a, b), reps),
    }
    for name, us in out.items():
        print(f"[host] (1, 1, 256) @ (1, 256, 256) {name}: {us:.2f} us a call",
              flush=True)
    return out


def worker(reps):
    sys.path.insert(0, os.getcwd())
    print("K4HOST " + json.dumps(event_ms(reps)), flush=True)


def run_worker(tree, reps):
    proc = subprocess.run(
        [sys.executable, os.path.join(HEAD_DIR, "scripts",
                                      "torch_k4_host.py"),
         "--worker", "--reps", str(reps)],
        cwd=tree, capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("K4HOST "):
            return json.loads(line[len("K4HOST "):])
    raise RuntimeError(f"worker in {tree} failed:\n{proc.stdout}\n"
                       f"{proc.stderr}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("base", nargs="?")
    ap.add_argument("--reps", type=int, default=2000)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        return worker(args.reps)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    summary = {"pieces_us": pieces(args.reps)}
    if args.base:
        runs = {"base": [], "head": []}
        for side in ("base", "head", "head", "base"):
            tree = os.path.abspath(args.base) if side == "base" else HEAD_DIR
            runs[side].append(run_worker(tree, args.reps))
        summary["event_ms"] = {}
        for shape in map(str, SHAPES):
            row = {side: [r[shape] for r in rs] for side, rs in runs.items()}
            summary["event_ms"][shape] = row
            print(f"[events] {shape}: base {row['base']} ms | head "
                  f"{row['head']} ms a call", flush=True)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
