#!/usr/bin/env python3
"""Where a launch of K6 (``csrc/chain_mm.cu``) spends its time, on one GPU.

    python3 scripts/torch_k6_phases.py [--batches 256 100] [--reps 20]
                                       [--out FILE.json]

Prints what ``nvcc -Xptxas -v`` reports for K6's kernels (registers,
shared memory, spills), then builds a second copy of ``chain_mm.cu`` with
``-DTWOACE_K6_PHASE_TIMER`` (``_build.NVCC_FLAGS`` plus the macro, into a
temporary directory; the normal build never sets it).  In that build,
the first thread of block 0 stamps ``%globaltimer`` after each part of a
launch and sums the nanoseconds per slot: loading V and G, the steps'
products, their norms with the barriers (and the writes of V for the next
step), and the stores.  For each batch (16x16 instances, 8 steps, the
chain benchmark's kind of input, ``chip_smoke.k6_case``) it prints the
microseconds a launch per slot beside the normal build's CUDA-event and
profiler device time of the same launch.  With ``--out``, writes every
number as JSON.
"""

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from twoace_tpu_torch.ops.kernels import _build, chain_mm  # noqa: E402

#: the timer's slots, in csrc/chain_mm.cu's K6Slot order, then the launches
SLOTS = ("load", "products", "norm and barriers", "store")
MACRO = "-DTWOACE_K6_PHASE_TIMER"
#: the chain benchmark's batch and chip_smoke.py's ragged one
DEFAULT_BATCHES = (256, 100)


def build_timer_lib(tmpdir):
    """chain_mm.cu built with the phase timer, loaded with ctypes and given
    the signature the wrapper calls."""
    src = os.path.join(_build.CSRC, "chain_mm.cu")
    out = os.path.join(tmpdir, "libk6timer.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, MACRO, "-o", out,
                    src], check=True, capture_output=True, text=True,
                   timeout=600)
    lib = ctypes.CDLL(out)
    lib.twoace_chain_mm.argtypes = _build.SIGNATURES["twoace_chain_mm"]
    lib.twoace_chain_mm.restype = ctypes.c_int
    lib.twoace_chain_mm_phases.argtypes = [ctypes.c_void_p]
    lib.twoace_chain_mm_phases.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def kernel_library(lib):
    """The wrapper calls ``lib`` in place of the normal build while inside
    (the wrapper looks its C function up once: that lookup is reset on
    entry and exit)."""
    saved = _build._lib
    _build._lib = lib
    chain_mm.__dict__["_fn"] = None
    try:
        yield
    finally:
        _build._lib = saved
        chain_mm.__dict__["_fn"] = None


def phase_split(lib, launch, reps=20):
    """Run ``launch()`` (one K6 call through the wrapper) once to warm up
    and then ``reps`` times with ``lib`` in place of the kernel library;
    returns the mean microseconds a launch per slot."""
    import torch

    buf = (ctypes.c_ulonglong * (len(SLOTS) + 1))()
    with kernel_library(lib):
        launch()
        torch.cuda.synchronize()
        _build.check(lib.twoace_chain_mm_phases(buf), "phase timer")
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
        _build.check(lib.twoace_chain_mm_phases(buf), "phase timer")
    launches = max(int(buf[len(SLOTS)]), 1)
    return {name: buf[i] / 1e3 / launches for i, name in enumerate(SLOTS)}


def fmt_split(split):
    total = sum(split.values())
    return (f"{total:.2f} us a launch: " + ", ".join(
        f"{k} {v:.2f} ({100 * v / total:.0f}%)" for k, v in split.items()))


def main():
    import chip_smoke as cs
    from torch_k4_routes import ptxas_report

    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+",
                    default=list(DEFAULT_BATCHES))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="write every number to this JSON file")
    args = ap.parse_args()
    out = dict(device=cs.phase0_device())
    cs.phase1_build()
    out["ptxas"] = ptxas_report("chain_mm.cu")
    for line in out["ptxas"]:
        print(f"[ptxas] {line}", flush=True)
    out["cases"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_timer_lib(tmp)
        for batch in args.batches:
            v, g = cs.k6_case(batch)

            def launch():
                return chain_mm.pair_chain_mm(v, g)

            ms = cs.cuda_ms(launch)
            dev = cs.device_ms(launch)
            split = phase_split(lib, launch, args.reps)
            label = f"B {batch} {chain_mm.N}x{chain_mm.N} {chain_mm.CHAIN} steps"
            print(f"[K6 phases] {label}: normal build {ms:.4f} ms (events), "
                  f"device {cs.fmt_ms(dev)} | timer build, block 0: "
                  f"{fmt_split(split)}", flush=True)
            out["cases"][label] = dict(ms=ms, device_ms=dev, us=split)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
