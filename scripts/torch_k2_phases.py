#!/usr/bin/env python3
"""Where a launch of K2 (``csrc/zprox.cu``) spends its time, on one GPU.

    python3 scripts/torch_k2_phases.py [--shapes 192,20,16,16 1,1,16,16]
                                       [--reps 20] [--out FILE.json]

Prints what ``nvcc -Xptxas -v`` reports for K2's kernel (registers,
shared memory, spills), then builds a second copy of ``zprox.cu`` with
``-DTWOACE_K2_PHASE_TIMER`` (``_build.NVCC_FLAGS`` plus the macro, into a
temporary directory; the normal build never sets it).  In that build,
thread 0 of lane 0's block stamps ``%globaltimer`` after each part of a
launch and sums the nanoseconds per slot: waiting for W's chunks (and the
other warps) in the Gram's loop, its own Gram steps, the sum of the
warps' partial Grams, the chain's products, its elementwise steps and its
ladder (the time thread 0 waits for it), the delta apply and the stores
of V and W' (in a streamed launch the apply's waits and stores count as
apply); ``ladder warp`` is the ladder's own time on the warp that runs
it, beside the products.
Each shape is ``lanes,r,nt,nr`` (``chip_smoke.k2_case``: a warm basis
and the phase-2 ladder mix); for each it prints the microseconds a launch
per slot beside the normal build's CUDA-event and profiler device time
of the same launch.  With ``--out``, writes every number as JSON.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from twoace_tpu_torch.ops.kernels import _build  # noqa: E402

#: the timer's slots, in csrc/zprox.cu's K2Slot order, then the launches
SLOTS = ("load", "gram", "reduce", "chain products", "chain elementwise",
         "chain ladder", "apply", "store", "ladder warp")
#: slots that overlap others: the ladder's own time on its warp
INSIDE = ("ladder warp",)
MACRO = "-DTWOACE_K2_PHASE_TIMER"
#: the main path's shapes: the batch solve's 192 lanes and the warm
#: rank-1 trackers' one lane (lanes, r, nt, nr)
DEFAULT_SHAPES = ((192, 20, 16, 16), (1, 1, 16, 16))


def build_timer_lib(tmpdir):
    """zprox.cu built with the phase timer, loaded with ctypes and given
    the signature the wrapper calls."""
    src = os.path.join(_build.CSRC, "zprox.cu")
    out = os.path.join(tmpdir, "libk2timer.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, MACRO, "-o", out,
                    src], check=True, capture_output=True, text=True,
                   timeout=600)
    lib = ctypes.CDLL(out)
    lib.twoace_zprox_t.argtypes = _build.SIGNATURES["twoace_zprox_t"]
    lib.twoace_zprox_t.restype = ctypes.c_int
    lib.twoace_zprox_phases.argtypes = [ctypes.c_void_p]
    lib.twoace_zprox_phases.restype = ctypes.c_int
    return lib


def phase_split(lib, launch, reps=20):
    """Run ``launch()`` (one K2 call through the wrapper) once to warm up
    and then ``reps`` times with ``lib`` in place of the kernel library;
    returns the mean microseconds a launch per slot."""
    import torch

    saved = _build._lib
    _build._lib = lib
    buf = (ctypes.c_ulonglong * (len(SLOTS) + 1))()
    try:
        launch()
        torch.cuda.synchronize()
        _build.check(lib.twoace_zprox_phases(buf), "phase timer")
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
        _build.check(lib.twoace_zprox_phases(buf), "phase timer")
    finally:
        _build._lib = saved
    launches = max(int(buf[len(SLOTS)]), 1)
    return {name: buf[i] / 1e3 / launches for i, name in enumerate(SLOTS)}


def fmt_split(split):
    total = sum(v for k, v in split.items() if k not in INSIDE)
    return (f"{total:.2f} us a launch: " + ", ".join(
        f"{k} {v:.2f} ({100 * v / total:.0f}%)"
        for k, v in split.items() if k not in INSIDE)
        + "".join(f" | {k} {split[k]:.2f}" for k in INSIDE))


def parse_shape(text):
    lanes, r, nt, nr = (int(x) for x in text.split(","))
    return lanes, r, nt, nr


def main():
    import chip_smoke as cs
    from torch_k4_routes import ptxas_report
    from twoace_tpu_torch.ops.kernels import fused_zprox_t

    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", type=parse_shape, nargs="+",
                    default=list(DEFAULT_SHAPES),
                    help="lanes,r,nt,nr of each shape")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="write every number to this JSON file")
    args = ap.parse_args()
    out = dict(device=cs.phase0_device())
    cs.phase1_build()
    out["ptxas"] = ptxas_report("zprox.cu")
    for line in out["ptxas"]:
        print(f"[ptxas] {line}", flush=True)
    out["cases"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_timer_lib(tmp)
        for lanes, r, nt, nr in args.shapes:
            z, v0, lad = cs.k2_case(lanes, r, nt, nr)

            def launch():
                return fused_zprox_t(z, v0, nt, nr, lad)

            ms = cs.cuda_ms(launch)
            dev = cs.device_ms(launch)
            split = phase_split(lib, launch, args.reps)
            label = f"lanes {lanes} r {r} nt {nt} nr {nr}"
            print(f"[K2 phases] {label}: normal build {ms:.4f} ms (events), "
                  f"device {cs.fmt_ms(dev)} | timer build, lane 0: "
                  f"{fmt_split(split)}", flush=True)
            out["cases"][label] = dict(ms=ms, device_ms=dev, us=split)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
