#!/usr/bin/env python3
"""Where a trip of K3 (``csrc/infer_admm.cu``) spends its time, on one GPU.

    python3 scripts/torch_k3_phases.py [--m 972 80] [--out FILE.json]

Prints what ``nvcc -Xptxas -v`` reports for K3's kernels (registers,
shared memory, spills), then builds a second copy of ``infer_admm.cu``
with ``-DTWOACE_K3_PHASE_TIMER`` (``_build.NVCC_FLAGS`` plus the macro,
into a temporary directory; the normal build never sets it).  In that
build, thread 0 of lane 0's first CTA stamps ``%globaltimer`` at the end
of each phase of a trip (A: the X-update's right-hand side; B: X and the
panel-Gram partial; C: A X, then the magnitude prox; D: A^H Y, the Gram
sum, the Z-prox chain and its apply; E: the residual tests) and sums the
nanoseconds per phase; the time it waits in cluster barriers has its own
slot.  Reported beside the phases, as parts of them: the products' time
waiting for a stage of their cp.async ring, issuing a stage's copies and
computing on a stage (in A, B, C and D gemm), and the Z-prox chain's
products, elementwise steps and ladder (in D zprox).  For each m it runs
``chip_smoke.k3_cases(m)`` (3 lanes, r 20, 16x16, both passes, 30 trips
from a warm lane state, as phase 2 does) through the wrapper with the
timer build swapped in, and prints the microseconds a trip per phase
beside the normal build's CUDA-event time of the same launch.  With
``--out``, writes every number as JSON.
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

#: the timer's slots, in csrc/infer_admm.cu's PhaseSlot order
SLOTS = ("setup", "A", "B", "B gram", "C", "C prox", "D gemm", "D gram",
         "D zprox", "D apply", "E", "barriers", "product waits",
         "product issue", "product mma", "zprox products",
         "zprox elementwise", "zprox ladder")
#: slots that are part of others: the products' time (in A, B, C and D
#: gemm) waiting for a stage of the ring, issuing a stage's copies, and
#: computing on a stage; the Z-prox chain's products, elementwise steps
#: and ladder (in D zprox)
INSIDE = ("product waits", "product issue", "product mma", "zprox products",
          "zprox elementwise", "zprox ladder")
MACRO = "-DTWOACE_K3_PHASE_TIMER"


def build_timer_lib(tmpdir):
    """infer_admm.cu built with the phase timer, loaded with ctypes and
    given the signatures the wrapper calls."""
    src = os.path.join(_build.CSRC, "infer_admm.cu")
    out = os.path.join(tmpdir, "libk3timer.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, MACRO, "-o", out,
                    src], check=True, capture_output=True, text=True,
                   timeout=600)
    lib = ctypes.CDLL(out)
    fn = lib.twoace_infer_admm
    fn.argtypes = _build.SIGNATURES["twoace_infer_admm"]
    fn.restype = ctypes.c_int
    lib.twoace_infer_admm_phases.argtypes = [ctypes.c_void_p]
    lib.twoace_infer_admm_phases.restype = ctypes.c_int
    return lib


def phase_split(lib, launch, reps=3):
    """Run ``launch()`` (one K3 call through the wrapper) ``reps`` times
    with ``lib`` in place of the kernel library; returns the mean
    microseconds a trip per slot and the trips."""
    import torch

    saved = _build._lib
    _build._lib = lib
    buf = (ctypes.c_ulonglong * (len(SLOTS) + 1))()
    sums = [0.0] * len(SLOTS)
    trips = 0
    try:
        for _ in range(reps):
            launch()
            torch.cuda.synchronize()
            _build.check(lib.twoace_infer_admm_phases(buf), "phase timer")
            trips += buf[len(SLOTS)]
            for i in range(len(SLOTS)):
                sums[i] += buf[i] / 1e3
    finally:
        _build._lib = saved
    per_trip = {name: s / max(trips, 1) for name, s in zip(SLOTS, sums)}
    return per_trip, trips // reps


def fmt_split(per_trip):
    total = sum(v for k, v in per_trip.items()
                if k != "setup" and k not in INSIDE)
    return (f"{total:.2f} us a trip: " + ", ".join(
        f"{k} {v:.2f} ({100 * v / total:.0f}%)"
        for k, v in per_trip.items() if k != "setup")
        + f" | setup {per_trip['setup']:.2f} us a trip of the launch")


def main():
    import chip_smoke as cs
    from torch_k4_routes import ptxas_report
    from twoace_tpu_torch.ops.kernels import fused_infer_admm

    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, nargs="+", default=[cs.M_TRAIN, 80])
    ap.add_argument("--out", help="write every number to this JSON file")
    args = ap.parse_args()
    out = dict(device=cs.phase0_device())
    cs.phase1_build()
    out["ptxas"] = ptxas_report("infer_admm.cu")
    for line in out["ptxas"]:
        print(f"[ptxas] {line}", flush=True)
    out["cases"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_timer_lib(tmp)
        for m in args.m:
            for label, a, kw in cs.k3_cases(m):
                ms = cs.cuda_ms(lambda: fused_infer_admm(*a, **kw), reps=5)
                split, trips = phase_split(
                    lib, lambda: fused_infer_admm(*a, **kw))
                print(f"[K3 phases] {label}: normal build {ms:.4f} ms "
                      f"({1e3 * ms / trips:.2f} us a trip over {trips}) | "
                      f"timer build, CTA 0 of lane 0: {fmt_split(split)}",
                      flush=True)
                out["cases"][label] = dict(ms=ms, trips=trips, us=split)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
