#!/usr/bin/env python3
"""What a two-stage FISTA trip costs on the card, and its ``eigh``.

    python3 scripts/torch_eigh_bench.py [--out FILE]

The baselines' FISTA (``ops/phaselift.py::phaselift_fista``) runs 4000
trips a recovery, each with one ``torch.linalg.eigh`` of the compressed
mCS x mCS iterate, which waits for the card.  This prints, for complex64
Hermitian matrices of the sizes the campaigns reach (mCS 8-175, and the
testbed PhaseLift's n 256), the milliseconds of one ``eigh`` on the card
(cuSOLVER), of a batch of 5 and 10 (what a cell's trials would cost
batched), of the same matrix taken to the host and back, and of the
host's LAPACK on 1 and 4 threads; then the milliseconds a trip of
``phaselift_fista`` at three (m, mCS) shapes.  Means of 50 calls (5
FISTA runs of 400 trips), after one warm-up, ending in a synchronize.
"""

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from twoace_tpu_torch.config import PhaseLiftConfig  # noqa: E402
from twoace_tpu_torch.ops.phaselift import phaselift_fista  # noqa: E402

SIZES = (8, 20, 33, 50, 100, 175, 256)
BATCHES = (1, 5, 10)
FISTA_SHAPES = ((49, 20), (196, 50), (1024, 175))
FISTA_TRIPS = 400


def hermitian(batch, n, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, n, n, dtype=torch.complex64, generator=g)
    return ((x + x.mH) / 2).to(device)


def mean_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON results here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out = {"device": torch.cuda.get_device_name(0), "eigh_ms": {},
           "fista_ms_a_trip": {}}
    for n in SIZES:
        row = {}
        for b in BATCHES:
            h = hermitian(b, n, "cuda")
            arg = h if b > 1 else h[0]
            row[f"card b{b}"] = mean_ms(lambda: torch.linalg.eigh(arg), 50)
        h = hermitian(1, n, "cuda")[0]
        row["card->host->card"] = mean_ms(
            lambda: [t.to("cuda") for t in torch.linalg.eigh(h.cpu())], 50)
        threads = torch.get_num_threads()
        for th in (1, 4):
            torch.set_num_threads(th)
            hc = h.cpu()
            row[f"host t{th}"] = mean_ms(lambda: torch.linalg.eigh(hc), 50)
        torch.set_num_threads(threads)
        out["eigh_ms"][n] = row
        print(f"eigh n {n}: " + " | ".join(f"{k} {v:.3f} ms"
                                          for k, v in row.items()),
              flush=True)
    g = torch.Generator().manual_seed(1)
    for m, k in FISTA_SHAPES:
        a = torch.randn(m, k, dtype=torch.complex64, generator=g).cuda()
        b = torch.rand(m, generator=g).cuda()
        cfg = PhaseLiftConfig(max_iters=FISTA_TRIPS)
        ms = mean_ms(lambda: phaselift_fista(a, b, cfg), 5) / FISTA_TRIPS
        out["fista_ms_a_trip"][f"{m}x{k}"] = ms
        print(f"phaselift_fista m {m}, mCS {k}: {ms:.3f} ms a trip",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
