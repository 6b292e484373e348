"""The controls of the comparison: runs that must come out not correct.

- ``reference``: the reference put in the program's place, computed in
  TF32, the precision below the configurations' float32.  Each call
  returns the channels the traffic drew for it, worked out from their
  paths with TF32 operands (:func:`.reference.channels`).
- ``k4_tf32``: the program with its loop products in single-pass TF32,
  the speed mode a later change could reach for (one TF32 product in
  place of K4's three): K4 is replaced, from the benchmark's side, by a
  pair product of TF32-rounded operands.  Batch cells only; the single
  cells run K3, which has no such switch.

Not run by the benchmark's own runs.  ``python -m port_bench.control
--workload <cell> --kind <kind> --seeds <n> ... --seconds <s>`` prints
each seed's compared number and verdict; ``tests/test_pb_control.py`` holds the same at a
small size on the CPU, and at the cells' sizes on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from . import draw, harness, reference

KINDS = ("reference", "k4_tf32")


def pair_matmul_tf32(a, b):
    """a @ b of (G, M, K) and (G, K, N) pairs as a TF32 product computes
    it: operands rounded to TF32, float32 sums, the Karatsuba form."""
    from twoace_tpu_torch.ops.cplx import Pair

    r = reference.round_tf32
    p1 = torch.matmul(r(a.re), r(b.re))
    p2 = torch.matmul(r(a.im), r(b.im))
    p3 = torch.matmul(r(a.re + a.im), r(b.re + b.im))
    return Pair(p1 - p2, p3 - p1 - p2)


@contextlib.contextmanager
def control(kind: str, traffic: dict):
    """Put the control ``kind`` in the program's place for the block."""
    if kind == "reference":
        mod = harness.entry(traffic["entry"])
        drawn = {}
        channel_batch = draw.channel_batch

        def spy(*args, **kwargs):
            d = channel_batch(*args, **kwargs)
            drawn["last"] = d
            return d

        def answer(generator, a, b, nt, nr, cfg):
            d = drawn["last"]
            h = reference.channels(d.aoa, d.aod, d.gain, nt, nr, tf32=True)
            if b.dim() == 1:
                h = h[0]
            x = h.to(torch.complex64)
            return _Result(x.real.contiguous(), x.imag.contiguous())

        saved = mod.SOLVE
        draw.channel_batch, mod.SOLVE = spy, answer
        try:
            yield
        finally:
            draw.channel_batch, mod.SOLVE = channel_batch, saved
    elif kind == "k4_tf32":
        if traffic["entry"] != "batch":
            raise ValueError("k4_tf32 acts on K4, which only the batch "
                             "entry's per-op loop runs")
        from twoace_tpu_torch.ops import pair_solver

        saved = pair_solver.pair_matmul
        pair_solver.pair_matmul = pair_matmul_tf32
        try:
            yield
        finally:
            pair_solver.pair_matmul = saved
    else:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")


class _Result:
    """What the entries read of a solve's result."""

    def __init__(self, re, im):
        from twoace_tpu_torch.ops.cplx import Pair

        self.x = Pair(re, im)
        lead = re.shape[:-1]
        self.iters = torch.zeros(lead, dtype=torch.int32, device=re.device)
        self.quality = torch.ones(lead, device=re.device)


def run(cell: str, kind: str, seed: int, seconds: float,
        device: torch.device):
    """One run of ``cell`` with the control in the program's place;
    returns ``(result, compared)`` as :func:`.harness.run_cell` does."""
    spec = harness.load_json(harness.spec_path())
    _, config, traffic, e2e, per_layer = harness.resolve(spec, cell)
    with control(kind, traffic):
        return harness.run_cell(config, traffic, e2e, per_layer, seed,
                                seconds, False, device, time.perf_counter())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run a control of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kind", choices=KINDS, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the controls are measured on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        result, compared = run(args.workload, args.kind, seed, args.seconds,
                               torch.device("cuda", 0))
        print(f"{args.workload} {args.kind} seed {seed}: "
              f"{harness.compared_lines(compared)} | correct "
              f"{result['correct']} | failed {result['failed']} of "
              f"{result['attempted']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
