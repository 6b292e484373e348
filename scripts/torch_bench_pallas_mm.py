#!/usr/bin/env python3
"""The PyTorch/CUDA counterpart of scripts/bench_pallas_mm.py: a chain of
batched complex 16x16 products (B = 256), renormalised each step, on one
GPU.

    python3 scripts/torch_bench_pallas_mm.py

Times 100 back-to-back launches of an 8-step chain with CUDA events and
no host sync between them, for three routes: the hand-written kernel K6
(``twoace_tpu_torch/csrc/chain_mm.cu``), its plain PyTorch version, and
the batch-major complex64 ``torch.matmul`` chain of
scripts/bench_smallmm.py:31-56 with the same renormalisation.  Prints
microseconds per batched complex product for each, then each route's max
abs error after the 800 products against a numpy complex128 chain
(bench_pallas_mm.py:111-122), the card's name and power limit, and a
JSON line.  The sizes and the seed are bench_pallas_mm.py's
(``chain_mm.B``, ``N``, ``CHAIN``, ``REPS``).  Needs a card; builds the
kernels at first use.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from twoace_tpu_torch.ops.kernels.chain_mm import chain_benchmark  # noqa: E402


def main() -> None:
    res = chain_benchmark()
    for route, label in (("kernel", "K6 chain_mm.cu"), ("plain", "plain torch"),
                         ("library", "complex64 torch.matmul")):
        print(f"{label:>24}: {res[f'{route}_us_per_product']:8.3f} us per "
              f"batched complex {res['n']}x{res['n']} product (B={res['b']})"
              f" | max abs err vs numpy complex128 after "
              f"{res['chain'] * res['reps']} products "
              f"{res[f'{route}_max_abs_err']:.2e}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps(dict(res, device=smi)))


if __name__ == "__main__":
    main()
