#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: sets up the cell named in BENCHMARK.json on
one CUDA card, measures for ``--seconds``, judges what the window
produced against the plain reference, and prints one JSON object as the
last line of standard output (``port_bench/README.md`` lists its keys).
Exits non-zero, printing no result, without a CUDA card, without the
program, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of the program stays in the checkout, at a fixed path
for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness

    spec = harness.load_json(harness.spec_path())
    wl, config, traffic, e2e, per_layer = harness.resolve(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"need {wl['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, compared = harness.run_cell(
        config, traffic, e2e, per_layer, args.seed, args.seconds,
        bool(args.trace), torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: no JAX, JAX package or JAX script may "
              "run on the card", file=sys.stderr)
        return 3
    print(harness.compared_lines(compared), file=sys.stderr)
    print(harness.result_line(result, compared), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
