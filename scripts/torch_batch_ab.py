#!/usr/bin/env python3
"""A/B timing of chip_smoke.py's phase 3, the port's batch solve, between
two checkouts on one GPU.

    python3 scripts/torch_batch_ab.py BASE_DIR [--pairs 10] [--profile-head]

Starts one worker process in BASE_DIR and one in the checkout that holds
this script.  Each imports its own tree's ``twoace_tpu_torch`` and
``chip_smoke.build_solve_problem`` (the bench.py solve workload: seed 1,
64 two-path 16x16 channels, m = 1024), and solves it once to warm up at
phase 3's config (maxiter 500, warm_iters 80, pass caps 120/160, split
generator seed 0).  With ``--profile-head`` the head worker first takes
one torch.profiler measurement (``chip_smoke.device_ms``, with which
phase 2 reads K1's, K5's and K6's device time before phase 3) of an
elementwise op.  Then the workers take turns in the order base, head,
head, base, ..., ``--pairs`` timed solves each, one
``solve_lowrank_multi_pair_batch`` between CUDA events.  Prints one line
per solve, then a JSON summary: per side the rec/s median and quartiles,
the median NMSE and the trips; per pair the head/base ratio and whether
head won.  Exits non-zero if a worker fails or a solve misses phase 3's
bars (median NMSE <= -60 dB, min quality >= 0.98).
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HEAD_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(profile_first):
    """Serve timed solves: one per line read on stdin."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from twoace_tpu_torch import interop
    from twoace_tpu_torch.config import AdmmConfig
    from twoace_tpu_torch.ops.pair_solver import solve_lowrank_multi_pair_batch
    from twoace_tpu_torch.utils.metrics import nmse_h_projection

    a, b, x_true = cs.build_solve_problem()
    ap = interop.pair_from_numpy(a, None, device="cuda")
    bt = torch.as_tensor(b, dtype=torch.float32, device="cuda")
    cfg = AdmmConfig(maxiter=500, warm_iters=80, stage1_maxiter=120,
                     stage2_maxiter=160)

    def solve():
        return solve_lowrank_multi_pair_batch(
            torch.Generator().manual_seed(0), ap, bt, cs.NT, cs.NR, cfg)

    if profile_first:
        print(f"profiled: {cs.device_ms(lambda: bt * 2.0)} ms a launch",
              flush=True)
    solve()
    torch.cuda.synchronize()
    print("AB " + json.dumps({"ready": True}), flush=True)
    for _ in sys.stdin:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        res = solve()
        stop.record()
        torch.cuda.synchronize()
        secs = start.elapsed_time(stop) / 1e3
        x = (res.x.re.double() + 1j * res.x.im.double()).cpu()
        db = 10 * torch.log10(torch.clamp(
            nmse_h_projection(x, torch.as_tensor(x_true)), min=1e-30))
        print("AB " + json.dumps(dict(
            secs=secs, rec_s=b.shape[0] / secs, iters=int(res.iters.sum()),
            nmse_db=float(db.median()), qmin=float(res.quality.min()))),
            flush=True)


def read(proc, name):
    for line in proc.stdout:
        if line.startswith("AB "):
            return json.loads(line[3:])
    raise RuntimeError(f"the {name} worker ended (rc {proc.wait()})")


def quartiles(v):
    q1, med, q3 = np.percentile(v, [25, 50, 75])
    return dict(median=float(med), q1=float(q1), q3=float(q3))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base_dir")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--profile-head", action="store_true")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.profile_head)

    dirs = {"base": os.path.abspath(args.base_dir), "head": HEAD_DIR}
    procs = {name: subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), d, "--worker"]
        + (["--profile-head"] if name == "head" and args.profile_head else []),
        cwd=d, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for name, d in dirs.items()}
    try:
        for name, proc in procs.items():
            read(proc, name)
        runs = {"base": [], "head": []}
        for i in range(args.pairs):
            for name in (("base", "head") if i % 2 == 0 else ("head", "base")):
                procs[name].stdin.write("run\n")
                procs[name].stdin.flush()
                r = read(procs[name], name)
                runs[name].append(r)
                print(f"pair {i} {name}: {r['secs']:.4f} s | {r['rec_s']:.2f} "
                      f"rec/s | {r['iters']} iters | median NMSE "
                      f"{r['nmse_db']:.2f} dB | min quality {r['qmin']:.6f}",
                      flush=True)
                if r["nmse_db"] > -60.0 or r["qmin"] < 0.98:
                    raise RuntimeError(f"{name} missed phase 3's bars: {r}")
    finally:
        for proc in procs.values():
            proc.stdin.close()
        for proc in procs.values():
            proc.wait(timeout=60)
    ratio = [h["rec_s"] / b["rec_s"] for b, h in zip(runs["base"], runs["head"])]
    summary = {name: dict(rec_s=quartiles([r["rec_s"] for r in rs]),
                          nmse_db_median=float(np.median(
                              [r["nmse_db"] for r in rs])),
                          iters=sorted({r["iters"] for r in rs}))
               for name, rs in runs.items()}
    summary["head_over_base"] = dict(**quartiles(ratio),
                                     head_wins=sum(x > 1.0 for x in ratio),
                                     pairs=len(ratio))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
