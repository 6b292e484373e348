#!/usr/bin/env python3
"""A/B timing of one of chip_smoke.py's cells between two checkouts on one
GPU: phase 3's batch solve, or a phase 5 warm tracker's windows.

    python3 scripts/torch_batch_ab.py BASE_DIR [--cell batch|warm|warm_fresh]
        [--pairs 10] [--profile-head]

Starts one worker process in the checkout that holds this script (head)
and then one in BASE_DIR (base).  Each imports its own tree's
``twoace_tpu_torch`` and sets up the cell:

- ``batch`` (the default): ``chip_smoke.build_solve_problem`` (the
  bench.py solve workload: seed 1, 64 two-path 16x16 channels,
  m = 1024), solved once to warm up at phase 3's config (maxiter 500,
  warm_iters 80, pass caps 120/160, split generator seed 0).  A run is
  one ``solve_lowrank_multi_pair_batch`` between CUDA events; it fails
  unless it meets phase 3's bars (median NMSE <= -60 dB, min quality
  >= 0.98).
- ``warm`` / ``warm_fresh``: phase 5's warm rank-1 tracker
  (``make_warm_pair_solver(use_rank_one=True)``, maxiter 500) on the
  sector stream with max_window 80, or on the fresh-pair stream with
  max_window 256 (``chip_smoke.mobility_workload``).  The head worker
  tracks all 40 windows once and records each window's solver call
  (probe rows, amplitudes, ladder, the previous window's estimate); both
  workers load that record, so both replay the same inputs.  A run
  replays windows 2, 6, ... 38 one after another, each from its
  recorded previous estimate, on the host clock (each window ends in
  the estimate's copy to the host), and reports windows/s and each
  window's ms.

With ``--profile-head`` the head worker first takes one torch.profiler
measurement (``chip_smoke.device_ms``) of an elementwise op, as phase 2
does before the later phases.  Then the workers take turns in the order
base, head, head, base, ..., ``--pairs`` timed runs each.  Prints one
line per run, then a JSON summary: per side the rate's median and
quartiles and the launches; per pair the head/base ratio and whether
head won; for the trackers also the head/base ratio of each window's ms,
pooled over the pairs.  Exits non-zero if a worker fails.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

HEAD_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the windows a tracker run replays
TRACK_WINDOWS = range(2, 40, 4)


def batch_cell():
    """The batch solve, warmed up; returns its timed run."""
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

    solve()
    torch.cuda.synchronize()

    def run():
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
        out = dict(secs=secs, rate=b.shape[0] / secs,
                   iters=int(res.iters.sum()), nmse_db=float(db.median()),
                   qmin=float(res.quality.min()))
        if out["nmse_db"] > -60.0 or out["qmin"] < 0.98:
            raise RuntimeError(f"missed phase 3's bars: {out}")
        return out

    return run


def tracker_cell(cell, record_path):
    """A warm tracker's recorded windows (recorded here first if
    ``record_path`` does not exist yet), warmed up; returns its timed
    run."""
    import torch

    import chip_smoke as cs
    from twoace_tpu_torch.config import AdmmConfig, ArrayConfig
    from twoace_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from twoace_tpu_torch.pipeline import mobility

    cfg = ArrayConfig(nt=cs.NT, nr=cs.NR)
    admm = AdmmConfig(maxiter=500)
    solver = mobility.make_warm_pair_solver(cfg, admm, use_rank_one=True)
    if not os.path.exists(record_path):
        rows, amps, rows_fresh, amps_fresh, _, _, p = cs.mobility_workload()
        fresh = cell == "warm_fresh"
        mob = mobility.MobilityConfig(window_probes=p,
                                      max_window=256 if fresh else 80,
                                      admm=admm)
        calls = []

        def recording(gen, a, b, ladder_m=None):
            calls.append((a, b, ladder_m, solver.state["x"]))
            return solver(gen, a, b, ladder_m=ladder_m)

        recording.cc_frac = solver.cc_frac
        recording.takes_ladder_m = True
        mobility.track(torch.Generator().manual_seed(0),
                       rows_fresh if fresh else rows,
                       amps_fresh if fresh else amps, cfg, mob,
                       solver=recording)
        with open(record_path + ".part", "wb") as f:
            pickle.dump([calls[w] for w in TRACK_WINDOWS], f)
        os.replace(record_path + ".part", record_path)
    with open(record_path, "rb") as f:
        calls = pickle.load(f)

    def run():
        reset_launch_counts()
        ms = []
        t0 = time.perf_counter()
        for a, b, ladder_m, x_prev in calls:
            solver.state["x"] = x_prev
            t = time.perf_counter()
            x = solver(torch.Generator().manual_seed(0), a, b,
                       ladder_m=ladder_m)
            ms.append((time.perf_counter() - t) * 1e3)
            if not np.isfinite(x).all():
                raise RuntimeError("non-finite estimate")
        secs = time.perf_counter() - t0
        return dict(secs=secs, rate=len(calls) / secs, window_ms=ms,
                    launches=launch_counts())

    run()
    return run


def worker(cell, record_path, profile_first):
    """Serve timed runs: one per line read on stdin."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    if profile_first:
        import torch

        x = torch.ones(1024, device="cuda")
        print(f"profiled: {cs.device_ms(lambda: x * 2.0)} ms a launch",
              flush=True)
    run = batch_cell() if cell == "batch" else tracker_cell(cell, record_path)
    print("AB " + json.dumps({"ready": True}), flush=True)
    for _ in sys.stdin:
        print("AB " + json.dumps(run()), flush=True)


def read(proc, name):
    for line in proc.stdout:
        if line.startswith("AB "):
            return json.loads(line[3:])
    raise RuntimeError(f"the {name} worker ended (rc {proc.wait()})")


def quartiles(v):
    q1, med, q3 = np.percentile(v, [25, 50, 75])
    return dict(median=float(med), q1=float(q1), q3=float(q3))


def describe(r, unit):
    if unit == "rec/s":
        return (f"{r['secs']:.4f} s | {r['rate']:.2f} rec/s | {r['iters']} "
                f"iters | median NMSE {r['nmse_db']:.2f} dB | min quality "
                f"{r['qmin']:.6f}")
    return (f"{r['secs']:.4f} s | {r['rate']:.4f} windows/s | window ms "
            f"{[round(x, 2) for x in r['window_ms']]} | launches "
            f"{r['launches']}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base_dir")
    ap.add_argument("--cell", choices=("batch", "warm", "warm_fresh"),
                    default="batch")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--profile-head", action="store_true")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--record", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.cell, args.record, args.profile_head)

    unit = "rec/s" if args.cell == "batch" else "windows/s"
    tmp = tempfile.TemporaryDirectory()
    record = os.path.join(tmp.name, "windows.pkl")
    dirs = {"head": HEAD_DIR, "base": os.path.abspath(args.base_dir)}
    procs = {}
    try:
        # head first: for a tracker it records the windows both replay
        for name, d in dirs.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-u", os.path.abspath(__file__), d,
                 "--worker", "--cell", args.cell, "--record", record]
                + (["--profile-head"] if name == "head" and args.profile_head
                   else []),
                cwd=d, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True)
            read(procs[name], name)
        runs = {"base": [], "head": []}
        for i in range(args.pairs):
            for name in (("base", "head") if i % 2 == 0 else ("head", "base")):
                procs[name].stdin.write("run\n")
                procs[name].stdin.flush()
                r = read(procs[name], name)
                runs[name].append(r)
                print(f"pair {i} {name}: {describe(r, unit)}", flush=True)
    finally:
        for proc in procs.values():
            proc.stdin.close()
        for proc in procs.values():
            proc.wait(timeout=60)
        tmp.cleanup()
    ratio = [h["rate"] / b["rate"] for b, h in zip(runs["base"], runs["head"])]
    summary = {"cell": args.cell, "unit": unit}
    for name, rs in runs.items():
        summary[name] = dict(rate=quartiles([r["rate"] for r in rs]))
        if unit == "rec/s":
            summary[name].update(
                nmse_db_median=float(np.median([r["nmse_db"] for r in rs])),
                iters=sorted({r["iters"] for r in rs}))
        else:
            summary[name]["launches"] = rs[-1]["launches"]
    summary["head_over_base"] = dict(**quartiles(ratio),
                                     head_wins=sum(x > 1.0 for x in ratio),
                                     pairs=len(ratio))
    if unit == "windows/s":
        # a window's ms, base over head: above 1 where head is faster
        per_window = [bw / hw for b, h in zip(runs["base"], runs["head"])
                      for bw, hw in zip(b["window_ms"], h["window_ms"])]
        summary["window_ms_base_over_head"] = quartiles(per_window)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
