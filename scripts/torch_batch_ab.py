#!/usr/bin/env python3
"""A/B timing of one of chip_smoke.py's cells between two checkouts on one
GPU: phase 6's profiled complex solve, a phase 5 warm tracker's windows,
or phase 2's K2, K3, K5 or K6 alone.  The A2 entries' cells are
``port_bench``'s (``python3 port_bench/run.py --workload <cell> --seed <n>
--seconds 15 --trace 0`` in each checkout).

    python3 scripts/torch_batch_ab.py BASE_DIR
        [--cell k2|k3|k5|k6|campaign|warm|warm_fresh]
        [--pairs 10]
        [--profile-head]

Starts one worker process in the checkout that holds this script (head)
and then one in BASE_DIR (base).  Each imports its own tree's
``twoace_tpu_torch`` and sets up the cell:

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
- ``k2`` (the default): K2 alone at the batch solve's shape (192
  lanes, r 20, 16x16) and the warm trackers' (1 lane, r 1), on phase 2's
  kind of input drawn from one seed (``k2_inputs``); a run reads each
  shape's device time a launch from the profiler
  (``chip_smoke.device_ms``), back to back and with each launch after 41
  small kernels, as a tracker's trip runs them (K2's own events only).
- ``k3``: K3 alone on ``chip_smoke.k3_cases`` at m 972, 1024, 80 and 3,
  both passes; a run takes each case's CUDA-event ms a launch (5
  launches).  K3 has its own cell: after a K3 launch the profiler's reads
  of the other kernels fail their check (PERF.md, section 6).
- ``k5``: K5 (``fused_prox_dual``) alone at every ``K5_AB_SHAPES`` entry
  (chip_smoke.py's ``K5_SHAPES``: the campaign's (972, 20) in the row
  and the per-entry form, the refine's (1024, 1), a tracker window's
  (80, 20), a ragged (97, 3) and complex128), on phase 2's kind of input
  drawn from one seed (``torch_kernel_common.k5_inputs``).
- ``k6``: K6 (``pair_chain_mm``) alone at B 256 and 100 (16x16, 8 steps,
  the chain benchmark's inputs).
  For ``k5`` and ``k6`` a run reads, per shape, the profiler's device ms
  a launch back to back and with each launch after 41 small kernels (as
  the complex loop's trip runs them; the kernel's own events only), and
  the host's cost of a call (``torch_kernel_common.host_us``: 2000
  back-to-back calls, on CUDA events and on the host clock, in ms a
  call), the host's cost of the wrapper's argument checks alone (its
  ``_check``, on the host clock), and the launch floor (the profiler's
  device ms of a one-element elementwise op).
  For the kernel cells, a run's rate is 1 / the first case's ms, and the
  summary gives each case's ms per side and base/head per pair.
- ``campaign``: phase 6's profiled solve (``chip_smoke.campaign_workload``:
  the complex ``solve_lowrank_multi`` at M = 1024, its K5 loop) once to
  warm up; a run is one solve under torch.profiler (the device's own
  events, ``chip_smoke.device_events``), and reports its wall ms, the
  device's busy ms and share, its trips and wall ms a trip.  Its rate is
  1 / the wall seconds.

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


#: the k2 cell's shapes (lanes, r, nt, nr) and the k3 cell's m
K2_AB_SHAPES = ((192, 20, 16, 16), (1, 1, 16, 16))
K3_AB_MS = (972, 1024, 80, 3)


def k2_inputs(lanes, r, nt, nr, seed=0):
    """K2's inputs of phase 2's kind at (lanes, r, nt x nr), as
    ``chip_smoke.k2_case`` draws them: z, a warm basis from a cold eigh of
    a perturbed z, the three ladders mixed over the lanes.  Built here
    from the tree's own modules, so a checkout older than ``k2_case``
    runs it too."""
    import torch

    from twoace_tpu_torch.ops.cplx import LadderArrays, Pair
    from twoace_tpu_torch.ops.kernels.zprox import zprox_t_plain
    from twoace_tpu_torch.ops.prox import profile_ladder_arrays

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = nt * nr

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    z = Pair(randn(lanes, r, n), randn(lanes, r, n))
    zp = Pair(z.re + 0.05 * randn(lanes, r, n),
              z.im + 0.05 * randn(lanes, r, n))
    m = 4 * n
    lads = [profile_ladder_arrays(nt, nr, mm, n, one, device="cuda")
            for mm, one in ((int(np.floor(m * 0.95)), False),
                            (int(np.floor(m * 0.95)), True), (m, False))]
    pick = torch.arange(lanes, device="cuda") % 3
    lad = LadderArrays(torch.stack([l.ranks for l in lads])[pick],
                       torch.stack([l.fracs for l in lads])[pick])
    _, v0 = zprox_t_plain(zp, None, nt, nr, lad)
    return z, v0, lad


#: the k5 cell's shapes (m, r, dtype name, per_entry): chip_smoke.py's
#: K5_SHAPES
K5_AB_SHAPES = ((972, 20, "complex64", False), (972, 20, "complex64", True),
                (1024, 1, "complex64", False), (80, 20, "complex64", False),
                (97, 3, "complex64", True), (972, 20, "complex128", False))
K6_AB_BATCHES = (256, 100)


def small_kernels():
    """What a trip of the loops runs between two launches of one kernel: a
    few dozen small elementwise kernels and a reduction (41 launches)."""
    import torch

    x = torch.ones(4096, device="cuda")

    def others():
        y = x
        for _ in range(40):
            y = y * 1.0001 + 1e-7
        return y.sum()

    return others


def kernel_cell(cell):
    """K2's, K3's, K5's or K6's cases, warmed up; returns the timed run."""
    import chip_smoke as cs
    from twoace_tpu_torch.ops.kernels import fused_infer_admm, fused_zprox_t

    cases, between, host, checks, own = {}, {}, {}, {}, None
    if cell == "k2":
        others, own = small_kernels(), "zprox"
        for lanes, r, nt, nr in K2_AB_SHAPES:
            z, v0, lad = k2_inputs(lanes, r, nt, nr)
            launch = (lambda z=z, v0=v0, lad=lad, nt=nt, nr=nr:
                      fused_zprox_t(z, v0, nt, nr, lad))
            cases[f"K2 lanes {lanes} r {r} {nt}x{nr}"] = launch
            between[f"K2 lanes {lanes} r {r} {nt}x{nr} between others"] = (
                lambda launch=launch: (others(), launch()))
    elif cell in ("k5", "k6"):
        import torch

        from torch_kernel_common import (HOST_CALLS, host_us, k5_inputs,
                                         launch_floor_ms)
        from twoace_tpu_torch.ops.cplx import Pair
        from twoace_tpu_torch.ops.kernels import (chain_mm, fused_prox_dual,
                                                  pair_chain_mm,
                                                  prox_dual_rows)

        others = small_kernels()
        if cell == "k5":
            own = "prox_dual"
            for m, r, dt, per_entry in K5_AB_SHAPES:
                args = k5_inputs(m, r, getattr(torch, dt))
                name = f"K5 ({m}, {r}) {dt} per_entry {per_entry}"
                cases[name] = (lambda args=args, pe=per_entry:
                               fused_prox_dual(*args, per_entry=pe))
                checks[name] = lambda args=args: prox_dual_rows._check(*args)
        else:
            own = "chain_mm"
            for batch in K6_AB_BATCHES:
                planes = chain_mm.lane_inputs(seed=6, b=batch)
                v, g = (chain_mm.from_lanes(Pair(*(
                    torch.as_tensor(p, device="cuda") for p in pl)))
                    for pl in (planes[:2], planes[2:]))
                name = f"K6 B {batch} {chain_mm.N}x{chain_mm.N}"
                cases[name] = lambda v=v, g=g: pair_chain_mm(v, g)
                checks[name] = lambda v=v, g=g: chain_mm._check(v, g)
        for name, launch in list(cases.items()):
            between[f"{name} between others"] = (
                lambda launch=launch: (others(), launch()))
            host[f"{name} host (events, {HOST_CALLS} calls)"] = launch
    else:
        for m in K3_AB_MS:
            for label, a, kw in cs.k3_cases(m):
                cases[f"K3 {label}"] = (lambda a=a, kw=kw:
                                        fused_infer_admm(*a, **kw))

    def run():
        ms = {name: (cs.cuda_ms(fn, reps=5) if cell == "k3"
                     else cs.device_ms(fn))
              for name, fn in cases.items()}
        for name, fn in between.items():
            # the kernel's own events of each call, apart from the others'
            # (a second function, launching nothing, owns those)
            ms[name] = cs.device_ms(
                fn, lambda: None, owner=lambda k: 0 if own in k else 1)[0]
        for name, fn in host.items():
            us = host_us(fn)
            ms[name] = us["events_us"] / 1e3
            ms[name.replace("(events", "(host clock")] = us["clock_us"] / 1e3
        for name, fn in checks.items():
            # the wrapper's argument checks alone (they launch nothing)
            ms[f"{name} checks (host clock, {HOST_CALLS} calls)"] = (
                host_us(fn)["clock_us"] / 1e3)
        if host:
            ms["launch floor (one-element op)"] = launch_floor_ms(cs.device_ms)
        first = next(iter(ms.values()))
        return dict(secs=sum(v or 0.0 for v in ms.values()) / 1e3,
                    rate=1.0 / first if first else float("nan"), ms=ms)

    return run


def campaign_cell():
    """Phase 6's profiled M = 1024 complex solve, warmed up; returns its
    timed run (under the profiler, as phase 6 runs it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from twoace_tpu_torch.ops import admm
    from twoace_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from twoace_tpu_torch.pipeline import recovery
    from twoace_tpu_torch.utils.units import dbm_to_amplitude

    cb, _, rss, _ = cs.campaign_workload()
    cc = recovery.CampaignConfig(array=cs.ArrayConfig(nt=cs.NT, nr=cs.NR))
    a = cb[:cs.M]
    b = dbm_to_amplitude(torch.as_tensor(rss[:cs.M], device=a.device),
                         cc.rss_fct)

    def solve():
        return admm.solve_lowrank_multi(torch.Generator().manual_seed(0), a,
                                        b, cs.NT, cs.NR, cc.admm)

    solve()
    torch.cuda.synchronize()

    def run():
        reset_launch_counts()
        admm.infer_admm.trips = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy = sum(ms for ms, _ in cs.device_events(prof).values())
        trips = admm.infer_admm.trips
        return dict(secs=wall_ms / 1e3, rate=1e3 / wall_ms, wall_ms=wall_ms,
                    busy_ms=busy, busy_share=busy / wall_ms, trips=trips,
                    ms_a_trip=wall_ms / max(trips, 1),
                    launches=launch_counts())

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
    run = (campaign_cell() if cell == "campaign" else kernel_cell(cell)
           if cell in ("k2", "k3", "k5", "k6")
           else tracker_cell(cell, record_path))
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
    if unit == "1/s":
        return (f"wall {r['wall_ms']:.2f} ms | device busy {r['busy_ms']:.2f} "
                f"ms ({100 * r['busy_share']:.1f}%) | {r['trips']} trips, "
                f"{r['ms_a_trip']:.4f} ms a trip | launches {r['launches']}")
    if unit == "1/ms":
        return " | ".join(f"{k} {'not measured' if v is None else f'{v:.6f}'}"
                          f" ms" for k, v in r["ms"].items())
    return (f"{r['secs']:.4f} s | {r['rate']:.4f} windows/s | window ms "
            f"{[round(x, 2) for x in r['window_ms']]} | launches "
            f"{r['launches']}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base_dir")
    ap.add_argument("--cell", choices=("k2", "k3", "k5", "k6", "campaign",
                                       "warm", "warm_fresh"),
                    default="k2")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--profile-head", action="store_true")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--record", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.cell, args.record, args.profile_head)

    unit = {"campaign": "1/s", "k2": "1/ms", "k3": "1/ms", "k5": "1/ms",
            "k6": "1/ms"}.get(args.cell, "windows/s")
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
        if unit == "1/s":
            summary[name].update({k: quartiles([r[k] for r in rs]) for k in (
                "wall_ms", "busy_ms", "busy_share", "ms_a_trip")})
            summary[name].update(trips=sorted({r["trips"] for r in rs}),
                                 launches=rs[-1]["launches"])
        elif unit == "1/ms":
            summary[name]["ms"] = {
                k: quartiles([r["ms"][k] for r in rs if r["ms"][k]])
                for k in rs[0]["ms"] if any(r["ms"][k] for r in rs)}
        else:
            summary[name]["launches"] = rs[-1]["launches"]
    summary["head_over_base"] = dict(**quartiles(ratio),
                                     head_wins=sum(x > 1.0 for x in ratio),
                                     pairs=len(ratio))
    if unit == "1/ms":
        # each case's ms, base over head: above 1 where head is faster
        summary["ms_base_over_head"] = {
            k: quartiles([b["ms"][k] / h["ms"][k]
                          for b, h in zip(runs["base"], runs["head"])
                          if b["ms"][k] and h["ms"][k]])
            for k in runs["head"][0]["ms"]
            if any(b["ms"][k] and h["ms"][k]
                   for b, h in zip(runs["base"], runs["head"]))}
    if unit == "windows/s":
        # a window's ms, base over head: above 1 where head is faster
        per_window = [bw / hw for b, h in zip(runs["base"], runs["head"])
                      for bw, hw in zip(b["window_ms"], h["window_ms"])]
        summary["window_ms_base_over_head"] = quartiles(per_window)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
