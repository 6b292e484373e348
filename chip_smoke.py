#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises and exits non-zero:

  0. device: requires CUDA; prints nvidia-smi's name and power limit, the
     torch and CUDA versions and ``nvcc --version``;
  1. build: compiles ``twoace_tpu_torch/csrc/*.cu`` (one nvcc per source,
     in parallel) into the git-ignored ``twoace_tpu_torch/_build/``;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes, with CUDA-event times of both and the least time
     the card could take for the same work;
  3. the batch slice: ``solve_lowrank_multi_pair_batch`` on the bench.py
     solve workload (seed 1, 64 two-path 16x16 channels, one shared 2-bit
     codebook, m = 1024, maxiter 500, warm_iters 80, pass caps 120/160),
     once to warm up and once timed, with K4's, K1's and K2's launch
     counts;
  4. the single-recovery slice: ``solve_lowrank_multi_pair`` at the cold
     config (maxiter 500) through bench.py's single-latency codebook (seed
     3, 16x16, m = 1024): one warm-up and ten timed solves of bench.py's
     random complex x, then of a two-path channel, with K3's launch count;
     then one anchored ``refine_lowrank_pair`` seeded by the two-path
     result, which runs K4, K1 and K2;
  5. the mobility tracker: ``track`` with the four trackers of
     scripts/bench_mobility_r05.py on its workload (rebuilt with numpy:
     16x16, 40 windows of 64 kron probes, max_window 80 and 256,
     maxiter 500) after one short warm-up track each: windows/s, median
     per-window ms, tracked NMSE, the budget branches, launches and a
     profiled window; then a 10-window ``track_simulated`` on a
     ``brownian_trace``;
  6. the testbed campaign through the complex family (K5):
     ``recover_a2only`` over the 16x16 probe-budget grid on 3968 random
     probe rows, a noiseless M = 1024 point, ``recover_a2nuclear``,
     ``recover_warm_sweep``, ``track(solver=None)`` for TRACK_WINDOWS
     windows and one profiled M = 1024 solve;
  7. the headline Vs_M campaign of VSM_r05.json: ``sweep_measurements``
     at 16x16 with A2 on the pair path (K3) against PhaseLift, PLOMP,
     PLGAMP and perfect/noisy-phase CS, each curve beside VSM_r05's (it
     fails if one is more than 3 dB off at M >= 529, or if A2 does not
     beat PLOMP at M = 784 and 1024); one complex-family A2 cell (K5),
     one ``sweep_snr`` point beside VSSNR_r05.json, one profiled cell.

Between phases 2 and 3 the chain benchmark (``chain``), K6's own path,
runs ``scripts/torch_bench_pallas_mm.py``'s body.

Phase 2 also holds K4 (the per-op loop's pair GEMM) against its plain
version at the batch solver's, the anchored refine's (one row: the warm
trackers' m 80 and 256, phase 4's m 1024) and a ragged shape, and K5 at
the campaign's, the refine's and a tracker window's shapes, a ragged m
and complex128, and K6 at the chain benchmark's batch and a ragged
one.  Phase 2 also reads K1's, K5's and K6's device time a launch from
the profiler beside their CUDA-event times.  Each path (the batch solve, the single solves, the
refine, each tracker, each part of the campaign) is driven with the
launch counts set to 0 just before it and read just after, and fails if
a kernel it runs was never launched.

The last three lines are a JSON summary of the kernels, the nvidia-smi
line, and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from twoace_tpu_torch import interop  # noqa: E402
from twoace_tpu_torch.config import (  # noqa: E402
    AdmmConfig, ArrayConfig, ChannelConfig, MethodFlags, probe_budget_grid)
from twoace_tpu_torch.models.channel import generate_channel  # noqa: E402
from twoace_tpu_torch.ops import admm, dispatch  # noqa: E402
from twoace_tpu_torch.ops.cplx import LadderArrays, Pair  # noqa: E402
from twoace_tpu_torch.ops import pair_solver  # noqa: E402
from twoace_tpu_torch.ops.kernels import (  # noqa: E402
    _build, chain_mm, fused_infer_admm, fused_prox_dual, fused_prox_dual_t,
    fused_zprox_t, infer_admm_plain, launch_counts, pair_chain_mm,
    pair_chain_mm_plain, pair_matmul, pair_matmul_plain,
    prox_dual_rows_plain, prox_dual_t_plain, reset_launch_counts,
    zprox_t_plain)
from twoace_tpu_torch.ops.pair_solver import (  # noqa: E402
    no_tf32, refine_lowrank_pair, solve_lowrank_multi_pair,
    solve_lowrank_multi_pair_batch)
from twoace_tpu_torch.ops.prox import profile_ladder_arrays  # noqa: E402
from twoace_tpu_torch.pipeline import mobility, recovery, simulation  # noqa: E402
from twoace_tpu_torch.sensing.codebooks import (  # noqa: E402
    kron_probe_rows, random_codebook)
from twoace_tpu_torch.sensing.provider import SyntheticProvider  # noqa: E402
from twoace_tpu_torch.utils.metrics import nmse_h_projection  # noqa: E402
from twoace_tpu_torch.utils.rng import fold_in  # noqa: E402
from twoace_tpu_torch.utils.units import dbm_to_amplitude  # noqa: E402

NT = NR = 16
N = NT * NR
M = 4 * N
R = 20
SOLVE_BATCH = 64
RESTARTS = 3
M_TRAIN = int(np.floor(M * 0.95))            # 972, the first-pass train split
LANES = SOLVE_BATCH * RESTARTS               # 192
K1_TOL = dict(rtol=1e-5, atol=1e-6)
K2_ATOL = 5e-5
#: K3 against its plain version: max |difference| over max |plain| of
#: opt_x and opt_y after K3_TRIPS trips.  Measured 5e-6 to 7e-6 on the
#: H100 (chip run, PR 2).  The check starts from a warm lane state (50
#: first-pass trips) at mu0 = K3_MU0: from a cold start, and in the
#: per-column pass at small mu, the loop amplifies float32 rounding (the
#: plain version on the CPU and on the card part as far within 10 trips)
#: and the argmin column can flip, so no tolerance would hold there.
K3_RTOL = 1e-4
K3_TRIPS = 30
K3_WARM = 50
K3_MU0 = 0.4
SINGLE_REPS = 10
#: K4 against its plain version: max |difference| over max |plain|.
#: Measured 0 (bit-identical) at the batch shapes on an H100 80GB HBM3
#: at 700 W: both sum K in order with FMAs.
K4_RTOL = 1e-5
#: K4's shapes, (G, M, K, N): the batch solver's three products (G = 3
#: restarts, M = 64 instances x r 20); the anchored refine's, whose seed
#: is one vector (G 1, M = r 1, n 256) at the warm trackers' windows
#: (m 80, 256) and phase 4's m 1024; and a ragged one
K4_SHAPES = [(RESTARTS, SOLVE_BATCH * R, M_TRAIN, N),
             (RESTARTS, SOLVE_BATCH * R, N, N),
             (RESTARTS, SOLVE_BATCH * R, N, M_TRAIN),
             *dict.fromkeys((1, 1, k, n) for m in (80, 256, M)
                            for k, n in ((m, N), (N, N), (N, m))),
             (2, 70, 97, 51)]

#: K5 against its plain version: max |difference| over max |plain|.  The
#: two round every step alike except the order of the row sum.
K5_RTOL = {torch.complex64: 2e-6, torch.complex128: 1e-14}
#: K5's shapes (m, r, dtype, per_entry): the campaign's pass 1 and pass 2
#: at M 1024 (m = floor(0.95 M), r 20), the refine (m = M, r 1), a tracker
#: window (80, 20), a ragged m, and complex128; each with 9 padded
#: (b = 0) rows and one all-zero row
K5_SHAPES = [(M_TRAIN, R, torch.complex64, False),
             (M_TRAIN, R, torch.complex64, True),
             (M, 1, torch.complex64, False),
             (80, R, torch.complex64, False),
             (97, 3, torch.complex64, True),
             (M_TRAIN, R, torch.complex128, False)]
#: K6 against its plain version: max |difference| over max |plain|, at the
#: benchmark's batch and a ragged one
K6_RTOL = 1e-5
K6_BATCHES = (chain_mm.B, 100)
#: the chain benchmark's error after 800 products against numpy complex128
#: (2.6e-6 for the plain version on the CPU at B 32)
K6_CHAIN_ATOL = 1e-4
#: phase 6: the shipped random_probe_cb_16x16.mat's dimensions
CAMPAIGN_ROUNDS, CAMPAIGN_SECTORS = 64, 62
CAMPAIGN_SEED = 6
#: the channel's scale, as in the testbed sample (about -46 dBm per probe)
CHANNEL_SCALE = 3e-4
TRACK_WINDOWS = 10

#: phase 7: the headline Vs_M campaign of VSM_r05.json
#: (scripts/finalize_vsm_artifact.py:6-10): 16x16, 3 paths, 95 degrees,
#: SNR 20, Random_Phase_State, maxiter 500, 3 restarts, seed 1, A2 against
#: PhaseLift, PLOMP, PLGAMP and perfect/noisy-phase CS
VSM_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "VSM_r05.json")
VSSNR_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "VSSNR_r05.json")
VSM_SEED = 1
VSM_AREA = 95.0
#: trials per point: VSM_r05 ran 10; cut to 5 (292 s on an H100, the
#: two-stage FISTA's 4000 eigh a recovery; PERF.md sections 4 and 5) for
#: the script's time limit
VSM_TRIALS = 5
#: the checks at M >= VSM_CHECK_FROM: every curve within VSM_TOL_DB of
#: VSM_r05's, and A2 below PLOMP at VSM_A2_WINS
VSM_CHECK_FROM = 529
VSM_TOL_DB = 3.0
VSM_A2_WINS = (784, 1024)
#: the complex-family cell (A2 alone) and the profiled cell (every
#: method): M 1024, 2 trials; the Vs_SNR point: VSSNR_r05's M 529 at SNR
#: 10, VSM_TRIALS trials
VSM_SIDE_TRIALS = 2
VSSNR_M, VSSNR_SNR = 529, 10.0

#: H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, float32 flop/s
#: outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12


def phase0_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [_build.nvcc(), "--version"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"[0 device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | nvcc: {nvcc}", flush=True)
    return smi


def phase1_build():
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"[1 build] {path.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)


def cuda_ms(fn, reps=50):
    """Mean CUDA-event milliseconds of ``fn()`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_events(prof):
    """{name: [ms, count]} of the device's own events (kernels, copies)
    in a finished torch.profiler run, summed from the raw trace: a CPU
    op's device time would repeat its kernels', and parsing the trace
    into the profiler's event tree (``key_averages``) takes minutes for
    the 10^5 launches of a Vs_M cell."""
    from torch.autograd import DeviceType

    out = {}
    results = prof.profiler.kineto_results
    for e in (results.events() if results is not None else ()):
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            acc = out.setdefault(e.name(), [0.0, 0])
            acc[0] += e.duration_ns() / 1e6
            acc[1] += 1
    return out


def device_ms(fn, reps=20):
    """Mean device milliseconds per call of ``fn()`` under torch.profiler:
    its kernels' own time, without the host's cost of the call that
    ``cuda_ms``'s events take in when a wrapper outlasts its kernel.
    None if the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):                  # the profiler now and then sees none
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(ms for ms, _ in device_events(prof).values())
        if total > 0:
            return total / reps
    return None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.6f} ms"


def max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def nbytes(*ts):
    """Bytes of the tensors (Pairs and LadderArrays count both halves)."""
    flat = []
    for t in ts:
        flat.extend(t if isinstance(t, tuple) else (t,))
    return sum(t.numel() * t.element_size() for t in flat)


def bound(n_bytes, flops):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the flops over the float32 rate, in ms."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32 * 1e3
    return (dict(bound_ms=t_bytes, bound_by="bytes") if t_bytes >= t_ops
            else dict(bound_ms=t_ops, bound_by="operations"))


def phase2_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    summary = {}
    # K1: first-pass train split and full-data shapes, both prox modes
    errs, times = [], {}
    for m in (M_TRAIN, M):
        ax = Pair(randn(LANES, R, m), randn(LANES, R, m))
        md = Pair(randn(LANES, R, m), randn(LANES, R, m))
        b = torch.rand(LANES, m, generator=gen, device="cuda") + 0.5
        b[:, :7] = 0.0                       # inactive padding columns
        ax.re[:, :, 7:11] = 0.0              # zero columns
        ax.im[:, :, 7:11] = 0.0
        md.re[:, :, 7:11] = 0.0
        md.im[:, :, 7:11] = 0.0
        mu = torch.rand(LANES, generator=gen, device="cuda") + 1e-3
        for per_entry in (False, True):
            y, mo = fused_prox_dual_t(ax, b, md, mu, per_entry=per_entry)
            y0, mo0 = prox_dual_t_plain(ax, b, md, mu, per_entry)
            torch.cuda.synchronize()
            for got, want in ((y.re, y0.re), (y.im, y0.im),
                              (mo.re, mo0.re), (mo.im, mo0.im)):
                torch.testing.assert_close(got, want, **K1_TOL)
            err = max_err([y.re, y.im, mo.re, mo.im],
                          [y0.re, y0.im, mo0.re, mo0.im])
            errs.append(err)
            ms = cuda_ms(lambda: fused_prox_dual_t(ax, b, md, mu,
                                                   per_entry=per_entry))
            plain = cuda_ms(lambda: prox_dual_t_plain(ax, b, md, mu,
                                                      per_entry))
            dev = device_ms(lambda: fused_prox_dual_t(ax, b, md, mu,
                                                      per_entry=per_entry))
            times[(m, per_entry)] = (ms, plain, dev)
            print(f"[2 K1 fused_prox_dual_t] lanes {LANES} r {R} m {m} "
                  f"per_entry {per_entry}: max_abs_err {err:.3e} | kernel "
                  f"{ms:.4f} ms (events), device {fmt_ms(dev)} per launch "
                  f"(profiler) | plain {plain:.4f} ms", flush=True)
    # bound at the row-form m 972 shape: 4 planes in, 4 out, b and mu;
    # about 16 flops per entry
    k1_bytes = (8 * LANES * R * M_TRAIN + LANES * M_TRAIN + LANES) * 4
    summary["fused_prox_dual_t"] = dict(
        max_abs_err=max(errs), ms=times[(M_TRAIN, False)][0],
        plain_ms=times[(M_TRAIN, False)][1],
        device_ms=times[(M_TRAIN, False)][2],
        **bound(k1_bytes, 16 * LANES * R * M_TRAIN), library_ms=None)

    # K2: warm basis from a cold eigh of a perturbed z; the lanes mix the
    # normal train-split ladder (one f = 0 pad), the rank-1 ladder (three
    # pads) and the m >= 3n full-data ladder (three pads)
    z = Pair(randn(LANES, R, N), randn(LANES, R, N))
    zp = Pair(z.re + 0.05 * randn(LANES, R, N), z.im + 0.05 * randn(LANES, R, N))
    ladders = [profile_ladder_arrays(NT, NR, M_TRAIN, N, False, device="cuda"),
               profile_ladder_arrays(NT, NR, M_TRAIN, N, True, device="cuda"),
               profile_ladder_arrays(NT, NR, M, N, False, device="cuda")]
    pick = torch.arange(LANES, device="cuda") % 3
    lad = LadderArrays(torch.stack([l.ranks for l in ladders])[pick],
                       torch.stack([l.fracs for l in ladders])[pick])
    _, v0 = zprox_t_plain(zp, None, NT, NR, lad)
    zn, vn = fused_zprox_t(z, v0, NT, NR, lad)
    zn0, vn0 = zprox_t_plain(z, v0, NT, NR, lad)
    torch.cuda.synchronize()
    for got, want in ((zn.re, zn0.re), (zn.im, zn0.im), (vn.re, vn0.re),
                      (vn.im, vn0.im)):
        torch.testing.assert_close(got, want, rtol=0.0, atol=K2_ATOL)
    err = max_err([zn.re, zn.im, vn.re, vn.im], [zn0.re, zn0.im, vn0.re,
                                                  vn0.im])
    moved = float((zn.re - z.re).abs().max())
    if moved < 1e-2:
        raise RuntimeError(f"K2 check is vacuous: the ladder moved z by "
                           f"only {moved:.2e}")
    ms = cuda_ms(lambda: fused_zprox_t(z, v0, NT, NR, lad))
    plain = cuda_ms(lambda: zprox_t_plain(z, v0, NT, NR, lad))
    print(f"[2 K2 fused_zprox_t] lanes {LANES} r {R} nt=nr={NR}: "
          f"max_abs_err {err:.3e} (ladder moved z by {moved:.3f}) | kernel "
          f"{ms:.4f} ms | plain {plain:.4f} ms", flush=True)
    rows = R * NT
    k2_flops = LANES * (2 * rows * NR * NR * 8 + 7 * NR ** 3 * 8)
    summary["fused_zprox_t"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain,
        **bound(nbytes(z, v0, lad, zn, vn), k2_flops), library_ms=None)
    summary["fused_infer_admm"] = phase2_k3()
    summary["pair_matmul"] = phase2_k4()
    summary["fused_prox_dual"] = phase2_k5()
    summary["pair_chain_mm"] = phase2_k6()
    return summary


def phase2_k6():
    """K6 against its plain version at K6_BATCHES of (16, 16) instances
    (8 steps), with the times of both, of the complex64 ``torch.matmul``
    chain and the bound: V and G read once and V' written once, and the
    Karatsuba chain's 3 real n x n x n products a step."""
    out = {}
    for batch in K6_BATCHES:
        planes = chain_mm.lane_inputs(seed=6, b=batch)
        v = chain_mm.from_lanes(Pair(*(torch.as_tensor(p, device="cuda")
                                       for p in planes[:2])))
        g = chain_mm.from_lanes(Pair(*(torch.as_tensor(p, device="cuda")
                                       for p in planes[2:])))
        vc, gc = torch.complex(*v), torch.complex(*g)
        with no_tf32():
            got = pair_chain_mm(v, g)
            want = pair_chain_mm_plain(v, g)
            torch.cuda.synchronize()
            rel = max(float((x - w).abs().max() / w.abs().max())
                      for x, w in zip(got, want))
            if not rel <= K6_RTOL:
                raise RuntimeError(f"K6 disagrees with its plain version at "
                                   f"B {batch}: {rel:.3e} > {K6_RTOL}")
            err = max_err(got, want)
            ms = cuda_ms(lambda: pair_chain_mm(v, g))
            plain = cuda_ms(lambda: pair_chain_mm_plain(v, g))
            lib = cuda_ms(lambda: chain_mm.library_chain(vc, gc))
            dev = device_ms(lambda: pair_chain_mm(v, g))
        n = chain_mm.N
        bnd = bound(nbytes(v, g, got),
                    chain_mm.CHAIN * batch * 3 * 2 * n ** 3)
        print(f"[2 K6 pair_chain_mm] B {batch}, {n}x{n}, {chain_mm.CHAIN} "
              f"steps: max rel err {rel:.3e} (tol {K6_RTOL}), max abs err "
              f"{err:.3e} | kernel {ms:.4f} ms (events), device "
              f"{fmt_ms(dev)} per launch (profiler) | plain {plain:.4f} ms | "
              f"complex64 torch.matmul chain {lib:.4f} ms | bound "
              f"{bnd['bound_ms']:.6f} ms ({bnd['bound_by']})", flush=True)
        out[batch] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                          device_ms=dev, **bnd, library_ms=lib)
    return out[K6_BATCHES[0]]


def phase_chain_bench():
    """K6's own path, ``scripts/torch_bench_pallas_mm.py``: 100 launches of
    the 8-step chain at B 256 timed back to back for K6, its plain version
    and the complex64 ``torch.matmul`` chain, and each route's error after
    800 products against numpy complex128."""
    reset_launch_counts()
    res = chain_mm.chain_benchmark()
    counts = launch_counts()
    require_launched(counts, ("pair_chain_mm",), "the chain benchmark")
    worst = max(res[f"{r}_max_abs_err"] for r in ("kernel", "plain", "library"))
    print(f"[chain] torch_bench_pallas_mm B {res['b']} {res['n']}x{res['n']}, "
          f"{res['reps']} launches of {res['chain']} steps: us per batched "
          f"product: K6 {res['kernel_us_per_product']:.3f} | plain "
          f"{res['plain_us_per_product']:.3f} | complex64 torch.matmul "
          f"{res['library_us_per_product']:.3f} || max abs err vs numpy "
          f"complex128: K6 {res['kernel_max_abs_err']:.2e} | plain "
          f"{res['plain_max_abs_err']:.2e} | library "
          f"{res['library_max_abs_err']:.2e} | launches {counts}", flush=True)
    if not worst <= K6_CHAIN_ATOL:
        raise RuntimeError(f"the chain benchmark's error {worst:.2e} > "
                           f"{K6_CHAIN_ATOL}")
    return counts


def phase2_k5():
    """K5 against its plain version at K5_SHAPES, with the times of both
    and the bound: each of ax, M, b, mu read once and y, M' written once,
    about 20 flops per complex entry."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for m, r, dtype, per_entry in K5_SHAPES:
        rdt = torch.float32 if dtype == torch.complex64 else torch.float64
        ax, md = (torch.randn(m, r, dtype=dtype, generator=gen, device="cuda")
                  for _ in range(2))
        b = torch.rand(m, dtype=rdt, generator=gen, device="cuda") + 0.5
        b[m - 9:] = 0.0                       # padded (inactive) rows
        ax[3] = 0.0                           # an all-zero row
        md[3] = 0.0
        mu = torch.tensor(0.41, dtype=rdt, device="cuda")
        got = fused_prox_dual(ax, b, md, mu, per_entry)
        want = prox_dual_rows_plain(ax, b, md, mu, per_entry)
        torch.cuda.synchronize()
        rel = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want))
        label = f"({m}, {r}) {str(dtype)[6:]} per_entry {per_entry}"
        if not rel <= K5_RTOL[dtype]:
            raise RuntimeError(f"K5 disagrees with its plain version at "
                               f"{label}: {rel:.3e} > {K5_RTOL[dtype]}")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ms = cuda_ms(lambda: fused_prox_dual(ax, b, md, mu, per_entry))
        plain = cuda_ms(lambda: prox_dual_rows_plain(ax, b, md, mu,
                                                     per_entry))
        dev = device_ms(lambda: fused_prox_dual(ax, b, md, mu, per_entry))
        bnd = bound(nbytes(ax, md, b, mu, *got), 20 * m * r)
        print(f"[2 K5 fused_prox_dual] {label}: max rel err {rel:.3e} (tol "
              f"{K5_RTOL[dtype]}), max abs err {err:.3e} | kernel {ms:.4f} "
              f"ms (events), device {fmt_ms(dev)} per launch (profiler) | "
              f"plain {plain:.4f} ms | bound {bnd['bound_ms']:.6f} ms "
              f"({bnd['bound_by']})", flush=True)
        out[(m, r, dtype, per_entry)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, device_ms=dev, **bnd,
            library_ms=None)
    return out[K5_SHAPES[0]]


def k3_flops(it, r, m, n):
    """Flops of the trips the lanes ran: the four complex products in
    Karatsuba form, the Z-prox (panel Gram, delta apply, nr x nr chain)
    and the prox, per trip."""
    per_trip = (6 * r * (3 * m * n + n * n) + 2 * r * n * NR * 8
                + 7 * NR ** 3 * 8 + 16 * r * m)
    return int(it.sum()) * per_trip


def rel_err(got, want):
    """max |got - want| / max |want| over opt_x and opt_y."""
    return max(float((g.cpu() - w.cpu()).abs().max() / w.abs().max().cpu())
               for gp, wp in zip(got[:2], want[:2]) for g, w in zip(gp, wp))


def cold_divergence(args, loop, trips=10):
    """From a cold start (spectral init, mu0 1e-3) the loop amplifies
    float32 rounding: print how far K3 and the plain version part after
    ``trips`` trips, beside how far the plain version on the CPU and on
    the card part.  No tolerance is held here."""
    def cpu(t):
        if isinstance(t, tuple):
            return type(t)(*(v.cpu() for v in t))
        return t.cpu()

    kw = dict(scale_by_row=True, maxiter=trips, **loop)
    got = fused_infer_admm(*args, **kw)
    want = infer_admm_plain(*args, **kw)
    want_cpu = infer_admm_plain(*(cpu(t) for t in args), **kw)
    print(f"[2 K3 cold start] {trips} trips from the spectral init at mu0 "
          f"1e-3, m {M_TRAIN}: K3 vs plain rel err "
          f"{rel_err(got, want):.3e} | plain on the CPU vs plain on the "
          f"card {rel_err(want_cpu, want):.3e} (reported, not held)",
          flush=True)


def phase2_k3():
    """K3 on 3 lanes (one per restart), r 20, 16x16, at the train split's
    m 972 and the full m 1024, both passes, K3_TRIPS trips with zero
    tolerances so every trip runs, from a warm lane state."""
    lanes = RESTARTS
    out = {}
    for m in (M_TRAIN, M):
        a, b, _ = build_solve_problem(seed=5, batch=lanes, m=m)
        ap = Pair(*(torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32,
                                    device="cuda")[None].expand(lanes, m, N)
                    .contiguous() for v in (a.real, a.imag)))
        bt = torch.as_tensor(b, dtype=torch.float32, device="cuda")[:, None]
        bt = bt / torch.linalg.vector_norm(bt, dim=-1, keepdim=True)
        lad = profile_ladder_arrays(NT, NR, m, N, False, device="cuda")
        lad = LadderArrays(lad.ranks.expand(lanes, -1).contiguous(),
                           lad.fracs.expand(lanes, -1).contiguous())
        lad3 = LadderArrays(lad.ranks[:, None], lad.fracs[:, None])
        u = pair_solver.precompute_u_pair(ap)
        x0 = pair_solver.spectral_initialize_pair(
            ap, bt, R, torch.Generator().manual_seed(5))

        def prepared(x, sbr, mu0):
            y0, z0, v0 = pair_solver.admm_init_pair(
                ap, bt, x, scale_by_row=sbr, nt=NT, nr=NR, ladder=lad3)
            c = lambda p: Pair(p.re.contiguous(), p.im.contiguous())
            return [ap, bt, u, c(y0), c(z0), c(v0),
                    torch.full((lanes, 1), mu0, device="cuda"), lad]

        loop = dict(nt=NT, nr=NR, rho=1.03, tol_rel=0.0, tol_abs=0.0)
        cold = prepared(x0, True, 1e-3)
        if m == M_TRAIN:
            cold_divergence(cold, loop)
        xw = fused_infer_admm(*cold, scale_by_row=True, maxiter=K3_WARM,
                              **loop)[0]
        for sbr in (True, False):
            x = xw if sbr else pair_solver._orthonormalize_cols_t(xw)
            args = prepared(x, sbr, K3_MU0)
            kw = dict(scale_by_row=sbr, maxiter=K3_TRIPS, **loop)
            got = fused_infer_admm(*args, **kw)
            want = infer_admm_plain(*args, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(got[3], want[3])
                    and torch.equal(got[2], want[2])):
                raise RuntimeError(f"K3 trips {got[3].tolist()} / converged "
                                   f"{got[2].tolist()} vs plain "
                                   f"{want[3].tolist()} / {want[2].tolist()}")
            if int(got[3].min()) != K3_TRIPS:
                raise RuntimeError(f"K3 ran {got[3].tolist()} trips, not "
                                   f"{K3_TRIPS}")
            rel = rel_err(got, want)
            err = max_err([*got[0], *got[1]], [*want[0], *want[1]])
            if not rel <= K3_RTOL:
                raise RuntimeError(f"K3 disagrees with its plain version: "
                                   f"relative error {rel:.3e} > {K3_RTOL}")
            ms = cuda_ms(lambda: fused_infer_admm(*args, **kw), reps=5)
            plain = cuda_ms(lambda: infer_admm_plain(*args, **kw), reps=2)
            flops = k3_flops(got[3], R, m, N)
            bnd = bound(nbytes(*args[:7], args[7], *got[:2]) + 8 * lanes,
                        flops)
            print(f"[2 K3 fused_infer_admm] lanes {lanes} r {R} 16x16 m {m} "
                  f"scale_by_row {sbr} {K3_TRIPS} trips (warm state, mu0 "
                  f"{K3_MU0}): max rel err {rel:.3e} (tol {K3_RTOL}), max "
                  f"abs err {err:.3e} | kernel {ms:.4f} ms | plain "
                  f"{plain:.4f} ms | bound {bnd['bound_ms']:.4f} ms "
                  f"({bnd['bound_by']})", flush=True)
            out[(m, sbr)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                 **bnd, library_ms=None)
    return out[(M_TRAIN, True)]


def phase2_k4():
    """K4 against its plain version (TF32 off) at K4_SHAPES, with the
    times of K4, the plain version and one complex64 ``torch.matmul`` on
    tensors built beforehand, beside the bound: 6 M N K G flops at the
    float32 rate against each operand read and the output written once."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    with no_tf32():
        for g, m, k, n in K4_SHAPES:
            a, b = (Pair(*(torch.randn(g, rows, cols, generator=gen,
                                       device="cuda") for _ in range(2)))
                    for rows, cols in ((m, k), (k, n)))
            got = pair_matmul(a, b)
            want = pair_matmul_plain(a, b)
            torch.cuda.synchronize()
            rel = max(float((x - w).abs().max() / w.abs().max())
                      for x, w in zip(got, want))
            if not rel <= K4_RTOL:
                raise RuntimeError(f"K4 disagrees with its plain version at "
                                   f"{(g, m, k, n)}: {rel:.3e} > {K4_RTOL}")
            ac, bc = torch.complex(*a), torch.complex(*b)
            ms = cuda_ms(lambda: pair_matmul(a, b))
            plain = cuda_ms(lambda: pair_matmul_plain(a, b))
            lib = cuda_ms(lambda: torch.matmul(ac, bc))
            bnd = bound(nbytes(a, b, got), 6 * g * m * k * n)
            print(f"[2 K4 pair_matmul] ({g}, {m}, {k}) @ ({g}, {k}, {n}): "
                  f"max rel err {rel:.3e} (tol {K4_RTOL}) | kernel {ms:.4f} "
                  f"ms | plain {plain:.4f} ms | complex64 torch.matmul "
                  f"{lib:.4f} ms | bound {bnd['bound_ms']:.4f} ms "
                  f"({bnd['bound_by']})", flush=True)
            out[(g, m, k, n)] = dict(
                max_abs_err=max_err(got, want), ms=ms, plain_ms=plain, **bnd,
                library_ms=lib)
    return out[K4_SHAPES[0]]


def build_solve_problem(seed=1, batch=SOLVE_BATCH, m=M):
    """bench.py's solve workload, rebuilt with numpy: ``batch`` two-path
    16x16 channels through one shared 2-bit random codebook."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 4, (m, N))
    a = np.exp(1j * bits * (np.pi / 2)) / np.sqrt(N)

    def steer(nn, ang):
        return np.exp(1j * np.pi * np.arange(nn) * np.sin(ang)) / np.sqrt(nn)

    xs, bs = [], []
    for _ in range(batch):
        angs = rng.uniform(-1.2, 1.2, 4)
        h = sum((rng.normal() + 1j * rng.normal())
                * np.outer(steer(NR, angs[2 * i]),
                           steer(NT, angs[2 * i + 1]).conj())
                for i in range(2))
        x = h.T.reshape(-1)
        xs.append(x)
        bs.append(np.abs(a @ x))
    return a, np.stack(bs), np.stack(xs)


def phase3_slice():
    a, b, x_true = build_solve_problem()
    ap = interop.pair_from_numpy(a, None, device="cuda")
    bt = torch.as_tensor(b, dtype=torch.float32, device="cuda")
    cfg = AdmmConfig(maxiter=500, warm_iters=80, stage1_maxiter=120,
                     stage2_maxiter=160)

    def solve():
        return solve_lowrank_multi_pair_batch(
            torch.Generator().manual_seed(0), ap, bt, NT, NR, cfg)

    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    res = solve()
    stop.record()
    torch.cuda.synchronize()
    launches = launch_counts()
    secs = start.elapsed_time(stop) / 1e3

    if res.x.re.device.type != "cuda":
        raise RuntimeError(f"result lies on {res.x.re.device}, not cuda")
    if tuple(res.x.re.shape) != (SOLVE_BATCH, N):
        raise RuntimeError(f"result shape {tuple(res.x.re.shape)}")
    x = (res.x.re.double() + 1j * res.x.im.double()).cpu()
    if not bool(torch.isfinite(x.real).all() & torch.isfinite(x.imag).all()):
        raise RuntimeError("non-finite recovery")
    nmse_db = 10 * torch.log10(torch.clamp(nmse_h_projection(
        x, torch.as_tensor(x_true)), min=1e-30))
    med = float(nmse_db.median())
    qmin = float(res.quality.min())
    iters = int(res.iters.sum())
    print(f"[3 slice] solve_lowrank_multi_pair_batch 16x16 m {M} batch "
          f"{SOLVE_BATCH} r {R}: {secs:.4f} s timed (warm-up {warm_s:.2f} s) "
          f"| {SOLVE_BATCH / secs:.2f} rec/s | {iters} iters, "
          f"{iters / secs:.1f} iter/s | median NMSE {med:.2f} dB | worst "
          f"{float(nmse_db.max()):.2f} dB | min quality {qmin:.6f} | "
          f"launches {launches}", flush=True)
    if med > -60.0:
        raise RuntimeError(f"median NMSE {med:.2f} dB above -60 dB")
    if qmin < 0.98:
        raise RuntimeError(f"min quality {qmin:.4f} below 0.98")
    require_launched(launches, ("fused_prox_dual_t", "fused_zprox_t",
                                "pair_matmul"), "the batch solve")
    return launches


def nmse_db(x, x_true):
    """Projection-invariant NMSE in dB of a (n,) pair against x_true."""
    xe = (x.re.double() + 1j * x.im.double()).cpu()
    err = nmse_h_projection(xe, torch.as_tensor(x_true))
    return float(10 * torch.log10(torch.clamp(err, min=1e-30)))


def require_launched(counts, names, path):
    for name in names:
        if counts[name] <= 0:
            raise RuntimeError(f"{name} was never launched by {path}")


def profile_call(label, fn):
    """One call of ``fn`` under torch.profiler: device time by kernel
    against the call's wall time, from the device's own events
    (:func:`device_events`); recording the host's ops of a many-trip
    solve costs minutes of post-processing.  Returns ``fn()``'s result."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    total = sum(ms for ms, _ in events.values())
    if total <= 0:
        print(f"{label} device time not measured (the profiler saw no "
              "CUDA kernels)", flush=True)
        return out
    top = sorted(events.items(), key=lambda kv: -kv[1][0])[:6]
    parts = " | ".join(f"{name[:40]} {ms:.2f} ms x{count}"
                       for name, (ms, count) in top)
    print(f"{label} under the profiler: wall {wall_ms:.2f} ms, device busy "
          f"{total:.2f} ms ({100 * total / wall_ms:.1f}%) | {parts}",
          flush=True)
    return out


def single_workload():
    """bench.py's single-latency workload (bench.py:288-298), rebuilt with
    numpy: seed 3, one 2-bit 16x16 codebook with m = 1024 and a random
    complex x; beside it a two-path channel through the same codebook.
    Returns ``(a, {name: x})``."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 4, (M, N))
    a = np.exp(1j * bits * (np.pi / 2)) / np.sqrt(N)
    x_rand = (rng.standard_normal(N) + 1j * rng.standard_normal(N)) / np.sqrt(2)
    x_two = build_solve_problem(seed=3, batch=1)[2][0]
    return a, {"random x": x_rand, "two-path x": x_two}


def phase4_single():
    """The single-latency workload at the cold AdmmConfig(maxiter=500):
    ten timed solves of bench.py's random complex x, then of a two-path
    channel through the same codebook, then one anchored refine."""
    a, workloads = single_workload()
    ap = interop.pair_from_numpy(a, None)
    cfg = AdmmConfig(maxiter=500)
    results = {}
    k3_launches = 0
    for name, x_true in workloads.items():
        bt = torch.as_tensor(np.abs(a @ x_true), dtype=torch.float32,
                             device="cuda")

        def solve(i, bt=bt):
            return solve_lowrank_multi_pair(torch.Generator().manual_seed(i),
                                            ap, bt, NT, NR, cfg)

        solve(0)                                        # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        ms, nmse, qual, iters = [], [], [], []
        for i in range(1, SINGLE_REPS + 1):
            t0 = time.perf_counter()
            res = solve(i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if res.x.re.device.type != "cuda" or tuple(res.x.re.shape) != (N,):
                raise RuntimeError(f"result {tuple(res.x.re.shape)} on "
                                   f"{res.x.re.device}")
            if not bool(torch.isfinite(res.x.re).all()
                        & torch.isfinite(res.x.im).all()):
                raise RuntimeError("non-finite recovery")
            nmse.append(nmse_db(res.x, x_true))
            qual.append(float(res.quality))
            iters.append(int(res.iters))
        counts = launch_counts()
        k3_launches += counts["fused_infer_admm"]
        print(f"[4 single] solve_lowrank_multi_pair 16x16 m {M} r {R} "
              f"{name}: median {np.median(ms):.2f} ms (range {min(ms):.2f}-"
              f"{max(ms):.2f}) over {SINGLE_REPS} solves | iters median "
              f"{int(np.median(iters))} (range {min(iters)}-{max(iters)}) | "
              f"NMSE median {np.median(nmse):.2f} dB (range "
              f"{min(nmse):.2f} to {max(nmse):.2f}) | quality min "
              f"{min(qual):.6f} median {np.median(qual):.6f} | K3 launches "
              f"{counts['fused_infer_admm']} ({counts})", flush=True)
        results[name] = dict(nmse=float(np.median(nmse)), qmin=min(qual),
                             res=res, bt=bt, x_true=x_true, solve=solve)
    profile_call("[4 profile] two-path solve",
                 lambda: results["two-path x"]["solve"](SINGLE_REPS + 1))

    # bench.py's random x is full-rank, which the spectral-profile ladder
    # does not model: the JAX package's own solver stops near -14 dB at
    # quality 0.8 on it (tests/jax_single_reference.py).  Hold the port to
    # that class there, and to the -60 dB / 0.98 bar on the two-path
    # channel the solver is built for.
    rand, two = results["random x"], results["two-path x"]
    if rand["nmse"] > -10.0 or rand["qmin"] < 0.7:
        raise RuntimeError(f"random x: median NMSE {rand['nmse']:.2f} dB, "
                           f"min quality {rand['qmin']:.4f} (need <= -10 dB, "
                           ">= 0.7)")
    if two["nmse"] > -60.0:
        raise RuntimeError(f"two-path x: median NMSE {two['nmse']:.2f} dB "
                           "above -60 dB")
    if two["qmin"] < 0.98:
        raise RuntimeError(f"two-path x: min quality {two['qmin']:.4f} "
                           "below 0.98")
    require_launched({"fused_infer_admm": k3_launches},
                     ("fused_infer_admm",), "the single-recovery path")

    # the anchored refine, seeded by the two-path result: the per-op loop
    reset_launch_counts()
    t0 = time.perf_counter()
    ref = refine_lowrank_pair(ap, two["bt"], two["res"].x, NT, NR, cfg,
                              anchor_weight=0.5)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    ref_db = nmse_db(ref.x, two["x_true"])
    print(f"[4 refine] refine_lowrank_pair anchor_weight 0.5 from the "
          f"two-path result: {ref_ms:.2f} ms | iters {int(ref.iters)} | "
          f"NMSE {ref_db:.2f} dB | quality {float(ref.quality):.6f} | "
          f"launches {counts}", flush=True)
    require_launched(counts, ("fused_prox_dual_t", "fused_zprox_t",
                              "pair_matmul"), "the anchored refine")
    if ref_db > -60.0 or float(ref.quality) < 0.98:
        raise RuntimeError(f"anchored refine: NMSE {ref_db:.2f} dB, quality "
                           f"{float(ref.quality):.4f}")
    return {"fused_infer_admm": k3_launches, **{
        k: v for k, v in counts.items() if k != "fused_infer_admm"}}


MOB_WINDOWS = 40
MOB_JUMP_AT = 20
MOB_RX_SECTORS = MOB_TX_SECTORS = 8
MOB_RX_CB = 64


def mobility_workload(n_windows=MOB_WINDOWS, jump_at=MOB_JUMP_AT):
    """scripts/bench_mobility_r05.py's workload (``build_workload``,
    :49-112), rebuilt with numpy from the same seed: 16x16, windows of
    8 Rx x 8 Tx kron probes, a rank-1 LOS channel drifting 0.1 deg a
    window with a 25 deg Rx jump at window 20.  Two probe streams from the
    same kron cross product: the sector stream (the Rx set rotates
    through a fixed 64-entry codebook, 7/8 of it shared by consecutive
    windows) and the fresh-pair stream (an independent (w, f) pair per
    probe).  Returns ``(rows, amps, rows_fresh, amps_fresh, vhs, ats,
    p)``."""
    rng = np.random.default_rng(0)
    p = MOB_RX_SECTORS * MOB_TX_SECTORS

    def steer(nn, ang):
        return np.exp(1j * np.pi * np.arange(nn) * np.sin(ang)) / np.sqrt(nn)

    def chan(a_rx, a_tx):
        return np.outer(steer(NR, a_rx), steer(NT, a_tx).conj()).T.reshape(-1)

    def beam(nn):
        return np.exp(1j * rng.integers(0, 4, nn) * (np.pi / 2)) / np.sqrt(nn)

    rx_cb = np.exp(1j * rng.integers(0, 4, (MOB_RX_CB, NR))
                   * (np.pi / 2)) / np.sqrt(NR)
    rows = []
    for t in range(n_windows):
        for j in range(MOB_RX_SECTORS):
            w = rx_cb[(t + j) % MOB_RX_CB]
            for _ in range(MOB_TX_SECTORS):
                rows.append(np.kron(beam(NT), w))
    rows = np.stack(rows).astype(np.complex64)
    rows_fresh = []
    for _ in range(n_windows * p):
        w = beam(NR)
        rows_fresh.append(np.kron(beam(NT), w))
    rows_fresh = np.stack(rows_fresh).astype(np.complex64)

    g = 1.5 * np.exp(1j * 0.3)
    a_rx, a_tx = 0.4, -0.7
    amps = np.zeros(n_windows * p, np.float32)
    amps_fresh = np.zeros(n_windows * p, np.float32)
    vhs, ats = [], []
    for t in range(n_windows):
        drx = 0.1 * t * np.pi / 180 + (25 * np.pi / 180 if t >= jump_at else 0)
        dtx = -0.1 * t * np.pi / 180
        vh = g * chan(a_rx + drx, a_tx + dtx)
        vhs.append(vh)
        ats.append(steer(NT, a_tx + dtx))
        amps[t * p:(t + 1) * p] = np.abs(rows[t * p:(t + 1) * p] @ vh)
        amps_fresh[t * p:(t + 1) * p] = np.abs(
            rows_fresh[t * p:(t + 1) * p] @ vh)
    return rows, amps, rows_fresh, amps_fresh, np.stack(vhs), np.stack(ats), p


class TimedSolver:
    """A tracking solver that records each window's host-clock ms (ending
    in ``torch.cuda.synchronize()``) and its last call, so that call can
    be replayed under the profiler from the same warm state."""

    def __init__(self, solver):
        self.solver = solver
        self.cc_frac = solver.cc_frac
        self.takes_ladder_m = True
        self.ms = []
        self.last = None

    def __call__(self, gen, a, b, ladder_m=None):
        kw = {} if ladder_m is None else {"ladder_m": ladder_m}
        state = getattr(self.solver, "state", None)
        self.last = (gen.initial_seed(), a, b, kw,
                     None if state is None else state["x"])
        t0 = time.perf_counter()
        x = self.solver(gen, a, b, **kw)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return x

    def replay(self):
        seed, a, b, kw, x_prev = self.last
        if x_prev is not None:
            self.solver.state["x"] = x_prev
        return self.solver(torch.Generator().manual_seed(seed), a, b, **kw)


def tracked_nmse_db(estimates, vhs):
    """bench_mobility_r05.py's gauge-invariant tracked NMSE (:132-137):
    the estimate's best complex scaling against the window's channel."""
    out = []
    for x, vh in zip(estimates, vhs):
        c = np.vdot(x, vh) / max(np.vdot(x, x).real, 1e-30)
        out.append(10 * np.log10(max(
            np.linalg.norm(vh - c * x) ** 2 / np.linalg.norm(vh) ** 2,
            1e-30)))
    return np.asarray(out)


def run_tracker(name, solver, rows, amps, vhs, p, mob):
    """One warm-up track over two windows, a reset, then the timed track
    over every window (bench_mobility_r05.py's ``run_tracker``)."""
    cfg = ArrayConfig(nt=NT, nr=NR)
    timed = TimedSolver(solver)
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    mobility.track(gen, rows[:2 * p], amps[:2 * p], cfg, mob, solver=timed)
    warm_s = time.perf_counter() - t0
    if hasattr(solver, "reset"):
        solver.reset()
    timed.ms.clear()
    reset_launch_counts()
    t0 = time.perf_counter()
    trace = mobility.track(gen, rows, amps, cfg, mob, solver=timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()

    if not np.isfinite(trace.estimates).all():
        raise RuntimeError(f"{name}: non-finite estimate")
    n_windows = len(vhs)
    db = tracked_nmse_db(trace.estimates, vhs)
    budgets = trace.probe_budget
    out = dict(first=float(np.median(db[1:n_windows // 4])),
               last=float(np.median(db[-n_windows // 4:])),
               reset=bool((budgets[2:] == 0).any()),
               growth=bool((budgets[2:] > 0).any()), counts=counts, db=db,
               wps=n_windows / wall, ms=float(np.median(timed.ms)))
    print(f"[5 track] {name}: {n_windows / wall:.2f} windows/s | median "
          f"{np.median(timed.ms):.2f} ms per window (range "
          f"{min(timed.ms):.2f}-{max(timed.ms):.2f}; warm-up "
          f"{warm_s:.2f} s) | tracked NMSE median first quarter "
          f"{out['first']:.2f} dB, last quarter {out['last']:.2f} dB | "
          f"reset branch {out['reset']}, growth branch {out['growth']} | "
          f"launches {counts}", flush=True)
    profile_call(f"[5 profile] {name}, last window", timed.replay)
    return out


def phase5_mobility():
    """The four trackers of bench_mobility_r05.py (:164-197), then one
    10-window ``track_simulated`` on a ``brownian_trace``."""
    rows, amps, rows_fresh, amps_fresh, vhs, _, p = mobility_workload()
    cfg = ArrayConfig(nt=NT, nr=NR)
    admm = AdmmConfig(maxiter=500)
    mob = mobility.MobilityConfig(window_probes=p, max_window=80, admm=admm)
    mob_ext = mobility.MobilityConfig(window_probes=p, max_window=256,
                                      admm=admm)
    runs = {
        "cold_resolve_ref_semantics": run_tracker(
            "cold_resolve_ref_semantics",
            mobility.make_pair_solver(cfg, admm), rows, amps, vhs, p, mob),
        "warm_anchored_rank1": run_tracker(
            "warm_anchored_rank1",
            mobility.make_warm_pair_solver(cfg, admm, use_rank_one=True),
            rows, amps, vhs, p, mob),
        "warm_anchored_rank1_freshpairs_window256": run_tracker(
            "warm_anchored_rank1_freshpairs_window256",
            mobility.make_warm_pair_solver(cfg, admm, use_rank_one=True),
            rows_fresh, amps_fresh, vhs, p, mob_ext),
        "cold_freshpairs_window256": run_tracker(
            "cold_freshpairs_window256",
            mobility.make_pair_solver(cfg, admm), rows_fresh, amps_fresh,
            vhs, p, mob_ext),
    }
    for name, run in runs.items():
        kernel = "pair_matmul" if name.startswith("warm") else \
            "fused_infer_admm"
        require_launched(run["counts"], (kernel,), f"the {name} tracker")
    cold_fresh = runs["cold_freshpairs_window256"]
    if cold_fresh["last"] > -10.0:
        raise RuntimeError(f"cold fresh-pair tracker: last-quarter median "
                           f"{cold_fresh['last']:.2f} dB above -10 dB")
    cold_sector = runs["cold_resolve_ref_semantics"]
    if not (cold_sector["reset"] and cold_sector["growth"]):
        raise RuntimeError("cold sector tracker: the reset and the growth "
                           "branch did not both fire")

    smob = mobility.SimulatedMobilityConfig()
    gen = torch.Generator().manual_seed(1)
    cb, rss, vec_h = mobility.brownian_trace(gen, cfg, smob, n_windows=10)
    reset_launch_counts()
    t0 = time.perf_counter()
    trace = mobility.track_simulated(gen, cb, rss, cfg, smob,
                                     solver=mobility.make_pair_solver(
                                         cfg, smob.admm))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if not np.isfinite(trace.estimates).all():
        raise RuntimeError("track_simulated: non-finite estimate")
    db = tracked_nmse_db(trace.estimates, vec_h.cpu().numpy())
    print(f"[5 track_simulated] brownian_trace {NT}x{NR}, 10 windows of "
          f"{smob.window_probes} probes, make_pair_solver: "
          f"{10 / wall:.2f} windows/s | tracked "
          f"NMSE median {np.median(db):.2f} dB (range {db.min():.2f} to "
          f"{db.max():.2f}) | budgets {trace.probe_budget.tolist()} | "
          f"launches {counts}", flush=True)
    require_launched(counts, ("fused_infer_admm",), "track_simulated")
    totals = {}
    for c in [run["counts"] for run in runs.values()] + [counts]:
        for k, v in c.items():
            totals[k] = totals.get(k, 0) + v
    return totals, cold_sector


def campaign_workload(device="cuda"):
    """Phase 6's testbed inputs, as ``pipeline/testbed.py``
    (``run_random_campaign``) builds its random campaign: a 16x16 2-bit
    Tx codebook of 64 rounds x 62 sectors and a 64-entry Rx codebook,
    kron'd sector-major (``interleave=True``) into 3968 probe rows; a
    3-path ``generate_channel`` scaled by CHANNEL_SCALE; its RSS in dBm
    from ``SyntheticProvider`` at its defaults (0.5 dB jitter, 10 dumps,
    RSSI quantization) and without jitter or quantization.  Every draw is
    made on the CPU from CAMPAIGN_SEED, so ``device="cpu"`` gives the
    same inputs.  Returns ``(cb, x_true, rss_dbm, rss_dbm_noiseless)``."""
    cfg = ArrayConfig(nt=NT, nr=NR)
    n_paths = recovery.CampaignConfig().n_paths
    g = torch.Generator().manual_seed(CAMPAIGN_SEED)
    rounds, sectors = CAMPAIGN_ROUNDS, CAMPAIGN_SECTORS
    tx = random_codebook(fold_in(g, 0), rounds * sectors, NT, device=device)
    rx = random_codebook(fold_in(g, 1), rounds, NR, device=device)
    cb = kron_probe_rows(tx.rows().reshape(rounds, sectors, NT), rx.rows(),
                         interleave=True)
    ch = generate_channel(fold_in(g, 2), cfg, ChannelConfig(n_paths=n_paths),
                          device=device)
    x_true = ch.vec_h[0] * CHANNEL_SCALE
    rss = SyntheticProvider(vec_h=x_true, generator=fold_in(g, 3)).measure(cb)
    clean = SyntheticProvider(vec_h=x_true, noise_dbm_std=0.0,
                              quantize_rssi=False).measure(cb)
    return cb, x_true, rss, clean


def proj_nmse_db(x_est, x_true):
    """Projection-invariant NMSE in dB of complex (n,) estimates."""
    err = nmse_h_projection(torch.as_tensor(np.asarray(x_est)),
                            torch.as_tensor(np.asarray(x_true)))
    return float(10 * torch.log10(torch.clamp(err, min=1e-30)))


def campaign_estimate(out, i):
    return out.h_amp[i, 0] * np.exp(1j * out.h_angle[i, 0])


class SolveProbe:
    """Records each ``dispatch.admm_v2`` solve of a campaign while it is
    entered: host-clock seconds (ending in ``torch.cuda.synchronize()``),
    the trips ``infer_admm`` ran, K5's launches and the quality."""

    def __enter__(self):
        self.calls = []
        self.inner = dispatch.admm_v2
        dispatch.admm_v2 = self
        return self

    def __exit__(self, *exc):
        dispatch.admm_v2 = self.inner

    def __call__(self, *args, **kwargs):
        trips, k5 = admm.infer_admm.trips, fused_prox_dual.launches
        t0 = time.perf_counter()
        res = self.inner(*args, **kwargs)
        torch.cuda.synchronize()
        self.calls.append(dict(
            s=time.perf_counter() - t0, trips=admm.infer_admm.trips - trips,
            k5=fused_prox_dual.launches - k5, quality=float(res.quality)))
        return res


def run_campaign(label, fn):
    """``fn()`` with the launch counts and trips set to 0 just before it and
    read just after, under a SolveProbe; fails unless K5 was launched."""
    reset_launch_counts()
    admm.infer_admm.trips = 0
    with SolveProbe() as probe:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    require_launched(counts, ("fused_prox_dual",), label)
    return out, probe.calls, wall, counts


def phase6_campaign(cold_k3):
    """The testbed recovery campaign on the card (see campaign_workload),
    at the default CampaignConfig (16x16, AdmmConfig maxiter 500, three
    restarts)."""
    cb, x_true, rss, clean = campaign_workload()
    x_np = x_true.cpu().numpy()
    cc = recovery.CampaignConfig(array=ArrayConfig(nt=NT, nr=NR))
    grid = probe_budget_grid(NT, NR)
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    out, calls, wall, counts = run_campaign(
        "recover_a2only", lambda: recovery.recover_a2only(cb, rss, cc=cc))
    add(counts)
    if len(calls) != len(grid):
        raise RuntimeError(f"recover_a2only ran {len(calls)} solves for "
                           f"{len(grid)} grid points")
    for i, (m_cur, call) in enumerate(zip(grid, calls)):
        db = proj_nmse_db(campaign_estimate(out, i), x_np)
        if not np.isfinite(out.h_amp[i]).all() or call["k5"] <= 0:
            raise RuntimeError(f"recover_a2only M {m_cur}: non-finite "
                               f"estimate or no K5 launch")
        print(f"[6 a2only] M {m_cur}: {call['s']:.3f} s | trips "
              f"{call['trips']} | K5 launches {call['k5']} | quality "
              f"{call['quality']:.6f} | NMSE {db:.2f} dB", flush=True)
    print(f"[6 a2only] recover_a2only {NT}x{NR}, {CAMPAIGN_ROUNDS * CAMPAIGN_SECTORS}"
          f" probe rows, grid {grid}: {wall:.2f} s | trips "
          f"{admm.infer_admm.trips} | launches {counts}", flush=True)

    out, calls, wall, counts = run_campaign(
        "the noiseless campaign", lambda: recovery.recover_campaign(
            cb, clean, MethodFlags(), cc, m_grid=(M,)))
    add(counts)
    db = proj_nmse_db(campaign_estimate(out, 0), x_np)
    q = calls[0]["quality"]
    print(f"[6 noiseless] recover_a2only M {M}, no jitter or quantization: "
          f"{wall:.3f} s | trips {calls[0]['trips']} | K5 launches "
          f"{calls[0]['k5']} | quality {q:.6f} | NMSE {db:.2f} dB", flush=True)
    if not (db <= -60.0 and q >= 0.98):
        raise RuntimeError(f"noiseless M {M}: NMSE {db:.2f} dB, quality "
                           f"{q:.4f} (need <= -60 dB, >= 0.98)")

    out, calls, wall, counts = run_campaign(
        "recover_a2nuclear", lambda: recovery.recover_campaign(
            cb, rss, MethodFlags(), cc, m_grid=(M,), nuclear=True))
    add(counts)
    print(f"[6 a2nuclear] recover_a2nuclear M {M}: {wall:.3f} s | trips "
          f"{calls[0]['trips']} | K5 launches {calls[0]['k5']} | quality "
          f"{calls[0]['quality']:.6f} | NMSE "
          f"{proj_nmse_db(campaign_estimate(out, 0), x_np):.2f} dB",
          flush=True)

    (out, quals), _, wall, counts = run_campaign(
        "recover_warm_sweep",
        lambda: recovery.recover_warm_sweep(cb, rss, cc=cc))
    add(counts)
    dbs = [round(proj_nmse_db(campaign_estimate(out, i), x_np), 2)
           for i in range(len(grid))]
    print(f"[6 warm sweep] recover_warm_sweep over {grid}: {wall:.2f} s | "
          f"trips {admm.infer_admm.trips} | NMSE dB {dbs} | quality "
          f"{[round(q, 6) for q in quals]} | launches {counts}", flush=True)

    rows, amps, _, _, vhs, _, p = mobility_workload()
    rows, amps, vhs = (rows[:TRACK_WINDOWS * p], amps[:TRACK_WINDOWS * p],
                       vhs[:TRACK_WINDOWS])
    mob = mobility.MobilityConfig(window_probes=p, max_window=80,
                                  admm=AdmmConfig(maxiter=500))
    trace, _, wall, counts = run_campaign(
        "track(solver=None)", lambda: mobility.track(
            torch.Generator().manual_seed(0), rows, amps,
            ArrayConfig(nt=NT, nr=NR), mob))
    add(counts)
    if not np.isfinite(trace.estimates).all():
        raise RuntimeError("track(solver=None): non-finite estimate")
    db = tracked_nmse_db(trace.estimates, vhs)
    print(f"[6 track] track(solver=None), the complex A2 solver, on phase "
          f"5's sector stream, {TRACK_WINDOWS} windows of {p} probes, "
          f"max_window 80: {TRACK_WINDOWS / wall:.2f} windows/s, "
          f"{1e3 * wall / TRACK_WINDOWS:.1f} ms per window | tracked NMSE "
          f"median {np.median(db[1:]):.2f} dB (windows 1-9) | budgets "
          f"{trace.probe_budget.tolist()} | launches {counts} || phase 5's "
          f"K3 cold tracker: {cold_k3['wps']:.2f} windows/s, median "
          f"{cold_k3['ms']:.1f} ms per window, tracked NMSE median "
          f"{np.median(cold_k3['db'][1:TRACK_WINDOWS]):.2f} dB (windows "
          f"1-9)", flush=True)

    a = cb[:M]
    b = dbm_to_amplitude(torch.as_tensor(rss[:M], device=a.device),
                         cc.rss_fct)
    _, _, _, counts = run_campaign("the profiled solve", lambda: profile_call(
        f"[6 profile] solve_lowrank_multi M {M}",
        lambda: admm.solve_lowrank_multi(torch.Generator().manual_seed(0), a,
                                         b, NT, NR, cc.admm)))
    add(counts)
    return totals


def vsm_config(trials, impl="pair", methods=("admm_lowrank_v4", "phaselift",
                                            "plomp", "plgamp")):
    """The headline Vs_M configuration (as the JAX CLI's vs-m builds it,
    twoace_tpu/cli.py:74-88)."""
    return simulation.SimulationConfig(
        array=ArrayConfig(nt=NT, nr=NR),
        channel=ChannelConfig(n_paths=3, rician_k=0), snr_db=20.0,
        beam_method="Random_Phase_State",
        methods=MethodFlags(**{m: True for m in methods}),
        admm=AdmmConfig(maxiter=500, n_restarts=RESTARTS), n_trials=trials,
        impl=impl)


def run_sweep(label, fn, need):
    """``fn()`` (a sweep) with the launch counts set to 0 just before it
    and read just after; fails unless every kernel in ``need`` was
    launched.  Returns the result, the wall seconds and the counts."""
    reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    require_launched(counts, need, label)
    for name, curve in res.nmse.items():
        if not np.all(np.isfinite(curve)) or not np.all(curve > 0):
            raise RuntimeError(f"{label}: {name} NMSE {curve} is not finite "
                               f"and positive")
    return res, wall, counts


def print_cells(tag, res):
    """Each point's host seconds (the cell and each method group, as the
    sweep records them) and two-stage compression sizes."""
    for i, point in enumerate(res.grid.tolist()):
        times = " | ".join(f"{k} {v[i]:.2f} s" for k, v in res.seconds.items())
        print(f"{tag} {point}: {times} | mCS {res.mcs[i].tolist()}",
              flush=True)


def phase7_vsm():
    """The headline Vs_M campaign (VSM_r05.json's configuration) at full
    width through ``sweep_measurements`` with A2 on the pair path (K3),
    each curve beside VSM_r05's; then one complex-family A2 cell (K5), one
    Vs_SNR point beside VSSNR_r05's, and one profiled M 1024 cell."""
    with open(VSM_REF) as f:
        ref = json.load(f)
    grid = list(probe_budget_grid(NT, NR))
    if grid != ref["m_grid"]:
        raise RuntimeError(f"grid {grid} differs from VSM_r05's {ref['m_grid']}")
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    res, wall, counts = run_sweep(
        "the Vs_M sweep", lambda: simulation.sweep_measurements(
            torch.Generator().manual_seed(VSM_SEED), grid,
            vsm_config(VSM_TRIALS), VSM_AREA), ("fused_infer_admm",))
    add(counts)
    print_cells("[7 vsm] M", res)
    db = {k: 10 * np.log10(v) for k, v in res.nmse.items()}
    if sorted(db) != sorted(ref["nmse_db"]):
        raise RuntimeError(f"curves {sorted(db)} vs VSM_r05's "
                           f"{sorted(ref['nmse_db'])}")
    failures = []
    for name in ref["nmse_db"]:
        want = np.asarray(ref["nmse_db"][name])
        print(f"[7 vsm] {name}: NMSE dB {np.round(db[name], 2).tolist()} | "
              f"VSM_r05 {want.tolist()} | per-trial std dB "
              f"{np.round(np.std(10 * np.log10(res.nmse_trials[name]), axis=1), 2).tolist()}"
              f" | AoD/AoA err deg {np.round(res.aoda_err[name], 2).tolist()}",
              flush=True)
        for i, m in enumerate(grid):
            if m >= VSM_CHECK_FROM and abs(db[name][i] - want[i]) > VSM_TOL_DB:
                failures.append(f"{name} at M {m}: {db[name][i]:.2f} dB vs "
                                f"VSM_r05 {want[i]:.2f}")
    for m in VSM_A2_WINS:
        i = grid.index(m)
        if not db["admm_lowrank_v4"][i] < db["plomp"][i]:
            failures.append(f"A2 {db['admm_lowrank_v4'][i]:.2f} dB does not "
                            f"beat PLOMP {db['plomp'][i]:.2f} at M {m}")
    print(f"[7 vsm] sweep_measurements {NT}x{NR}, {VSM_TRIALS} trials, "
          f"impl pair: {wall:.1f} s | launches {counts}", flush=True)
    if failures:
        raise RuntimeError("Vs_M checks failed: " + "; ".join(failures))

    res, wall, counts = run_sweep(
        "the complex-family cell", lambda: simulation.sweep_measurements(
            torch.Generator().manual_seed(VSM_SEED + 1), [M],
            vsm_config(VSM_SIDE_TRIALS, impl="complex",
                       methods=("admm_lowrank_v4",)), VSM_AREA),
        ("fused_prox_dual",))
    add(counts)
    print_cells("[7 complex] M", res)
    print(f"[7 complex] impl complex, M {M}, {VSM_SIDE_TRIALS} trials: "
          f"{wall:.1f} s | NMSE dB "
          f"{ {k: round(float(10 * np.log10(v[0])), 2) for k, v in res.nmse.items()} }"
          f" | launches {counts}", flush=True)

    with open(VSSNR_REF) as f:
        ref_snr = json.load(f)
    j = ref_snr["snr_grid_db"].index(VSSNR_SNR)
    res, wall, counts = run_sweep(
        "the Vs_SNR point", lambda: simulation.sweep_snr(
            torch.Generator().manual_seed(VSM_SEED), [VSSNR_SNR], VSSNR_M,
            vsm_config(VSM_TRIALS, methods=("admm_lowrank_v4", "plomp",
                                            "plgamp")), VSM_AREA),
        ("fused_infer_admm",))
    add(counts)
    print_cells("[7 snr] SNR", res)
    print(f"[7 snr] sweep_snr M {VSSNR_M}, SNR {VSSNR_SNR}, {VSM_TRIALS} "
          f"trials: {wall:.1f} s | NMSE dB "
          + " | ".join(f"{k} {10 * np.log10(v[0]):.2f} (VSSNR_r05 "
                       f"{ref_snr['nmse_db'][k][j]})"
                       for k, v in res.nmse.items())
          + f" | launches {counts}", flush=True)

    reset_launch_counts()
    t0 = time.perf_counter()
    profile_call(f"[7 profile] sweep_measurements M {M}, "
                 f"{VSM_SIDE_TRIALS} trials, impl pair",
                 lambda: simulation.sweep_measurements(
                     torch.Generator().manual_seed(VSM_SEED + 2), [M],
                     vsm_config(VSM_SIDE_TRIALS), VSM_AREA))
    print(f"[7 profile] {time.perf_counter() - t0:.1f} s with the "
          "profiler's own cost", flush=True)
    counts = launch_counts()
    require_launched(counts, ("fused_infer_admm",), "the profiled cell")
    add(counts)
    return totals


def main():
    t0 = time.perf_counter()

    def done(phase):
        print(f"[time] phase {phase} done, {time.perf_counter() - t0:.1f} s "
              "since the start", flush=True)

    smi = phase0_device()
    phase1_build()
    summary = phase2_kernels()
    done(2)
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    add(phase_chain_bench())
    add(phase3_slice())
    add(phase4_single())
    done(4)
    counts5, cold_k3 = phase5_mobility()
    add(counts5)
    done(5)
    add(phase6_campaign(cold_k3))
    done(6)
    add(phase7_vsm())
    done(7)
    sources = {"fused_prox_dual_t": ("twoace_tpu_torch/csrc/prox_dual.cu",
                                     "twoace_tpu/ops/pallas/kernels.py:121"),
               "fused_zprox_t": ("twoace_tpu_torch/csrc/zprox.cu",
                                 "twoace_tpu/ops/pallas/kernels.py:339"),
               "fused_infer_admm": ("twoace_tpu_torch/csrc/infer_admm.cu",
                                    "twoace_tpu/ops/pallas/solver_kernel.py:431"),
               "pair_matmul": ("twoace_tpu_torch/csrc/pair_matmul.cu",
                               "twoace_tpu/ops/pallas/kernels.py:182"),
               "fused_prox_dual": ("twoace_tpu_torch/csrc/prox_dual_rows.cu",
                                   "twoace_tpu/ops/pallas/kernels.py:55"),
               "pair_chain_mm": ("twoace_tpu_torch/csrc/chain_mm.cu",
                                 "scripts/bench_pallas_mm.py:76")}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **summary[name])
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
