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
  6. the testbed campaign through the complex family (K5) on 3968 random
     probe rows: a noiseless M = 1024 point, ``recover_a2nuclear``,
     ``recover_warm_sweep``, ``track(solver=None)`` for TRACK_WINDOWS (5)
     windows and one profiled M = 1024 solve (its ``recover_a2only``
     grid runs in phase 9, through the testbed driver);
  7. the headline Vs_M campaign of VSM_r05.json: ``sweep_measurements``
     at 16x16 with A2 on the pair path (K3) against PhaseLift, PLOMP,
     PLGAMP and perfect/noisy-phase CS over VSM_r05's points from M 529,
     VSM_TRIALS (4) trials a point, each curve beside VSM_r05's (it
     fails if one is more than 3 dB off, or if A2 does not beat PLOMP
     at M = 784 and 1024); one
     complex-family A2 cell (K5), one ``sweep_snr`` point beside
     VSSNR_r05.json, one profiled cell;
  8. the paths of the VS_SR campaign, the trace and windowed simulations,
     the lifted testbed entries and the rest of the baselines:
     ``measurements_needed_vs_range`` at VSSR_r05.json's configuration
     (12x12, all seven ranges with the reference's (M, G) tables, A2 on
     the pair path, K3), each method's MAEE by range and budgets beside
     the artifact's (it fails if an MAEE is not finite, if the 70/80
     degree ranges do not beat the 20/30 degree ones, if a method's
     grand-mean MAEE is more than VSSR_TOL_DEG from the artifact's, or
     if A2's is more than VSSR_PAIRED_TOL_DEG from the same campaign's
     A2 on the CPU, run by a child process during phases 7 and 8);
     ``sweep_measurements_trace`` on two 16x16 3-path channel matrices
     (K3); ``infer_channel_windows`` on phase 6's probe rows (K5; each
     window's fit held, and a 1024-row window held against the CPU's);
     the PhaseLift campaign point at M 1024 and ``recover_directional``;
     one VS_SR cell with CPRL, PRGAMP and SparsePL, then one call of each
     new baseline on its first trial, held against the same call on the
     CPU in complex64 and complex128, and of the metrics and the sector
     sweep, held likewise;
  9. the testbed driver: the four sensing modes ported last at 16x16, M
     1024, batch 4, on the card and the CPU (the directional beams equal,
     Random_Beam_Bayes's C 4096 selection held by its A-criterion against
     the same selection on the CPU, run by a child process from phase 8
     on, and both below the initial design's); ``pick_beams``'
     ``Bayes_Beam`` over 40000 candidates, timed; ``TestbedRunner`` at
     TestbedConfig's defaults on phase 6's channel: the five campaigns,
     ``estimate("random", "a2only")`` over the probe-budget grid (K5 on
     every point; phase 6's rows), ``beamforming_comparison`` and
     ``evaluate_codebook_rss`` against the true channel's beams; a second
     runner resuming the random campaign from the checkpoints (no
     provider call, RSS bit-identical); four random rounds through
     ``TcpProvider`` and ``native/rss_server`` held to the noiseless RSS;
     ``python -m twoace_tpu_torch testbed`` in a subprocess (its NMSE
     below CLI_NMSE_DB) and again with CUDA hidden (it must fail); one
     Z-free ``infer_admm_pair`` (K4, K1, no K2) held against the CPU;
 10. the sharded paths (``twoace_tpu_torch.parallel``) on phase 3's
     problem, its first SHARDED_BATCH instances: (i) one rank over NCCL
     in this process, mesh (1, 1): ``solve_lowrank_multi_sharded_pair``
     (K4, K1, K2; no K3) held to phase 3's bars, then
     ``solve_lowrank_sharded`` on the complex twin (K5) on the first
     SHARDED_COMPLEX_BATCH, and ``scaling_benchmark()`` at its defaults
     (d = 1); (ii) two ranks sharing the card over gloo, spawned once,
     mesh (1, 2): the same two solves, held to (i); each with its
     seconds, loop trips, all-reduces a trip, NMSE and quality; then
     ``entry()``'s step against the CPU's, ``dryrun_multichip(1)``, and
     ``dryrun_multichip(2)``, which must raise on one card.

Between phases 2 and 3 the chain benchmark (``chain``), K6's own path,
runs ``scripts/torch_bench_pallas_mm.py``'s body.

Phase 2 holds K2 (the warm Z-prox) against its plain version at
K2_SHAPES: the batch solve's 192 lanes, the warm trackers' one lane, the
32x32 point of BENCH_full32_r05.json (W streamed through shared memory)
and a ragged 24-row shape, with the profiler's device time, the bounds
and the phase timer's split of a launch (``scripts/torch_k2_phases.py``).
It holds K3 (the loop kernel) against its plain version at the
single solve's m 972 and 1024, the cold tracker's m 80, Vs_M's m 3, the
trace sweep's m 529 and the VS_SR campaign's 12x12 m 196 and 4
(K3_CASES), with its 3xTF32 and FP32 bounds, the card's 16-CTA cluster
occupancy and the phase timer's split of one launch
(``scripts/torch_k3_phases.py``).  It also holds K4 (the per-op loop's
pair GEMM) against its plain version at the batch solver's, the anchored
refine's (one row: the warm trackers' m 80 and 256, phase 4's m 1024)
and a ragged shape for each
route, and both against the complex128 product (K4's error at most
K4_C128_FACTOR times the plain version's), with the route each shape
takes, the 3xTF32 and float32 bounds and K4's roofline share; and K5 at
the campaign's, the refine's, a tracker window's and the windowed
inference's shapes, a ragged m and complex128, and K6 at the chain
benchmark's batch and a ragged one, each with its host cost a call (2000 calls back to back) beside the
launch floor (the profiler's device time of a one-element elementwise
op).  Phase 2 also reads K1's, K2's, K4's, K5's and K6's (and complex64
``torch.matmul``'s, beside K4) device time a launch from the profiler
beside their CUDA-event times.  Phases 3, 4 and 5 print K4's launches
by route.  Each path (the batch solve, the single solves, the
refine, each tracker, each part of the campaign) is driven with the
launch counts set to 0 just before it and read just after, and fails if
a kernel it runs was never launched.

The last three lines are a JSON summary of the kernels, the nvidia-smi
line, and ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from twoace_tpu_torch import interop  # noqa: E402
from twoace_tpu_torch.config import (  # noqa: E402
    AdmmConfig, ArrayConfig, ChannelConfig, MethodFlags, probe_budget_grid)
from twoace_tpu_torch.entry import dryrun_multichip, entry  # noqa: E402
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
from twoace_tpu_torch.ops.kernels.pair_matmul import (  # noqa: E402
    route as k4_route)
from twoace_tpu_torch.ops.pair_solver import (  # noqa: E402
    no_tf32, refine_lowrank_pair, solve_lowrank_multi_pair,
    solve_lowrank_multi_pair_batch)
from twoace_tpu_torch.ops.prox import profile_ladder_arrays  # noqa: E402
from twoace_tpu_torch.parallel import (  # noqa: E402
    make_mesh, problem_sharding, scaling_benchmark, solve_lowrank_sharded,
    solve_lowrank_multi_sharded_pair, spawn_ranks)
from twoace_tpu_torch.parallel.distributed import free_port  # noqa: E402
from twoace_tpu_torch.pipeline import mobility, recovery, simulation  # noqa: E402
from twoace_tpu_torch.models.steering import angle_dictionary  # noqa: E402
from twoace_tpu_torch.pipeline.testbed import (  # noqa: E402
    TestbedConfig, TestbedRunner)
from twoace_tpu_torch.sensing.bayes_opt import a_criterion  # noqa: E402
from twoace_tpu_torch.sensing.codebooks import (  # noqa: E402
    kron_probe_rows, random_codebook, random_sensing_rows)
from twoace_tpu_torch.sensing.provider import SyntheticProvider  # noqa: E402
from twoace_tpu_torch.sensing.sensing_matrix import (  # noqa: E402
    generate_sensing_matrix, pick_beams)
from twoace_tpu_torch.utils.metrics import nmse_h_projection  # noqa: E402
from twoace_tpu_torch.utils.rng import fold_in  # noqa: E402
from twoace_tpu_torch.utils.units import (  # noqa: E402
    RSSI_OFFSET, RSSI_SLOPE, dbm_to_amplitude)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "scripts"))
from torch_kernel_common import (  # noqa: E402
    host_us, k5_inputs, launch_floor_ms)

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
#: K2's shapes (lanes, r, nt, nr): the batch solve's (64 channels x 3
#: restarts, r 20, 16x16), the warm rank-1 trackers' one lane at r 1, the
#: 32x32 point of BENCH_full32_r05.json (16 x 3 restarts, r 20: W is 160 KB
#: a lane, streamed through shared memory) and a ragged one (rows 24, not
#: a multiple of 16)
K2_SHAPES = ((LANES, R, NT, NR), (1, 1, NT, NR), (48, R, 32, 32),
             (3, 3, 8, 8))
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
#: K3's m in phase 2: the single solve's train split and full data, the
#: cold sector tracker's window (max_window 80) and Vs_M's M = 4 (train
#: split m 3: 13 of the 16 CTAs of a lane own no row)
K3_MS = (M_TRAIN, M, 80, 3)
#: K3's (nt = nr, m) cases: K3_MS at 16x16, the trace sweep's M 529, and
#: the VS_SR campaign's 12x12 array (4 of a lane's 16 CTAs own no column)
#: at its largest and smallest M, 196 and 4
K3_CASES = tuple((NT, m) for m in K3_MS) + ((NT, 529), (12, 196), (12, 4))
#: the m at 16x16, and the (nt = nr, m) cases, whose per-column pass is held
#: over K3_COLUMN_TRIPS trips.  From the warm state of ``k3_cases`` that pass
#: amplifies float32 rounding about 3x a trip at m 80: after K3_TRIPS trips,
#: float32 versions of the loop that differ only in their rounding (the plain
#: version, the plain version with 3xTF32 products, K3) stand 5e-4 to 9e-4 from
#: the same loop run in float64 at m 80, and all take another argmin column
#: than it at m 3 (``scripts/torch_k3_witness.py``, PERF.md).  The plain
#: version on the CPU stands 1.8e-2 from float64 at 16x16 m 529, 8.4e-5 at
#: 12x12 m 196 and 1.7 at 12x12 m 4 after K3_TRIPS trips
#: (``scripts/torch_rounding_spread.py k3``).  Over K3_COLUMN_TRIPS trips the
#: plain version stays within 2e-5 of the float64 run, and K3 is held at
#: K3_RTOL against both; after K3_TRIPS the three distances are printed, not
#: held.
K3_COLUMN_MS = (80, 3)
K3_COLUMN_CASES = (tuple((NT, m) for m in K3_COLUMN_MS)
                   + ((NT, 529), (12, 196), (12, 4)))
K3_COLUMN_TRIPS = 3
SINGLE_REPS = 10
#: K4 against its plain version: max |difference| over max |plain|.  The
#: two are no longer bit-identical: the tensor-core route's 3xTF32
#: products accumulate in the tensor cores' float32, in another order
#: than the plain version's FMA chain, and the split-K route sums K in
#: slices.
K4_RTOL = 1e-5
#: K4's error against the complex128 product (max |error| over max
#: |exact|) may be at most this many times the plain version's: the
#: margin for the tensor cores' float32 accumulation, which rounds
#: otherwise than an FMA chain
K4_C128_FACTOR = 3.0
#: K4's shapes, (G, M, K, N): the batch solver's three products (G = 3
#: restarts, M = 64 instances x r 20; the tensor-core route); the
#: anchored refine's, whose seed is one vector (G 1, M = r 1, n 256) at
#: the warm trackers' windows (m 80, 256) and phase 4's m 1024 (the
#: split-K route); and a ragged one for each route
K4_SHAPES = [(RESTARTS, SOLVE_BATCH * R, M_TRAIN, N),
             (RESTARTS, SOLVE_BATCH * R, N, N),
             (RESTARTS, SOLVE_BATCH * R, N, M_TRAIN),
             *dict.fromkeys((1, 1, k, n) for m in (80, 256, M)
                            for k, n in ((m, N), (N, N), (N, m))),
             (2, 70, 97, 51), (2, 3, 97, 51)]

#: K5 against its plain version: max |difference| over max |plain|.  The
#: two round every step alike except the order of the row sum.
K5_RTOL = {torch.complex64: 2e-6, torch.complex128: 1e-14}
#: K5's shapes (m, r, dtype, per_entry): the campaign's pass 1 and pass 2
#: at M 1024 (m = floor(0.95 M), r 20), the refine (m = M, r 1), a tracker
#: window (80, 20), a ragged m, complex128, and the windowed inference's
#: 200-row window (both passes on its 190-row train split, then the full
#: window); each with 9 padded (b = 0) rows and one all-zero row
K5_SHAPES = [(M_TRAIN, R, torch.complex64, False),
             (M_TRAIN, R, torch.complex64, True),
             (M, 1, torch.complex64, False),
             (80, R, torch.complex64, False),
             (97, 3, torch.complex64, True),
             (M_TRAIN, R, torch.complex128, False),
             (190, R, torch.complex64, False),
             (190, R, torch.complex64, True),
             (200, R, torch.complex64, False)]
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
#: windows of ``track(solver=None)``: cut from 10 to 5 for phase 10 (it
#: checks only that the estimates are finite); back to 10 once the
#: two-stage FISTA is faster (ROADMAP.md)
TRACK_WINDOWS = 5

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
#: trials per point: VSM_r05 ran 10; cut to 5 for the script's time
#: limit (the eight points at 5 trials took 290-380 s on an H100, 85% of
#: it the two-stage FISTA's 4000 eigh a recovery; PERF.md sections 4 and
#: 5), then to 4 for phase 10; back to 10 once FISTA is faster
VSM_TRIALS = 4
#: the checks at M >= VSM_CHECK_FROM: every curve within VSM_TOL_DB of
#: VSM_r05's, and A2 below PLOMP at VSM_A2_WINS.  Only those points of
#: VSM_r05's grid are swept: the five below, which no check reads, were
#: cut for the script's time limit when phase 8 came
VSM_CHECK_FROM = 529
VSM_TOL_DB = 3.0
VSM_A2_WINS = (784, 1024)
#: the complex-family cell (A2 alone): M 1024, 2 trials; the profiled
#: cell (every method): M 1024, 1 trial, for the script's time limit;
#: the Vs_SNR point: VSSNR_r05's M 529 at SNR 10, VSSNR_TRIALS trials
#: (cut from 5 to 3 for the script's time limit when phase 9 came: the
#: smoke took 918 s of its 1200 with 5, PERF.md section 4)
VSM_SIDE_TRIALS, VSM_PROFILE_TRIALS = 2, 1
VSSNR_M, VSSNR_SNR, VSSNR_TRIALS = 529, 10.0, 3

#: phase 8: the VS_SR campaign of VSSR_r05.json
#: (scripts/run_vssr_r05.py:34-50): 12x12, 1 path, Rician K 5, SNR 0 with
#: noise, Directional_Beam_Angular, A2 on the pair path (K3), PLOMP,
#: PLGAMP and perfect/noisy-phase CS, maxiter 500, 3 restarts, seed 1, the
#: reference's per-range (M, G) tables, MAEE targets (0.6, 0.8, 1.0) deg
VSSR_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "VSSR_r05.json")
VSSR_SEED = 1
VSSR_RANGES = (20.0, 30.0, 40.0, 50.0, 60.0, 70.0, 80.0)
VSSR_NT = 12
#: trials per point: VSSR_r05 ran 10; cut to 1 for the script's time
#: limit (2 trials took 270 s on an H100, 87% of it the two-stage FISTA's
#: 4000 eigh a recovery; PERF.md section 4)
VSSR_TRIALS = 1
#: each method's grand-mean MAEE over the 34 points within VSSR_TOL_DEG of
#: VSSR_r05's: 3 degrees at 10 trials, scaled by sqrt(10 / trials)
VSSR_TOL_DEG = 3.0 * np.sqrt(10.0 / VSSR_TRIALS)
#: the ranges whose mean MAEE must lie below the narrow ranges' (the
#: artifact: about 7 against 24 degrees)
VSSR_WIDE, VSSR_NARROW = (70.0, 80.0), (20.0, 30.0)
#: A2's grand-mean MAEE on the card within VSSR_PAIRED_TOL_DEG of the same
#: campaign's A2 on the CPU (the plain version of K3) on the same draws,
#: run by a child process with VSSR_CPU_THREADS threads while phases 7
#: and 8 drive the card.  No per-point bar holds here: float32 runs of A2
#: that differ only in their rounding (the plain version against the
#: plain version with 3xTF32 products, on the CPU) take other angles at 3
#: of 5 points of the 70 degree range, 2 of 4 at 20 and 3 of 6 at 50
#: (``scripts/torch_rounding_spread.py vssr``); their paired differences,
#: 1.6 degrees on average with a spread of 3.3 over those 20 points, put
#: the mean over 34 points within 0.6 (one standard error) of the other
#: run's
VSSR_PAIRED_TOL_DEG = 3.0
VSSR_CPU_THREADS = 3
#: the trace sweep: generate_channel matrices standing in for ray-traced
#: traces (none is in the repository); cut from five to two for the
#: script's time limit (PLOMP took 82 of its 92 s at five on an H100)
TRACE_COUNT, TRACE_SEED, TRACE_M = 2, 8, (529, 1024)
#: windowed inference on phase 6's probe rows (JAX's default of 30
#: windows needs 6000 rows); cut from 5 windows to 3 for the script's time
#: limit when phase 9 came (PERF.md section 4)
WINDOW, WINDOWS = 200, 3
#: recover_directional's points of probe_budget_grid(16, 16): from 121
#: up, cut to M 1024 alone for the script's time limit (the six points
#: took 44 s on an H100; PERF.md section 4)
DIRECTIONAL_FROM = 1024
#: the baselines' cell: one VS_SR point (range 20, G 25, Mt = Mr = 5)
BASE_RANGE, BASE_G, BASE_M, BASE_TRIALS = 20.0, 25, 5, 2
#: the digital beamforming gain and the array-response MSE, card against
#: CPU (the analog gain follows the SVD's phase convention and is printed
#: only)
BF_RTOL = 1e-4
#: each direct call of ``[8 baselines]``, card against CPU on the same
#: inputs, phase-aligned (``aligned_dist``).  On this degenerate cell
#: (SNR 0, 25 probes, nothing recovered) complex64 runs on the CPU that
#: differ only in their rounding (1e-7 input perturbations, or complex64
#: against complex128) part by up to 7e-2 (``phaselift_bm_pair``), 1.4e-2
#: (``cprl``), 2e-3 (the z-domain PhaseLift) and 2e-5 or less (the rest;
#: ``scripts/torch_rounding_spread.py baselines``), so complex64 is held
#: at BASE_C64_TOL, where an all-zero estimate stands at 1 and a random
#: one near 1.4.  In complex128 a 1e-15 perturbation moves the smooth
#: calls by 4e-13 at most, so they are held at BASE_C128_RTOL.  CPRL (a
#: subgradient step on a smoothed L1 term and a soft threshold) still
#: moves by 9e-3 there, and the Burer-Monteiro pair solver (nonconvex)
#: starts from the top eigenvectors of a Gram whose basis cuSOLVER and
#: LAPACK choose differently, so those two stay at BASE_NONSMOOTH_TOL
BASE_C64_TOL = 0.25
BASE_C128_RTOL = 1e-9
BASE_NONSMOOTH = ("cprl", "phaselift_bm_pair")
BASE_NONSMOOTH_TOL = 0.25
#: sweep_channel's refined angles, card against CPU: within one step of
#: the fine grid (beam_sweep's step_deg)
SWEEP_ANGLE_TOL = 0.05
#: each 200-row window's magnitude fit ``||s |A x| - b|| / ||b||`` on its
#: own rows (s the least-squares scale) at most WINDOW_FIT_MAX: on the CPU
#: the windows fit at 0.03-0.05 and the true channel at 0.02, a random x
#: at 0.6 and a zero x at 1.  With 200 rows for 256 unknowns the solve
#: itself is not reproducible (complex64 and complex128 runs on the CPU
#: part by 1.2), so the estimates are not held against the CPU's; a
#: window of WINDOW_WELL rows, where complex64 and complex128 agree to
#: 1.2e-6, is: card against CPU within WINDOW_WELL_TOL, phase-aligned,
#: and its NMSE against phase 6's channel at most WINDOW_WELL_DB
#: (``scripts/torch_rounding_spread.py windows``)
WINDOW_FIT_MAX = 0.2
WINDOW_WELL, WINDOW_WELL_TOL, WINDOW_WELL_DB = 1024, 1e-4, -20.0

#: phase 9: the sensing modes at 16x16, Mt = Mr = SENSE_M (M 1024), batch
#: SENSE_BATCH, over VSM_AREA; Random_Beam_Bayes draws C = max(4M, 256) =
#: 4096 candidates (twoace_tpu/sensing/sensing_matrix.py:93)
SENSE_M, SENSE_BATCH, SENSE_SEED = 32, 4, 9
#: the Bayes selection on the card against the same selection on the CPU
#: (a child process, BAYES_CPU_THREADS threads, started with phase 8), by
#: the A-criterion trace(inv(X^H X + I)) of the picked rows: near-ties
#: among 4096 candidates can part float32 runs, so indices are not compared
BAYES_RTOL = 1e-4
BAYES_CPU_THREADS = 3
#: pick_beams("Bayes_Beam") over a BAYES_ROWS-row random 2-bit codebook:
#: C = min(num, 40000) (sensing_matrix.py:205), M 1024
BAYES_ROWS, BAYES_SEED = 40000, 10
#: the TCP provider's first TCP_ROUNDS random rounds against the noiseless
#: RSS: within half an RSSI step (the server rounds to 0.0652 dB words)
#: plus float32 rounding of the card's reference
TCP_ROUNDS = 4
TCP_ATOL = 0.5 * 0.0652 + 1e-3
#: the CLI's testbed command (8x8, 16 rounds x 16 sectors: 256 probe rows
#: for 64 unknowns, 0.3 dB jitter) must reach this NMSE
CLI_ARGS = ("testbed", "--nt", "8", "--nr", "8", "--rounds", "16",
            "--sectors", "16", "--method", "a2only")
CLI_NMSE_DB = -10.0
CLI_TIMEOUT = 400
#: the Z-free branch: 16x16, m 1024, ZFREE_LANES lanes of phase 3's
#: problem from a spectral init, card against CPU by ``zfree_dist``.  From
#: this cold start the float32 solve on the CPU stands 1.5e-4 from the
#: same solve in float64 after its ~135 trips (a 1e-7 change of b moves it
#: by 4e-6; ``scripts/torch_rounding_spread.py zfree``), so two float32
#: solves may part by 3e-4: held at about 3x that
ZFREE_LANES, ZFREE_RTOL = 3, 1e-3
#: the estimated channel's SVD beam against the true channel's, measured
#: through the provider (0.5 dB jitter): at most this many dB weaker
BF_DB_GAP = 3.0
#: phase 10: the sharded paths on phase 3's problem (seed 1), its first
#: SHARDED_BATCH instances, the shared codebook broadcast to
#: (SHARDED_BATCH, 1024, 256), at the production scaffold's config (the
#: JAX package's sharded scaffolds read no pass caps)
SHARDED_BATCH = 4
#: the complex twin solves its instances one after another (≈ 1.4 s an
#: instance on one rank, 3 s on two; chip run, PR 12, call 1): it takes
#: the first SHARDED_COMPLEX_BATCH of them, cut from 4 for the script's
#: time limit (phase 10 took 65.2 s with 4, against the ≈ 47 s that
#: phase 6's and phase 7's cuts freed)
SHARDED_COMPLEX_BATCH = 2
SHARDED_CFG = AdmmConfig(maxiter=500, warm_iters=80, n_restarts=3)
#: two ranks over gloo against one over NCCL: each instance's quality
#: within SHARDED_Q_TOL, its NMSE both at most -60 dB or within
#: SHARDED_DB_TOL dB (the two sum the rows in another order, and the loop
#: amplifies float32 rounding)
SHARDED_Q_TOL = 1e-3
SHARDED_DB_TOL = 1.0
#: each run's bar: the pair scaffold's median NMSE and the complex
#: twin's NMSE at every instance at most this (phase 3's bar)
SHARDED_DB_BAR = -60.0
SHARDED_TIMEOUT = 600.0
#: entry()'s step on the card against the same step on the CPU (plain
#: versions): max |difference| over the largest |value| of each output
#: pair (K4's 3xTF32 and K2's chain, PERF.md section 6)
ENTRY_RTOL = 1e-4
#: the shapes phase 10 gives each kernel, held against the plain versions
#: in phase 2 at the tolerances above (not timed): the pair scaffold's
#: G = SHARDED_BATCH x RESTARTS groups of r 20 and its refine's
#: SHARDED_BATCH groups of one vector, at m 1024 a rank (one rank) and
#: 512 (two), and entry()'s one lane of r 20 at m 1024
SHARDED_MS = (M, M // 2)
SHARDED_GROUPS = ((SHARDED_BATCH * RESTARTS, R), (SHARDED_BATCH, 1))
K4_SHARDED_SHAPES = list(dict.fromkeys(
    [(g, r, k, n) for g, r in SHARDED_GROUPS for m in SHARDED_MS
     for k, n in ((m, N), (N, N), (N, m))]
    + [(1, R, k, n) for k, n in ((M, N), (N, N), (N, M))]))
#: K1's (lanes, r, m, forms): both forms in the two passes, the row form
#: in the refine and entry()
K1_SHARDED_SHAPES = ([(g, r, m, (False, True) if r > 1 else (False,))
                      for g, r in SHARDED_GROUPS for m in SHARDED_MS]
                     + [(1, R, M, (False,))])
#: K2's (lanes, r, nt, nr)
K2_SHARDED_SHAPES = ([(g, r, NT, NR) for g, r in SHARDED_GROUPS]
                     + [(1, R, NT, NR)])
#: K5's (m, r, dtype, per_entry): the complex twin's passes at r 20 and
#: its rank-1 solves, complex64
K5_SHARDED_SHAPES = [(m, r, torch.complex64, pe) for m in SHARDED_MS
                     for r, pe in ((R, False), (R, True), (1, False))]

#: H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, float32 flop/s
#: outside the tensor cores, dense TF32 flop/s on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12


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


def device_ms(*fns, reps=20, owner=None):
    """Mean device milliseconds per call of ``fn()`` under torch.profiler:
    its kernels' own time, without the host's cost of the call that
    ``cuda_ms``'s events take in when a wrapper outlasts its kernel.
    A session is kept only if it saw ``reps`` times the kernels of one
    profiled call (the profiler now and then drops events, which reads
    as a time far too short); None if no session of three did.
    Several functions share the sessions, each called in turn, when
    ``owner(name)`` gives the index of the one a kernel of that name
    belongs to; the result is then a tuple, one time a function."""
    from torch.profiler import ProfilerActivity, profile

    def session(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                for _ in range(n):
                    fn()
            torch.cuda.synchronize()
        parts = [[0, 0.0] for _ in fns]
        for name, (ms, count) in device_events(prof).items():
            part = parts[owner(name) if owner else 0]
            part[0] += count
            part[1] += ms
        return parts

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        once, many = session(1), session(reps)
        if all(c1 and c == c1 * reps for (c1, _), (c, _) in zip(once, many)):
            out = tuple(ms / reps for _, ms in many)
            return out if owner else out[0]
    return (None,) * len(fns) if owner else None


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


def k2_case(lanes, r, nt, nr, seed=0):
    """K2's inputs at (lanes, r, nt x nr): z, a warm basis from a cold eigh
    of a perturbed z, and three ladders mixed over the lanes: the normal
    train-split one, the rank-1 one and the m >= 3n full-data one, each
    padded with f = 0 levels."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = nt * nr

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    z = Pair(randn(lanes, r, n), randn(lanes, r, n))
    zp = Pair(z.re + 0.05 * randn(lanes, r, n),
              z.im + 0.05 * randn(lanes, r, n))
    m = 4 * n
    m_train = int(np.floor(m * 0.95))
    ladders = [profile_ladder_arrays(nt, nr, m_train, n, False, device="cuda"),
               profile_ladder_arrays(nt, nr, m_train, n, True, device="cuda"),
               profile_ladder_arrays(nt, nr, m, n, False, device="cuda")]
    pick = torch.arange(lanes, device="cuda") % 3
    lad = LadderArrays(torch.stack([l.ranks for l in ladders])[pick],
                       torch.stack([l.fracs for l in ladders])[pick])
    _, v0 = zprox_t_plain(zp, None, nt, nr, lad)
    return z, v0, lad


def k2_held(z, v0, lad, nt, nr):
    """K2 against its plain version, each entry within K2_ATOL; returns
    K2's outputs and the max |error|."""
    zn, vn = fused_zprox_t(z, v0, nt, nr, lad)
    zn0, vn0 = zprox_t_plain(z, v0, nt, nr, lad)
    torch.cuda.synchronize()
    for got, want in ((zn.re, zn0.re), (zn.im, zn0.im), (vn.re, vn0.re),
                      (vn.im, vn0.im)):
        torch.testing.assert_close(got, want, rtol=0.0, atol=K2_ATOL)
    return zn, vn, max_err([zn.re, zn.im, vn.re, vn.im],
                           [zn0.re, zn0.im, vn0.re, vn0.im])


def phase2_k2():
    """K2 against its plain version at K2_SHAPES, each entry of both
    outputs within K2_ATOL (the batch shape also moved by its ladders:
    the check is not vacuous), with events, the profiler's device time,
    the plain version's time and the bounds: z, v0 and the ladder read and
    both outputs written once, and the Gram's, the chain's six and the
    apply's complex products (6 flops a complex multiply-add, the
    Karatsuba 3M form) as 3xTF32 on the tensor cores."""
    from twoace_tpu_torch.ops.kernels.zprox import plan as k2_plan

    out = {}
    for lanes, r, nt, nr in K2_SHAPES:
        z, v0, lad = k2_case(lanes, r, nt, nr)
        zn, vn, err = k2_held(z, v0, lad, nt, nr)
        moved = float((zn.re - z.re).abs().max())
        if (lanes, r, nt, nr) == K2_SHAPES[0] and moved < 1e-2:
            raise RuntimeError(f"K2 check is vacuous: the ladder moved z by "
                               f"only {moved:.2e}")
        ms = cuda_ms(lambda: fused_zprox_t(z, v0, nt, nr, lad))
        plain = cuda_ms(lambda: zprox_t_plain(z, v0, nt, nr, lad))
        dev = device_ms(lambda: fused_zprox_t(z, v0, nt, nr, lad))
        rows = r * nt
        flops = 6 * lanes * (2 * rows * nr * nr + 6 * nr ** 3)
        t_bytes = nbytes(z, v0, lad, zn, vn) / PEAK_BYTES * 1e3
        t_tf32 = 3 * flops / PEAK_TF32 * 1e3
        bnd = (dict(bound_ms=t_bytes, bound_by="bytes") if t_bytes >= t_tf32
               else dict(bound_ms=t_tf32, bound_by="operations"))
        share = (f"{100 * bnd['bound_ms'] / dev:.1f}% of the "
                 f"{bnd['bound_by']} bound" if dev else "not measured")
        pl = k2_plan(rows, nr)
        staged = (f"W resident in {pl['chunks']} chunk(s)" if pl["resident"]
                  else f"W streamed in {pl['chunks']} chunks of "
                       f"{pl['chunk']} rows")
        print(f"[2 K2 fused_zprox_t] lanes {lanes} r {r} nt {nt} nr {nr} "
              f"(rows {rows}; {staged}, {pl['smem']} B of shared memory a "
              f"block): max_abs_err {err:.3e} (tol {K2_ATOL}; the ladder "
              f"moved z by {moved:.3f}) | kernel {ms:.4f} ms (events), "
              f"device {fmt_ms(dev)} per launch (profiler) | plain "
              f"{plain:.4f} ms | bounds: bytes {t_bytes:.6f} ms, 3xTF32 "
              f"{t_tf32:.6f} ms | roofline share {share}", flush=True)
        out[(lanes, r, nt, nr)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, device_ms=dev, **bnd,
            library_ms=None)
    errs = [o["max_abs_err"] for o in out.values()]
    for lanes, r, nt, nr in K2_SHARDED_SHAPES:
        errs.append(k2_held(*k2_case(lanes, r, nt, nr), nt, nr)[2])
        print(f"[2 K2 fused_zprox_t] phase 10's lanes {lanes} r {r} nt {nt} "
              f"nr {nr}: max_abs_err {errs[-1]:.3e} (tol {K2_ATOL}; held, "
              f"not timed)", flush=True)
    first = dict(out[K2_SHAPES[0]])
    first["max_abs_err"] = max(errs)
    return first


def print_k2_phases():
    """The phase timer's split of a K2 launch at the first two K2_SHAPES
    (``scripts/torch_k2_phases.py``'s timer build).  Run after the
    profiler's reads of the other kernels, as K3's split is."""
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    from torch_k2_phases import build_timer_lib, fmt_split, phase_split

    with tempfile.TemporaryDirectory() as tmp:
        lib = build_timer_lib(tmp)
        for lanes, r, nt, nr in K2_SHAPES[:2]:
            z, v0, lad = k2_case(lanes, r, nt, nr)
            split = phase_split(lib, lambda: fused_zprox_t(z, v0, nt, nr,
                                                           lad))
            print(f"[2 K2 phases] lanes {lanes} r {r} nt {nt} nr {nr}, timer "
                  f"build, lane 0: {fmt_split(split)}", flush=True)


def k1_case(gen, lanes, r, m):
    """K1's inputs at (lanes, r, m), drawn from ``gen``, with 7 inactive
    padding columns (b = 0) and 4 zero columns."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    ax = Pair(randn(lanes, r, m), randn(lanes, r, m))
    md = Pair(randn(lanes, r, m), randn(lanes, r, m))
    b = torch.rand(lanes, m, generator=gen, device="cuda") + 0.5
    b[:, :7] = 0.0                       # inactive padding columns
    ax.re[:, :, 7:11] = 0.0              # zero columns
    ax.im[:, :, 7:11] = 0.0
    md.re[:, :, 7:11] = 0.0
    md.im[:, :, 7:11] = 0.0
    mu = torch.rand(lanes, generator=gen, device="cuda") + 1e-3
    return ax, b, md, mu


def k1_held(ax, b, md, mu, per_entry):
    """K1 against its plain version within K1_TOL; its max |error|."""
    y, mo = fused_prox_dual_t(ax, b, md, mu, per_entry=per_entry)
    y0, mo0 = prox_dual_t_plain(ax, b, md, mu, per_entry)
    torch.cuda.synchronize()
    for got, want in ((y.re, y0.re), (y.im, y0.im), (mo.re, mo0.re),
                      (mo.im, mo0.im)):
        torch.testing.assert_close(got, want, **K1_TOL)
    return max_err([y.re, y.im, mo.re, mo.im], [y0.re, y0.im, mo0.re, mo0.im])


def phase2_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    # K1: first-pass train split and full-data shapes, both prox modes
    errs, times = [], {}
    for m in (M_TRAIN, M):
        ax, b, md, mu = k1_case(gen, LANES, R, m)
        for per_entry in (False, True):
            err = k1_held(ax, b, md, mu, per_entry)
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
    for lanes, r, m, forms in K1_SHARDED_SHAPES:
        case = k1_case(gen, lanes, r, m)
        for per_entry in forms:
            err = k1_held(*case, per_entry)
            errs.append(err)
            print(f"[2 K1 fused_prox_dual_t] phase 10's lanes {lanes} r {r} "
                  f"m {m} per_entry {per_entry}: max_abs_err {err:.3e} "
                  f"(held, not timed)", flush=True)
    # bound at the row-form m 972 shape: 4 planes in, 4 out, b and mu;
    # about 16 flops per entry
    k1_bytes = (8 * LANES * R * M_TRAIN + LANES * M_TRAIN + LANES) * 4
    summary["fused_prox_dual_t"] = dict(
        max_abs_err=max(errs), ms=times[(M_TRAIN, False)][0],
        plain_ms=times[(M_TRAIN, False)][1],
        device_ms=times[(M_TRAIN, False)][2],
        **bound(k1_bytes, 16 * LANES * R * M_TRAIN), library_ms=None)

    summary["fused_zprox_t"] = phase2_k2()
    summary["pair_matmul"] = phase2_k4()
    floor = launch_floor_ms(device_ms)
    print(f"[2 launch floor] a one-element elementwise op: device "
          f"{fmt_ms(floor)} per launch (profiler); the floor for reading K5 "
          f"and K6", flush=True)
    summary["fused_prox_dual"] = phase2_k5(floor)
    summary["pair_chain_mm"] = phase2_k6(floor)
    # K3 after the profiler's reads of K4-K6: after a K3 launch those
    # reads failed their consistency check (PERF.md, section 7)
    summary["fused_infer_admm"], k3_timed = phase2_k3()
    print_k3_phases(*k3_timed)
    print_k2_phases()
    return summary


def k6_case(batch, seed=6):
    """K6's inputs at ``batch`` instances of 16x16: the chain benchmark's
    kind (``chain_mm.lane_inputs``) as (B, n, n) pairs V and G on the
    card."""
    planes = chain_mm.lane_inputs(seed=seed, b=batch)
    return tuple(chain_mm.from_lanes(Pair(*(torch.as_tensor(p, device="cuda")
                                            for p in pl)))
                 for pl in (planes[:2], planes[2:]))


def phase2_k6(floor):
    """K6 against its plain version at K6_BATCHES of (16, 16) instances
    (8 steps), with the times of both, the host's cost of a call, of the
    complex64 ``torch.matmul`` chain and the bound beside the launch floor
    ``floor``: V and G read once and V' written once, or the operations,
    the Karatsuba chain's 3 real n x n x n products a step in 3xTF32 on
    the tensor cores and about 10 float32 flops a complex entry a step
    (the Karatsuba sums, the norm and the scale), whichever is larger; the
    FP32 time of all of it is printed beside."""
    out = {}
    for batch in K6_BATCHES:
        v, g = k6_case(batch)
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
            host = host_us(lambda: pair_chain_mm(v, g))
        n = chain_mm.N
        prod = chain_mm.CHAIN * batch * 3 * 2 * n ** 3
        rest = chain_mm.CHAIN * batch * 10 * n * n
        t_bytes = nbytes(v, g, got) / PEAK_BYTES * 1e3
        t_tf32 = (3 * prod / PEAK_TF32 + rest / PEAK_FP32) * 1e3
        t_fp32 = (prod + rest) / PEAK_FP32 * 1e3
        bnd = (dict(bound_ms=t_bytes, bound_by="bytes") if t_bytes >= t_tf32
               else dict(bound_ms=t_tf32, bound_by="operations"))
        share = (f"{100 * bnd['bound_ms'] / dev:.1f}% of the "
                 f"{bnd['bound_by']} bound" if dev else "not measured")
        print(f"[2 K6 pair_chain_mm] B {batch}, {n}x{n}, {chain_mm.CHAIN} "
              f"steps: max rel err {rel:.3e} (tol {K6_RTOL}), max abs err "
              f"{err:.3e} | kernel {ms:.4f} ms (events), device "
              f"{fmt_ms(dev)} per launch (profiler) | host "
              f"{host['events_us']:.2f} us a call (events; host clock "
              f"{host['clock_us']:.2f}) | plain {plain:.4f} ms | "
              f"complex64 torch.matmul chain {lib:.4f} ms | bounds: bytes "
              f"{t_bytes:.6f} ms, 3xTF32 {t_tf32:.6f} ms, FP32 {t_fp32:.6f} "
              f"ms | roofline share {share} | launch floor {fmt_ms(floor)}",
              flush=True)
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


def k5_held(ax, b, md, mu, per_entry):
    """K5 against its plain version within K5_RTOL (max |difference| over
    max |plain|); returns K5's outputs, that ratio, the max |error| and
    the case's label."""
    m, r = ax.shape
    got = fused_prox_dual(ax, b, md, mu, per_entry)
    want = prox_dual_rows_plain(ax, b, md, mu, per_entry)
    torch.cuda.synchronize()
    rel = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    label = f"({m}, {r}) {str(ax.dtype)[6:]} per_entry {per_entry}"
    if not rel <= K5_RTOL[ax.dtype]:
        raise RuntimeError(f"K5 disagrees with its plain version at "
                           f"{label}: {rel:.3e} > {K5_RTOL[ax.dtype]}")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return got, rel, err, label


def phase2_k5(floor):
    """K5 against its plain version at K5_SHAPES, with the times of both,
    the host's cost of a call and the bound (each of ax, M, b, mu read
    once and y, M' written once, about 20 flops per complex entry) beside
    the launch floor ``floor``."""
    out = {}
    for m, r, dtype, per_entry in K5_SHAPES:
        ax, b, md, mu = k5_inputs(m, r, dtype)
        got, rel, err, label = k5_held(ax, b, md, mu, per_entry)
        ms = cuda_ms(lambda: fused_prox_dual(ax, b, md, mu, per_entry))
        plain = cuda_ms(lambda: prox_dual_rows_plain(ax, b, md, mu,
                                                     per_entry))
        dev = device_ms(lambda: fused_prox_dual(ax, b, md, mu, per_entry))
        host = host_us(lambda: fused_prox_dual(ax, b, md, mu, per_entry))
        bnd = bound(nbytes(ax, md, b, mu, *got), 20 * m * r)
        print(f"[2 K5 fused_prox_dual] {label}: max rel err {rel:.3e} (tol "
              f"{K5_RTOL[dtype]}), max abs err {err:.3e} | kernel {ms:.4f} "
              f"ms (events), device {fmt_ms(dev)} per launch (profiler) | "
              f"host {host['events_us']:.2f} us a call (events; host clock "
              f"{host['clock_us']:.2f}) | plain {plain:.4f} ms | bound "
              f"{bnd['bound_ms']:.6f} ms ({bnd['bound_by']}) | launch floor "
              f"{fmt_ms(floor)}", flush=True)
        out[(m, r, dtype, per_entry)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, device_ms=dev, **bnd,
            library_ms=None)
    first = dict(out[K5_SHAPES[0]])
    for m, r, dtype, per_entry in K5_SHARDED_SHAPES:
        _, rel, err, label = k5_held(*k5_inputs(m, r, dtype), per_entry)
        first["max_abs_err"] = max(first["max_abs_err"], err)
        print(f"[2 K5 fused_prox_dual] phase 10's {label}: max rel err "
              f"{rel:.3e} (tol {K5_RTOL[dtype]}), max abs err {err:.3e} "
              f"(held, not timed)", flush=True)
    return first


def k3_flops(it, r, m, n, nr=NR):
    """Flops of the trips the lanes ran: the four complex products in
    Karatsuba form, and the rest (the Z-prox: panel Gram, delta apply,
    nr x nr chain; the prox), per trip."""
    trips = int(it.sum())
    products = 6 * r * (3 * m * n + n * n)
    rest = 2 * r * n * nr * 8 + 7 * nr ** 3 * 8 + 16 * r * m
    return trips * products, trips * rest


def rel_err(got, want):
    """max |got - want| / max |want| over opt_x and opt_y."""
    return max(float((g.cpu() - w.cpu()).abs().max() / w.abs().max().cpu())
               for gp, wp in zip(got[:2], want[:2]) for g, w in zip(gp, wp))


def cast_args(args, dtype=None, device=None):
    """K3's prepared arguments moved to ``device`` and/or with their
    floating tensors cast to ``dtype``."""
    def one(t):
        if isinstance(t, tuple):
            return type(t)(*(one(v) for v in t))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device) if device is not None else t

    return [one(t) for t in args]


def cold_divergence(args, loop, trips=10):
    """From a cold start (spectral init, mu0 1e-3) the loop amplifies
    float32 rounding: print how far K3 and the plain version part after
    ``trips`` trips, beside how far the plain version on the CPU and on
    the card part.  No tolerance is held here."""
    kw = dict(scale_by_row=True, maxiter=trips, **loop)
    got = fused_infer_admm(*args, **kw)
    want = infer_admm_plain(*args, **kw)
    want_cpu = infer_admm_plain(*cast_args(args, device="cpu"), **kw)
    print(f"[2 K3 cold start] {trips} trips from the spectral init at mu0 "
          f"1e-3, m {M_TRAIN}: K3 vs plain rel err "
          f"{rel_err(got, want):.3e} | plain on the CPU vs plain on the "
          f"card {rel_err(want_cpu, want):.3e} (reported, not held)",
          flush=True)


def k3_cases(m, lanes=RESTARTS, seed=5, device="cuda", nt=NT, nr=NR):
    """K3's inputs at m: ``lanes`` lanes (one per restart), r R, nt x nr
    (16x16), bench.py's codebook rows normalised as the solver does, the
    full-data ladder, the spectral init run K3_WARM first-pass trips (zero
    tolerances) to a warm lane state; then both passes from there at mu0
    K3_MU0.  Yields ``(label, args, kw)`` for each pass, with zero
    tolerances so every trip of K3_TRIPS runs."""
    n = nt * nr
    a, b, _ = build_solve_problem(seed=seed, batch=lanes, m=m, nt=nt, nr=nr)
    ap = Pair(*(torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32,
                                device=device)[None].expand(lanes, m, n)
                .contiguous() for v in (a.real, a.imag)))
    bt = torch.as_tensor(b, dtype=torch.float32, device=device)[:, None]
    bt = bt / torch.linalg.vector_norm(bt, dim=-1, keepdim=True)
    lad = profile_ladder_arrays(nt, nr, m, n, False, device=device)
    lad = LadderArrays(lad.ranks.expand(lanes, -1).contiguous(),
                       lad.fracs.expand(lanes, -1).contiguous())
    lad3 = LadderArrays(lad.ranks[:, None], lad.fracs[:, None])
    u = pair_solver.precompute_u_pair(ap)
    x0 = pair_solver.spectral_initialize_pair(
        ap, bt, R, torch.Generator().manual_seed(seed))

    def prepared(x, sbr, mu0):
        y0, z0, v0 = pair_solver.admm_init_pair(
            ap, bt, x, scale_by_row=sbr, nt=nt, nr=nr, ladder=lad3)
        c = lambda p: Pair(p.re.contiguous(), p.im.contiguous())
        return [ap, bt, u, c(y0), c(z0), c(v0),
                torch.full((lanes, 1), mu0, device=device), lad]

    loop = dict(nt=nt, nr=nr, rho=1.03, tol_rel=0.0, tol_abs=0.0)
    cold = prepared(x0, True, 1e-3)
    if (nt, m) == (NT, M_TRAIN) and lanes == RESTARTS and device == "cuda":
        cold_divergence(cold, loop)
    xw = fused_infer_admm(*cold, scale_by_row=True, maxiter=K3_WARM,
                          **loop)[0]
    for sbr in (True, False):
        x = xw if sbr else pair_solver._orthonormalize_cols_t(xw)
        yield (f"lanes {lanes} r {R} {nt}x{nr} m {m} scale_by_row {sbr}",
               prepared(x, sbr, K3_MU0),
               dict(scale_by_row=sbr, maxiter=K3_TRIPS, **loop))


def same_trips(got, want, what):
    """Raise unless K3's trip counts and converged flags equal the plain
    version's."""
    if not (torch.equal(got[3], want[3]) and torch.equal(got[2], want[2])):
        raise RuntimeError(f"K3 trips {got[3].tolist()} / converged "
                           f"{got[2].tolist()} vs plain {want[3].tolist()} / "
                           f"{want[2].tolist()} at {what}")


def k3_column_held(label, args, kw, got, want):
    """The per-column pass at a case of K3_COLUMN_CASES: print K3's, the plain
    version's and the float64 run's distances after K3_TRIPS trips (not
    held), then hold K3 at K3_RTOL against the plain version and the
    float64 run over K3_COLUMN_TRIPS trips.  Returns K3's distance from
    the plain version there."""
    f64 = infer_admm_plain(*cast_args(args, torch.float64), **kw)
    print(f"[2 K3 per-column pass at {label}, {K3_TRIPS} trips, reported, "
          f"not held] K3 vs plain {rel_err(got, want):.3e} | plain vs float64 "
          f"{rel_err(want, f64):.3e} | K3 vs float64 {rel_err(got, f64):.3e}",
          flush=True)
    trips = K3_COLUMN_TRIPS
    kw = dict(kw, maxiter=trips)
    got = fused_infer_admm(*args, **kw)
    want = infer_admm_plain(*args, **kw)
    f64 = infer_admm_plain(*cast_args(args, torch.float64), **kw)
    same_trips(got, want, f"{label}, {trips} trips")
    rel, rel_f64 = rel_err(got, want), rel_err(got, f64)
    print(f"[2 K3 per-column pass at {label}, {trips} trips, held] K3 vs "
          f"plain {rel:.3e} | K3 vs float64 {rel_f64:.3e} (tol {K3_RTOL} "
          f"each) | plain vs float64 {rel_err(want, f64):.3e}", flush=True)
    if not (rel <= K3_RTOL and rel_f64 <= K3_RTOL):
        raise RuntimeError(f"K3 disagrees at {label} over {trips} trips: "
                           f"relative error {rel:.3e} against the plain "
                           f"version, {rel_f64:.3e} against float64 > "
                           f"{K3_RTOL}")
    return rel


def phase2_k3():
    """K3 against its plain version at K3_CASES: 3 lanes (one per restart),
    r 20, both passes, K3_TRIPS trips with zero tolerances so every trip
    runs, from a warm lane state (``k3_cases``): equal trips and converged
    flags everywhere, and the relative error within K3_RTOL (the
    per-column pass at K3_COLUMN_CASES over K3_COLUMN_TRIPS trips, also
    against the loop in float64).  Returns the summary at (16x16, m 972,
    scale_by_row) and that case's arguments for ``print_k3_phases``."""
    out = {}
    for nt, m in K3_CASES:
        for label, args, kw in k3_cases(m, nt=nt, nr=nt):
            got = fused_infer_admm(*args, **kw)
            want = infer_admm_plain(*args, **kw)
            torch.cuda.synchronize()
            same_trips(got, want, label)
            if int(got[3].min()) != K3_TRIPS:
                raise RuntimeError(f"K3 ran {got[3].tolist()} trips, not "
                                   f"{K3_TRIPS}")
            err = max_err([*got[0], *got[1]], [*want[0], *want[1]])
            if not kw["scale_by_row"] and (nt, m) in K3_COLUMN_CASES:
                rel = k3_column_held(label, args, kw, got, want)
                held = f"over {K3_COLUMN_TRIPS} trips"
            else:
                rel = rel_err(got, want)
                held = f"over {K3_TRIPS} trips"
                if not rel <= K3_RTOL:
                    raise RuntimeError(f"K3 disagrees with its plain version "
                                       f"at {label}: relative error "
                                       f"{rel:.3e} > {K3_RTOL}")
            ms = cuda_ms(lambda: fused_infer_admm(*args, **kw), reps=5)
            plain = cuda_ms(lambda: infer_admm_plain(*args, **kw), reps=2)
            prod, rest = k3_flops(got[3], R, m, nt * nt, nt)
            t_bytes = (nbytes(*args[:7], args[7], *got[:2])
                       + 8 * len(got[3])) / PEAK_BYTES * 1e3
            t_fp32 = (prod + rest) / PEAK_FP32 * 1e3
            t_tf32 = (3 * prod / PEAK_TF32 + rest / PEAK_FP32) * 1e3
            bnd = (dict(bound_ms=t_bytes, bound_by="bytes")
                   if t_bytes >= t_tf32
                   else dict(bound_ms=t_tf32, bound_by="operations"))
            print(f"[2 K3 fused_infer_admm] {label}, {K3_TRIPS} trips (warm "
                  f"state, mu0 {K3_MU0}): max rel err {rel:.3e} {held} (tol "
                  f"{K3_RTOL}), max abs err {err:.3e} after {K3_TRIPS}, trips "
                  f"and converged equal | kernel {ms:.4f} ms | plain "
                  f"{plain:.4f} ms | bounds: 3xTF32 {t_tf32:.4f} ms (products "
                  f"on the tensor cores), FP32 {t_fp32:.4f} ms, bytes "
                  f"{t_bytes:.4f} ms", flush=True)
            out[(nt, m, kw["scale_by_row"])] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, **bnd,
                library_ms=None)
            if (nt, m, kw["scale_by_row"]) == (NT, M_TRAIN, True):
                timed = args, kw
    return out[(NT, M_TRAIN, True)], timed


def print_k3_phases(args, kw):
    """K3's cluster occupancy and the phase timer's split of one launch
    (``scripts/torch_k3_phases.py``'s timer build)."""
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    from torch_k3_phases import build_timer_lib, fmt_split, phase_split
    from twoace_tpu_torch.ops.kernels.infer_admm import (CLUSTER,
                                                          active_clusters)

    print(f"[2 K3 occupancy] clusters of {CLUSTER} CTAs placed at once "
          f"(cudaOccupancyMaxActiveClusters): r {R} 16x16 "
          f"{active_clusters(R, NT, NR)}, r 32 {active_clusters(32, NT, NR)}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        split, trips = phase_split(build_timer_lib(tmp),
                                   lambda: fused_infer_admm(*args, **kw))
    print(f"[2 K3 phases] m {M_TRAIN} scale_by_row True, timer build, CTA "
          f"0 of lane 0 over {trips} trips: {fmt_split(split)}", flush=True)


def k4_held(gen, g, m, k, n):
    """K4 against its plain version (within K4_RTOL) and both against the
    complex128 product (K4 within K4_C128_FACTOR x the plain version's
    error), on operands drawn from ``gen``; returns the operands, both
    products and the three errors."""
    a, b = (Pair(*(torch.randn(g, rows, cols, generator=gen, device="cuda")
                   for _ in range(2)))
            for rows, cols in ((m, k), (k, n)))
    got = pair_matmul(a, b)
    want = pair_matmul_plain(a, b)
    torch.cuda.synchronize()
    rel = max(float((x - w).abs().max() / w.abs().max())
              for x, w in zip(got, want))
    if not rel <= K4_RTOL:
        raise RuntimeError(f"K4 disagrees with its plain version at "
                           f"{(g, m, k, n)}: {rel:.3e} > {K4_RTOL}")
    exact = (torch.complex(*a).to(torch.complex128)
             @ torch.complex(*b).to(torch.complex128))
    scale = float(exact.abs().max())
    err_k4, err_plain = (
        float((torch.complex(*p).to(torch.complex128) - exact).abs().max())
        / scale for p in (got, want))
    if not err_k4 <= K4_C128_FACTOR * err_plain:
        raise RuntimeError(
            f"K4's error against complex128 at {(g, m, k, n)}, "
            f"{err_k4:.3e}, is above {K4_C128_FACTOR} x the plain "
            f"version's {err_plain:.3e}")
    return a, b, got, want, rel, err_k4, err_plain


def phase2_k4():
    """K4 against its plain version (TF32 off) at K4_SHAPES, both against
    the complex128 product, with the route the shape takes, the times of
    K4 (events and profiler device time), the plain version and one
    complex64 ``torch.matmul`` on tensors built beforehand, beside the
    bounds: each operand read and the output written once, and 6 M N K G
    flops either as 3xTF32 on the tensor cores (three TF32 products each,
    the bound the roofline share is taken against) or on the float32
    CUDA cores."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    with no_tf32():
        for g, m, k, n in K4_SHAPES:
            a, b, got, want, rel, err_k4, err_plain = k4_held(gen, g, m, k, n)
            which = k4_route(g, m, k, n)
            ac, bc = torch.complex(*a), torch.complex(*b)
            ms = cuda_ms(lambda: pair_matmul(a, b))
            plain = cuda_ms(lambda: pair_matmul_plain(a, b))
            lib = cuda_ms(lambda: torch.matmul(ac, bc))
            # K4's kernels are pair_mm_*; the rest are the library's
            dev, lib_dev = device_ms(
                lambda: pair_matmul(a, b), lambda: torch.matmul(ac, bc),
                owner=lambda name: 0 if "pair_mm_" in name else 1)
            flops = 6 * g * m * k * n
            t_bytes = nbytes(a, b, got) / PEAK_BYTES * 1e3
            t_tf32 = 3 * flops / PEAK_TF32 * 1e3
            t_fp32 = flops / PEAK_FP32 * 1e3
            bnd = (dict(bound_ms=t_bytes, bound_by="bytes")
                   if t_bytes >= t_tf32
                   else dict(bound_ms=t_tf32, bound_by="operations"))
            share = (f"{100 * bnd['bound_ms'] / dev:.1f}% of the "
                     f"{'3xTF32' if bnd['bound_by'] == 'operations' else 'bytes'}"
                     f" bound" if dev else "not measured")
            print(f"[2 K4 pair_matmul] ({g}, {m}, {k}) @ ({g}, {k}, {n}), "
                  f"route {which}: max rel err {rel:.3e} (tol {K4_RTOL}) | "
                  f"vs complex128: K4 {err_k4:.3e}, plain {err_plain:.3e} "
                  f"(K4 at most {K4_C128_FACTOR:g}x) | kernel {ms:.4f} ms "
                  f"(events), device {fmt_ms(dev)} per launch (profiler) | "
                  f"plain {plain:.4f} ms | complex64 torch.matmul {lib:.4f} "
                  f"ms (events), device {fmt_ms(lib_dev)} | bounds: 3xTF32 "
                  f"{t_tf32:.6f} ms, FP32 {t_fp32:.6f} ms, bytes "
                  f"{t_bytes:.6f} ms | roofline share {share}", flush=True)
            out[(g, m, k, n)] = dict(
                max_abs_err=max_err(got, want), ms=ms, plain_ms=plain,
                device_ms=dev, **bnd, library_ms=lib,
                library_device_ms=lib_dev)
        first = dict(out[K4_SHAPES[0]])
        for g, m, k, n in K4_SHARDED_SHAPES:
            *_, got, want, rel, err_k4, err_plain = k4_held(gen, g, m, k, n)
            first["max_abs_err"] = max(first["max_abs_err"],
                                       max_err(got, want))
            print(f"[2 K4 pair_matmul] phase 10's ({g}, {m}, {k}) @ ({g}, "
                  f"{k}, {n}), route {k4_route(g, m, k, n)}: max rel err "
                  f"{rel:.3e} (tol {K4_RTOL}) | vs complex128: K4 "
                  f"{err_k4:.3e}, plain {err_plain:.3e} (K4 at most "
                  f"{K4_C128_FACTOR:g}x; held, not timed)", flush=True)
    return first


def build_solve_problem(seed=1, batch=SOLVE_BATCH, m=M, nt=NT, nr=NR):
    """bench.py's solve workload, rebuilt with numpy: ``batch`` two-path
    nt x nr (16x16) channels through one shared 2-bit random codebook."""
    n = nt * nr
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 4, (m, n))
    a = np.exp(1j * bits * (np.pi / 2)) / np.sqrt(n)

    def steer(nn, ang):
        return np.exp(1j * np.pi * np.arange(nn) * np.sin(ang)) / np.sqrt(nn)

    xs, bs = [], []
    for _ in range(batch):
        angs = rng.uniform(-1.2, 1.2, 4)
        h = sum((rng.normal() + 1j * rng.normal())
                * np.outer(steer(nr, angs[2 * i]),
                           steer(nt, angs[2 * i + 1]).conj())
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
    solve costs minutes of post-processing.  Returns the call's wall ms
    (without the profiler's post-processing)."""
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
        return wall_ms
    top = sorted(events.items(), key=lambda kv: -kv[1][0])[:6]
    parts = " | ".join(f"{name[:40]} {ms:.2f} ms x{count}"
                       for name, (ms, count) in top)
    print(f"{label} under the profiler: wall {wall_ms:.2f} ms, device busy "
          f"{total:.2f} ms ({100 * total / wall_ms:.1f}%) | {parts}",
          flush=True)
    return wall_ms


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
    """Phase 6's testbed inputs, drawn as ``TestbedRunner(...,
    generator=torch.Generator().manual_seed(CAMPAIGN_SEED))``'s
    ``run_random_campaign`` draws its random campaign (phase 9 runs that
    campaign and finds the same rows): a 16x16 2-bit Tx codebook of 64
    rounds x 62 sectors and a 64-entry Rx codebook, kron'd sector-major
    (``interleave=True``) into 3968 probe rows; a 3-path
    ``generate_channel`` scaled by CHANNEL_SCALE; its RSS in dBm from
    ``SyntheticProvider`` at its defaults (0.5 dB jitter, 10 dumps, RSSI
    quantization) and without jitter or quantization.  Every draw is made
    on the CPU from CAMPAIGN_SEED, so ``device="cpu"`` gives the same
    inputs.  Returns ``(cb, x_true, rss_dbm, rss_dbm_noiseless)``."""
    cfg = ArrayConfig(nt=NT, nr=NR)
    n_paths = recovery.CampaignConfig().n_paths
    g = torch.Generator().manual_seed(CAMPAIGN_SEED)
    rounds, sectors = CAMPAIGN_ROUNDS, CAMPAIGN_SECTORS
    g_random = fold_in(g, 4)
    tx = random_codebook(fold_in(g_random, 0), rounds * sectors, NT,
                         device=device)
    rx = random_codebook(fold_in(g_random, 1), rounds, NR, device=device)
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
    restarts).  Its ``recover_a2only`` grid runs in phase 9, through
    ``TestbedRunner.estimate``."""
    cb, x_true, rss, clean = campaign_workload()
    x_np = x_true.cpu().numpy()
    cc = recovery.CampaignConfig(array=ArrayConfig(nt=NT, nr=NR))
    grid = probe_budget_grid(NT, NR)
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

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
          f"median {np.median(db[1:]):.2f} dB (windows "
          f"1-{TRACK_WINDOWS - 1}) | budgets "
          f"{trace.probe_budget.tolist()} | launches {counts} || phase 5's "
          f"K3 cold tracker: {cold_k3['wps']:.2f} windows/s, median "
          f"{cold_k3['ms']:.1f} ms per window, tracked NMSE median "
          f"{np.median(cold_k3['db'][1:TRACK_WINDOWS]):.2f} dB (windows "
          f"1-9)", flush=True)

    a = cb[:M]
    b = dbm_to_amplitude(torch.as_tensor(rss[:M], device=a.device),
                         cc.rss_fct)
    wall_ms, _, _, counts = run_campaign(
        "the profiled solve", lambda: profile_call(
            f"[6 profile] solve_lowrank_multi M {M}",
            lambda: admm.solve_lowrank_multi(
                torch.Generator().manual_seed(0), a, b, NT, NR, cc.admm)))
    add(counts)
    trips = admm.infer_admm.trips
    print(f"[6 profile] {trips} trips, K5 launches "
          f"{counts['fused_prox_dual']}: {wall_ms / max(trips, 1):.3f} ms "
          f"a trip (wall under the profiler)", flush=True)
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


def timed_launches(fn):
    """``fn()`` with the launch counts set to 0 just before it and read
    just after; returns the result, the wall seconds and the counts."""
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, launch_counts()


def run_sweep(label, fn, need):
    """``fn()`` (a sweep) under :func:`timed_launches`; fails unless every
    kernel in ``need`` was launched and every NMSE is finite and
    positive.  Returns the result, the wall seconds and the counts."""
    res, wall, counts = timed_launches(fn)
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
    full = list(probe_budget_grid(NT, NR))
    if full != ref["m_grid"]:
        raise RuntimeError(f"grid {full} differs from VSM_r05's {ref['m_grid']}")
    grid = [m for m in full if m >= VSM_CHECK_FROM]
    ref = dict(ref, nmse_db={k: [v[full.index(m)] for m in grid]
                             for k, v in ref["nmse_db"].items()})
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
            if abs(db[name][i] - want[i]) > VSM_TOL_DB:
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
            vsm_config(VSSNR_TRIALS, methods=("admm_lowrank_v4", "plomp",
                                              "plgamp")), VSM_AREA),
        ("fused_infer_admm",))
    add(counts)
    print_cells("[7 snr] SNR", res)
    print(f"[7 snr] sweep_snr M {VSSNR_M}, SNR {VSSNR_SNR}, {VSSNR_TRIALS} "
          f"trials: {wall:.1f} s | NMSE dB "
          + " | ".join(f"{k} {10 * np.log10(v[0]):.2f} (VSSNR_r05 "
                       f"{ref_snr['nmse_db'][k][j]})"
                       for k, v in res.nmse.items())
          + f" | launches {counts}", flush=True)

    reset_launch_counts()
    t0 = time.perf_counter()
    profile_call(f"[7 profile] sweep_measurements M {M}, "
                 f"{VSM_PROFILE_TRIALS} trial, impl pair",
                 lambda: simulation.sweep_measurements(
                     torch.Generator().manual_seed(VSM_SEED + 2), [M],
                     vsm_config(VSM_PROFILE_TRIALS), VSM_AREA))
    print(f"[7 profile] {time.perf_counter() - t0:.1f} s with the "
          "profiler's own cost", flush=True)
    counts = launch_counts()
    require_launched(counts, ("fused_infer_admm",), "the profiled cell")
    add(counts)
    return totals


def vssr_config(trials, nq=None, methods=("admm_lowrank_v4", "plomp",
                                            "plgamp")):
    """VSSR_r05's configuration (scripts/run_vssr_r05.py:34-44), A2 on the
    pair path."""
    return simulation.SimulationConfig(
        array=ArrayConfig(nt=VSSR_NT, nr=VSSR_NT, nqt=nq, nqr=nq),
        channel=ChannelConfig(n_paths=1, rician_k=5), snr_db=0.0,
        add_noise=True, beam_method="Directional_Beam_Angular",
        methods=MethodFlags(**dict(dict.fromkeys(["admm_lowrank_v4"], False),
                                   **{m: True for m in methods})),
        admm=AdmmConfig(maxiter=500, n_restarts=RESTARTS), n_trials=trials,
        impl="pair")


def vssr_a2_cpu(queue):
    """In a child process: the VS_SR campaign's A2 alone on the CPU, on the
    draws of ``phase8_vssr``; puts its per-range MAEE curves (or the error)
    on ``queue``."""
    torch.set_num_threads(VSSR_CPU_THREADS)
    try:
        res = simulation.measurements_needed_vs_range(
            torch.Generator().manual_seed(VSSR_SEED), VSSR_RANGES,
            sim=vssr_config(VSSR_TRIALS, methods=("admm_lowrank_v4",)),
            device="cpu")
        queue.put([np.asarray(c).tolist()
                   for c in res.maee_curves["admm_lowrank_v4"]])
    except BaseException as e:
        queue.put(repr(e))
        raise


def start_vssr_a2_cpu():
    """Start :func:`vssr_a2_cpu` in a (daemonic) child process; returns
    the process and its queue."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=vssr_a2_cpu, args=(queue,), daemon=True)
    proc.start()
    return proc, queue


def vssr_a2_paired(curves, cpu):
    """Hold the card's A2 MAEE curves against the CPU's (``cpu``: the
    child's process and queue) on the same draws; returns a failure
    message or None."""
    proc, queue = cpu
    t0 = time.perf_counter()
    try:
        host = queue.get(timeout=900)
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.terminate()
    if isinstance(host, str):
        return f"the CPU's A2 campaign failed: {host}"
    by_range = [round(float(np.mean(c)), 2) for c in host]
    card, host = np.concatenate(curves), np.concatenate(host)
    same = int(np.sum(np.abs(card - host) < 1e-3))
    diff = float(np.mean(card) - np.mean(host))
    print(f"[8 vssr] admm_lowrank_v4 against the same campaign's A2 on the "
          f"CPU (the plain K3 path, the same draws; waited "
          f"{time.perf_counter() - t0:.1f} s): grand-mean MAEE "
          f"{np.mean(card):.2f} vs {np.mean(host):.2f} deg, difference "
          f"{diff:.2f} (tol {VSSR_PAIRED_TOL_DEG}) | the same MAEE at {same} "
          f"of {len(card)} points | CPU mean MAEE by range {by_range}",
          flush=True)
    if not abs(diff) <= VSSR_PAIRED_TOL_DEG:
        return (f"admm_lowrank_v4: grand-mean MAEE {np.mean(card):.2f} deg "
                f"vs {np.mean(host):.2f} on the CPU")
    return None


def phase8_vssr(cpu=None):
    """The VS_SR campaign at VSSR_r05's configuration, each range's mean
    MAEE and the budgets beside the artifact's, and A2's beside the same
    campaign's on the CPU (``cpu``: :func:`start_vssr_a2_cpu`'s result,
    started here if None)."""
    if cpu is None:
        cpu = start_vssr_a2_cpu()
    with open(VSSR_REF) as f:
        ref = json.load(f)
    res, wall, counts = timed_launches(
        lambda: simulation.measurements_needed_vs_range(
            torch.Generator().manual_seed(VSSR_SEED), VSSR_RANGES,
            sim=vssr_config(VSSR_TRIALS)))
    require_launched(counts, ("fused_infer_admm",), "the VS_SR campaign")
    if sorted(res.maee_curves) != sorted(ref["maee_deg"]):
        raise RuntimeError(f"methods {sorted(res.maee_curves)} vs "
                           f"VSSR_r05's {sorted(ref['maee_deg'])}")
    if res.m_grids != ref["m_grids"] or res.g_grids != ref["g_grids"]:
        raise RuntimeError("the (M, G) tables differ from VSSR_r05's")
    failures = []
    for name, curves in res.maee_curves.items():
        want = ref["maee_deg"][name]
        pts = np.concatenate(curves)
        if not np.all(np.isfinite(pts)):
            failures.append(f"{name}: non-finite MAEE {pts}")
        by_range = [round(float(np.mean(c)), 2) for c in curves]
        ref_range = [round(float(np.mean(c)), 2) for c in want]
        secs = sum(float(np.sum(v)) for v in res.seconds.get(
            {"admm_lowrank_v4": "admm_lowrank_v4", "plomp": "plomp+plgamp",
             "plgamp": "plomp+plgamp"}.get(name, "perfect+noisy CS"), []))
        print(f"[8 vssr] {name}: m_needed "
              f"{res.m_needed[name].astype(int).tolist()} | VSSR_r05 "
              f"{ref['m_needed'][name]} | mean MAEE deg by range {by_range} "
              f"| VSSR_r05 {ref_range} | its group's seconds {secs:.1f}",
              flush=True)
        sel = [VSSR_RANGES.index(r) for r in VSSR_WIDE]
        wide = np.mean(np.concatenate([curves[i] for i in sel]))
        sel = [VSSR_RANGES.index(r) for r in VSSR_NARROW]
        narrow = np.mean(np.concatenate([curves[i] for i in sel]))
        if not wide < narrow:
            failures.append(f"{name}: mean MAEE {wide:.2f} deg at "
                            f"{VSSR_WIDE} is not below {narrow:.2f} at "
                            f"{VSSR_NARROW}")
        grand = float(np.mean(pts))
        ref_grand = float(np.mean(np.concatenate(want)))
        print(f"[8 vssr] {name}: grand-mean MAEE {grand:.2f} deg over "
              f"{len(pts)} points | VSSR_r05 {ref_grand:.2f} | tolerance "
              f"{VSSR_TOL_DEG:.2f} at {VSSR_TRIALS} trials | "
              f"{VSSR_WIDE} {wide:.2f} vs {VSSR_NARROW} {narrow:.2f}",
              flush=True)
        if abs(grand - ref_grand) > VSSR_TOL_DEG:
            failures.append(f"{name}: grand-mean MAEE {grand:.2f} deg vs "
                            f"VSSR_r05 {ref_grand:.2f}")
    paired = vssr_a2_paired(res.maee_curves["admm_lowrank_v4"], cpu)
    if paired is not None:
        failures.append(paired)
    groups = " | ".join(f"{k} {sum(float(np.sum(v)) for v in vs):.1f} s"
                        for k, vs in res.seconds.items())
    print(f"[8 vssr] measurements_needed_vs_range {VSSR_NT}x{VSSR_NT}, "
          f"{VSSR_TRIALS} trials, {sum(map(len, res.m_grids))} points: "
          f"{wall:.1f} s | {groups} | "
          f"launches {counts}", flush=True)
    if failures:
        raise RuntimeError("VS_SR checks failed: " + "; ".join(failures))
    return counts


def phase8_trace():
    """sweep_measurements_trace on TRACE_COUNT 16x16 3-path
    generate_channel matrices (stand-ins for ray-traced traces)."""
    ch = generate_channel(torch.Generator().manual_seed(TRACE_SEED),
                          ArrayConfig(nt=NT, nr=NR),
                          ChannelConfig(n_paths=3), batch=TRACE_COUNT,
                          device="cuda")
    sim = dataclasses.replace(
        vsm_config(TRACE_COUNT, methods=("admm_lowrank_v4", "plomp")),
        snr_db=20.0)
    res, wall, counts = run_sweep(
        "the trace sweep", lambda: simulation.sweep_measurements_trace(
            torch.Generator().manual_seed(TRACE_SEED), ch.h_matrix,
            list(TRACE_M), sim), ("fused_infer_admm",))
    for i, m in enumerate(TRACE_M):
        print(f"[8 trace] M {m}: NMSE dB " + " | ".join(
            f"{k} {10 * np.log10(v[i]):.2f}" for k, v in res.nmse.items())
            + " | seconds " + " | ".join(
                f"{k} {v[i]:.2f}" for k, v in res.seconds.items()),
            flush=True)
    print(f"[8 trace] sweep_measurements_trace {NT}x{NR}, {TRACE_COUNT} "
          f"traces (magnitude-normalized), Random_Phase_State, SNR 20: "
          f"{wall:.1f} s | launches {counts}", flush=True)
    return counts


def window_fit(est, rows, amps):
    """``||s |A x| - b|| / ||b||`` of an (nr, nt) window estimate on its
    rows, s the least-squares scale, in float64 on the host."""
    x = torch.as_tensor(est.T.reshape(-1)).to(torch.complex128)
    y = (rows.cpu().to(torch.complex128) @ x).abs()
    b = amps.cpu().to(torch.float64)
    s = (y @ b) / torch.clamp(y @ y, min=1e-300)
    return float(torch.linalg.vector_norm(s * y - b)
                 / torch.linalg.vector_norm(b))


def phase8_windows():
    """infer_channel_windows on phase 6's probe rows and amplitudes: the
    WINDOWS windows of WINDOW rows held by their fit, then one window of
    WINDOW_WELL rows held against the same call on the CPU."""
    cb, x_true, rss, _ = campaign_workload()
    amps = dbm_to_amplitude(torch.as_tensor(rss, device=cb.device),
                            recovery.CampaignConfig().rss_fct)
    cfg = ArrayConfig(nt=NT, nr=NR)

    def windows(cb, amps, window, n_windows):
        return simulation.infer_channel_windows(
            torch.Generator().manual_seed(0), cb, amps, cfg, window=window,
            n_windows=n_windows)

    ests, wall, counts = timed_launches(
        lambda: windows(cb, amps, WINDOW, WINDOWS))
    require_launched(counts, ("fused_prox_dual",), "the windowed inference")
    if ests.shape != (WINDOWS, NR, NT) or not np.isfinite(ests).all():
        raise RuntimeError(f"infer_channel_windows: shape {ests.shape} or "
                           "a non-finite estimate")
    x_np = x_true.cpu().numpy()
    dbs = [round(proj_nmse_db(e.T.reshape(-1), x_np), 2) for e in ests]
    fits = [round(window_fit(e, cb[i * WINDOW:(i + 1) * WINDOW],
                             amps[i * WINDOW:(i + 1) * WINDOW]), 4)
            for i, e in enumerate(ests)]
    print(f"[8 windows] infer_channel_windows {NT}x{NR}, {WINDOWS} windows "
          f"of {WINDOW} of phase 6's probe rows: {1e3 * wall / WINDOWS:.1f}"
          f" ms per window | NMSE dB against phase 6's channel {dbs} | fit "
          f"{fits} (max {WINDOW_FIT_MAX}) | launches {counts}", flush=True)
    t0 = time.perf_counter()
    well = windows(cb, amps, WINDOW_WELL, 1)[0]
    sec = time.perf_counter() - t0
    well_cpu = windows(cb.cpu(), amps.cpu(), WINDOW_WELL, 1)[0]
    dist = aligned_dist(torch.as_tensor(well), torch.as_tensor(well_cpu))
    db = proj_nmse_db(well.T.reshape(-1), x_np)
    print(f"[8 windows] one window of {WINDOW_WELL} rows: {sec:.2f} s | "
          f"NMSE {db:.2f} dB (max {WINDOW_WELL_DB}) | card vs CPU, "
          f"phase-aligned, {dist:.3e} (tol {WINDOW_WELL_TOL})", flush=True)
    if not (max(fits) <= WINDOW_FIT_MAX and dist <= WINDOW_WELL_TOL
            and db <= WINDOW_WELL_DB):
        raise RuntimeError(f"infer_channel_windows: fits {fits}, the "
                           f"{WINDOW_WELL}-row window {db:.2f} dB, card vs "
                           f"CPU {dist:.3e}")
    return counts


def phase8_lifted():
    """The testbed campaign's lifted entries on phase 6's workload:
    recover_phaselift's flags at M 1024, recover_directional (2.9 mm, 180
    degrees) over the probe-budget grid from DIRECTIONAL_FROM."""
    cb, x_true, rss, _ = campaign_workload()
    x_np = x_true.cpu().numpy()
    cc = recovery.CampaignConfig(array=ArrayConfig(nt=NT, nr=NR))
    out, wall, counts = timed_launches(
        lambda: recovery.recover_campaign(
            cb, rss, MethodFlags(admm_lowrank_v4=False, phaselift=True), cc,
            m_grid=(M,)))
    est = campaign_estimate(out, 0)
    if not np.isfinite(est).all() or not np.abs(est).max() > 0:
        raise RuntimeError("recover_phaselift: a zero or non-finite "
                           "estimate")
    print(f"[8 lifted] recover_phaselift's flags at M {M} (n {N}, 4000 "
          f"FISTA trips, each a {N}x{N} eigh): {wall:.2f} s | NMSE "
          f"{proj_nmse_db(est, x_np):.2f} dB", flush=True)
    grid = tuple(m for m in probe_budget_grid(NT, NR)
                 if m >= DIRECTIONAL_FROM)
    cc = recovery.CampaignConfig(array=ArrayConfig(nt=NT, nr=NR,
                                                   spacing=2.9e-3),
                                 searching_area_deg=180.0)
    totals = dict(counts)
    for m in grid:
        out, wall, counts = timed_launches(
            lambda: recovery.recover_campaign(
                cb, rss, MethodFlags(admm_lowrank_v4=False, plomp=True,
                                     plgamp=True), cc, m_grid=(m,)))
        for k, v in counts.items():
            totals[k] += v
        dbs = {}
        for j, name in enumerate(out.methods):
            e = out.h_amp[0, j] * np.exp(1j * out.h_angle[0, j])
            if not np.isfinite(e).all():
                raise RuntimeError(f"recover_directional M {m}: {name} "
                                   "is not finite")
            dbs[name] = round(proj_nmse_db(e, x_np), 2)
        print(f"[8 lifted] recover_directional M {m}: {wall:.2f} s | NMSE "
              f"dB {dbs}", flush=True)
    return totals


def aligned_dist(x, ref):
    """The phase-aligned relative distance min over phi of
    ||x e^(i phi) - ref|| / ||ref||, in complex128 on the host (||x|| where
    ref is zero)."""
    x = x.detach().reshape(-1).cpu().to(torch.complex128)
    ref = ref.detach().reshape(-1).cpu().to(torch.complex128)
    norm = float(torch.linalg.vector_norm(ref))
    if norm == 0.0:
        return float(torch.linalg.vector_norm(x))
    c = torch.vdot(x, ref)
    phase = c / c.abs() if float(c.abs()) > 0 else 1.0
    return float(torch.linalg.vector_norm(x * phase - ref)) / norm


def baseline_calls(snr_db, n_p):
    """The direct calls of ``[8 baselines]``, each ``(a, b2, y, fw) ->
    (n,) complex estimate`` on the first trial's measurement matrix,
    intensities, perfect-phase measurements and sensing rows."""
    from twoace_tpu_torch.ops import cpr_baselines, gamp
    from twoace_tpu_torch.ops.phaselift import phaselift_bm_pair

    def bm_pair(a, b2, y, fw):
        res = phaselift_bm_pair(None, Pair(fw.real.contiguous(),
                                           fw.imag.contiguous()), b2)
        return torch.complex(res.x_re, res.x_im)

    return {
        "recover_sparse(phaselift=True)": lambda a, b2, y, fw:
            dispatch.recover_sparse(None, b2, a, MethodFlags(
                admm_lowrank_v4=False, phaselift=True), 1)["phaselift"],
        "cprl": lambda a, b2, y, fw: cpr_baselines.cprl(b2, a),
        "prgamp": lambda a, b2, y, fw: gamp.prgamp(torch.sqrt(b2), a),
        "sparse_phaselift": lambda a, b2, y, fw:
            cpr_baselines.sparse_phaselift(b2, a),
        "vamp_cs": lambda a, b2, y, fw: gamp.vamp_cs(y, a, snr_db, 1 / n_p),
        "lifted_omp": lambda a, b2, y, fw: cpr_baselines.lifted_omp(b2, a, 1),
        "unconventional_cs": lambda a, b2, y, fw:
            cpr_baselines.unconventional_cs(y, a.T),
        "phaselift_bm_pair": bm_pair}


def phase8_baselines():
    """One VS_SR cell with CPRL, PRGAMP and SparsePL; then one direct call
    of each new baseline on that cell's first trial (``draw_cell``), held
    against the same call on the CPU on the same inputs, and the metrics
    and the sector sweep, held likewise."""
    from twoace_tpu_torch.ops import beamsweep
    from twoace_tpu_torch.utils import metrics

    gen = torch.Generator().manual_seed(VSSR_SEED)
    sim = vssr_config(BASE_TRIALS, BASE_G, ("cprl", "prgamp", "sparse_pl"))
    res, wall, counts = run_sweep(
        "the baselines' cell", lambda: simulation.sweep_measurements(
            gen, [BASE_M], sim, BASE_RANGE), ())
    print(f"[8 baselines] sweep_measurements {VSSR_NT}x{VSSR_NT}, range "
          f"{BASE_RANGE:.0f}, G {BASE_G}, Mt = Mr = {BASE_M}, {BASE_TRIALS} "
          f"trials: {wall:.2f} s | NMSE dB " + " | ".join(
              f"{k} {10 * np.log10(v[0]):.2f}" for k, v in res.nmse.items())
          + " | MAEE deg " + " | ".join(
              f"{k} {v[0]:.2f}" for k, v in res.aoda_err.items())
          + " | seconds " + " | ".join(
              f"{k} {v[0]:.2f}" for k, v in res.seconds.items()), flush=True)

    # the sweep's cell 0 draws from fold_in(gen, 0)
    cfg = sim.array
    ch, rep, sensing, meas = simulation.draw_cell(
        fold_in(gen, 0), sim, BASE_M, BASE_M, BASE_RANGE, "cuda")
    inputs = (sensing.measurement_mat[0], meas.norm_square[0],
              meas.perfect_phase[0], sensing.fw[0])
    vec_h = ch.vec_h[0]
    n_p = inputs[0].shape[1]

    def db_of(v):
        v = v @ rep.ad.T.to(v.dtype) if v.shape[-1] == n_p else v
        return float(10 * torch.log10(nmse_h_projection(
            v, vec_h.to(v.dtype))))

    def run(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def wide(t):
        return t.to(torch.complex128 if t.is_complex() else torch.float64)

    failures, ests = [], {}
    for label, fn in baseline_calls(sim.snr_db, n_p).items():
        est, sec = run(lambda: fn(*inputs))
        host = fn(*(t.cpu() for t in inputs))
        d64 = aligned_dist(est, host)
        d128 = aligned_dist(fn(*(wide(t) for t in inputs)),
                            fn(*(wide(t).cpu() for t in inputs)))
        tol = BASE_NONSMOOTH_TOL if label in BASE_NONSMOOTH \
            else BASE_C128_RTOL
        db = db_of(est)
        print(f"[8 baselines] {label}: {sec:.3f} s | NMSE {db:.2f} dB | card "
              f"vs CPU, phase-aligned: complex64 {d64:.3e} (tol "
              f"{BASE_C64_TOL}), complex128 {d128:.3e} (tol {tol})",
              flush=True)
        if not (np.isfinite(db) and float(est.abs().max()) > 0
                and d64 <= BASE_C64_TOL and d128 <= tol):
            failures.append(f"{label}: NMSE {db}, card vs CPU {d64:.3e} / "
                            f"{d128:.3e}")
        ests[label] = est

    z_pl, x_bm = ests["recover_sparse(phaselift=True)"], \
        ests["phaselift_bm_pair"]
    aod, aoa = metrics.angles_from_sparse(z_pl[None], cfg, rep.tx_window,
                                          rep.rx_window, 1)
    true_aod, true_aoa = ch.aod_deg[:1], ch.aoa_deg[:1]
    arm, sec = run(lambda: metrics.array_response_mse(
        aod, aoa, true_aod.to(aod.dtype), true_aoa.to(aoa.dtype), cfg))
    arm_cpu = metrics.array_response_mse(
        aod.cpu(), aoa.cpu(), true_aod.cpu().to(aod.dtype),
        true_aoa.cpu().to(aoa.dtype), cfg)
    h_true = ch.h_matrix[0]
    gains, sec_bf = run(lambda: metrics.beamforming_gain(x_bm, h_true, cfg))
    gains_cpu = metrics.beamforming_gain(x_bm.cpu(), h_true.cpu(), cfg)
    ideal = metrics.beamforming_gain(vec_h, h_true, cfg)[1]
    arm, arm_cpu = float(arm[0]), float(arm_cpu[0])
    dig, dig_cpu = float(gains[1]), float(gains_cpu[1])
    print(f"[8 baselines] array_response_mse of the z-domain PhaseLift's "
          f"angles: {arm:.6f} (CPU {arm_cpu:.6f}; {sec:.3f} s) | "
          f"beamforming_gain of phaselift_bm_pair's estimate ({sec_bf:.3f} "
          f"s): digital {dig:.4f} (CPU {dig_cpu:.4f}, the true channel's "
          f"{float(ideal):.4f}), analog {float(gains[0]):.4f} (CPU "
          f"{float(gains_cpu[0]):.4f}; follows the SVD's phase "
          f"convention)", flush=True)
    if not (abs(arm - arm_cpu) <= BF_RTOL * abs(arm_cpu)
            and abs(dig - dig_cpu) <= BF_RTOL * abs(dig_cpu)):
        failures.append(f"array_response_mse {arm} vs CPU {arm_cpu}, "
                        f"digital gain {dig} vs CPU {dig_cpu}")

    vh3 = generate_channel(torch.Generator().manual_seed(TRACE_SEED),
                           ArrayConfig(nt=NT, nr=NR), ChannelConfig(n_paths=3),
                           device="cuda")

    def sweep(vec_h):
        return beamsweep.sweep_channel(
            torch.Generator().manual_seed(0), vec_h,
            ArrayConfig(nt=NT, nr=NR), NT, NR, (-47.5, 47.5), (-47.5, 47.5),
            snr_db=20.0)

    sw, sec = run(lambda: sweep(vh3.vec_h[0]))
    sw_cpu = sweep(vh3.vec_h[0].cpu())
    angles = (float(sw.aod_deg), float(sw.aoa_deg))
    angles_cpu = (float(sw_cpu.aod_deg), float(sw_cpu.aoa_deg))
    aod_err = float(torch.min(torch.abs(vh3.aod_deg[0] - sw.aod_deg)))
    aoa_err = float(torch.min(torch.abs(vh3.aoa_deg[0] - sw.aoa_deg)))
    print(f"[8 baselines] sweep_channel {NT}x{NR}, 3 paths, {NT}x{NR} "
          f"beams, SNR 20: {sec:.3f} s | AoD {angles[0]:.2f} / AoA "
          f"{angles[1]:.2f} deg (CPU {angles_cpu[0]:.2f} / "
          f"{angles_cpu[1]:.2f}), nearest path {aod_err:.2f} / "
          f"{aoa_err:.2f} deg off", flush=True)
    if not max(abs(g - c) for g, c in zip(angles, angles_cpu)) \
            <= SWEEP_ANGLE_TOL:
        failures.append(f"sweep_channel angles {angles} vs CPU {angles_cpu}")
    if failures:
        raise RuntimeError("baselines disagree with the CPU: "
                           + "; ".join(failures))
    return counts


def phase8_new_paths(vssr_cpu=None):
    """Phase 8: the paths of the VS_SR campaign, the trace and windowed
    simulations, the lifted testbed entries and the baselines
    (``vssr_cpu``: see :func:`phase8_vssr`)."""
    totals = {}
    for part, args in ((phase8_vssr, (vssr_cpu,)), (phase8_trace, ()),
                       (phase8_windows, ()), (phase8_lifted, ()),
                       (phase8_baselines, ())):
        t0 = time.perf_counter()
        counts = part(*args)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        print(f"[8 time] {part.__name__} {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"[8 launches] K3 {totals['fused_infer_admm']}, K5 "
          f"{totals['fused_prox_dual']} | {totals}", flush=True)
    return totals


def sense_config():
    """Phase 9's sensing cell: 16x16 over VSM_AREA, its angle dictionary
    on the CPU."""
    cfg = ArrayConfig(nt=NT, nr=NR)
    half = VSM_AREA / 2
    ad = angle_dictionary(cfg, VSM_AREA, device="cpu")
    return cfg, ad, (-half, half)


def bayes_cpu(queue):
    """In a child process: ``Random_Beam_Bayes`` at phase 9's cell on the
    CPU (the same host draws as the card's call); puts the A-criterion of
    its rows and its seconds (or the error) on ``queue``."""
    torch.set_num_threads(BAYES_CPU_THREADS)
    try:
        cfg, ad, rng = sense_config()
        t0 = time.perf_counter()
        sm = generate_sensing_matrix(
            torch.Generator().manual_seed(SENSE_SEED), "Random_Beam_Bayes",
            SENSE_M, SENSE_M, cfg, ad, rng, rng, batch=SENSE_BATCH)
        queue.put((a_criterion(sm.fw[0]), time.perf_counter() - t0))
    except BaseException as e:
        queue.put(repr(e))
        raise


def start_bayes_cpu():
    """Start :func:`bayes_cpu` in a (daemonic) child process; returns the
    process and its queue."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=bayes_cpu, args=(queue,), daemon=True)
    proc.start()
    return proc, queue


def check_beams(label, sm, cfg):
    """Quantized beams: unit-modulus 2-bit rows (|F| = 1/sqrt(nt), |W| =
    1/sqrt(nr), phases on the pi/2 grid) and FW = kron(F^T, W^H)."""
    for name, mat, n_ant in (("F", sm.f, cfg.nt), ("W", sm.w[0], cfg.nr)):
        mag = (mat.abs() * np.sqrt(n_ant) - 1).abs().max()
        q = torch.angle(mat) / (np.pi / 2)
        if float(mag) > 1e-5 or float((q - q.round()).abs().max()) > 1e-4:
            raise RuntimeError(f"{label}: {name} is not unit-modulus 2-bit")


def phase9_sensing(bayes):
    """The four sensing modes ported last, at 16x16, Mt = Mr = 32 (M
    1024), batch 4, on the card and on the CPU; the Bayes selections at
    C 4096 (Random_Beam_Bayes) and 40000 (pick_beams' Bayes_Beam)."""
    cfg, ad, rng = sense_config()
    ad_dev = ad.cuda()
    for mode in ("Directional_Beam", "Directional_Random_Beam",
                 "Region_Random_Beam"):
        t0 = time.perf_counter()
        got = generate_sensing_matrix(
            torch.Generator().manual_seed(SENSE_SEED), mode, SENSE_M,
            SENSE_M, cfg, ad_dev, rng, rng, batch=SENSE_BATCH)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        want = generate_sensing_matrix(
            torch.Generator().manual_seed(SENSE_SEED), mode, SENSE_M,
            SENSE_M, cfg, ad, rng, rng, batch=SENSE_BATCH)
        check_beams(mode, got, cfg)
        same = all(torch.equal(getattr(got, f).cpu(), getattr(want, f))
                   for f in ("f", "w", "fw"))
        err = float((got.measurement_mat.cpu() - want.measurement_mat)
                    .abs().max() / want.measurement_mat.abs().max())
        if not same or not err <= 1e-5:
            raise RuntimeError(f"{mode}: card against CPU: beams equal "
                               f"{same}, measurement matrix {err:.3e}")
        print(f"[9 sensing] {mode} M {SENSE_M ** 2} batch {SENSE_BATCH}: "
              f"{sec:.3f} s | F, W, FW equal to the CPU's | measurement "
              f"matrix {err:.3e} from the CPU's (tol 1e-5)", flush=True)

    n_cand = max(4 * SENSE_M ** 2, 256)
    gen = torch.Generator().manual_seed(SENSE_SEED)
    cand = random_sensing_rows(gen, n_cand, N, device="cpu")
    init = torch.randint(0, n_cand, (SENSE_M ** 2,),
                         generator=fold_in(gen, 1))
    crit0 = a_criterion(cand[init])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = generate_sensing_matrix(
        torch.Generator().manual_seed(SENSE_SEED), "Random_Beam_Bayes",
        SENSE_M, SENSE_M, cfg, ad_dev, rng, rng, batch=SENSE_BATCH)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    rows = got.fw[0]
    q = torch.angle(rows) / (np.pi / 2)
    if (float((rows.abs() * np.sqrt(N) - 1).abs().max()) > 1e-5
            or float((q - q.round()).abs().max()) > 1e-4):
        raise RuntimeError("Random_Beam_Bayes: rows not unit-modulus 2-bit")
    crit = a_criterion(rows)
    proc, queue = bayes
    t_wait = time.perf_counter()
    cpu = queue.get(timeout=900)
    proc.join(timeout=60)
    if isinstance(cpu, str):
        raise RuntimeError(f"Random_Beam_Bayes on the CPU failed: {cpu}")
    crit_cpu, sec_cpu = cpu
    rel = abs(crit - crit_cpu) / crit_cpu
    print(f"[9 bayes] Random_Beam_Bayes 16x16 M {SENSE_M ** 2}, C {n_cand}, "
          f"{2 * SENSE_M ** 2} exchange steps: card {sec:.3f} s (CPU child "
          f"{sec_cpu:.1f} s at {BAYES_CPU_THREADS} threads; waited "
          f"{time.perf_counter() - t_wait:.1f} s) | A-criterion card "
          f"{crit:.6f}, CPU {crit_cpu:.6f} ({rel:.3e} apart, tol "
          f"{BAYES_RTOL}), initial design {crit0:.6f}", flush=True)
    if not (rel <= BAYES_RTOL and crit < crit0 and crit_cpu < crit0):
        raise RuntimeError("Random_Beam_Bayes: the card's criterion is not "
                           "the CPU's, or a selection does not beat its "
                           "initial design")

    gen = torch.Generator().manual_seed(BAYES_SEED)
    cb = random_sensing_rows(gen, BAYES_ROWS, N, device="cuda")
    g_pick = torch.Generator().manual_seed(BAYES_SEED + 1)
    cand_idx = torch.randint(0, BAYES_ROWS, (min(BAYES_ROWS, 40000),),
                             generator=torch.Generator().manual_seed(
                                 BAYES_SEED + 1))
    init = torch.randint(0, len(cand_idx), (M,),
                         generator=fold_in(g_pick, 1))
    crit0 = a_criterion(cb[cand_idx[init].cuda()])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = pick_beams(g_pick, "Bayes_Beam", M, cb)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    crit = a_criterion(cb[idx])
    steps = 2 * M
    tflop = steps * 8 * N * N * len(cand_idx) / 1e12
    print(f"[9 bayes] pick_beams Bayes_Beam over {BAYES_ROWS} random 2-bit "
          f"rows, M {M}, C {len(cand_idx)}, {steps} exchange steps: "
          f"{sec:.3f} s ({tflop:.1f} TFLOP of (256 x 256) @ (256 x C) "
          f"complex64 products, {tflop / sec:.1f} TFLOP/s) | A-criterion "
          f"{crit:.6f}, initial design {crit0:.6f}", flush=True)
    if not crit < crit0:
        raise RuntimeError("Bayes_Beam: the selection does not beat its "
                           "initial design")


def phase9_testbed(bayes):
    """Phase 9: the testbed driver on the card.  The sensing modes and
    Bayes selections (:func:`phase9_sensing`); one Z-free
    ``infer_admm_pair`` (K4, K1, no K2); ``TestbedRunner`` at
    TestbedConfig's defaults (16x16) on phase 6's channel through
    ``SyntheticProvider``: its five campaigns, ``estimate("random",
    "a2only")`` over the probe-budget grid (phase 6's checks and lines:
    K5 on every point), ``beamforming_comparison`` and
    ``evaluate_codebook_rss``; a second runner resuming the random
    campaign from the first's checkpoints; the first TCP_ROUNDS random
    rounds through ``TcpProvider`` and ``native/rss_server``.  The CLI's
    testbed command, on the card and with CUDA hidden, runs in two
    subprocesses once the grid is timed, beside the steps after it."""
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    phase9_sensing(bayes)
    add(phase9_zfree())
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    procs = {}

    def start_cli():
        procs["t0"] = time.perf_counter()
        for name, extra in (("cli", {}), ("hidden",
                                          {"CUDA_VISIBLE_DEVICES": ""})):
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "twoace_tpu_torch", *CLI_ARGS],
                cwd=root, env=dict(env, **extra), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)

    try:
        add(phase9_runner(start_cli))
        out, err = procs["cli"].communicate(timeout=CLI_TIMEOUT)
        sec = time.perf_counter() - procs["t0"]
        _, hidden_err = procs["hidden"].communicate(timeout=CLI_TIMEOUT)
    finally:
        for proc in (procs.get("cli"), procs.get("hidden")):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    if procs["cli"].returncode != 0:
        raise RuntimeError(f"the CLI exited {procs['cli'].returncode}: "
                           f"{err[-2000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    db = res["nmse_db_final"]
    print(f"[9 cli] python -m twoace_tpu_torch {' '.join(CLI_ARGS)}: exit 0 "
          f"after {sec:.1f} s (started after the grid) | {json.dumps(res)}",
          flush=True)
    if db is None or not (np.isfinite(db) and db < CLI_NMSE_DB):
        raise RuntimeError(f"the CLI's nmse_db_final {db} is not below "
                           f"{CLI_NMSE_DB} dB")
    hidden = procs["hidden"].returncode
    last = (hidden_err.strip().splitlines() or [""])[-1]
    print(f"[9 cli] with CUDA hidden: exit {hidden} | {last}", flush=True)
    if hidden == 0:
        raise RuntimeError("the CLI exited 0 with CUDA hidden")
    return totals


def phase9_runner(after_grid):
    """``TestbedRunner`` on phase 6's channel (see
    :func:`phase9_testbed`); calls ``after_grid()`` once the estimation
    grid is timed."""
    cb6, x_true, _, _ = campaign_workload()
    x_np = x_true.cpu().numpy()
    cfg = ArrayConfig(nt=NT, nr=NR)
    totals = {}
    os.makedirs(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "_scratch")) as ckpt:
        tcfg = TestbedConfig(array=cfg, checkpoint_dir=ckpt)
        prov = SyntheticProvider(vec_h=x_true, generator=fold_in(
            torch.Generator().manual_seed(CAMPAIGN_SEED), 3))
        runner = TestbedRunner(tcfg, prov, generator=torch.Generator()
                               .manual_seed(CAMPAIGN_SEED))
        aco = None
        for name, run in (("sweeps", runner.run_sweep_campaigns),
                          ("directional", runner.run_directional_campaign),
                          ("random", runner.run_random_campaign),
                          ("aco", runner.collect_aco),
                          ("multires", runner.run_multires_campaign)):
            calls = prov._calls
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            if name == "aco":
                aco = out
                print(f"[9 campaign] aco: {prov._calls - calls} probes, one "
                      f"call each: {sec:.3f} s | wt bits "
                      f"{out[0].tolist()} | wr bits {out[1].tolist()}",
                      flush=True)
                continue
            keys = {"sweeps": ("theta_phi", "phi")}.get(name, (name,))
            for key in keys:
                res = runner.results[key]
                if not np.isfinite(res["rss_dbm"]).all():
                    raise RuntimeError(f"campaign {key}: non-finite RSS")
            rows = {k: tuple(runner.results[k]["rows"].shape) for k in keys}
            print(f"[9 campaign] {name}: rows {rows}, {prov._calls - calls} "
                  f"provider calls: {sec:.3f} s", flush=True)
        random = runner.results["random"]
        if not torch.equal(random["rows"], cb6):
            raise RuntimeError("the runner's random rows are not phase 6's")

        grid = probe_budget_grid(NT, NR)
        out, calls, wall, counts = run_campaign(
            "TestbedRunner.estimate", lambda: runner.estimate(
                "random", "a2only"))
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        if len(calls) != len(grid):
            raise RuntimeError(f"estimate ran {len(calls)} solves for "
                               f"{len(grid)} grid points")
        for i, (m_cur, call) in enumerate(zip(grid, calls)):
            db = proj_nmse_db(campaign_estimate(out, i), x_np)
            if not np.isfinite(out.h_amp[i]).all() or call["k5"] <= 0:
                raise RuntimeError(f"estimate M {m_cur}: non-finite "
                                   f"estimate or no K5 launch")
            print(f"[9 a2only] M {m_cur}: {call['s']:.3f} s | trips "
                  f"{call['trips']} | K5 launches {call['k5']} | quality "
                  f"{call['quality']:.6f} | NMSE {db:.2f} dB", flush=True)
        print(f"[9 a2only] TestbedRunner.estimate('random', 'a2only') "
              f"{NT}x{NR}, {len(random['rss_dbm'])} probe rows, grid {grid}: "
              f"{wall:.2f} s | trips {admm.infer_admm.trips} | launches "
              f"{counts}", flush=True)
        after_grid()

        est = torch.as_tensor(campaign_estimate(out, len(grid) - 1))
        x_c = x_true.to(torch.complex128)
        bf = runner.beamforming_comparison({"a2only": est, "true": x_c})
        rss, tx_bits, _ = runner.evaluate_codebook_rss(
            torch.stack([est, x_c.cpu()]), aco_bits=aco)
        print(f"[9 beams] beamforming_comparison (dBm): a2only "
              f"{bf['a2only']:.4f}, true channel {bf['true']:.4f} | "
              f"evaluation codebook, {len(rss)} beams (2 SVD, ACO, "
              f"{len(rss) - 3} probes): a2only {rss[0]:.4f}, true "
              f"{rss[1]:.4f}, ACO {rss[2]:.4f}, probes median "
              f"{np.median(rss[3:]):.4f} dBm", flush=True)
        if not (np.isfinite(rss).all() and tx_bits.shape == (len(rss), NT)
                and bf["a2only"] >= bf["true"] - BF_DB_GAP
                and rss[0] >= rss[1] - BF_DB_GAP):
            raise RuntimeError(f"the estimate's SVD beam is more than "
                               f"{BF_DB_GAP} dB below the true channel's")

        prov2 = SyntheticProvider(vec_h=x_true, generator=torch.Generator()
                                  .manual_seed(CAMPAIGN_SEED + 1))
        t0 = time.perf_counter()
        again = TestbedRunner(tcfg, prov2, generator=torch.Generator()
                              .manual_seed(CAMPAIGN_SEED)
                              ).run_random_campaign().results["random"]
        sec = time.perf_counter() - t0
        same = np.array_equal(again["rss_dbm"], random["rss_dbm"])
        print(f"[9 resume] a second runner on the same checkpoint_dir: "
              f"random campaign {sec:.3f} s, {prov2._calls} provider calls, "
              f"RSS bit-identical {same}", flush=True)
        if prov2._calls != 0 or not same \
                or not torch.equal(again["rows"], random["rows"]):
            raise RuntimeError("the resumed campaign is not the stored one")

    from twoace_tpu_torch.sensing.tcp_provider import (ServerProcess,
                                                       TcpProvider,
                                                       build_server)
    t0 = time.perf_counter()
    build_server()
    t_build = time.perf_counter() - t0
    with ServerProcess() as srv:
        tcp = TcpProvider(port=srv.port)
        try:
            tcp.set_channel(x_true)
            tcp.set_noise(0.0)
            t0 = time.perf_counter()
            part = TestbedRunner(
                TestbedConfig(array=cfg, n_random_rounds=TCP_ROUNDS), tcp,
                generator=torch.Generator().manual_seed(CAMPAIGN_SEED)
            ).run_random_campaign().results["random"]
            sec = time.perf_counter() - t0
        finally:
            tcp.close()
    clean = SyntheticProvider(vec_h=x_true, noise_dbm_std=0.0,
                              quantize_rssi=False).measure(part["rows"])
    want = np.clip(clean, RSSI_OFFSET, RSSI_OFFSET + 1000 * RSSI_SLOPE)
    err = float(np.abs(part["rss_dbm"] - want).max())
    rows_same = torch.equal(part["rows"],
                            random["rows"].reshape(CAMPAIGN_SECTORS,
                                                   CAMPAIGN_ROUNDS, N)
                            [:, :TCP_ROUNDS].reshape(-1, N))
    print(f"[9 tcp] native/rss_server built in {t_build:.2f} s; "
          f"TcpProvider, random rounds 0-{TCP_ROUNDS - 1} "
          f"({len(part['rss_dbm'])} rows, the first runner's rows "
          f"{rows_same}): {sec:.3f} s | max |RSS - noiseless| {err:.4f} dB "
          f"(tol {TCP_ATOL:.4f})", flush=True)
    if not (rows_same and err <= TCP_ATOL):
        raise RuntimeError("the TCP rounds do not hold")
    return totals


def zfree_inputs(device="cuda", dtype=torch.float32):
    """Phase 9's Z-free solve: a (1, 1024, 256) codebook block, the b of
    ZFREE_LANES of phase 3's channels and a spectral init (drawn on the
    CPU in float32), on ``device`` in ``dtype``."""
    a, b, _ = build_solve_problem(batch=ZFREE_LANES)
    a_cpu = interop.pair_from_numpy(a[None], None, device="cpu")
    b_cpu = torch.tensor(b[None], dtype=torch.float32)
    x0 = pair_solver.spectral_initialize_pair(
        a_cpu, b_cpu, R, torch.Generator().manual_seed(0))
    return tuple(Pair(p.re.to(device, dtype), p.im.to(device, dtype))
                 if isinstance(p, Pair) else p.to(device, dtype)
                 for p in (a_cpu, b_cpu, x0))


def zfree_dist(x, ref):
    """Max over lanes of |P - P_ref| / max |P_ref|, P = sum_k x_k x_k^H the
    (r, n) iterate's Gram, which no gauge of the fit (a unitary mix of
    its rows) moves."""
    def gram(p):
        z = torch.complex(p.re.double(), p.im.double()).cpu()
        return z.mT @ z.conj()
    g, g_ref = gram(x), gram(ref)
    return float(((g - g_ref).abs().amax(dim=(-2, -1))
                  / g_ref.abs().amax(dim=(-2, -1))).max())


def phase9_zfree():
    """One Z-free ``infer_admm_pair`` (no ladder: K4 and K1, no Z-prox) at
    16x16, m 1024, ZFREE_LANES lanes, on the card and on the CPU."""
    kw = dict(scale_by_row=True, nt=NT, nr=NR, maxiter=500)
    args = zfree_inputs()
    pair_solver.infer_admm_pair(*args, **kw)               # warm-up
    reset_launch_counts()
    t0 = time.perf_counter()
    x, _, conv, it = pair_solver.infer_admm_pair(*args, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = launch_counts()
    require_launched(counts, ("pair_matmul", "fused_prox_dual_t"),
                     "the Z-free infer_admm_pair")
    x_c, _, _, it_c = pair_solver.infer_admm_pair(*zfree_inputs("cpu"), **kw)
    dist = zfree_dist(x, x_c)
    print(f"[9 zfree] infer_admm_pair without a ladder, 16x16, m {M}, "
          f"{ZFREE_LANES} lanes, r {R}: {sec:.3f} s | trips "
          f"{it.flatten().tolist()} (CPU {it_c.flatten().tolist()}) | "
          f"converged {conv.flatten().tolist()} | Gram {dist:.3e} from the "
          f"CPU's (tol {ZFREE_RTOL}) | launches {counts}", flush=True)
    if not (dist <= ZFREE_RTOL and counts["fused_zprox_t"] == 0):
        raise RuntimeError("the Z-free branch: card against CPU "
                           f"{dist:.3e}, or K2 launched")
    return counts


def sharded_solves(mesh, go=None):
    """Phase 10's two solves on this rank of ``mesh``: the production
    scaffold ``solve_lowrank_multi_sharded_pair`` (K4, K1, K2), then the
    complex twin ``solve_lowrank_sharded`` (K5), each with the launch
    counts set to 0 just before it and read just after.  With ``go`` (an
    event), the problem is built and moved to the card first, and the
    solves wait for the event.  Returns per solve its seconds, launches,
    loop trips, all-reduces, iters, quality and each local instance's
    NMSE (picklable)."""
    a, b, x_true = build_solve_problem(batch=SHARDED_BATCH)
    ac = torch.tensor(np.broadcast_to(a, (SHARDED_BATCH,) + a.shape),
                      dtype=torch.complex64)
    ac, bl = (t.to(mesh.device) for t in problem_sharding(
        mesh, ac, torch.tensor(b, dtype=torch.float32)))
    ap = Pair(ac.real.contiguous(), ac.imag.contiguous())
    b0 = mesh.coords[0] * ac.shape[0]
    x_loc = torch.as_tensor(x_true[b0:b0 + ac.shape[0]])
    torch.cuda.synchronize()
    if go is not None and not go.wait(SHARDED_TIMEOUT):
        raise RuntimeError(f"no go within {SHARDED_TIMEOUT} s")
    runs = (("pair", lambda: solve_lowrank_multi_sharded_pair(
                mesh, torch.Generator().manual_seed(0), ap, bl, NT, NR,
                SHARDED_CFG)),
            ("complex", lambda: solve_lowrank_sharded(
                mesh, ac[:SHARDED_COMPLEX_BATCH], bl[:SHARDED_COMPLEX_BATCH],
                NT, NR, SHARDED_CFG)))
    out = dict(coords=mesh.coords)
    for name, solve in runs:
        mesh.reduce.calls = mesh.reduce.trips = 0
        admm.infer_admm.trips = 0
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = launch_counts()
        x = torch.complex(res.x.re, res.x.im) if name == "pair" else res
        x = x.to(torch.complex128).cpu()
        if not bool(torch.isfinite(torch.view_as_real(x)).all()):
            raise RuntimeError(f"phase 10 {name}: non-finite recovery")
        db = 10 * torch.log10(torch.clamp(nmse_h_projection(
            x, x_loc[:len(x)]), min=1e-30))
        out[name] = dict(
            s=sec, launches=counts, trips=mesh.reduce.trips,
            calls=mesh.reduce.calls, db=db.tolist(),
            iters=(res.iters.tolist() if name == "pair"
                   else admm.infer_admm.trips),
            quality=res.quality.tolist() if name == "pair" else None)
    return out


def sharded_rank(rank, world, go):
    """Run (ii)'s ranks: ``sharded_solves`` on a (1, world) mesh of ranks
    sharing this card over gloo, once ``go`` is set."""
    _build.library()
    return sharded_solves(make_mesh(batch=1, rows=world, device="cuda"), go)


def report_sharded(label, res):
    """Print and check one rank's phase-10 solves; returns its launches."""
    totals = {}
    for name in ("pair", "complex"):
        r = res[name]
        need = (("pair_matmul", "fused_prox_dual_t", "fused_zprox_t")
                if name == "pair" else ("fused_prox_dual",))
        print(f"[10 {name}] {label}, rank {res['coords']}: {r['s']:.3f} s | "
              f"loop trips {r['trips']}, iters {r['iters']} | all-reduces "
              f"{r['calls']} ({r['calls'] / max(r['trips'], 1):.3f} a trip) "
              f"| NMSE {[round(v, 2) for v in r['db']]} dB | quality "
              f"{r['quality']} | launches {r['launches']}", flush=True)
        require_launched(r["launches"], need, f"{label}'s {name} solve")
        if r["launches"]["fused_infer_admm"]:
            raise RuntimeError(f"{label}'s {name} solve launched K3")
        if name == "pair" and (np.median(r["db"]) > SHARDED_DB_BAR
                               or min(r["quality"]) < 0.98):
            raise RuntimeError(f"{label}: median NMSE above "
                               f"{SHARDED_DB_BAR} dB or a quality below 0.98")
        if name == "complex" and max(r["db"]) > SHARDED_DB_BAR:
            raise RuntimeError(f"{label}: the complex twin's NMSE above "
                               f"{SHARDED_DB_BAR} dB at an instance")
        for k, v in r["launches"].items():
            totals[k] = totals.get(k, 0) + v
    return totals


def held_sharded(one, two):
    """(ii)'s rank against (i): quality within SHARDED_Q_TOL, NMSE both at
    most -60 dB or within SHARDED_DB_TOL."""
    gaps = []
    for name in ("pair", "complex"):
        for k, (d1, d2) in enumerate(zip(one[name]["db"], two[name]["db"])):
            if not ((d1 <= SHARDED_DB_BAR and d2 <= SHARDED_DB_BAR)
                    or abs(d1 - d2) <= SHARDED_DB_TOL):
                raise RuntimeError(f"phase 10 {name} instance {k}: "
                                   f"{d2:.2f} dB on 2 ranks, {d1:.2f} on 1")
            gaps.append(abs(d1 - d2))
    dq = max(abs(q1 - q2) for q1, q2 in zip(one["pair"]["quality"],
                                             two["pair"]["quality"]))
    if dq > SHARDED_Q_TOL:
        raise RuntimeError(f"phase 10: quality {dq:.2e} apart on 2 ranks")
    return max(gaps), dq


def phase10_entry():
    """``entry()``'s step on the card against the same step on the CPU;
    returns its launches."""
    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    reset_launch_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    counts = launch_counts()
    ms = cuda_ms(lambda: fn(*args), reps=20)
    fn_c, args_c = entry("cpu")
    want = fn_c(*args_c)
    err = 0.0
    for idx in ((0, 1), (2, 3), (4, 5), (6, 7), (8,), (9,)):
        scale_ = max(float(want[i].abs().max()) for i in idx)
        err = max(err, max(float((got[i].cpu() - want[i]).abs().max())
                           for i in idx) / max(scale_, 1e-30))
    print(f"[10 entry] entry(): one admm_iteration_pair step, 16x16, m {M}, "
          f"r {R}: {ms:.4f} ms (events) | card against the CPU's plain "
          f"versions {err:.3e} (tol {ENTRY_RTOL}) | launches {counts}",
          flush=True)
    require_launched(counts, ("pair_matmul", "fused_prox_dual_t",
                              "fused_zprox_t"), "entry()'s step")
    if not err <= ENTRY_RTOL:
        raise RuntimeError(f"entry(): {err:.3e} from the CPU's step")
    return counts


def phase10_sharded():
    """Phase 10: the sharded paths on the card.  (i) One rank over NCCL
    in this process, mesh (1, 1): ``solve_lowrank_multi_sharded_pair``
    then ``solve_lowrank_sharded`` on the complex twin, and
    ``entry()``'s step against the CPU.  (ii) Two ranks sharing this
    card over gloo (NCCL refuses two ranks on one device), spawned once
    at the phase's start, mesh (1, 2), m 512 rows a rank: the same two
    solves once (i) is done, held against (i), beside
    ``dryrun_multichip(1)`` and ``scaling_benchmark()`` at its defaults
    (d = 1) in the one-rank world.  ``dryrun_multichip(2)`` must raise
    on one card."""
    import torch.distributed as dist

    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    t0 = time.perf_counter()
    # (ii)'s ranks start first: they import, join their world and build
    # the problem while (i) runs, then wait for ``go``
    go = multiprocessing.get_context("spawn").Event()
    two, dry = {}, {}

    def run(out, fn, *args, **kw):
        try:
            out["value"] = fn(*args, **kw)
        except BaseException as e:               # raised in this thread
            out["error"] = e
        out["done"] = time.perf_counter()

    threads = [threading.Thread(target=run, args=(
        two, spawn_ranks, sharded_rank, 2, (go,)), kwargs=dict(
            device="cuda", backend="gloo", timeout=SHARDED_TIMEOUT))]
    threads[0].start()
    try:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                f"{free_port()}", world_size=1, rank=0)
        try:
            one = sharded_solves(make_mesh(batch=1, rows=1, device="cuda"))
            add(report_sharded("(i) 1 rank, NCCL, mesh (1, 1)", one))
            add(phase10_entry())
            # from here (ii)'s solves, dryrun_multichip(1) (its child
            # starts now) and scaling_benchmark() run side by side
            t_go = time.perf_counter()
            go.set()
            threads.append(threading.Thread(target=run, args=(
                dry, dryrun_multichip, 1)))
            threads[1].start()
            pts = scaling_benchmark()
            print(f"[10 scaling] scaling_benchmark() at its defaults, beside "
                  f"(ii)'s solves and the dry run: "
                  f"{time.perf_counter() - t_go:.2f} s | "
                  + " | ".join(f"d {d}: {p.recoveries_per_s:.3f} rec/s, "
                               f"efficiency {p.efficiency:.3f}"
                               for d, p in pts.items()), flush=True)
            if list(pts) != [1]:
                raise RuntimeError(f"scaling_benchmark ran counts "
                                   f"{list(pts)}")
        finally:
            dist.destroy_process_group()
    finally:
        go.set()                   # (ii)'s ranks run out, the threads end
        for t in threads:
            t.join()
    if "error" in dry:
        raise RuntimeError("phase 10: dryrun_multichip(1) failed") \
            from dry["error"]
    print(f"[10 dryrun] dryrun_multichip(1): {dry['done'] - t_go:.2f} s | "
          f"mesh {dry['value'][0]['shape']} | launches "
          f"{dry['value'][0]['launches']}", flush=True)
    try:
        dryrun_multichip(2)
    except ValueError as e:
        print(f"[10 dryrun] dryrun_multichip(2) on one card raises: {e}",
              flush=True)
    else:
        raise RuntimeError("dryrun_multichip(2) ran on one card")
    if "error" in two:
        raise RuntimeError("phase 10 (ii) failed") from two["error"]
    for k, res in enumerate(two["value"]):
        add(report_sharded("(ii) 2 ranks on one card, gloo, mesh (1, 2)",
                           res))
        db_gap, dq = held_sharded(one, res)
        print(f"[10 held] (ii) rank {k} against (i): NMSE gap at most "
              f"{db_gap:.3f} dB, quality gap {dq:.2e}", flush=True)
    print(f"[10 ranks] (ii) spawned at the phase's start, "
          f"{t_go - t0:.2f} s before its go; done {two['done'] - t_go:.2f} "
          f"s after it", flush=True)
    print(f"[10 sharded] phase 10: {time.perf_counter() - t0:.1f} s",
          flush=True)
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
    vssr_cpu = start_vssr_a2_cpu()
    add(phase7_vsm())
    done(7)
    # the VS_SR child is done by now (about 150 s of CPU since phase 7
    # began): the Bayes child takes its cores for phase 8
    bayes = start_bayes_cpu()
    add(phase8_new_paths(vssr_cpu))
    done(8)
    add(phase9_testbed(bayes))
    done(9)
    add(phase10_sharded())
    done(10)
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
