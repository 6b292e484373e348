#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises and exits non-zero:

  0. device: requires CUDA; prints nvidia-smi's name and power limit, the
     torch and CUDA versions and ``nvcc --version``;
  1. build: compiles ``twoace_tpu_torch/csrc/*.cu`` into the git-ignored
     ``twoace_tpu_torch/_build/``;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes, with CUDA-event times of both;
  3. the slice: ``solve_lowrank_multi_pair_batch`` on the bench.py solve
     workload (seed 1, 64 two-path 16x16 channels, one shared 2-bit
     codebook, m = 1024, maxiter 500, warm_iters 80, pass caps 120/160),
     once to warm up and once timed, with the kernels' launch counts.

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
from twoace_tpu_torch.config import AdmmConfig  # noqa: E402
from twoace_tpu_torch.ops.cplx import LadderArrays, Pair  # noqa: E402
from twoace_tpu_torch.ops.kernels import (  # noqa: E402
    _build, fused_prox_dual_t, fused_zprox_t, launch_counts,
    prox_dual_t_plain, reset_launch_counts, zprox_t_plain)
from twoace_tpu_torch.ops.pair_solver import solve_lowrank_multi_pair_batch  # noqa: E402
from twoace_tpu_torch.ops.prox import profile_ladder_arrays  # noqa: E402
from twoace_tpu_torch.utils.metrics import nmse_h_projection  # noqa: E402

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


def max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


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
            times[(m, per_entry)] = (ms, plain)
            print(f"[2 K1 fused_prox_dual_t] lanes {LANES} r {R} m {m} "
                  f"per_entry {per_entry}: max_abs_err {err:.3e} | kernel "
                  f"{ms:.4f} ms | plain {plain:.4f} ms", flush=True)
    summary["fused_prox_dual_t"] = dict(
        max_abs_err=max(errs), ms=times[(M_TRAIN, False)][0],
        plain_ms=times[(M_TRAIN, False)][1])

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
    summary["fused_zprox_t"] = dict(max_abs_err=err, ms=ms, plain_ms=plain)
    return summary


def build_solve_problem(seed=1):
    """bench.py's solve workload, rebuilt with numpy: SOLVE_BATCH two-path
    16x16 channels through one shared 2-bit random codebook."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 4, (M, N))
    a = np.exp(1j * bits * (np.pi / 2)) / np.sqrt(N)

    def steer(nn, ang):
        return np.exp(1j * np.pi * np.arange(nn) * np.sin(ang)) / np.sqrt(nn)

    xs, bs = [], []
    for _ in range(SOLVE_BATCH):
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
    for name, count in launches.items():
        if count <= 0:
            raise RuntimeError(f"{name} was never launched on the main path")
    return launches


def main():
    smi = phase0_device()
    phase1_build()
    summary = phase2_kernels()
    launches = phase3_slice()
    sources = {"fused_prox_dual_t": ("twoace_tpu_torch/csrc/prox_dual.cu",
                                     "twoace_tpu/ops/pallas/kernels.py:121"),
               "fused_zprox_t": ("twoace_tpu_torch/csrc/zprox.cu",
                                 "twoace_tpu/ops/pallas/kernels.py:339")}
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
