#!/usr/bin/env python3
"""How far runs of phase 8's and 9's paths part when only their rounding
differs, on the CPU: the spreads behind ``chip_smoke.py``'s tolerances.

    python3 scripts/torch_rounding_spread.py [vssr|baselines|windows|k3|zfree ...]
        [--ranges 20 50 70 80]

- ``vssr``: the VS_SR campaign's A2 alone (``chip_smoke.vssr_config``,
  1 trial) at each range of ``--ranges``, once with K3's plain version
  and once with the plain version's four products in 3xTF32
  (``scripts/torch_k3_witness.py``'s ``emulated``, K3's arithmetic):
  the per-point MAEE and NMSE of both (``VSSR_PAIRED_TOL_DEG``);
- ``baselines``: each direct call of ``[8 baselines]`` on the baselines'
  cell's first trial: complex64 against complex128, complex64 after a
  1e-7 input perturbation and complex128 after a 1e-15 one, each as the
  phase-aligned relative distance (``BASE_*``);
- ``windows``: the first 200-row window of ``infer_channel_windows`` on
  phase 6's rows, complex64 against complex128 and after perturbations,
  the magnitude fit of each, of the true channel and of random ones, and
  a 1024-row window (``WINDOW_*``);
- ``k3``: the plain K3 loop in float32 against float64 from phase 2's
  warm state after K3_TRIPS and K3_COLUMN_TRIPS trips, at each of
  ``K3_COLUMN_CASES`` (both passes);
- ``zfree``: phase 9's Z-free ``infer_admm_pair`` (``chip_smoke.
  zfree_inputs``), float32 against float64 and against float32 after a
  1e-7 perturbation of b, by ``chip_smoke.zfree_dist`` and by the plain
  max |difference| (``ZFREE_RTOL``).

Everything runs on the CPU (a few minutes each; ``vssr`` about 20 s a
range).
"""

import argparse
import importlib.util
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from twoace_tpu_torch.config import ArrayConfig  # noqa: E402
from twoace_tpu_torch.ops import pair_solver  # noqa: E402
from twoace_tpu_torch.ops.kernels import infer_admm_plain  # noqa: E402
from twoace_tpu_torch.pipeline import recovery, simulation  # noqa: E402
from twoace_tpu_torch.utils.rng import fold_in  # noqa: E402
from twoace_tpu_torch.utils.units import dbm_to_amplitude  # noqa: E402


def perturbed(t, eps, gen):
    """``t * (1 + eps * N(0, 1))`` entry by entry, in ``t``'s dtype."""
    wide = torch.complex128 if t.is_complex() else torch.float64
    noise = torch.randn(t.shape, generator=gen, dtype=torch.float64)
    return (t.to(wide) * (1 + eps * noise)).to(t.dtype)


def widened(t):
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def vssr(ranges):
    spec = importlib.util.spec_from_file_location(
        "torch_k3_witness", os.path.join(ROOT, "scripts",
                                         "torch_k3_witness.py"))
    witness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(witness)
    sim = cs.vssr_config(1, methods=("admm_lowrank_v4",))
    for sr in ranges:
        for label, loop in (("plain", infer_admm_plain),
                            ("3xTF32", witness.emulated)):
            pair_solver.fused_infer_admm = loop
            res = simulation.measurements_needed_vs_range(
                torch.Generator().manual_seed(cs.VSSR_SEED), [sr], sim=sim,
                device="cpu")
            print(f"[vssr] range {sr:.0f}, A2 with the {label} loop: MAEE "
                  f"{np.round(res.maee_curves['admm_lowrank_v4'][0], 4).tolist()}"
                  f" | NMSE "
                  f"{np.round(res.nmse_curves['admm_lowrank_v4'][0], 5).tolist()}",
                  flush=True)


def baselines():
    sim = cs.vssr_config(cs.BASE_TRIALS, cs.BASE_G,
                         ("cprl", "prgamp", "sparse_pl"))
    gen = torch.Generator().manual_seed(cs.VSSR_SEED)
    _, _, sensing, meas = simulation.draw_cell(
        fold_in(gen, 0), sim, cs.BASE_M, cs.BASE_M, cs.BASE_RANGE, "cpu")
    inputs = (sensing.measurement_mat[0], meas.norm_square[0],
              meas.perfect_phase[0], sensing.fw[0])
    g = torch.Generator().manual_seed(3)
    for label, fn in cs.baseline_calls(sim.snr_db,
                                       inputs[0].shape[1]).items():
        c64 = fn(*inputs)
        c128 = fn(*(widened(t) for t in inputs))
        p64 = fn(*(perturbed(t, 1e-7, g) for t in inputs))
        p128 = fn(*(perturbed(widened(t), 1e-15, g) for t in inputs))
        print(f"[baselines] {label}: complex64 vs complex128 "
              f"{cs.aligned_dist(c64, c128):.3e} | complex64 moved by a 1e-7 "
              f"perturbation {cs.aligned_dist(p64, c64):.3e} | complex128 "
              f"moved by a 1e-15 one {cs.aligned_dist(p128, c128):.3e}",
              flush=True)


def windows():
    cb, x_true, rss, _ = cs.campaign_workload(device="cpu")
    amps = dbm_to_amplitude(torch.as_tensor(rss),
                            recovery.CampaignConfig().rss_fct)
    cfg = ArrayConfig(nt=cs.NT, nr=cs.NR)

    def one(rows, a, window):
        return torch.as_tensor(simulation.infer_channel_windows(
            torch.Generator().manual_seed(0), rows, a, cfg, window=window,
            n_windows=1, device="cpu")[0])

    g = torch.Generator().manual_seed(1)
    rows, a = cb[:cs.WINDOW], amps[:cs.WINDOW]
    for window in (cs.WINDOW, cs.WINDOW_WELL):
        c64 = one(cb, amps, window)
        c128 = one(widened(cb), widened(amps), window)
        p64 = one(perturbed(cb, 1e-7, g), amps, window)
        print(f"[windows] window {window}: complex64 vs complex128 "
              f"{cs.aligned_dist(c64, c128):.3e} | complex64 moved by a 1e-7 "
              f"perturbation {cs.aligned_dist(p64, c64):.3e} | NMSE "
              f"{cs.proj_nmse_db(c64.T.reshape(-1).numpy(), x_true.numpy()):.2f}"
              f" dB", flush=True)
        if window == cs.WINDOW:
            fits = [cs.window_fit(e.numpy(), rows, a)
                    for e in (c64, c128, p64)]
            truth = cs.window_fit(x_true.reshape(cs.NT, cs.NR).T.numpy(),
                                  rows, a)
            rand = [cs.window_fit(torch.randn(
                cs.NR, cs.NT, dtype=torch.complex128, generator=g).numpy(),
                rows, a) for _ in range(3)]
            print(f"[windows] window {window} fits: complex64, complex128, "
                  f"perturbed {np.round(fits, 4).tolist()} | the true "
                  f"channel {truth:.4f} | random {np.round(rand, 3).tolist()}"
                  f" | zero 1", flush=True)


def k3():
    for nt, m in cs.K3_COLUMN_CASES:
        for label, args, kw in cs.k3_cases(m, device="cpu", nt=nt, nr=nt):
            wide = cs.cast_args(args, torch.float64)
            dist = [cs.rel_err(infer_admm_plain(*args, **dict(kw, maxiter=t)),
                               infer_admm_plain(*wide, **dict(kw, maxiter=t)))
                    for t in (cs.K3_TRIPS, cs.K3_COLUMN_TRIPS)]
            print(f"[k3] {label}: float32 vs float64 after {cs.K3_TRIPS} "
                  f"trips {dist[0]:.3e}, after {cs.K3_COLUMN_TRIPS} "
                  f"{dist[1]:.3e}", flush=True)


def zfree():
    kw = dict(scale_by_row=True, nt=cs.NT, nr=cs.NR, maxiter=500)
    a, b, x0 = cs.zfree_inputs("cpu")
    base = pair_solver.infer_admm_pair(a, b, x0, **kw)
    runs = {"float64": pair_solver.infer_admm_pair(
                *cs.zfree_inputs("cpu", torch.float64), **kw),
            "b perturbed 1e-7": pair_solver.infer_admm_pair(
                a, perturbed(b, 1e-7, torch.Generator().manual_seed(1)), x0,
                **kw)}
    for label, run in runs.items():
        plain = float(max((g.double() - w.double()).abs().max()
                          / w.double().abs().max()
                          for g, w in zip(base[0], run[0])))
        print(f"[zfree] float32 against {label}: Gram "
              f"{cs.zfree_dist(base[0], run[0]):.3e}, iterate {plain:.3e} | "
              f"trips {base[3].flatten().tolist()} against "
              f"{run[3].flatten().tolist()}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parts", nargs="*",
                        default=["k3", "baselines", "windows", "vssr"])
    parser.add_argument("--ranges", type=float, nargs="+",
                        default=[20.0, 50.0, 70.0, 80.0])
    args = parser.parse_args()
    for part in args.parts:
        if part == "vssr":
            vssr(args.ranges)
        else:
            {"baselines": baselines, "windows": windows, "k3": k3,
             "zfree": zfree}[part]()


if __name__ == "__main__":
    main()
