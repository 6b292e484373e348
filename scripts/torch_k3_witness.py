#!/usr/bin/env python3
"""How far K3 (``csrc/infer_admm.cu``) and its plain version each stray
from the same loop run in float64, trip by trip, on one GPU.

    python3 scripts/torch_k3_witness.py [--m 80 3 972] [--trips 1 2 4 8 16 30]
        [--device cuda] [--out FILE.json]

For each m it takes ``chip_smoke.k3_cases(m)`` (3 lanes, r 20, 16x16,
both passes from the warm lane state phase 2 holds K3 at) and, for each
trip count T, runs T trips five ways from that state:

- ``k3``: the kernel (on ``--device cpu`` its wrapper runs the plain
  version, so the script can be tried at small cost without a card);
- ``plain``: the plain version (float32) on the same device;
- ``plain_cpu``: the plain version on the CPU;
- ``f64``: the plain version on the same device with every input and
  every step in float64, the witness;
- ``emu``: the plain version with its four products through
  ``pair_matmul_tf32_emulated`` (3xTF32 in plain torch: K3's product
  arithmetic, in another summation order).

It prints, per pass and T, the relative distance (max |difference| over
max |other|, over opt_x and opt_y, as phase 2's ``rel_err``) of each pair
that tells a fault in the kernel from float32 rounding that the loop
amplifies: K3 and the plain version from each other and each from the
witness, whether the trip counts and converged flags agree, and each
run's objective at its opt_x (computed in float64 on the host) beside the
witness's, as the largest relative difference over the lanes.  With
``--out``, writes every number as JSON.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the distances printed, as (name, one run, the other)
PAIRS = (("k3-plain", "k3", "plain"), ("plaincpu-plain", "plain_cpu", "plain"),
         ("k3-f64", "k3", "f64"), ("plain-f64", "plain", "f64"),
         ("plaincpu-f64", "plain_cpu", "f64"), ("emu-f64", "emu", "f64"),
         ("k3-emu", "k3", "emu"))


def emulated(a, b, u, y0, z0, v0, mu0, ladder, *, nt, nr, scale_by_row,
             rho, tol_rel, tol_abs, maxiter):
    """The plain version with 3xTF32 products (``infer_admm_plain`` with
    ``pair_matmul_tf32_emulated`` in place of the float32 product)."""
    from twoace_tpu_torch.ops.admm_loop import admm_loop
    from twoace_tpu_torch.ops.kernels.admm_trip import trip_plain
    from twoace_tpu_torch.ops.kernels.pair_matmul import (
        pair_matmul_tf32_emulated)
    from twoace_tpu_torch.ops.kernels.prox_dual import prox_dual_t_plain
    from twoace_tpu_torch.ops.kernels.zprox import zprox_t_plain

    def z_prox(z, v, mu):
        return zprox_t_plain(z, v, nt, nr, ladder)

    return admm_loop(a, b, u, y0, z0, v0, mu0, scale_by_row=scale_by_row,
                     pair_gemm=pair_matmul_tf32_emulated,
                     prox_dual=prox_dual_t_plain, z_prox=z_prox,
                     trip=trip_plain, rho=rho, tol_rel=tol_rel,
                     tol_abs=tol_abs, maxiter=maxiter)


def objective(args, out):
    """Each lane's objective at its opt_x, in float64 on the host: the
    norm of |A X| over the rows (all rows; the best column per column)
    minus b."""
    import torch

    a = (args[0].re.double() + 1j * args[0].im.double()).cpu()   # (G, m, n)
    b = args[1].double().cpu()                                   # (G, P, m)
    x = (out[0].re.double() + 1j * out[0].im.double()).cpu()     # (G, P, k, n)
    ax = torch.einsum("gmn,gpkn->gpkm", a, x)
    amp = torch.sqrt(torch.sum(ax.abs() ** 2, dim=-2))           # (G, P, m)
    return torch.linalg.vector_norm(amp - b, dim=-1).flatten()


def witness(args, kw, trips):
    """The five runs' distances after each of ``trips`` trips."""
    import torch

    import chip_smoke as cs
    from twoace_tpu_torch.ops.kernels import fused_infer_admm
    from twoace_tpu_torch.ops.kernels.infer_admm import infer_admm_plain

    rows = []
    for t in trips:
        k = dict(kw, maxiter=t)
        cpu = cs.cast_args(args, device="cpu")
        f64 = cs.cast_args(args, torch.float64)
        runs = dict(k3=fused_infer_admm(*args, **k),
                    plain=infer_admm_plain(*args, **k),
                    plain_cpu=infer_admm_plain(*cpu, **k),
                    f64=infer_admm_plain(*f64, **k),
                    emu=emulated(*args, **k))
        row = dict(trips=t)
        for name, p, q in PAIRS:
            row[name] = cs.rel_err(runs[p], runs[q])
        obj = objective(args, runs["f64"])
        for name in ("k3", "plain", "emu"):
            row[f"obj {name}-f64"] = float(
                ((objective(args, runs[name]) - obj).abs() / obj).max())
        row["same_trips_converged"] = all(
            torch.equal(runs[n][3].cpu(), runs["f64"][3].cpu())
            and torch.equal(runs[n][2].cpu(), runs["f64"][2].cpu())
            for n in runs)
        rows.append(row)
        print("  T " + f"{t:3d} | " + " | ".join(
            f"{name} {row[name]:.3e}" for name, _, _ in PAIRS)
            + " | objective " + ", ".join(
                f"{name} {row['obj ' + name + '-f64']:.2e}"
                for name in ("k3", "plain", "emu"))
            + f" | trips, converged equal {row['same_trips_converged']}",
            flush=True)
    return rows


def main():
    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, nargs="+", default=[80, 3, cs.M_TRAIN])
    ap.add_argument("--trips", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, cs.K3_TRIPS])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="write every number to this JSON file")
    args = ap.parse_args()
    out = {}
    if args.device == "cuda":
        out["device"] = cs.phase0_device()
        cs.phase1_build()
    out["cases"] = {}
    for m in args.m:
        for label, a, kw in cs.k3_cases(m, device=args.device):
            print(f"[K3 witness] {label}, from the warm state at mu0 "
                  f"{cs.K3_MU0}:", flush=True)
            out["cases"][label] = witness(a, kw, args.trips)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
