#!/usr/bin/env python3
"""Where K4's two routes cross, and what nvcc reports for each kernel,
on one GPU.

    python3 scripts/torch_k4_routes.py [--out FILE.json]

Builds the kernels (as chip_smoke.py's phase 1), prints what
``nvcc -Xptxas -v`` reports for each of ``csrc/pair_matmul.cu``'s kernels
(registers, shared memory, spills) and their SASS opcode counts, then
runs both routes at M = 1, 2, ... 128 for (K, N) in (1024, 256),
(256, 1024), (256, 256): where the split-K route stops winning, which
sets ``pair_matmul.ROWS_MAX_M``.

Each line gives the device time a launch from the profiler and the
CUDA-event time of each route, with its error against the plain version
(TF32 off) and against the complex128 product (max |error| over max
|exact|), and whether it meets chip_smoke.py's bars (within K4_RTOL of
the plain version, at most K4_C128_FACTOR times its complex128 error).
The complex64 ``torch.matmul`` device time is printed beside each shape.
With ``--out``, writes every number to that file as JSON.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from twoace_tpu_torch.ops.cplx import Pair  # noqa: E402
from twoace_tpu_torch.ops.kernels import _build  # noqa: E402
from twoace_tpu_torch.ops.pair_solver import no_tf32  # noqa: E402

# the package exports the function under the module's name
k4 = importlib.import_module("twoace_tpu_torch.ops.kernels.pair_matmul")

CROSS_M = (1, 2, 4, 8, 16, 32, 64, 128)
CROSS_KN = ((1024, 256), (256, 1024), (256, 256))


def ptxas_report(name="pair_matmul.cu"):
    """nvcc -Xptxas -v of one source of csrc/: one line per kernel; and
    the SASS opcode counts of each kernel (cuobjdump -sass)."""
    src = os.path.join(_build.CSRC, name)
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    bindir = os.path.dirname(_build.nvcc())
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "kernels.o")
        proc = subprocess.run(
            [_build.nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", obj, src],
            capture_output=True, text=True, check=True, timeout=600)
        sass = subprocess.run([os.path.join(bindir, "cuobjdump"), "-sass",
                               obj], capture_output=True, text=True,
                              timeout=600).stdout
    lines, name = [], None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            lines.append(f"{name}: {line.split('ptxas info    :')[-1].strip()}")
    name, counts = None, {}
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[-1].strip()
            counts[name] = {}
        elif name and line.strip().startswith("/*") and "*/" in line:
            toks = line.split("*/", 1)[1].split()
            if toks and toks[0].startswith("@"):
                toks = toks[1:]
            if toks and not toks[0].startswith("/*"):
                op = toks[0].split(".")[0]
                counts[name][op] = counts[name].get(op, 0) + 1
    for fn, ops in counts.items():
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:14]
        lines.append(f"{fn}: SASS {sum(ops.values())} instructions: "
                     + ", ".join(f"{k} {v}" for k, v in top))
    try:
        demangled = subprocess.run(
            [os.path.join(bindir, "cu++filt")], input="\n".join(lines),
            capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(demangled) == len(lines):
            lines = demangled
    except OSError:
        pass
    return lines


def operands(g, m, k, n, seed=4):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [Pair(*(torch.randn(g, rows, cols, generator=gen, device="cuda")
                   for _ in range(2))) for rows, cols in ((m, k), (k, n))]


def c128_err(pair, exact):
    return float((torch.complex(*pair).to(torch.complex128) - exact).abs()
                 .max() / exact.abs().max())


def measure(fn, plain, exact):
    got = fn()
    torch.cuda.synchronize()
    rel_plain = max(float((x - w).abs().max() / w.abs().max())
                    for x, w in zip(got, plain))
    err = c128_err(got, exact)
    held = (rel_plain <= cs.K4_RTOL
            and err <= cs.K4_C128_FACTOR * c128_err(plain, exact))
    return dict(rel_plain=rel_plain, err_c128=err, held=held,
                device_ms=cs.device_ms(fn), event_ms=cs.cuda_ms(fn))


def shape_refs(shape):
    a, b = operands(*shape)
    plain = k4.pair_matmul_plain(a, b)
    ac, bc = torch.complex(*a), torch.complex(*b)
    exact = ac.to(torch.complex128) @ bc.to(torch.complex128)
    err_plain = c128_err(plain, exact)
    lib = cs.device_ms(lambda: torch.matmul(ac, bc))
    return a, b, plain, exact, dict(err_plain_c128=err_plain,
                                    library_device_ms=lib)


def fmt(r):
    return (f"device {cs.fmt_ms(r['device_ms'])}, events "
            f"{r['event_ms']:.4f} ms | rel vs plain {r['rel_plain']:.2e}, "
            f"vs complex128 {r['err_c128']:.2e} | bars "
            f"{'held' if r['held'] else 'MISSED'}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write every number to this JSON file")
    args = ap.parse_args()
    out = dict(device=cs.phase0_device())
    cs.phase1_build()
    out["ptxas"] = ptxas_report()
    for line in out["ptxas"]:
        print(f"[ptxas] {line}", flush=True)

    with no_tf32():
        out["cross"] = {}
        for k, n in CROSS_KN:
            for m in CROSS_M:
                shape = (1, m, k, n)
                a, b, plain, exact, ref = shape_refs(shape)
                rows = dict(ref)
                for which in ("rows", "tc"):
                    rows[which] = measure(lambda: k4.launch(a, b, which),
                                          plain, exact)
                print(f"[cross] {shape}: rows {fmt(rows['rows'])} || tc "
                      f"{fmt(rows['tc'])} || torch.matmul device "
                      f"{cs.fmt_ms(ref['library_device_ms'])} | the wrapper "
                      f"picks {k4.route(*shape)}", flush=True)
                out["cross"][str(shape)] = rows

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
