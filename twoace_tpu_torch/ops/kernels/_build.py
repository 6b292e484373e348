"""Build and load the port's CUDA kernels, and check what their wrappers
pass them.

``twoace_tpu_torch/csrc/*.cu`` are compiled at first use, one ``nvcc``
per source, all started together, and linked into one shared library
with a plain C interface.  It is written to ``twoace_tpu_torch/_build/``
(git-ignored) under a name keyed by a hash of the sources, the headers
they include (``csrc/*.cuh``) and the flags, and loaded with ``ctypes``.
Nothing is built when a module is imported: the CPU tests import every
module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the exported functions; every pointer and the stream are
# c_void_p so ctypes does not cut them to 32 bits
SIGNATURES = {
    "twoace_prox_dual_t": [_P] * 10 + [_I, _I, _I, _I, _P],
    "twoace_zprox_t": [_P] * 10 + [_I, _I, _I, _I, _P],
    "twoace_zprox_plan": [_I, _I, _P],
    "twoace_infer_admm": [_P] * 21 + [_I] * 11 + [_F] * 3 + [_P],
    "twoace_infer_admm_clusters": [_I, _I, _I],
    "twoace_infer_admm_smem": [_I, _I, _I],
    "twoace_infer_admm_smem_limit": [],
    "twoace_pair_matmul_tc": [_P] * 6 + [_I] * 4 + [_P],
    "twoace_pair_matmul_rows": [_P] * 6 + [_I] * 5 + [_P],
    "twoace_prox_dual_rows": [_P] * 6 + [_L, _I, _I, _I, _P],
    "twoace_prox_dual_rows_plan": [_L, _I, _I, _P],
    "twoace_chain_mm": [_P] * 6 + [_I, _I, _I, _P],
    "twoace_trip_shift": [_P] * 7 + [_I, _L, _I, _F, _P],
    "twoace_trip_rhs": [_P] * 11 + [_I, _L, _I, _P],
    "twoace_trip_rows": [_P] * 8 + [_I] * 5 + [_P],
    "twoace_trip_n_dual": [_P] * 18 + [_I, _L, _I, _I, _P],
    "twoace_trip_commit": [_P] * 8 + [_I] + [_P] * 12 + [_I] * 10 + [_P],
}

_lib = None


def sources():
    """The translation units given to nvcc."""
    return sorted(CSRC.glob("*.cu"))


def hashed_files():
    """Everything the library is built from: the sources and headers."""
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in hashed_files():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtwoace_kernels-{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile the sources if no library for their hash exists yet: one
    nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        jobs = []
        for src in sources():
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = [nvcc(), *compile_flags, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for cmd, _, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                                   + stdout + stderr)
        tmp = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                               + proc.stdout + proc.stderr)
        os.replace(tmp, out)            # atomic: readers never see a partial
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def check_inputs(tensors: dict, device) -> None:
    """Raise unless every ``name: (tensor, shape)`` is a contiguous float32
    tensor of that shape on ``device``: what the kernels take."""
    for name, (t, shape) in tensors.items():
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name}: need float32 on {device}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: need shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
