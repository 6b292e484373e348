"""Codebook image files: ctypes binding over the native ``libtbrd`` library
(a copy of ``twoace_tpu.sensing.brd``; both packages load the same
``native/libtbrd.so``, built from ``native/brd_lib.cc`` by
``native/Makefile``).

The framework's equivalent of the closed-source ``wil6210_brd_mod`` editor
the reference shells out to per sector (ref: main/codebook_library.py:21-48)
and of the offline .brd generator scripts
(ref: codebook/generate_rx_codebook_16ant_random.py:44-92,
generate_rx_codebook_multires_16ant.py:47-144).  The proprietary .brd layout
is undocumented, so images use the open TBRD container implemented in
``native/brd_lib.cc``; the information content (per-sector per-antenna
amplitude + phase codes, active sector count, module mask) matches.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_lib: Optional[ctypes.CDLL] = None


def _load_lib(native_dir: Optional[str] = None) -> ctypes.CDLL:
    """Compile (if stale) and load the native library."""
    global _lib
    if _lib is not None:
        return _lib
    d = os.path.abspath(native_dir or _NATIVE_DIR)
    so = os.path.join(d, "libtbrd.so")
    src = os.path.join(d, "brd_lib.cc")
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src)):
        subprocess.run(["make", "-C", d, "libtbrd.so"], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(so)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tbrd_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.tbrd_get_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_uint32)]
    lib.tbrd_set_beam.argtypes = [ctypes.c_char_p, ctypes.c_int, u8p, u8p,
                                  ctypes.c_int]
    lib.tbrd_get_beam.argtypes = [ctypes.c_char_p, ctypes.c_int, u8p, u8p,
                                  ctypes.c_int]
    lib.tbrd_set_all.argtypes = [ctypes.c_char_p, u8p, u8p, ctypes.c_int,
                                 ctypes.c_int]
    lib.tbrd_get_all.argtypes = [ctypes.c_char_p, u8p, u8p, ctypes.c_int,
                                 ctypes.c_int]
    lib.tbrd_set_beam_num.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.tbrd_set_module_mask.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    _lib = lib
    return lib


_ERRORS = {-1: "io error", -2: "bad format", -3: "out of range",
           -4: "checksum mismatch (corrupt image)"}


def _check(rc: int, op: str):
    if rc != 0:
        raise OSError(f"tbrd {op}: {_ERRORS.get(rc, rc)}")


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), np.uint8)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class CodebookImage:
    """One codebook image file (the .brd equivalent)."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._lib = _load_lib()

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create(cls, path: str, n_ant: int, n_sectors: int) -> "CodebookImage":
        img = cls(path)
        _check(img._lib.tbrd_create(img._bpath, n_ant, n_sectors), "create")
        return img

    @property
    def _bpath(self) -> bytes:
        return self.path.encode()

    def info(self) -> Tuple[int, int, int, int]:
        """Returns (n_ant, n_sectors, active_sectors, module_mask)."""
        na, ns, act = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        mask = ctypes.c_uint32()
        _check(self._lib.tbrd_get_info(self._bpath, ctypes.byref(na),
                                       ctypes.byref(ns), ctypes.byref(act),
                                       ctypes.byref(mask)), "get_info")
        return na.value, ns.value, act.value, mask.value

    # -------------------------------------------------------------- sectors
    def set_beam(self, sector: int, phase_bits, amp=None):
        """Write one sector (ref: codebook_library.py set_beam, :21-30)."""
        phase = _u8(phase_bits)
        amp = _u8(np.full(phase.shape, 7) if amp is None else amp)
        _check(self._lib.tbrd_set_beam(self._bpath, sector, _ptr(amp),
                                       _ptr(phase), phase.size), "set_beam")

    def get_beam(self, sector: int) -> Tuple[np.ndarray, np.ndarray]:
        n_ant = self.info()[0]
        amp = np.zeros(n_ant, np.uint8)
        phase = np.zeros(n_ant, np.uint8)
        _check(self._lib.tbrd_get_beam(self._bpath, sector, _ptr(amp),
                                       _ptr(phase), n_ant), "get_beam")
        return amp, phase

    def set_all(self, phase_bits, amp=None):
        """Bulk sector write in one native I/O pass."""
        phase = _u8(phase_bits)
        n_sectors, n_ant = phase.shape
        amp = _u8(np.full(phase.shape, 7) if amp is None else amp)
        _check(self._lib.tbrd_set_all(self._bpath, _ptr(amp), _ptr(phase),
                                      n_sectors, n_ant), "set_all")

    def get_all(self) -> Tuple[np.ndarray, np.ndarray]:
        n_ant, n_sectors, _, _ = self.info()
        amp = np.zeros((n_sectors, n_ant), np.uint8)
        phase = np.zeros((n_sectors, n_ant), np.uint8)
        _check(self._lib.tbrd_get_all(self._bpath, _ptr(amp), _ptr(phase),
                                      n_sectors, n_ant), "get_all")
        return amp, phase

    # ------------------------------------------------------------- controls
    def set_beam_num(self, n: int):
        """Active sector count (ref: codebook_library.py:33-38)."""
        _check(self._lib.tbrd_set_beam_num(self._bpath, n), "set_beam_num")

    def enable_modules(self, mask: int):
        """RF-module enable mask (ref: codebook_library.py:41-48)."""
        _check(self._lib.tbrd_set_module_mask(self._bpath, mask),
               "set_module_mask")


def export_codebook_set(directory: str, name: str, phase_bits,
                        n_ant: Optional[int] = None,
                        per_image_sectors: Optional[int] = None
                        ) -> Sequence[str]:
    """Write a codebook as image files + the txt phase table.

    Mirrors the offline generator scripts' output shape — one image per
    probing round plus a human-readable phase table
    (ref: generate_rx_codebook_16ant_random.py:44-92: 64 single-sector
    images + ``rx_codebook_random.txt``).  ``phase_bits``: (entries, n_ant)
    int array; ``per_image_sectors`` groups that many consecutive entries
    into each image (default 1, like the Rx generators).
    """
    phase = _u8(phase_bits)
    entries, na = phase.shape
    n_ant = n_ant or na
    per = per_image_sectors or 1
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(0, entries, per):
        block = phase[i:i + per]
        p = os.path.join(directory, f"{name}_{i // per}.tbrd")
        img = CodebookImage.create(p, n_ant, block.shape[0])
        img.set_all(block)
        paths.append(p)
    table = os.path.join(directory, f"{name}.txt")
    with open(table, "w") as fh:
        for row in phase:
            fh.write("".join(str(int(b)) for b in row) + "\n")
    return paths


def read_phase_table(path: str) -> np.ndarray:
    """Parse a txt phase table back to an (entries, n_ant) int array
    (the ``processsing_codebook_*.m`` input format, ref
    codebook/processsing_codebook_random.m:43-53)."""
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                rows.append([int(c) for c in line])
    return np.asarray(rows, np.int32)
