"""Codebook generation, random family (port of the random family of
``twoace_tpu.sensing.codebooks``).

A codebook is data: integer phase *bits* (2-bit by default) plus an
amplitude mask, and functions that compile them into complex beamforming
rows and kron probe matrices.  The bits are drawn from an explicit
``torch.Generator`` on the CPU; the map from bits to rows is a function of
its own (:func:`phase_rows`), so tests can hand both packages the same
bits.  The directional, multi-resolution, sweep and ACO families are still
to port.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..interop import resolve_device


def phase_rows(bits, phase_bit: int = 2, amp=None, normalize_by=None):
    """Complex rows ``amp * exp(1j * bits * 2pi/2^b)`` (complex64) of an
    integer bits tensor, divided by ``sqrt(normalize_by)`` when given.
    ref: processsing_codebook_random.m:48-51, Generate_Sensing_Matrix.m:110-118.
    """
    nps = 2 ** phase_bit
    ang = bits.to(torch.float32) * (2.0 * math.pi / nps)
    w = torch.polar(torch.ones_like(ang), ang)
    if amp is not None:
        w = w * amp
    if normalize_by is not None:
        w = w / math.sqrt(normalize_by)
    return w


class Codebook(NamedTuple):
    """A phase-bit codebook: the replacement of the reference's ``.brd``
    images."""

    bits: torch.Tensor           #: (entries, n_ant) integer phase bits
    amp: torch.Tensor            #: (n_ant,) 0/1 amplitude mask
    phase_bit: int = 2

    @property
    def n_ant(self) -> int:
        return self.bits.shape[-1]

    def rows(self, normalize: bool = False) -> torch.Tensor:
        """Complex beamforming rows ``amp * exp(1j * bits * 2pi/2^b)``.

        ref: processsing_codebook_random.m:48-51.  ``normalize`` divides by
        sqrt(n_active) (sensing-matrix convention).
        """
        n_act = max(float(torch.sum(self.amp)), 1.0) if normalize else None
        return phase_rows(self.bits, self.phase_bit, self.amp, n_act)


def random_phase_bits(generator: Optional[torch.Generator], m: int, n: int,
                      phase_bit: int = 2, device="cuda") -> torch.Tensor:
    """Uniform random phase bits ``(m, n)`` (int64) on ``device``.

    The bits are drawn row after row from the generator on the CPU, so the
    first M rows are the same for any larger m: the nesting property the
    reference gets by drawing measurements incrementally
    (ref: Generate_Sensing_Matrix.m:86-99).
    """
    bits = torch.randint(0, 2 ** phase_bit, (m, n), generator=generator)
    return bits.to(resolve_device(device))


def random_codebook(generator: Optional[torch.Generator], entries: int,
                    n_ant: int, phase_bit: int = 2,
                    device="cuda") -> Codebook:
    """Per-round random 2-bit codebook (ref: generate_rx_codebook_16ant_random.py)."""
    bits = random_phase_bits(generator, entries, n_ant, phase_bit, device)
    return Codebook(bits=bits, amp=torch.ones(n_ant, device=bits.device),
                    phase_bit=phase_bit)


def random_sensing_rows(generator: Optional[torch.Generator], m: int, n: int,
                        phase_bit: int = 2, device="cuda") -> torch.Tensor:
    """Random phase-state sensing rows ``exp(1j b 2pi/Np)/sqrt(n)``.

    The ``Random_Phase_State`` mode draws the full (Nt*Nr)-length row
    directly (ref: Generate_Sensing_Matrix.m:110-118), not a Tx x Rx kron.
    """
    bits = random_phase_bits(generator, m, n, phase_bit, device)
    return phase_rows(bits, phase_bit, normalize_by=n)


def kron_probe_rows(tx_rows, rx_rows, interleave: bool = False):
    """Assemble full probe rows from per-round Tx sectors and one Rx row.

    ``tx_rows``: (rounds, sectors, nt) complex; ``rx_rows``: (rounds, nr).
    Row (i, j) is ``kron(tx_rows[i, j], rx_rows[i])``: Rx index fastest,
    matching vec(H).  ``interleave=False``: round-major, sector index
    fastest (the MULTIRES ordering, ref: processsing_codebook_multires.m:60-61);
    ``interleave=True``: sector-major, round index fastest (the RANDOM
    ordering, ref: processsing_codebook_random.m:54-62).
    """
    rounds, sectors, nt_ = tx_rows.shape
    nr_ = rx_rows.shape[-1]
    cb = torch.einsum("ijt,ir->ijtr", tx_rows, rx_rows)
    cb = cb.reshape(rounds, sectors, nt_ * nr_)
    if interleave:
        cb = cb.transpose(0, 1)
    return cb.reshape(rounds * sectors, nt_ * nr_)
