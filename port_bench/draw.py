"""The one traffic generator: a configuration's codebook, and the channels
and magnitudes of each batch or solve, all from ``--seed``.

The draws follow the repository's solve workload (two-path channels,
angles uniform in +-``angle_rad``, complex Gaussian gains, a random-phase
codebook of ``phase_bits`` bits), rebuilt here on the device: the codebook
once at set-up, then each call's channels from their own generator, so
call ``i`` of a seed is the same whatever ran before it.  Magnitudes are
taken in complex128 and handed to the program as float32; the channels
stay with the benchmark for the reference (:mod:`.reference`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .reference import channels

#: the streams drawn from one seed
CODEBOOK, CHANNELS, SOLVER = 0, 1, 2


def stream_seed(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit generator seed for (seed, stream, index): any whole
    ``seed``, negative or beyond 64 bits, gives its own streams."""
    seq = np.random.SeedSequence(
        abs(int(seed)), spawn_key=(int(seed < 0), stream, index % (1 << 64)))
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream, index))


class Codebook(NamedTuple):
    a: torch.Tensor        #: (m, n) complex128, rows of unit-modulus / sqrt(n)
    re: torch.Tensor       #: (m, n) float32, the program's pair
    im: torch.Tensor


def codebook(config: dict, seed: int, device) -> Codebook:
    """The configuration's one flashed codebook: m probes of n = nt * nr
    random phases of ``phase_bits`` bits, scaled by 1/sqrt(n)."""
    m, n = config["m"], config["nt"] * config["nr"]
    levels = 2 ** config["phase_bits"]
    k = torch.randint(0, levels, (m, n), device=device,
                      generator=generator(seed, CODEBOOK, 0, device))
    phase = k.to(torch.float64) * (2.0 * math.pi / levels)
    a = torch.polar(torch.full_like(phase, 1.0 / math.sqrt(n)), phase)
    return Codebook(a, a.real.to(torch.float32).contiguous(),
                    a.imag.to(torch.float32).contiguous())


class Draw(NamedTuple):
    b: torch.Tensor        #: (B, m) float32 magnitudes, the program's input
    h: torch.Tensor        #: (B, n) complex128 channels, the reference's
    aoa: torch.Tensor      #: (B, L) float64 path angles the channels are
    aod: torch.Tensor      #: made from, and their complex128 gains
    gain: torch.Tensor


def channel_batch(config: dict, traffic: dict, cb: Codebook, seed: int,
                  index: int, count: int) -> Draw:
    """Call ``index``'s ``count`` channels and their magnitudes |A h|."""
    dev = cb.a.device
    gen = generator(seed, CHANNELS, index, dev)
    paths, lim = traffic["paths"], traffic["angle_rad"]
    ang = (torch.rand((count, paths, 2), dtype=torch.float64, device=dev,
                      generator=gen) * 2.0 - 1.0) * lim
    g = torch.randn((count, paths, 2), dtype=torch.float64, device=dev,
                    generator=gen)
    aoa, aod = ang[..., 0], ang[..., 1]
    gain = torch.complex(g[..., 0], g[..., 1])
    h = channels(aoa, aod, gain, config["nt"], config["nr"])
    b = torch.abs(h @ cb.a.transpose(0, 1)).to(torch.float32)
    return Draw(b.contiguous(), h, aoa, aod, gain)


def solver_generator(seed: int, index: int) -> torch.Generator:
    """The CPU generator handed to call ``index``'s solve (its splits and
    spectral-init start blocks)."""
    return torch.Generator().manual_seed(stream_seed(seed, SOLVER, index))
