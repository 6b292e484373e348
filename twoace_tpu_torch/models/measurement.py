"""RSS measurement model.

Port of ``twoace_tpu.models.measurement`` (ref:
main/src/generate_measurement/Generate_Measurement.m:67-135).

``y = FW vec(H) + n`` with colored noise: the reference draws one complex
Gaussian noise matrix per Rx array and combines it through the combiner
columns (``diag(W' * noiseMatrix)``), the same realization for every Tx
probe (ref :110-115).  That structure is kept when ``w`` is given; iid
noise otherwise.  Draws come from ``torch.Generator``s on the CPU (the
noise from the generator, the phase scrambling from ``fold_in(generator,
1)``) and move to the data's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.rng import fold_in


class Measurements(NamedTuple):
    norm_square: torch.Tensor    #: (U, M) |y|^2, the RSS the testbed observes
    perfect_phase: torch.Tensor  #: (U, M) complex y
    noisy_phase: torch.Tensor    #: (U, M) y with scrambled phase (ref :119-120)
    isnr: torch.Tensor           #: (U, M) instantaneous SNR per measurement
    noise_power: torch.Tensor    #: scalar noise power


def _real_dtype(cdtype):
    return torch.float64 if cdtype == torch.complex128 else torch.float32


def complex_normal(generator, shape, dtype, device):
    """CN(0, 1) draws: (re + 1j im) / sqrt(2), re and im standard normal,
    drawn on the CPU in that order."""
    rdt = _real_dtype(dtype)
    re = torch.randn(shape, generator=generator, dtype=rdt)
    im = torch.randn(shape, generator=generator, dtype=rdt)
    return (torch.complex(re, im) / np.sqrt(2.0)).to(dtype).to(device)


def generate_measurement(generator: Optional[torch.Generator], fw, vec_h,
                         snr_db: float, add_noise: bool = True,
                         w: Optional[torch.Tensor] = None,
                         mt: Optional[int] = None) -> Measurements:
    """Measure a batch of channels through sensing rows.

    ``fw``: ``(U, M, n)`` or ``(M, n)`` (broadcast over U); ``vec_h``:
    ``(U, n)``; SNR in dB with the signal power normalised to 1
    (ref :96-100); without noise ``noise_power`` is 1e-10 (ref :123-125).
    ``w``: an optional per-user combiner ``(U, nr, mr)`` for colored noise
    (ref :110-115): one (nr, mr) draw per user, tiled over the ``mt`` Tx
    probes (default M // mr).
    """
    if vec_h.dim() == 1:
        vec_h = vec_h[None]
    batch = vec_h.shape[0]
    if fw.dim() == 2:
        fw = fw[None].expand(batch, *fw.shape)
    m = fw.shape[1]
    dtype = torch.promote_types(fw.dtype, vec_h.dtype)
    rdt = _real_dtype(dtype)
    dev = fw.device

    clean = torch.einsum("umn,un->um", fw.to(dtype), vec_h.to(dtype))

    if add_noise:
        noise_power = torch.tensor(10.0 ** (-snr_db / 10.0), dtype=rdt,
                                   device=dev)
        if w is not None:
            w = w.to(dtype)
            nr_, mr = w.shape[-2], w.shape[-1]
            mt_ = m // mr if mt is None else mt
            nmat = complex_normal(generator, (batch, nr_, mr), dtype, dev)
            sub = torch.einsum("urm,urm->um", w.conj(), nmat)   # diag(W' N)
            noise = sub.repeat(1, mt_) * torch.sqrt(noise_power)
        else:
            noise = complex_normal(generator, (batch, m), dtype, dev) \
                * torch.sqrt(noise_power)
        y = clean + noise
        isnr = y.abs() ** 2 / torch.clamp(noise.abs() ** 2, min=1e-30)
    else:
        noise_power = torch.tensor(1e-10, dtype=rdt, device=dev)
        y = clean
        isnr = torch.full((batch, m), float("inf"), dtype=rdt, device=dev)

    # "noisy phase": y times a fresh CN(0, 1) draw (ref :119-120); the
    # reference scrambles the magnitude as well, not only the phase
    noisy_phase = y * complex_normal(fold_in(generator, 1), (batch, m),
                                     dtype, dev)

    return Measurements(norm_square=y.abs() ** 2, perfect_phase=y,
                        noisy_phase=noisy_phase, isnr=isnr,
                        noise_power=noise_power)
