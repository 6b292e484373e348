"""The plain reference that decides ``correct``.

The cells recover noiseless two-path channels from magnitudes measured
through one codebook.  Such a channel is recovered exactly, up to one
global phase, so the reference answer is the channel itself: the sum of
its paths' steering-vector outer products, worked out here in float64
from the path parameters the traffic drew (:func:`channels`).  The
program is handed only the codebook and the magnitudes; nothing it makes
reaches this module except the recoveries it returns, which
:func:`nmse_db` judges.

Plain torch and numpy only: nothing of ``twoace_tpu_torch``, ``twoace_tpu``
or ``jax`` is imported here.
"""

from __future__ import annotations

import math

import torch


def steering(count: int, angle: torch.Tensor) -> torch.Tensor:
    """Unit-norm half-wavelength ULA steering vectors, (..., count)
    complex, for angles (...,) in radians."""
    k = torch.arange(count, dtype=angle.dtype, device=angle.device)
    phase = math.pi * k * torch.sin(angle)[..., None]
    return torch.polar(torch.full_like(phase, 1.0 / math.sqrt(count)), phase)


def channels(aoa, aod, gain, nt: int, nr: int, tf32: bool = False):
    """vec(H) of each channel, (B, nt * nr) complex128.

    ``aoa``, ``aod``: (B, L) float64 angles of the L paths; ``gain``:
    (B, L) complex128.  H = sum_l gain_l a_r(aoa_l) a_t(aod_l)^H is
    (nr, nt), and vec(H) stacks its columns (the layout the solvers
    reshape into nr x nt).  ``tf32`` computes H in TF32 instead, the
    precision below the configurations' float32 (:func:`round_tf32`):
    the control, which the comparison has to refuse.
    """
    ar = steering(nr, aoa) * gain[..., None]                  # (B, L, nr)
    at = steering(nt, aod).conj()                             # (B, L, nt)
    if tf32:
        ar, at = ar.to(torch.complex64), at.to(torch.complex64)
        ar = torch.complex(round_tf32(ar.real), round_tf32(ar.imag))
        at = torch.complex(round_tf32(at.real), round_tf32(at.imag))
    h = torch.einsum("blr,blt->btr", ar, at)                  # H^T: (B, nt, nr)
    return h.reshape(h.shape[0], nt * nr).to(torch.complex128)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties to even),
    as the tensor cores round a TF32 product's operands."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def nmse_db(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """||x e^{-j phi} - h||^2 / ||h||^2 in dB for each row, with phi the
    one global phase a magnitude measurement cannot see, in float64.

    Only the phase is fitted, not the scale: a recovery at the wrong
    scale is wrong.  ``x``, ``h``: (B, n) complex.
    """
    x = x.to(torch.complex128)
    h = h.to(torch.complex128)
    inner = torch.sum(h.conj() * x, dim=-1)                   # h^H x
    err2 = (torch.sum(x.abs() ** 2, dim=-1) + torch.sum(h.abs() ** 2, dim=-1)
            - 2.0 * inner.abs())
    rel = torch.clamp(err2, min=0.0) / torch.sum(h.abs() ** 2, dim=-1)
    return 10.0 * torch.log10(torch.clamp(rel, min=1e-30))
