"""Spectral-profile (power-law) analysis of channel matrices (port of
``twoace_tpu.utils.spectral_analysis``).

The analysis scripts that motivate the 2ACE prox design
(ref: Numerical_Simulation/src/others/):
  - ``variance_of_K_singular_values.m:1-24``: per-k captured energy
  - ``plot_deviation_from_power_law.m:10-30``: deviation of a channel's
    singular-value profile from the A1/A2 constraint ladders
  - ``eig_decay.m``: eigenvalue decay curves
  - ``nuclear_norm.m:1-15`` / ``plot_l1_norm.m``: norm summaries

Every function is batched over leading axes and runs on its input's
device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops.prox import profile_ladder


def singular_profile(h_matrix):
    """Squared singular values of H, descending, batched ``(..., k)``."""
    s = torch.linalg.svdvals(torch.as_tensor(h_matrix))
    return torch.flip(torch.sort(s * s, dim=-1).values, dims=(-1,))


def captured_energy(h_matrix):
    """Cumulative energy fraction captured by the top-k singular values.

    ref: variance_of_K_singular_values.m:1-24.
    """
    csum = torch.cumsum(singular_profile(h_matrix), dim=-1)
    return csum / torch.clamp(csum[..., -1:], min=1e-30)


def ladder_deviation(h_matrix, nt: int, nr: int,
                     mode: str = "v4") -> Dict[str, torch.Tensor]:
    """How far a channel's spectral profile violates each ladder level.

    Positive deviation: the top-r energy falls short of the required
    fraction f (the prox would rescale).  ref: plot_deviation_from_power_law.m.
    """
    frac = captured_energy(h_matrix)
    ladder = profile_ladder(nt, nr, m=0, n=nt * nr, use_rank_one=False,
                            mode=mode)
    return {f"C({r},{f})": torch.clamp(f - frac[..., r - 1], min=0.0)
            for r, f in ladder}


def eig_decay(h_matrix):
    """Normalized eigenvalue (squared singular value) decay curve."""
    s2 = singular_profile(h_matrix)
    return s2 / torch.clamp(s2[..., :1], min=1e-30)


def nuclear_norm(h_matrix):
    """||H||_* (ref: nuclear_norm.m:1-15)."""
    return torch.sum(torch.linalg.svdvals(torch.as_tensor(h_matrix)), dim=-1)


def l1_norm(vec_z):
    """||z||_1 of the sparse representation (ref: plot_l1_norm.m)."""
    return torch.sum(torch.abs(torch.as_tensor(vec_z)), dim=-1)


def power_law_fit(h_matrix) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares power-law exponent of the singular profile:
    log s2_k ~ alpha * log k + c.  Returns (alpha, rms residual)."""
    s2 = singular_profile(h_matrix)
    k = torch.arange(1, s2.shape[-1] + 1, dtype=s2.dtype, device=s2.device)
    x = torch.log(k)
    y = torch.log(torch.clamp(s2, min=1e-30))
    xm = torch.mean(x)
    ym = torch.mean(y, dim=-1, keepdim=True)
    alpha = torch.sum((x - xm) * (y - ym), dim=-1) / torch.sum((x - xm) ** 2)
    resid = y - (ym + alpha[..., None] * (x - xm))
    return alpha, torch.sqrt(torch.mean(resid ** 2, dim=-1))
