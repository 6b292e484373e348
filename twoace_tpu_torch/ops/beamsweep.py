"""Sector-level-sweep baseline (802.11ad SLS) with fine angle refinement
(port of ``twoace_tpu.ops.beamsweep``).

ref: main/src/evaluate_plot_results/MyBeamSweeping.m:81-159: probe a
directional beam grid, take the (f, w) pair of largest RSS, then refine
the AoD/AoA estimate by scanning the winning beam's pattern on a fine
angle grid (the reference steps 0.005 degrees, ref :134).  Also the
random-subset sector sweeps and the per-budget table of
main/show_beamforming_data.m.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ArrayConfig
from ..interop import resolve_device
from ..models.steering import steering_vector
from ..sensing.codebooks import directional_beams_angular
from ..utils.rng import fold_in


class SweepResult(NamedTuple):
    f_best: torch.Tensor      #: (nt,) winning precoder
    w_best: torch.Tensor      #: (nr,) winning combiner
    aod_deg: torch.Tensor     #: refined AoD estimate
    aoa_deg: torch.Tensor     #: refined AoA estimate
    rss: torch.Tensor         #: (mt*mr,) the measured sweep


def _refine(beam, n: int, k_d: float, step_deg: float):
    """argmax over theta of |beam^H a(theta)| on a fine grid of
    [-90, 90] degrees (ref :134-153), the first angle on ties."""
    angles = torch.arange(-90.0, 90.0 + step_deg / 2, step_deg,
                          dtype=torch.float64, device=beam.device)
    a = steering_vector(torch.sin(torch.deg2rad(angles)), n, k_d)
    gain = torch.abs(a @ beam.conj().to(a.dtype))
    return angles[torch.argmax(gain)]


def beam_sweep(measure_fn_output, f_set, w_set, cfg: ArrayConfig, mt: int,
               mr: int, step_deg: float = 0.05,
               refine: bool = True) -> SweepResult:
    """The best (f, w) pair of a sweep, with refined angles.

    ``measure_fn_output``: (mt*mr,) measured |y|^2 over the beam grid,
    Tx-major; ``f_set``: (nt, mt); ``w_set``: (nr, mr).  Without
    ``refine`` both angles are 0.
    """
    p = torch.argmax(measure_fn_output)
    f_best = f_set[:, p // mr]
    w_best = w_set[:, p % mr]
    if refine:
        aod = _refine(f_best, cfg.nt, cfg.k_d, step_deg)
        aoa = _refine(w_best, cfg.nr, cfg.k_d, step_deg)
    else:
        aod = aoa = torch.zeros((), device=f_set.device)
    return SweepResult(f_best=f_best, w_best=w_best, aod_deg=aod,
                       aoa_deg=aoa, rss=measure_fn_output)


def sweep_channel(generator: Optional[torch.Generator], vec_h,
                  cfg: ArrayConfig, mt: int, mr: int,
                  aod_range: Tuple[float, float],
                  aoa_range: Tuple[float, float],
                  snr_db: float = math.inf) -> SweepResult:
    """SLS end to end on a synthetic channel (ref :89-129): the
    directional grid, the powers |w^H H f|^2 (with exponential noise of
    power 10^(-snr_db/10) drawn from ``generator`` on the CPU when
    ``snr_db`` is finite), and :func:`beam_sweep`.  Runs on ``vec_h``'s
    device."""
    f_set, w_set = directional_beams_angular(mt, mr, cfg, aod_range,
                                             aoa_range, device=vec_h.device)
    fw = (f_set.T[:, None, :, None] * w_set.conj().T[None, :, None, :])
    fw = fw.reshape(mt * mr, cfg.n)
    power = torch.abs(fw @ vec_h.to(fw.dtype)) ** 2
    if math.isfinite(snr_db):
        noise = torch.empty(power.shape, dtype=power.dtype).exponential_(
            generator=generator)
        power = power + 10.0 ** (-snr_db / 10.0) * noise.to(power.device)
    return beam_sweep(power, f_set, w_set, cfg, mt, mr)


def subset_sweep_rss(generator: Optional[torch.Generator], rss_matrix,
                     m: int, n_runs: int = 10000):
    """Expected best RSS of a sector sweep over an m-beam random subset
    (ref: main/show_beamforming_data.m:42-49, beam_sweeping): draw ``m``
    of the ``total`` sweep beams without replacement (the same subset at
    both link ends), take the largest RSS of the induced submatrix, and
    average over ``n_runs`` draws.  ``rss_matrix``: (total, total), a
    tensor on the device the work runs on; the subsets are drawn from
    ``generator`` on the CPU, all in one batch as the JAX package draws
    them."""
    total = rss_matrix.shape[0]
    idx = torch.rand((n_runs, total), generator=generator).argsort(dim=1)
    idx = idx[:, :m].to(rss_matrix.device)
    sub = rss_matrix[idx[:, :, None], idx[:, None, :]]
    return sub.amax(dim=(1, 2)).mean()


def aggregate_beamforming(rss_bf, rss_sweep_phi=None, rss_sweep_theta=None,
                          m_grid=None,
                          generator: Optional[torch.Generator] = None,
                          n_runs: int = 10000, device="cuda"):
    """The per-budget comparison table of on-air beamforming results
    (ref: main/show_beamforming_data.m:19-38): for each probe budget M,
    each method's best measured beam RSS and the simulated random-subset
    sector sweeps of the phi and theta+phi codebooks.

    ``rss_bf``: {method: (n_m,) or (repeats, n_m)} measured beam RSS (the
    best repeat is kept); the sweeps are (total, total) RSS grids, put on
    ``device``, and budget i draws from ``fold_in(generator, i)``
    (``generator`` None: seed 0).  Returns {name: (n_m,) numpy array}.
    """
    out = {}
    n_m = len(m_grid) if m_grid is not None else \
        len(next(iter(rss_bf.values())))
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for name, vals in rss_bf.items():
        vals = np.asarray(vals)
        out[name] = vals.max(axis=0) if vals.ndim == 2 else vals
    for name, sweep in (("sweep_phi", rss_sweep_phi),
                        ("sweep_theta_phi", rss_sweep_theta)):
        if sweep is None:
            continue
        sweep = torch.as_tensor(sweep, device=resolve_device(device))
        out[name] = np.asarray([
            float(subset_sweep_rss(fold_in(generator, i), sweep,
                                   int(min(m, sweep.shape[0])), n_runs))
            for i, m in enumerate(m_grid[:n_m])])
    return out
