"""Figure layer: the reference's plot scripts as library functions (a
copy of ``twoace_tpu.utils.plotting``; the port imports nothing of the
JAX package).

Covers the roles of (ref: */src/evaluate_plot_results/Plot_*.m,
main/createfigure.m:1-65, main/show_beamforming_data.m:20-49,
Numerical_Simulation/src/others/plot_*.m):
  - recovery error vs measurements / SNR curves
  - CDF of channel NMSE
  - beam patterns and beam width
  - spectral-profile (power-law) diagnostics
  - beamforming-RSS method comparison

matplotlib is imported lazily so headless/compute-only deployments never
pay for it: no path on the card needs it.  Inputs are numpy arrays (or
anything ``np.asarray`` takes); ``plot_spectral_profile`` also takes the
channel matrices as a torch tensor.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_error_vs_grid(grid, curves: Dict[str, np.ndarray],
                       xlabel: str, path: str, logy: bool = True,
                       ylabel: str = "NMSE"):
    """Error curves per method (ref: Plot_result.m / Plot_result_H.m)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, ys in sorted(curves.items()):
        ax.plot(grid, ys, marker="o", label=name)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_measurements_vs_range(ranges_deg, m_needed: Dict[str, np.ndarray],
                               maee_targets, path: str,
                               methods=("plgamp", "perfect_phase_cs",
                                        "admm_lowrank_v4")):
    """The VS_SR figure: measurements needed vs search range, one panel
    per method, one curve per MAEE target (ref: VS_SR_par.m:125-152 —
    including its reversed x axis)."""
    plt = _plt()
    methods = [m for m in methods if m in m_needed]
    fig, axes = plt.subplots(len(methods), 1,
                             figsize=(6, 2.6 * len(methods)), sharex=True)
    if len(methods) == 1:
        axes = [axes]
    markers = ["*-", "s-", "o-"]
    for ax, name in zip(axes, methods):
        sel = np.asarray(m_needed[name])            # (R, T)
        for t_i, tgt in enumerate(maee_targets):
            ax.plot(ranges_deg, sel[:, t_i], markers[t_i % len(markers)],
                    label=f"MAEE $\\approx$ {tgt}$^\\circ$")
        ax.set_ylabel("measurements $M^2$")
        ax.set_title(name, fontsize=9)
        ax.grid(True, alpha=0.3)
        ax.invert_xaxis()                            # ref: XDir reverse
        ax.legend(fontsize=7)
    axes[-1].set_xlabel("searching range $\\Delta\\theta$ (deg)")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_nmse_cdf(nmse_by_method: Dict[str, np.ndarray], path: str):
    """CDF of per-instance channel NMSE (ref: CDF_H.m)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, vals in sorted(nmse_by_method.items()):
        v = np.sort(10 * np.log10(np.maximum(np.asarray(vals), 1e-30)))
        ax.plot(v, np.linspace(0, 1, len(v)), label=name)
    ax.set_xlabel("NMSE (dB)")
    ax.set_ylabel("CDF")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_beam_pattern(weights, k_d: float, path: str,
                      n_angles: int = 721):
    """|a(theta)^H w| over azimuth for each beam (ref: show_beam_pattern.m)."""
    plt = _plt()
    w = np.atleast_2d(np.asarray(weights))
    if w.shape[0] > w.shape[1]:
        w = w.T                                  # beams on rows
    n = w.shape[1]
    theta = np.linspace(-90, 90, n_angles)
    a = np.exp(-1j * k_d * np.sin(np.deg2rad(theta))[:, None]
               * np.arange(n)[None, :]) / np.sqrt(n)
    gain = np.abs(a.conj() @ w.T)
    fig, ax = plt.subplots(figsize=(6, 4))
    for i in range(min(w.shape[0], 16)):
        ax.plot(theta, 20 * np.log10(np.maximum(gain[:, i], 1e-6)), lw=0.8)
    ax.set_xlabel("azimuth (deg)")
    ax.set_ylabel("gain (dB)")
    ax.set_ylim(-40, 5)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_spectral_profile(h_matrices, path: str,
                          ladders: Optional[Dict[str, Sequence]] = None):
    """Captured-energy curves vs the constraint ladders
    (ref: plot_deviation_from_power_law.m:10-30)."""
    from .spectral_analysis import captured_energy

    plt = _plt()
    frac = captured_energy(torch.as_tensor(h_matrices)).cpu().numpy()
    fig, ax = plt.subplots(figsize=(6, 4))
    ks = np.arange(1, frac.shape[-1] + 1)
    for row in frac.reshape(-1, frac.shape[-1])[:32]:
        ax.plot(ks, row, color="C0", alpha=0.3, lw=0.8)
    if ladders:
        for name, lad in ladders.items():
            rs = [r for r, _ in lad]
            fs = [f for _, f in lad]
            ax.step(rs, fs, where="post", marker="s", label=name)
        ax.legend(fontsize=8)
    ax.set_xlabel("rank prefix k")
    ax.set_ylabel("captured energy fraction")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_beamforming_rss(rss_by_method: Dict[str, float], path: str):
    """Per-method beamformed-RSS bars (ref: createfigure.m:1-65,
    show_beamforming_data.m:20-49)."""
    plt = _plt()
    names = sorted(rss_by_method)
    vals = [rss_by_method[k] for k in names]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(range(len(names)), vals)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=30, ha="right", fontsize=8)
    ax.set_ylabel("beamformed RSS (dBm)")
    ax.grid(True, axis="y", alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def beam_width_deg(weights, k_d: float, scan_deg=(60.0, 120.0),
                   step_deg: float = 0.03, floor: float = 1e-3):
    """Half-power (-3 dB) beamwidth of a ULA beamformer, in degrees.

    Scans the array response |w^H a(theta)| over ``scan_deg`` on a
    ``step_deg`` grid (ref: show_beam_width.m:57-76 scans pi/3..2pi/3 at
    0.0005 rad) and returns ``(width_deg, thetas_deg, gain_db)``; the width
    is the extent of the contiguous region around the peak within 3 dB of it.
    """
    weights = np.asarray(weights).reshape(-1)
    n = weights.shape[0]
    thetas = np.arange(scan_deg[0], scan_deg[1] + step_deg / 2, step_deg)
    phase = np.cos(np.deg2rad(thetas))[:, None] * np.arange(n)[None, :]
    a = np.exp(1j * 2 * np.pi * k_d * phase)
    gain = np.abs(a @ weights.conj())
    gain = np.maximum(gain, floor)
    gain_db = 10 * np.log10(gain)
    peak = int(np.argmax(gain_db))
    thr = gain_db[peak] - 3.0
    lo = peak
    while lo > 0 and gain_db[lo - 1] >= thr:
        lo -= 1
    hi = peak
    while hi < len(thetas) - 1 and gain_db[hi + 1] >= thr:
        hi += 1
    return (thetas[hi] - thetas[lo]), thetas, gain_db


def plot_beam_width(weights, k_d: float, path: str):
    """Gain pattern with peak and -3 dB reference lines
    (ref: show_beam_width.m:77-81)."""
    width, thetas, gain_db = beam_width_deg(weights, k_d)
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(thetas, gain_db, "r", label=f"pattern (-3dB width {width:.1f}°)")
    ax.axhline(gain_db.max(), color="C0", lw=0.8)
    ax.axhline(gain_db.max() - 3.0, color="C1", lw=0.8)
    ax.set_xlabel("angle (deg)")
    ax.set_ylabel("gain (dB)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return width
