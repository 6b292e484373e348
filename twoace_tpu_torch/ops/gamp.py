"""Generalized Approximate Message Passing, complex (port of
``twoace_tpu.ops.gamp``: :func:`gamp` and :func:`embgamp`).

Replaces the vendored GAMP suite's ``EMBGAMP``
(main/3rd_software_component/GAMP/...): a Bernoulli-Gaussian input channel
with EM learning of (sparsity, signal variance, noise variance), stage 2
of PLGAMP and the conventional-CS baseline (ref:
My_TwoStage_Recovery.m:163-181, My_Conventional_CS.m:14-30).  The
standard sum-product recursion (Rangan 2011) with Vila-Schniter EM
updates, a fixed trip count and damping, as the JAX package writes it;
the loop reads nothing back to the host.  ``vamp``, ``vamp_cs`` and
``prgamp`` are still to port.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GampResult(NamedTuple):
    x: torch.Tensor
    tau_x: torch.Tensor
    sparsity: torch.Tensor
    noise_var: torch.Tensor


def _bg_denoiser(r, tau_r, lam, phi):
    """Posterior mean and variance of x under the prior
    lam CN(0, phi) + (1 - lam) delta_0 and the pseudo-observation
    r ~ CN(x, tau_r)."""
    tau_r = torch.clamp(tau_r, min=1e-20)
    phi_p = phi + tau_r
    r2 = r.abs() ** 2
    log_num = -r2 / phi_p - torch.log(phi_p)
    log_den = -r2 / tau_r - torch.log(tau_r)
    ratio = (lam / torch.clamp(1.0 - lam, min=1e-12)) * torch.exp(
        torch.clamp(log_num - log_den, -50.0, 50.0))
    pi = ratio / (1.0 + ratio)
    gamma = r * (phi / phi_p).to(r.dtype)
    nu = phi * tau_r / phi_p
    x_hat = pi.to(r.dtype) * gamma
    tau_x = pi * (nu + gamma.abs() ** 2) - x_hat.abs() ** 2
    return x_hat, torch.clamp(tau_x, min=1e-20), pi, gamma, nu


def _awgn_output(p, tau_p, y, psi):
    """AWGN output channel y = z + w, w ~ CN(0, psi)."""
    tau_p = torch.clamp(tau_p, min=1e-20)
    z_hat = (psi.to(p.dtype) * p + tau_p.to(p.dtype) * y) \
        / (psi + tau_p).to(p.dtype)
    tau_z = psi * tau_p / (psi + tau_p)
    return z_hat, tau_z


def _magnitude_output(p, tau_p, y_mag, psi):
    """Magnitude output channel y = |z| + w (phase-retrieval GAMP): p's
    phase kept, magnitudes blended with precision weights, plus the
    half-variance phase-uncertainty correction of prGAMP."""
    tau_p = torch.clamp(tau_p, min=1e-20)
    p_mag = p.abs()
    p_dir = p / torch.clamp(p_mag, min=1e-20).to(p.dtype)
    mag = (psi * p_mag + tau_p * y_mag) / (psi + tau_p)
    z_hat = mag.to(p.dtype) * p_dir
    tau_z = 0.5 * (psi * tau_p / (psi + tau_p)
                   + tau_p * y_mag / torch.clamp(p_mag + y_mag, min=1e-20))
    return z_hat, tau_z


def gamp(a, y, *, lam0: float, phi0=None, psi0=1e-2, iters: int = 200,
         damping: float = 0.7, learn_lambda: bool = True,
         output: str = "awgn", x0=None,
         adaptive_damping: bool = False) -> GampResult:
    """Run GAMP.  ``a``: (m, n); ``y``: (m,) complex (``output="awgn"``)
    or real magnitudes (``output="magnitude"``).

    ``adaptive_damping`` carries the damping factor in the state and backs
    it off whenever the data residual grows (EMBGAMP's robust step mode,
    which the reference enables, My_TwoStage_Recovery.m:171).  ``psi0``
    may be a float or a 0-d tensor on ``a``'s device.
    """
    m, n = a.shape
    abs2 = a.abs() ** 2
    rdt, dev = abs2.dtype, a.device
    y_pow = torch.mean(y.abs() ** 2)
    psi0 = torch.as_tensor(psi0, dtype=rdt, device=dev)
    if phi0 is None:
        # EM init (Vila-Schniter): split the measured power between signal
        # and noise
        phi0 = (y_pow - psi0) * n / torch.clamp(
            torch.sum(abs2) * lam0 / m, min=1e-20) / n
        phi0 = torch.clamp(phi0, min=1e-12)
    phi0 = torch.as_tensor(phi0, dtype=rdt, device=dev)
    x = (torch.zeros(n, dtype=a.dtype, device=dev) if x0 is None
         else torch.as_tensor(x0, dtype=a.dtype, device=dev))
    tau_x = (phi0 * lam0).expand(n)
    s = torch.zeros(m, dtype=a.dtype, device=dev)
    # the JAX package takes lam0 through float32 first
    lam = torch.tensor(lam0, dtype=torch.float32).to(rdt).to(dev)
    phi, psi = phi0, psi0
    damp = torch.tensor(damping, dtype=rdt, device=dev)
    last_resid = torch.tensor(math.inf, dtype=rdt, device=dev)
    a_h = a.conj().T
    out_fn = _awgn_output if output == "awgn" else _magnitude_output
    for _ in range(iters):
        # output linear step
        tau_p = abs2 @ tau_x
        p = a @ x - s * tau_p.to(a.dtype)
        z_hat, tau_z = out_fn(p, tau_p, y, psi)
        s = (z_hat - p) / tau_p.to(a.dtype)
        tau_s = torch.clamp((1.0 - tau_z / tau_p) / tau_p, min=1e-20)
        # input linear step
        tau_r = 1.0 / torch.clamp(abs2.T @ tau_s, min=1e-20)
        r = x + tau_r.to(a.dtype) * (a_h @ s)
        x_new, tau_x_new, pi, gamma, nu = _bg_denoiser(r, tau_r, lam, phi)
        # damping
        x = damp.to(a.dtype) * x_new + (1 - damp).to(a.dtype) * x
        tau_x = damp * tau_x_new + (1 - damp) * tau_x
        # EM updates (Vila-Schniter)
        if learn_lambda:
            lam = torch.clamp(torch.mean(pi), 1e-4, 1.0 - 1e-4)
        phi = torch.clamp(torch.sum(pi * (nu + gamma.abs() ** 2))
                          / torch.clamp(torch.sum(pi), min=1e-12), min=1e-12)
        resid = (y - a @ x) if output == "awgn" else (y - (a @ x).abs())
        resid2 = torch.mean(resid.abs() ** 2)
        psi = torch.clamp(resid2, min=1e-12)
        if adaptive_damping:
            # back off on residual growth, creep back up on progress
            grow = resid2 > last_resid
            damp = torch.where(grow, torch.clamp(damp * 0.8, min=0.1),
                               torch.clamp(damp * 1.02, max=damping))
        last_resid = resid2
    return GampResult(x=x, tau_x=tau_x, sparsity=lam, noise_var=psi)


def embgamp(y, a, snr_db: float, lam0: float, learn_lambda: bool = True,
            iters: int = 200):
    """EMBGAMP-compatible entry (ref: My_Conventional_CS.m:14-24): complex
    AWGN output, Bernoulli-Gaussian input, EM learning, adaptive damping
    (the reference's robust_gamp mode, My_TwoStage_Recovery.m:171)."""
    psi0 = torch.mean(y.abs() ** 2) / (1.0 + 10.0 ** (snr_db / 10.0))
    return gamp(a, y, lam0=lam0, psi0=psi0, iters=iters,
                learn_lambda=learn_lambda, output="awgn",
                adaptive_damping=True).x
