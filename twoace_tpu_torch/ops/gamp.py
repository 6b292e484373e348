"""Generalized Approximate Message Passing, complex (port of
``twoace_tpu.ops.gamp``).

Replaces the vendored GAMP suite (main/3rd_software_component/GAMP/...):

- ``EMBGAMP`` (:func:`gamp`, :func:`embgamp`): a Bernoulli-Gaussian input
  channel with EM learning of (sparsity, signal variance, noise
  variance), stage 2 of PLGAMP and the conventional-CS baseline (ref:
  My_TwoStage_Recovery.m:163-181, My_Conventional_CS.m:14-30);
- ``prGAMP4`` (:func:`prgamp`): GAMP with the magnitude-only output
  channel (ref: MyPRGAMP.m:63-76);
- VAMP (:func:`vamp`, :func:`vamp_cs`): vector AMP with the LMMSE stage
  solved through one SVD of A.

The standard recursions (Rangan 2011; Rangan-Schniter-Fletcher 2016)
with Vila-Schniter EM updates, a fixed trip count and damping, as the JAX
package writes them; the loops read nothing back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .spectral_init import spectral_initialize


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


class VampResult(NamedTuple):
    x: torch.Tensor
    precision: torch.Tensor   #: the final denoiser-input precision gamma1


def vamp(a, y, *, lam0: float, phi0, gamma_w, iters: int = 50,
         damping: float = 0.8) -> VampResult:
    """Vector AMP for ``y = A x + w`` with a Bernoulli-Gaussian prior.

    Replaces the vendored suite's VAMP (ref: {main,Numerical_Simulation}/
    3rd_software_component/GAMP/trunk/code/VAMP).  The LMMSE stage is
    solved exactly through one SVD of A, so a trip is O(mn) products;
    unlike GAMP, VAMP stays stable on ill-conditioned directional
    codebooks.  The answer does not depend on the SVD's phase convention.
    ``gamma_w``: the noise precision 1/psi; ``phi0``: the prior signal
    variance.  ``iters`` trips with gamma damping.
    """
    n = a.shape[1]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    k = s.shape[0]
    rdt, dev = s.dtype, a.device
    lam = torch.as_tensor(lam0, dtype=rdt, device=dev)
    phi = torch.as_tensor(phi0, dtype=rdt, device=dev)
    gw = torch.as_tensor(gamma_w, dtype=rdt, device=dev)
    d = s * s                              # (k,) eigenvalues of A^H A
    aty_v = s.to(a.dtype) * (u.mH @ y)     # A^H y in V coordinates
    v = vh.mH

    def lmmse(r2, g2):
        """argmin gw ||y - A x||^2 + g2 ||x - r2||^2 through the SVD;
        returns (x2, alpha2)."""
        vr2 = vh @ r2
        c = (gw * aty_v + g2.to(a.dtype) * vr2) / (gw * d + g2).to(a.dtype)
        x2 = v @ (c - vr2) + r2
        # divergence: k spectral components and n - k passed through
        alpha2 = (torch.sum(g2 / (gw * d + g2)) + (n - k)) / n
        return x2, alpha2

    r1 = a.mH @ y
    g1 = 1.0 / torch.clamp(phi, min=1e-20)
    for _ in range(iters):
        # the denoising stage
        x1, tau_x, _, _, _ = _bg_denoiser(r1, 1.0 / g1, lam, phi)
        alpha1 = torch.clamp(g1 * torch.mean(tau_x), 1e-6, 1.0 - 1e-6)
        eta1 = g1 / alpha1
        g2 = torch.clamp(eta1 - g1, min=1e-12)
        r2 = (eta1.to(a.dtype) * x1 - g1.to(a.dtype) * r1) / g2.to(a.dtype)
        # the LMMSE stage
        x2, alpha2 = lmmse(r2, g2)
        alpha2 = torch.clamp(alpha2, 1e-6, 1.0 - 1e-6)
        eta2 = g2 / alpha2
        g1_new = torch.clamp(eta2 - g2, min=1e-12)
        r1_new = (eta2.to(a.dtype) * x2 - g2.to(a.dtype) * r2) \
            / g1_new.to(a.dtype)
        g1 = damping * g1_new + (1 - damping) * g1
        r1 = damping * r1_new + (1 - damping) * r1
    x, _, _, _, _ = _bg_denoiser(r1, 1.0 / g1, lam, phi)
    return VampResult(x=x, precision=g1)


def vamp_cs(y, a, snr_db: float, lam0: float, iters: int = 50):
    """The VAMP conventional-CS entry, with :func:`embgamp`'s interface
    (the role of My_Conventional_CS.m:14-24, with the vendored suite's
    VAMP in place of EMBGAMP)."""
    m, n = a.shape
    y_pow = torch.mean(y.abs() ** 2)
    psi0 = y_pow / (1.0 + 10.0 ** (snr_db / 10.0))
    col_pow = torch.mean(torch.sum(a.abs() ** 2, dim=0))
    phi0 = torch.clamp((y_pow - psi0) * m
                       / torch.clamp(col_pow * lam0 * n, min=1e-20), min=1e-12)
    return vamp(a, y, lam0=lam0, phi0=phi0, gamma_w=1.0 / psi0,
                iters=iters).x


def prgamp(y_mag, a, lam0: float = 0.1, iters: int = 300):
    """Phase-retrieval GAMP, the magnitude-only output channel (ref:
    MyPRGAMP.m:71 ``prGAMP4(sqrt(y), A, opt)``: the input is the
    magnitude).  A spectral initialization, scaled so the predicted
    magnitudes carry the measured energy, breaks the x = 0 fixed point of
    the magnitude channel."""
    x0 = spectral_initialize(a, y_mag, 1)[:, 0]
    ax = (a @ x0).abs()
    x0 = x0 * (torch.linalg.vector_norm(y_mag) / torch.clamp(
        torch.linalg.vector_norm(ax), min=1e-20)).to(a.dtype)
    return gamp(a, y_mag, lam0=lam0, psi0=1e-3 * torch.mean(y_mag ** 2),
                iters=iters, learn_lambda=True, output="magnitude", x0=x0).x
