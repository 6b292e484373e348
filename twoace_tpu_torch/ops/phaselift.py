"""PhaseLift: trace-regularized PSD least squares for phase retrieval
(port of ``twoace_tpu.ops.phaselift``: :func:`phaselift_fista` and
:func:`phaselift_bm`).

Replaces the TFOCS ``solver_TraceLS`` path of the reference
(ref: main/src/my_recovery_algorithms/MyPhaseLift.m:69-108):

    minimize_{X >= 0}  0.5 || b - A(X) ||_2^2 + lam trace(X)

with the lifted operator ``A(X)_i = a_i^T X conj(a_i)``.

- :func:`phaselift_fista`: exact lifted accelerated proximal gradient;
  the prox of ``lam tr + PSD-indicator`` is an eigenvalue soft threshold,
  so every one of its ``max_iters`` trips runs a ``torch.linalg.eigh``
  (which waits for the card).  No early stop, as in the JAX package.
- :func:`phaselift_bm`: Burer-Monteiro factored X = V V^H, batched over
  leading axes (the JAX package vmaps it over instances).

``phaselift_bm_pair`` (the pair form for complex-free runtimes) is still
to port.  The rank-1 extraction follows MyPhaseLift.m:106-107; its
eigenvector is defined only up to a global phase.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import PhaseLiftConfig


class PhaseLiftResult(NamedTuple):
    x: torch.Tensor          #: (..., n) leading-eigvec extraction sqrt(w1) v1
    lifted: torch.Tensor     #: (..., n, n) the PSD iterate (V V^H for BM)
    objective: torch.Tensor


def _apply_linop(a, x_lift):
    """A(X)_i = a_i^T X conj(a_i)."""
    return torch.sum((a @ x_lift) * a.conj(), dim=-1).real


def _adjoint(a, r):
    """Adjoint of :func:`_apply_linop` under <X, Y> = Re tr(X^H Y):
    A*(r)[n, m] = sum_i r_i conj(a_i[n]) a_i[m]."""
    return a.conj().transpose(-1, -2) @ (r[..., None].to(a.dtype) * a)


def _fro(x):
    return torch.linalg.matrix_norm(x)


def _lipschitz(a, iters: int = 16):
    """Power iteration on X -> A*(A(X)) for the FISTA step size."""
    x = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    for _ in range(iters):
        y = _adjoint(a, _apply_linop(a, x))
        x = y / torch.clamp(_fro(y), min=1e-30).to(a.dtype)
    return _fro(_adjoint(a, _apply_linop(a, x)))


def _gram_eigh(h):
    """``torch.linalg.eigh`` of the BM factor's k x k Gram in double
    precision, cast back.  The Gram's block for the columns outside the
    measured subspace decays toward 1e-21 when M < k; in float32 the
    card's solver then fails to converge."""
    wide = torch.complex128 if h.is_complex() else torch.float64
    w, v = torch.linalg.eigh(h.to(wide))
    return w.to(h.real.dtype), v.to(h.dtype)


def _extract(x_lift):
    w, v = torch.linalg.eigh(x_lift)
    return torch.sqrt(torch.clamp(w[..., -1], min=0.0)).to(v.dtype) * v[..., -1]


def phaselift_fista(a, b, cfg: PhaseLiftConfig = PhaseLiftConfig()
                    ) -> PhaseLiftResult:
    """Accelerated proximal gradient on the lifted SDP, ``cfg.max_iters``
    trips.

    ``a``: (m, n) sensing rows; ``b``: (m,) intensity measurements
    (|y|^2), the reference's ``(measurements/2e5).^2*1e10`` convention
    (ref: Recover_Channel.m:35).
    """
    n = a.shape[-1]
    b = b.real
    t = 1.0 / _lipschitz(a)
    tc = t.to(a.dtype)
    x = torch.zeros((n, n), dtype=a.dtype, device=a.device)
    z = x

    def prox(x):
        x = 0.5 * (x + x.conj().T)
        w, v = torch.linalg.eigh(x)
        w = torch.clamp(w - t * cfg.lam, min=0.0)
        return (v * w.to(v.dtype)) @ v.conj().T

    tk = 1.0
    for _ in range(cfg.max_iters):
        g = _adjoint(a, _apply_linop(a, z) - b)
        x_new = prox(z - tc * g)
        tk_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * tk * tk))
        z = x_new + ((tk - 1.0) / tk_new) * (x_new - x)
        x, tk = x_new, tk_new
    obj = (0.5 * torch.sum((b - _apply_linop(a, x)) ** 2)
           + cfg.lam * torch.trace(x).real)
    return PhaseLiftResult(x=_extract(x), lifted=x, objective=obj)


def phaselift_bm(generator, a, b, cfg: PhaseLiftConfig = PhaseLiftConfig()
                 ) -> PhaseLiftResult:
    """Burer-Monteiro factored PhaseLift: X = V V^H, V of shape (n, k).

    minimize_V 0.5 || b - A(V V^H) ||^2 + lam ||V||_F^2, Wirtinger-flow
    style: spectral initialization from the top-k eigenvectors of
    ``A^H diag(b) A`` (rescaled to the mean measured intensity), then
    ``cfg.max_iters`` trips of momentum gradient descent with the
    scale-invariant decayed step ``0.2/(1 + t/300) ||V|| / ||g||``.
    ``a``: (..., m, n); ``b``: (..., m) intensities; leading axes are
    independent instances.  ``generator`` is unused (the JAX package's
    key is too): the spectral init is deterministic.
    """
    del generator
    b = b.real
    k = cfg.bm_rank
    a_h = a.conj().transpose(-1, -2)

    # spectral init (Wirtinger-flow style)
    y_mat = a_h @ (b[..., None].to(a.dtype) * a)
    w0, u0 = torch.linalg.eigh(0.5 * (y_mat + y_mat.conj().transpose(-1, -2)))
    w_top = w0.flip(-1)[..., :k]
    v0 = u0.flip(-1)[..., :k] * torch.sqrt(
        torch.clamp(w_top, min=0.0))[..., None, :].to(a.dtype)
    p0 = torch.sum((a @ v0).abs() ** 2, dim=-1)
    scale = torch.sqrt(torch.mean(b, dim=-1)
                       / torch.clamp(torch.mean(p0, dim=-1), min=1e-30))
    v0 = v0 * scale[..., None, None].to(a.dtype)

    def loss_grad(v):
        av = a @ v                                       # (..., m, k)
        r = torch.sum(av.abs() ** 2, dim=-1) - b          # A(V V^H) - b
        g = 2.0 * (a_h @ (r[..., None].to(a.dtype) * av)) + 2.0 * cfg.lam * v
        loss = (0.5 * torch.sum(r ** 2, dim=-1)
                + cfg.lam * torch.sum(v.abs() ** 2, dim=(-2, -1)))
        return loss, g

    v, mom = v0, torch.zeros_like(v0)
    for it in range(cfg.max_iters):
        _, g = loss_grad(v)
        eta = 0.2 / (1.0 + it / 300.0)
        rel = _fro(v) / torch.clamp(_fro(g), min=1e-30)
        mom = 0.9 * mom - (eta * rel)[..., None, None].to(a.dtype) * g
        v = v + mom
    # the leading column through the thin k x k Gram's eigh
    gram = v.conj().transpose(-1, -2) @ v
    w, s = _gram_eigh(0.5 * (gram + gram.conj().transpose(-1, -2)))
    w1 = w[..., -1]
    lead = (v @ s[..., -1:])[..., 0] / torch.clamp(
        torch.sqrt(w1), min=1e-30)[..., None].to(a.dtype)
    x = torch.sqrt(torch.clamp(w1, min=0.0))[..., None].to(a.dtype) * lead
    loss, _ = loss_grad(v)
    return PhaseLiftResult(x=x, lifted=v @ v.conj().transpose(-1, -2),
                           objective=loss)
