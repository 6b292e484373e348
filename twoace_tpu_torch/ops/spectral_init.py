"""Spectral initialization for magnitude-only recovery (port of
``twoace_tpu.ops.spectral_init`` and of ``eigh_jacobi.subspace_eigh``).

ref: inferLowRankV4_multi.m:561-574 (SpectralInitialize).  Rows of A are
scaled by b_i / ||A_i||; the top-r eigenpairs of As^H As, scaled by
sqrt(eigenvalue), initialize the over-parameterized X.  For n > 4r,
``method="subspace"`` finds the leading subspace by the JAX package's
fixed-trip orthogonal iteration instead of a full decomposition.
"""

from __future__ import annotations

from typing import Optional

import torch

from .prox import eigh_desc

#: seed of the start block when the caller passes no generator (the JAX
#: package's ``PRNGKey(17)``)
DEFAULT_SEED = 17


def subspace_eigh(g, k: int, iters: int = 24,
                  generator: Optional[torch.Generator] = None):
    """Top-``k`` eigenpairs of a Hermitian PSD ``g`` (n, n) by ``iters``
    trips of orthogonal iteration on a 2k-column block (a complex QR each
    trip) and a Rayleigh-Ritz step.  The start block is a real normal
    draw from ``generator`` on the CPU, cast to g's dtype.  Returns
    ``(w, v)`` descending."""
    n = g.shape[-1]
    k = min(k, n)
    if generator is None:
        generator = torch.Generator().manual_seed(DEFAULT_SEED)
    q = torch.randn((n, 2 * k), generator=generator, dtype=torch.float32)
    q = q.to(device=g.device, dtype=g.dtype)
    for _ in range(iters):
        q = torch.linalg.qr(g @ q).Q
    rr = q.mH @ (g @ q)
    w, s = eigh_desc(0.5 * (rr + rr.mH))
    return w[:k], (q @ s)[:, :k]


def spectral_initialize(a, b, r: int, method: str = "subspace",
                        eig_backend: str = "jacobi",
                        generator: Optional[torch.Generator] = None):
    """X0 of shape (n, r) for the complex (m, n) ``a`` and real (m,) ``b``.

    ``method="subspace"`` (for n > 4r) runs :func:`subspace_eigh` with
    ``generator``; otherwise, or with ``method="eigh"``, the full
    ``torch.linalg.eigh``.  ``eig_backend`` is accepted for the JAX
    signature.
    """
    m, n = a.shape
    r = min(r, m, n)
    row_norm = torch.linalg.vector_norm(a, dim=-1)
    scale = torch.where(row_norm > 0, b / torch.clamp(row_norm, min=1e-30),
                        1.0)
    a_s = a * scale[:, None].to(a.dtype)
    g = a_s.mH @ a_s
    g = 0.5 * (g + g.mH)
    if method == "subspace" and n > 4 * r:
        w, v = subspace_eigh(g, r, generator=generator)
    else:
        w, v = eigh_desc(g, eig_backend)
        w, v = w[:r], v[:, :r]
    w = torch.clamp(w, min=0.0)
    return v * torch.sqrt(w)[None, :].to(a.dtype)


def random_initialize(generator: Optional[torch.Generator], shape, like):
    """init_mode = 0: uniform random scaled by max |like|, in like's dtype
    and on its device (ref: inferLowRankV4_multi.m:59-61).  The draw is
    made on the CPU from ``generator``."""
    mx = torch.max(torch.abs(like))
    u = torch.rand(tuple(shape), generator=generator, dtype=mx.dtype)
    return (u.to(like.device) * mx).to(like.dtype)
