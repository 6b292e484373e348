"""Bayesian A-optimal beam (row) selection (port of
``twoace_tpu.sensing.bayes_opt``).

The reference's row-exchange A-optimality minimization with rank-1
Sherman-Morrison updates:
  ref: main/src/bayes_opt/bayesAopt_complex.m:105-240 (core loop :187-229)
  ref: main/src/bayes_opt/MyBayesAopt.m:1-231 (multi-user criterion :166-170)
  ref: main/src/generate_sensing_matrix/Bayes_Beam.m:1-15 (candidate draw)

Objective: choose M rows X out of a candidate set C to minimize the
(multi-user) Bayesian A-criterion ``sum_u trace(A * inv(X'X + K_u))``
(A = weight matrix, K_u = per-user prior precision).  The greedy exchange
removes one design row, evaluates the trace delta of adding every candidate
via Sherman-Morrison, and keeps the best swap when it improves the criterion
beyond ``-sqrt(eps)`` (ref: MyBayesAopt.m:201 ``a < acutoff``) or the slot
has never been placed.  As in JAX, each user's inverse is updated exactly
and the criterion deltas are summed (the reference updates the summed
inverse, which is only approximate for U > 1).

The exchange removes and adds a design row x as the rank-1 term
``v v^H`` with ``v = conj(x)``, so the inverse it tracks is that of
``sum_r conj(x_r) x_r^T + K = X^H X + K``: the matrix the criterion
names.  Where a prior K is not Hermitian (the noise prior of a complex
channel, :func:`noise_prior_from_vech`), that inverse is not Hermitian
either, and each update takes its left and right vectors apart; the
criterion's real part is minimized, as the reference's ``a < acutoff``
compares it.  JAX inverts ``X^H X + K`` but updates as ``x x^H``; the
two agree for real rows.

The selection runs on the candidates' device as ``sweeps * m`` exchange
steps.  Each step multiplies the U (n, n) inverses into all C candidates
(one batched complex ``torch.matmul`` with TF32 off, JAX's "float32"
precision; a second one for the left vectors where K is not Hermitian)
and reduces over n; the step's commit is a ``torch.where`` on the
device, so the loop never waits for the card.  The slots placed in the
first sweep are known on the host.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops.pair_solver import no_tf32


def bayes_a_opt_select(generator: Optional[torch.Generator], candidates,
                       m: int, prior_k=None, weight_a=None, sweeps: int = 2,
                       initial=None) -> torch.Tensor:
    """Select ``m`` row indices from ``candidates`` (C, n), complex.

    ``prior_k``: prior precision K, (n, n), or a stack (U, n, n) for the
    multi-user criterion (default I, as Bayes_Beam.m:13 uses);
    ``weight_a``: A-criterion weight, Hermitian (default I; then the step
    skips the weighted product, whose result would equal the unweighted
    one).  The random initial design (ref: bayesAopt_complex.m:127-128) is
    drawn with ``torch.randint`` from ``generator`` on the CPU; ``initial``
    ((m,) host indices) replaces it (tests hand over JAX's draw).
    Returns int64 indices (m,) on the candidates' device.
    """
    cand = torch.as_tensor(candidates)
    c_count, n = cand.shape
    dev, dtype = cand.device, cand.dtype
    if prior_k is None:
        prior_k = torch.eye(n, dtype=dtype, device=dev)
    else:
        prior_k = torch.as_tensor(prior_k).to(device=dev, dtype=dtype)
    if prior_k.dim() == 2:
        prior_k = prior_k[None]          # single user == U = 1
    hermitian = bool(torch.equal(prior_k, prior_k.mH))
    if weight_a is not None:
        weight_a = torch.as_tensor(weight_a).to(device=dev, dtype=dtype)
    acutoff = -math.sqrt(torch.finfo(cand.real.dtype).eps)
    if initial is None:
        initial = torch.randint(0, c_count, (m,), generator=generator)
    rowlist = torch.tensor(np.asarray(initial), dtype=torch.int64,
                           device=dev)

    def recip(s):                        # the Sherman-Morrison weight 1/s
        if hermitian:                    # s is real: JAX's clamp
            return 1.0 / torch.clamp(s.real, min=1e-12)
        return 1.0 / s

    def quad(l, r):                      # l^H A r over the n axis (dim 1)
        if weight_a is not None:
            return torch.sum(l.conj() * (weight_a @ r), dim=1)
        if l is r:
            return torch.linalg.vector_norm(r, dim=1) ** 2
        return torch.sum(l.conj() * r, dim=1)

    with no_tf32():
        x0 = cand[rowlist]
        minv = torch.linalg.inv(x0.mH @ x0 + prior_k)            # (U, n, n)
        xt = cand.T.contiguous()                                 # (n, C)
        vt = xt.conj().resolve_conj()                            # the v_c

        for i in range(sweeps * m):
            row = i % m
            v = vt.index_select(1, rowlist[row:row + 1])         # (n, 1)
            # remove the row, per user: Ninv_u = Minv_u + w_u r_u l_u^H
            # (ref :145-146)
            r = minv @ v                                         # (U, n, 1)
            l = r if hermitian else minv.mH @ v
            w = recip(1.0 - torch.sum(v.conj() * r, dim=(1, 2)))  # (U,)
            ninv = minv + w[:, None, None] * (r @ l.mH)
            # removal delta: +sum_u w_u l_u^H A r_u
            # (ref: MyBayesAopt.m:162-163)
            removal = torch.sum(w * quad(l, r)[:, 0])
            # addition deltas of every candidate (ref :166-171):
            # trace(A (Ninv - w_c r_c l_c^H))
            #     = trace(A Ninv) - w_c l_c^H A r_c
            r_all = ninv @ vt                                    # (U, n, C)
            l_all = r_all if hermitian else ninv.mH @ vt
            w_all = recip(1.0 + torch.sum(xt * r_all, dim=1))    # (U, C)
            delta = (removal - torch.sum(w_all * quad(l_all, r_all),
                                         dim=0)).real            # (C,)
            idx = torch.argmin(delta)                            # first on ties
            # commit when it improves or the slot was never placed
            # (ref: MyBayesAopt.m:201 ``(a < acutoff) || (rowlist(row) == 0)``)
            take = delta[idx] < acutoff
            if i < m:
                take = torch.ones_like(take)
            r_i = r_all[:, :, idx, None]                         # (U, n, 1)
            l_i = r_i if hermitian else l_all[:, :, idx, None]
            minv_new = ninv - w_all[:, idx, None, None] * (r_i @ l_i.mH)
            minv = torch.where(take, minv_new, minv)
            rowlist[row] = torch.where(take, idx, rowlist[row])
    return rowlist


def a_criterion(rows, prior_k=None) -> float:
    """The A-criterion ``sum_u trace(inv(X^H X + K_u))`` of design rows X
    (m, n), in complex128 on the CPU (a check of a selection, not part of
    it)."""
    x = torch.as_tensor(rows).detach().cpu().to(torch.complex128)
    n = x.shape[1]
    if prior_k is None:
        prior_k = torch.eye(n, dtype=torch.complex128)
    prior_k = torch.as_tensor(prior_k).detach().cpu().to(torch.complex128)
    if prior_k.dim() == 2:
        prior_k = prior_k[None]
    inv = torch.linalg.inv(x.mH @ x + prior_k)
    return float(torch.diagonal(inv, dim1=-2, dim2=-1).real.sum())


def prior_from_channel(h_matrix, cfg, n_grid: int,
                       aod_range=(-47.5, 47.5)) -> torch.Tensor:
    """Diagonal prior K from a channel estimate: K_ii = |H w(theta_i)|^{-1/2}
    averaged over the Rx antennas, complex64 on h's device.
    ref: main/src/bayes_opt/find_K.m:1-13."""
    from ..models.steering import steering_vector

    h = torch.as_tensor(h_matrix)
    aod = torch.linspace(aod_range[0], aod_range[1], n_grid,
                         dtype=torch.float64, device=h.device)
    w = steering_vector(torch.sin(torch.deg2rad(aod)), cfg.nt, cfg.k_d)
    gain = torch.abs(torch.einsum("rt,gt->gr", h, w.to(h.dtype)))
    vec_k = torch.sqrt(torch.mean(gain, dim=-1)) ** -1.0
    return torch.diag(vec_k.to(torch.complex64))


def noise_prior_from_vech(vec_h_users, snr_db: float) -> torch.Tensor:
    """Per-user diagonal prior ``K_u = db2pow(SNR) * diag(vecH_u ^ -1)``,
    (U, n, n).  ref: main/src/generate_sensing_matrix/Directional_Beam_Bayes.m:41-48.
    """
    vh = torch.as_tensor(vec_h_users)
    if vh.dim() == 1:
        vh = vh[None]
    scale = 10.0 ** (snr_db / 10.0)
    inv = scale / torch.where(torch.abs(vh) > 1e-30, vh,
                              torch.full_like(vh, 1e-30))
    return torch.diag_embed(inv)
