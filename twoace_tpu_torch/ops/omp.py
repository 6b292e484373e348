"""Orthogonal Matching Pursuit (port of ``twoace_tpu.ops.omp``).

Replaces the vendored CoSaMP_OMP toolbox ``OMP()`` of the two-stage PLOMP
recovery and the conventional-CS fallback
(ref: main/src/my_recovery_algorithms/My_TwoStage_Recovery.m:156-161,
My_Conventional_CS.m:14-30).

As in the JAX package: a fixed trip count with a support mask, each trip
one masked normal-equation solve (n x n), the state frozen once the
residual is small.  Nothing is read back to the host.
"""

from __future__ import annotations

import torch


def omp(a, y, max_steps: int, tol: float = 1e-12):
    """Solve ``y ~= A x`` with at most ``max_steps`` nonzeros.

    ``a``: (m, n); ``y``: (m,).  Returns dense ``x`` (n,) with zeros off
    the selected support.  Runs ``min(max_steps, m, n)`` trips; once the
    residual norm drops below ``tol * ||y||`` the support stops growing
    (the trips go on with a frozen state).  The largest correlation
    takes the first index on ties.
    """
    m, n = a.shape
    a_h = a.conj().T
    gram = a_h @ a                                   # (n, n)
    aty = a_h @ y
    ynorm = torch.linalg.vector_norm(y)
    rdt = ynorm.dtype

    def solve_masked(mask):
        """LS over the masked columns via regularised masked normal
        equations."""
        gm = gram * torch.outer(mask, mask).to(gram.dtype) \
            + torch.diag(1.0 - mask).to(gram.dtype)
        rhs = aty * mask.to(aty.dtype)
        return torch.linalg.solve_ex(gm, rhs)[0] * mask.to(aty.dtype)

    mask = torch.zeros(n, dtype=rdt, device=a.device)
    x = torch.zeros(n, dtype=a.dtype, device=a.device)
    resid = y
    done = torch.zeros((), dtype=torch.bool, device=a.device)
    for _ in range(min(max_steps, m, n)):
        corr = torch.abs(a_h @ resid)
        corr = torch.where(mask > 0, -torch.inf, corr)
        j = torch.argmax(corr)
        mask = torch.where(done, mask, mask.index_fill(0, j[None], 1.0))
        x = solve_masked(mask)
        resid = y - a @ x
        done = done | (torch.linalg.vector_norm(resid) < tol * ynorm)
    return x
