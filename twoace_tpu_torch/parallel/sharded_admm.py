"""Row- and batch-sharded 2ACE ADMM on complex tensors (port of
``twoace_tpu.parallel.sharded_admm``).

Measurement rows couple only through A^H (...) in the X-update and the
residual norms, so they shard over the rows axis of a (batch x rows)
mesh (:mod:`.mesh`) with two all-reduces a trip, while independent
instances shard over the batch axis with none (the parfor replacement).

This is the complex twin of :mod:`.sharded_pair`, with the JAX package's
REDUCED scaffold (spectral init, over-parameterized solve,
orthonormalization, per-column solve, full-data polish; no restarts):
the debug and reference path beside the production pair scaffold.  Its
loop is :func:`..ops.admm.infer_admm` with the row-reduction hook, so
the magnitude prox and M-dual of each trip are K5 on the card.  A rank
solves its instances one after another.
"""

from __future__ import annotations

import torch

from ..config import AdmmConfig
from ..ops.admm import (_fro2, _loop_kw, _make_prox, _orthonormalize,
                        _precision, infer_admm)
from .mesh import Mesh, RowReduce


def _solve_one(a, b, nt: int, nr: int, cfg: AdmmConfig, prox_kind: str,
               red: RowReduce, m: int):
    """One instance with its rows sharded: ``a`` (m_loc, n) complex,
    ``b`` (m_loc,) real, ``m`` the global row count.  The replicated
    quantities (X, Z, the N-dual, U, the norms) are the same on every
    rank of the rows group."""
    n = a.shape[1]
    r = min(cfg.rank, m, n)
    # normalization (ref: inferLowRankV4_multi.m:27-38)
    s2 = red.sum_(torch.stack([_fro2(a), _fro2(b)]))
    a_norm = torch.sqrt(s2[0] / m)
    a_norm = torch.where(a_norm < cfg.tol_abs, 1.0, a_norm)
    b_norm = torch.sqrt(s2[1])
    b_norm = torch.where(b_norm < cfg.tol_abs, 1.0, b_norm)
    a = a / a_norm.to(a.dtype)
    b = b / b_norm
    # U = inv(A^H A + I): the Gram all-reduced, a replicated Cholesky
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    g = red.sum_(a.mH @ a) + eye
    c = torch.linalg.cholesky(0.5 * (g + g.mH))
    w = torch.linalg.solve_triangular(c, eye, upper=False)
    u_mat = w.mH @ w
    # spectral init (ref :561-574): rows scaled locally, the Gram
    # all-reduced, a replicated eigh
    row_norm = torch.linalg.vector_norm(a, dim=-1)
    scal = torch.where(row_norm > 0, b / torch.clamp(row_norm, min=1e-30),
                       1.0)
    a_s = a * scal[:, None].to(a.dtype)
    g_s = red.sum_(a_s.mH @ a_s)
    w_s, v_s = torch.linalg.eigh(0.5 * (g_s + g_s.mH))
    w_s, v_s = w_s.flip(-1), v_s.flip(-1)
    xs = v_s[:, :r] * torch.sqrt(torch.clamp(w_s[:r], min=0.0))[None, :].to(
        a.dtype)

    prox = _make_prox(prox_kind, nt, nr, m, n, False, cfg, "xla")

    def admm(x0, scale_by_row):
        return infer_admm(a, b, x0, scale_by_row=scale_by_row, prox=prox,
                          u_mat=u_mat, reduce=red, m_eff=m,
                          **_loop_kw(cfg))[0]

    # inferLowRankImpl (ref :111-271), no restarts, then the full-data
    # polish (ref :89-101, without the rollback)
    x = _orthonormalize(admm(xs, True))
    x = admm(x, False)
    x = admm(x[:, None], True)[:, 0]
    return x * (b_norm / a_norm).to(a.dtype)


def solve_lowrank_sharded(mesh: Mesh, a, b, nt: int, nr: int,
                          cfg: AdmmConfig = AdmmConfig(),
                          prox_kind: str = "spectral_profile"):
    """Batch of magnitude-only recoveries over a (batch x rows) mesh.

    ``a``: this rank's (B/batch, m/rows, n) complex block, ``b`` its
    (B/batch, m/rows) real block (:func:`.mesh.problem_sharding`), on
    ``mesh.device``.  Returns x (B/batch, n), replicated over the rows
    group.  ``torch.linalg.eigh`` takes the place of the JAX package's
    ``eigh_desc``; ``infer_admm.trips`` counts the trips.
    """
    if not mesh.member:
        raise ValueError("this rank lies outside the mesh")
    if a.device != mesh.device or b.device != mesh.device:
        raise ValueError(f"the problem lies on {a.device}, the mesh's "
                         f"device is {mesh.device}")
    m = a.shape[1] * mesh.rows
    red = mesh.reduce
    with _precision(cfg):
        return torch.stack([
            _solve_one(a[i], b[i].to(a.real.dtype), nt, nr, cfg, prox_kind,
                       red, m) for i in range(a.shape[0])])
