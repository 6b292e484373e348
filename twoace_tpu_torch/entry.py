"""Driver entry points of the port (the counterpart of the JAX
package's root ``__graft_entry__.py``).

- :func:`entry`: one fused 2ACE ADMM iteration on a 16x16-array recovery
  problem (the X-update's products, the magnitude prox with the M-dual,
  the spectral-profile Z-prox, the N-dual, mu *= 1.03), as
  ``twoace_tpu.ops.cplx.admm_iteration_pair`` computes it, on the card;
- :func:`dryrun_multichip`: n ranks on a (batch x rows) mesh, each
  running one batched sharded recovery of each kind on tiny shapes.

    python -m twoace_tpu_torch.entry [--device cpu|cuda] [--ranks N]

runs the step once and then ``dryrun_multichip(N)``.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from .config import AdmmConfig
from .ops.cplx import LadderArrays, Pair, panel_gram_basis_pair, transpose
from .ops.kernels import fused_prox_dual_t, fused_zprox_t, pair_matmul
from .ops.prox import profile_ladder_arrays

#: the step's problem (``__graft_entry__.py:26-62``): 16x16, m = 4n, r 20
NT = NR = 16
RANK = 20


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the entry module runs on the card by default and "
                           "no CUDA device is available; pass device='cpu'")
    return dev


def _step_arrays():
    """The step's arrays in the JAX package's (m, r) / (n, r) layout,
    numpy, from ``default_rng(0)`` as ``__graft_entry__.py:44-62`` makes
    them: a 2-bit codebook A, b = |A x|, U = inv(A^H A + I), Y0 = A X0,
    Z0 = X0, zero duals, mu 1e-3."""
    n = NT * NR
    m = 4 * n
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 4, (m, n))
    a = np.exp(1j * bits * (np.pi / 2)) / np.sqrt(n)
    x_true = (rng.normal(size=n) + 1j * rng.normal(size=n)) / np.sqrt(2)
    b = np.abs(a @ x_true)
    u = np.linalg.inv(a.conj().T @ a + np.eye(n))
    x0 = rng.normal(size=(n, RANK))
    y0 = a @ x0
    zn, zm = np.zeros((n, RANK)), np.zeros((m, RANK))
    return (a.real, a.imag, b, u.real, u.imag, y0.real, y0.imag, x0, zn,
            zm, zm, zn, zn, 1e-3)


def entry(device="cuda"):
    """Return ``(fn, args)``: one 2ACE ADMM iteration (ref:
    inferLowRankV4_multi.m:318-341) and its example arguments on
    ``device`` (the card unless ``device="cpu"``).

    ``fn(a_re, a_im, b, u_re, u_im, y_re, y_im, z_re, z_im, m_re, m_im,
    n_re, n_im, mu)`` takes and returns the JAX package's layout
    ((m, n) A, (m, r) Y and M-dual, (n, r) Z and N-dual, float32 pairs)
    and returns ``(y.re, y.im, z.re, z.im, m.re, m.im, n.re, n.im, mu,
    obj)``, obj = || sqrt(sum_r |y|^2) - b ||.  Inside it runs in the
    port's transposed (r, m) / (r, n) layout: the three products
    (A^H (Y - M/mu), the X-update U (...), A X) in K4, the magnitude prox
    with the M-dual in K1's row form, and the Z-prox in K2, seeded by the
    exact eigenbasis of this iteration's panel Gram (so the perturbative
    step starts from the answer: JAX's cold prox takes 6 Jacobi sweeps).
    mu grows by 1.03 every step.  On the CPU each kernel's wrapper takes
    its plain version.
    """
    dev = _device(device)
    m = 4 * NT * NR
    lad = profile_ladder_arrays(NT, NR, m, NT * NR, False, device=dev)
    lad = LadderArrays(lad.ranks[None].contiguous(),
                       lad.fracs[None].contiguous())

    def t(p: Pair) -> Pair:
        """(k, l) -> (1, l, k), contiguous: the transposed layout."""
        return Pair(p.re.mT[None].contiguous(), p.im.mT[None].contiguous())

    def back(p: Pair):
        return p.re[0].mT.contiguous(), p.im[0].mT.contiguous()

    def forward(a_re, a_im, b, u_re, u_im, y_re, y_im, z_re, z_im,
                m_re, m_im, n_re, n_im, mu):
        """One 2ACE ADMM iteration (ref: inferLowRankV4_multi.m:318-341)."""
        a_conj = Pair(a_re[None].contiguous(), (-a_im)[None].contiguous())
        a_t = t(Pair(a_re, a_im))                               # A^T
        u_t = t(Pair(u_re, u_im))                               # U^T
        y, z = t(Pair(y_re, y_im)), t(Pair(z_re, z_im))
        m_d, n_d = t(Pair(m_re, m_im)), t(Pair(n_re, n_im))
        inv_mu = 1.0 / mu
        # X-update: x^T = ((Y - M/mu)^T conj(A) + (Z - N/mu)^T) U^T
        tt = Pair(y.re - m_d.re * inv_mu, y.im - m_d.im * inv_mu)
        aty = pair_matmul(tt, a_conj)
        rhs = Pair(aty.re + z.re - n_d.re * inv_mu,
                   aty.im + z.im - n_d.im * inv_mu)
        x = pair_matmul(rhs, u_t)
        ax = pair_matmul(x, a_t)                                # (1, r, m)
        y_new, m_new = fused_prox_dual_t(ax, b[None].contiguous(), m_d,
                                         mu.reshape(1), per_entry=False)
        z_in = Pair(x.re + n_d.re * inv_mu, x.im + n_d.im * inv_mu)
        w = Pair(z_in.re.reshape(1, -1, NR), z_in.im.reshape(1, -1, NR))
        _, v0 = panel_gram_basis_pair(transpose(w))             # E = W^T
        z_new, _ = fused_zprox_t(z_in, v0, NT, NR, lad)
        n_new = Pair(n_d.re + mu * (x.re - z_new.re),
                     n_d.im + mu * (x.im - z_new.im))
        amp = torch.sqrt(torch.sum(y_new.re[0] ** 2 + y_new.im[0] ** 2, dim=0))
        obj = torch.linalg.vector_norm(amp - b)
        return (*back(y_new), *back(z_new), *back(m_new), *back(n_new),
                mu * 1.03, obj)

    args = tuple(torch.tensor(np.asarray(v, np.float32), device=dev)
                 for v in _step_arrays())
    return forward, args


def _dryrun_rank(rank: int, world: int, device: str):
    """One rank of :func:`dryrun_multichip`: the three sharded solves of
    ``__graft_entry__.py:65-129`` at their shapes and configs."""
    from .ops.kernels import launch_counts, reset_launch_counts
    from .parallel import (make_mesh, problem_sharding, solve_lowrank_sharded,
                           solve_lowrank_multi_sharded_pair,
                           solve_lowrank_sharded_pair)

    rows = 2 if world % 2 == 0 and world >= 2 else 1
    mesh = make_mesh(batch=world // rows, rows=rows, device=device)
    nt = nr = 4
    n = nt * nr
    batch = max(2, world // rows)
    m = 4 * n
    gen = torch.Generator().manual_seed(0)
    bits = torch.randint(0, 4, (batch, m, n), generator=gen)
    a = torch.exp(1j * bits * (math.pi / 2)).to(torch.complex64) / math.sqrt(n)
    x_true = torch.randn((batch, n), generator=gen).to(torch.complex64)
    b = torch.abs(torch.einsum("umn,un->um", a, x_true))
    a_l, b_l = (v.to(mesh.device) for v in problem_sharding(mesh, a, b))
    b_loc = batch // mesh.batch
    reset_launch_counts()

    def check(ok, what):
        if not ok:
            raise RuntimeError(f"dryrun_multichip, rank {rank}: {what}")

    x = solve_lowrank_sharded(mesh, a_l, b_l, nt, nr, AdmmConfig(maxiter=30))
    check(x.shape == (b_loc, n), f"complex twin's x {tuple(x.shape)}")
    check(bool(torch.isfinite(torch.abs(x)).all()), "complex twin non-finite")

    # the pair form (the production path's representation)
    ap = Pair(a_l.real.contiguous(), a_l.imag.contiguous())
    xp = solve_lowrank_sharded_pair(mesh, ap, b_l, nt, nr,
                                    AdmmConfig(maxiter=30))
    check(xp.re.shape == (b_loc, n), f"pair x {tuple(xp.re.shape)}")
    check(bool(torch.isfinite(xp.re).all() & torch.isfinite(xp.im).all()),
          "pair form non-finite")

    # the production scaffold, row-sharded: restarts, quality gate, rank-1
    # retry and rollback around the sharded inner solves
    res = solve_lowrank_multi_sharded_pair(
        mesh, torch.Generator().manual_seed(2), ap, b_l, nt, nr,
        AdmmConfig(maxiter=20, n_restarts=2))
    check(res.x.re.shape == (b_loc, n) and res.quality.shape == (b_loc,),
          f"scaffold x {tuple(res.x.re.shape)}, quality "
          f"{tuple(res.quality.shape)}")
    check(bool(torch.isfinite(res.x.re).all()), "scaffold non-finite")
    return dict(coords=mesh.coords, shape=mesh.shape, launches=launch_counts())


def dryrun_multichip(n_devices: int, device="cuda"):
    """Spawn ``n_devices`` ranks on a (batch x rows) mesh (rows 2 when
    n_devices is even) and run one batched sharded recovery of each kind
    on each: the complex twin, the pair form and the production scaffold
    (``__graft_entry__.py:65-129``'s shapes, configs and checks; each
    rank checks its own block).  On CUDA each rank takes its own card
    (NCCL) and more ranks than cards raise: the CPU is reached only
    through ``device="cpu"`` (gloo).  Returns each rank's mesh
    coordinates and kernel launches."""
    from .parallel.distributed import spawn_ranks

    dev = _device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                         f"CUDA devices, {torch.cuda.device_count()} present")
    return spawn_ranks(_dryrun_rank, n_devices, (dev.type,), device=dev.type,
                       timeout=600.0)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks of dryrun_multichip (default: the cards, "
                        "8 on the CPU)")
    args = p.parse_args(argv)
    fn, ex = entry(args.device)
    out = fn(*ex)
    print("entry ok:", [tuple(o.shape) for o in out], flush=True)
    ranks = args.ranks or (torch.cuda.device_count() if args.device == "cuda"
                           else 8)
    dryrun_multichip(ranks, args.device)
    print(f"dryrun_multichip({ranks}) ok", flush=True)


if __name__ == "__main__":
    main()
