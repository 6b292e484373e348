"""K3: the whole InferADMM loop in one CUDA kernel, one 16-CTA
thread-block cluster per lane (``csrc/infer_admm.cu``).

Port of ``twoace_tpu.ops.pallas.solver_kernel.fused_infer_admm``, with a
lane axis: ``a`` (G, m, n) and ``u`` (G, n, n) per group, ``b`` and the
state (G, P, ...) per lane, and the ladder as per-lane runtime tensors.
A CPU tensor takes the plain version :func:`infer_admm_plain`, which runs
the shared loop body (:func:`..admm_loop.admm_loop`) with K4's, K1's,
K2's and K7's plain versions; a CUDA tensor launches the kernel or
raises.  Each launch leaves one lane-trip record (path "k3"), the plain
version one of path "k3-plain" (:mod:`...utils.profiling`), while a
profiler is open.

On CUDA the kernel computes its four complex products in 3xTF32 on the
tensor cores against constants split once per launch (the counterpart
of the JAX kernel's "split3" mode), float32-class whatever
``AdmmConfig.kernel_precision`` says: that option is ignored, and the
JAX kernel's single-pass "default" mode has no counterpart.
"""

from __future__ import annotations

import torch

from ...utils import profiling
from ..admm_loop import admm_loop
from ..cplx import LadderArrays, Pair
from . import _build
from .admm_trip import trip_plain
from .pair_matmul import pair_matmul_plain
from .prox_dual import prox_dual_t_plain
from .zprox import MAX_NR, zprox_t_plain

#: CTAs of the thread-block cluster that runs one lane (csrc/infer_admm.cu,
#: a build constant)
CLUSTER = 16
#: the kernel keeps at most this many rows r of a lane's state per tile
MAX_R = 32


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def smem_bytes(r: int, nt: int, nr: int) -> int:
    """Shared memory one CTA needs at this shape, in bytes, as the kernel
    lays it out (C ``twoace_infer_admm_smem``), or -1 where a CTA would own
    more columns of n than the kernel takes."""
    return _build.library().twoace_infer_admm_smem(r, nt, nr)


def smem_limit() -> int:
    """The most shared memory a CTA of the kernel may take, in bytes."""
    return _build.library().twoace_infer_admm_smem_limit()


def lane_floats(r: int, m: int, n: int) -> int:
    """Floats of one lane's state in the workspace: Y, the M-dual and
    Y - M/mu for both of the next trip's mu (r, m), X and the rhs (r, n),
    each a (re, im) pair.  Matches ``lane_workspace`` in the kernel."""
    return _round4(8 * r * m + 4 * r * n)


def split_floats(m: int, n: int) -> int:
    """Floats of one group's split constants: the (big, small) TF32
    halves of A's re, im, re + im and re - im planes (m, n) and of U's
    re, im and re - im planes (n, n).  Matches ``split_workspace``."""
    return _round4(2 * 4 * m * n + 2 * 3 * n * n)


def workspace_floats(lanes: int, groups: int, r: int, m: int, n: int) -> int:
    """Floats of a launch's workspace: every lane's state, then every
    group's split constants."""
    return lanes * lane_floats(r, m, n) + groups * split_floats(m, n)


def active_clusters(r: int, nt: int, nr: int) -> int:
    """How many of the kernel's clusters the current CUDA device places at
    once at this shape's shared memory (``cudaOccupancyMaxActiveClusters``);
    the launch raises at 0."""
    got = _build.library().twoace_infer_admm_clusters(r, nt, nr)
    _build.check(min(got, 0), "cudaOccupancyMaxActiveClusters")
    return got


def infer_admm_plain(a: Pair, b, u: Pair, y0: Pair, z0: Pair, v0: Pair, mu0,
                     ladder: LadderArrays, *, nt: int, nr: int,
                     scale_by_row: bool, rho: float, tol_rel: float,
                     tol_abs: float, maxiter: int):
    """Plain PyTorch version of :func:`fused_infer_admm`: the same
    function of the same prepared inputs, through K4's, K1's, K2's and
    K7's plain versions."""

    def z_prox(z, v, mu):
        return zprox_t_plain(z, v, nt, nr, ladder)

    return admm_loop(a, b, u, y0, z0, v0, mu0, scale_by_row=scale_by_row,
                     pair_gemm=pair_matmul_plain,
                     prox_dual=prox_dual_t_plain, z_prox=z_prox,
                     trip=trip_plain, rho=rho, tol_rel=tol_rel,
                     tol_abs=tol_abs, maxiter=maxiter, path="k3-plain")


def _check(a: Pair, b, u: Pair, y0: Pair, z0: Pair, v0: Pair, mu0,
           ladder: LadderArrays, nt: int, nr: int):
    g_, p_, r, m = y0.re.shape
    n = a.re.shape[-1]
    if n != nt * nr:
        raise ValueError(f"a has {n} columns, need nt*nr = {nt * nr}")
    if not 1 <= nr <= MAX_NR:
        raise ValueError(f"the kernel takes 1 <= nr <= {MAX_NR}, got {nr}")
    if not 1 <= r <= MAX_R:
        raise ValueError(f"the kernel takes 1 <= r <= {MAX_R}, got {r}")
    levels = ladder.ranks.shape[-1]
    lanes = g_ * p_
    _build.check_inputs({"a.re": (a.re, (g_, m, n)), "a.im": (a.im, (g_, m, n)),
                         "u.re": (u.re, (g_, n, n)), "u.im": (u.im, (g_, n, n)),
                         "b": (b, (g_, p_, m)),
                         "y0.re": (y0.re, (g_, p_, r, m)),
                         "y0.im": (y0.im, (g_, p_, r, m)),
                         "z0.re": (z0.re, (g_, p_, r, n)),
                         "z0.im": (z0.im, (g_, p_, r, n)),
                         "v0.re": (v0.re, (g_, p_, nr, nr)),
                         "v0.im": (v0.im, (g_, p_, nr, nr)),
                         "mu0": (mu0, (g_, p_)),
                         "ladder.ranks": (ladder.ranks, (lanes, levels)),
                         "ladder.fracs": (ladder.fracs, (lanes, levels))},
                        a.re.device)


def _check_fits(r: int, nt: int, nr: int):
    """Raise unless a CTA of the kernel's cluster can hold its share of
    this shape: its columns of n and its shared memory, as the kernel
    counts them."""
    need = smem_bytes(r, nt, nr)
    if need < 0:
        raise ValueError(f"a CTA of the {CLUSTER}-CTA cluster would own "
                         f"{-(-nt // CLUSTER) * nr} columns of n, more than "
                         f"the kernel takes")
    if need > smem_limit():
        raise ValueError(f"the kernel would need {need} B of shared memory "
                         f"a CTA, above {smem_limit()}")


def fused_infer_admm(a: Pair, b, u: Pair, y0: Pair, z0: Pair, v0: Pair, mu0,
                     ladder: LadderArrays, *, nt: int, nr: int,
                     scale_by_row: bool, rho: float, tol_rel: float,
                     tol_abs: float, maxiter: int):
    """Run the InferADMM loop of every lane from its prepared state.

    ``a``: (G, m, n) codebook blocks; ``u``: (G, n, n) = inv(A^H A + I);
    ``b``: (G, P, m); ``y0``/``z0``: (G, P, r, m)/(G, P, r, n) after the
    initialization; ``v0``: (G, P, nr, nr) warm Z-prox basis in the
    E-convention of ``cplx.panel_gram_basis_pair``; ``mu0``: (G, P);
    ``ladder``: ranks/fracs (G*P, L), padded levels with f = 0.

    Returns ``(opt_x, opt_y, converged, it)``: opt_x (G, P, r, n) and
    opt_y (G, P, r, m) with ``scale_by_row``, else the best column
    (G, P, 1, ·); ``converged`` bool and ``it`` int32, both (G, P).
    """
    kw = dict(nt=nt, nr=nr, scale_by_row=scale_by_row, rho=rho,
              tol_rel=tol_rel, tol_abs=tol_abs, maxiter=maxiter)
    if a.re.device.type == "cpu":
        return infer_admm_plain(a, b, u, y0, z0, v0, mu0, ladder, **kw)
    if a.re.device.type != "cuda":
        raise ValueError(f"unsupported device {a.re.device}")
    _check(a, b, u, y0, z0, v0, mu0, ladder, nt, nr)
    g_, p_, r, m = y0.re.shape
    _check_fits(r, nt, nr)
    n = a.re.shape[-1]
    lanes = g_ * p_
    k_opt = r if scale_by_row else 1
    dev = a.re.device
    lib = _build.library()
    ws_lane = lane_floats(r, m, n)
    ws = torch.empty(workspace_floats(lanes, g_, r, m, n),
                     dtype=torch.float32, device=dev)
    ox = [torch.zeros(g_, p_, k_opt, n, device=dev) for _ in range(2)]
    oy = [torch.zeros(g_, p_, k_opt, m, device=dev) for _ in range(2)]
    it = torch.zeros(g_, p_, dtype=torch.int32, device=dev)
    conv = torch.zeros(g_, p_, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.twoace_infer_admm(
        a.re.data_ptr(), a.im.data_ptr(), u.re.data_ptr(), u.im.data_ptr(),
        b.data_ptr(), y0.re.data_ptr(), y0.im.data_ptr(), z0.re.data_ptr(),
        z0.im.data_ptr(), v0.re.data_ptr(), v0.im.data_ptr(),
        mu0.data_ptr(), ladder.ranks.data_ptr(), ladder.fracs.data_ptr(),
        ws.data_ptr(), ox[0].data_ptr(), ox[1].data_ptr(), oy[0].data_ptr(),
        oy[1].data_ptr(), it.data_ptr(), conv.data_ptr(),
        lanes, p_, r, m, n, nt, nr, ladder.ranks.shape[-1],
        int(scale_by_row), maxiter, ws_lane, rho, tol_rel, tol_abs, stream)
    if rc == -1:
        raise RuntimeError(f"fused_infer_admm: a cluster of {CLUSTER} CTAs "
                           f"cannot be placed on {dev}")
    _build.check(rc, "fused_infer_admm")
    fused_infer_admm.launches += 1
    profiling.record_trips("k3", r, m, n, "k2", lanes, None, it)
    return Pair(*ox), Pair(*oy), conv.bool(), it


fused_infer_admm.launches = 0
