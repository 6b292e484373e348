"""Hand-written CUDA kernels of the solver loop, each beside its plain
PyTorch version.  Port of ``twoace_tpu.ops.pallas.kernels``:

- :func:`fused_prox_dual_t` (K1, ``csrc/prox_dual.cu``);
- :func:`fused_zprox_t` (K2, ``csrc/zprox.cu``), which also takes the
  place of the lane-packed ``fused_zprox_batch``;
- :func:`fused_infer_admm` (K3, ``csrc/infer_admm.cu``), the whole
  InferADMM loop, port of ``twoace_tpu.ops.pallas.solver_kernel``;
- :func:`pair_matmul` (K4, ``csrc/pair_matmul.cu``), the batched pair
  GEMM of the per-op loop: 3xTF32 tensor-core tiles, or split-K for
  the one-row products;
- :func:`fused_prox_dual` (K5, ``csrc/prox_dual_rows.cu``), the
  row-layout magnitude prox + M-dual of the complex-dtype loop
  (``ops.admm``);
- :func:`pair_chain_mm` (K6, ``csrc/chain_mm.cu``), the renormalised
  chain of batched complex n x n products of
  ``scripts/bench_pallas_mm.py`` (run by
  ``scripts/torch_bench_pallas_mm.py``).
- the passes of K7 (``csrc/admm_trip.cu``, :mod:`.admm_trip`): the per-op
  loop's trip glue around K4, K1 and K2 (``trip_shift``, ``trip_rhs``,
  ``trip_rows``, ``trip_n_dual``, ``trip_commit``).

Each wrapper counts its launches in a plain integer attribute
``.launches``; a CPU tensor takes the plain version and counts nothing.
"""

from .prox_dual import fused_prox_dual_t, prox_dual_t_plain  # noqa: F401
from .zprox import fused_zprox_t, zprox_t_plain  # noqa: F401
from .pair_matmul import pair_matmul, pair_matmul_plain  # noqa: F401
from .infer_admm import fused_infer_admm, infer_admm_plain  # noqa: F401
from .prox_dual_rows import fused_prox_dual, prox_dual_rows_plain  # noqa: F401
from .chain_mm import pair_chain_mm, pair_chain_mm_plain  # noqa: F401
from .admm_trip import PASSES as _K7

KERNELS = (fused_prox_dual_t, fused_zprox_t, fused_infer_admm, pair_matmul,
           fused_prox_dual, pair_chain_mm, *_K7)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
