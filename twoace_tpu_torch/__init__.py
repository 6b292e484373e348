"""twoace_tpu_torch: the PyTorch/CUDA port of 2ACE-TPU for NVIDIA Hopper.

The package imports torch and numpy and never jax.  The JAX package
``twoace_tpu`` is the reference it is tested against.  Ported so far: the
batched A2 solver ``solve_lowrank_multi_pair_batch`` with its two
hand-written CUDA kernels (``ops.kernels``).
"""

from . import interop  # noqa: F401
from .config import AdmmConfig  # noqa: F401
from .ops.cplx import Pair  # noqa: F401
from .ops.pair_solver import solve_lowrank_multi_pair_batch  # noqa: F401

__version__ = "0.1.0"
