"""twoace_tpu_torch: the PyTorch/CUDA port of 2ACE-TPU for NVIDIA Hopper.

The package imports torch and numpy and never jax.  The JAX package
``twoace_tpu`` is the reference it is tested against.  Ported so far: the
A2 solver of ``ops.pair_solver`` (``solve_lowrank_multi_pair_batch``,
``solve_lowrank_multi_pair``, ``refine_lowrank_pair``); the complex-dtype
solver family (``ops.admm``, ``ops.dispatch``) and the testbed recovery
campaigns (``pipeline.recovery``); five hand-written CUDA kernels
(``ops.kernels``); the steering and channel models (``models``); the
random codebooks, beam pick and measurement providers (``sensing``); and
the mobility tracker (``pipeline.mobility``).
"""

from . import interop  # noqa: F401
from .config import (  # noqa: F401
    AdmmConfig, ArrayConfig, ChannelConfig, SpectralProfileConfig)
from .ops.cplx import Pair  # noqa: F401
from .ops.pair_solver import (  # noqa: F401
    refine_lowrank_pair, solve_lowrank_multi_pair,
    solve_lowrank_multi_pair_batch)

__version__ = "0.1.0"
