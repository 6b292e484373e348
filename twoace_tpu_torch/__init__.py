"""twoace_tpu_torch: the PyTorch/CUDA port of 2ACE-TPU for NVIDIA Hopper.

The package imports torch and numpy and never jax.  The JAX package
``twoace_tpu`` is the reference it is tested against.  Ported so far: the
A2 solver of ``ops.pair_solver`` (``solve_lowrank_multi_pair_batch``,
``solve_lowrank_multi_pair``, ``refine_lowrank_pair``); the complex-dtype
solver family (``ops.admm``, ``ops.dispatch``) and the testbed recovery
campaigns (``pipeline.recovery``); the baselines (``ops.omp``,
``ops.gamp``, ``ops.phaselift``, ``ops.twostage``, ``ops.cpr_baselines``,
``ops.beamsweep``); six hand-written CUDA kernels (``ops.kernels``); the
steering, channel, sparse and measurement models (``models``); every
codebook family, the Bayes A-optimal beams, the sensing modes, beam
picks, codebook images and measurement providers (``sensing``); the
mobility tracker (``pipeline.mobility``); the Monte-Carlo campaigns
(``pipeline.simulation``: Vs_M, Vs_SNR, VS_SR, the trace sweep and
windowed inference); the testbed driver (``pipeline.testbed``); the
utilities (``utils``); and the CLI (``python -m twoace_tpu_torch``).
Still to port: ``parallel``, the entry module and ``utils.plotting``.
"""

from . import interop  # noqa: F401
from .config import (  # noqa: F401
    AdmmConfig, ArrayConfig, ChannelConfig, SpectralProfileConfig)
from .ops.cplx import Pair  # noqa: F401
from .ops.pair_solver import (  # noqa: F401
    refine_lowrank_pair, solve_lowrank_multi_pair,
    solve_lowrank_multi_pair_batch)

__version__ = "0.1.0"
