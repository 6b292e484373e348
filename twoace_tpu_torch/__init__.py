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
utilities (``utils``, the figures of ``utils.plotting`` too); the CLI
(``python -m twoace_tpu_torch``); the multi-process path on
``torch.distributed`` (``parallel``: the (batch x rows) mesh, the row-
and batch-sharded A2 solvers and their complex twin); and the entry
module (``twoace_tpu_torch.entry``: ``entry()`` and
``dryrun_multichip``).  Nothing public of the JAX package is left to
port, apart from the TPU workarounds the port leaves out (the Jacobi
eigensolver, the real-symmetric embeddings, the MXU lane packing,
``matmul_lowp``, ``eig_mode`` other than ``"perturb"``).
"""

from . import interop  # noqa: F401
from .config import (  # noqa: F401
    AdmmConfig, ArrayConfig, ChannelConfig, SpectralProfileConfig)
from .ops.cplx import Pair  # noqa: F401
from .ops.pair_solver import (  # noqa: F401
    refine_lowrank_pair, solve_lowrank_multi_pair,
    solve_lowrank_multi_pair_batch)

__version__ = "0.1.0"
