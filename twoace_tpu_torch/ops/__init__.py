"""Solver ops of the PyTorch port: pair arithmetic (:mod:`.cplx`), the
prox operators and constraint ladder (:mod:`.prox`), the CUDA kernels
(:mod:`.kernels`), the pair A2 solvers (:mod:`.pair_solver`), the
complex-dtype solver family (:mod:`.admm`, :mod:`.spectral_init`), the
baselines (:mod:`.omp`, :mod:`.gamp`, :mod:`.phaselift`,
:mod:`.twostage`, :mod:`.cpr_baselines`, :mod:`.beamsweep`) and their
dispatchers (:mod:`.dispatch`).  The JAX package's exports of the
baseline solvers are repeated here, except ``gamp``: the function would
hide the module of that name (``from twoace_tpu_torch.ops import gamp``)."""

from .gamp import embgamp, prgamp, vamp, vamp_cs  # noqa: F401
from .phaselift import (  # noqa: F401
    PairPhaseLiftResult, PhaseLiftResult, phaselift_bm, phaselift_bm_pair,
    phaselift_fista)
