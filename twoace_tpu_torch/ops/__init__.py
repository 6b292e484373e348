"""Solver ops of the PyTorch port: pair arithmetic (:mod:`.cplx`), the
prox operators and constraint ladder (:mod:`.prox`), the CUDA kernels
(:mod:`.kernels`), the pair A2 solvers (:mod:`.pair_solver`), the
complex-dtype solver family (:mod:`.admm`, :mod:`.spectral_init`) and its
dispatchers (:mod:`.dispatch`)."""
