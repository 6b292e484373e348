"""Solver ops of the PyTorch port: pair arithmetic (:mod:`.cplx`), the
constraint ladder (:mod:`.prox`), the CUDA kernels (:mod:`.kernels`) and
the batched A2 solver (:mod:`.pair_solver`)."""
