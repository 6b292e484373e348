"""Beam selection out of a measured codebook (port of
``twoace_tpu.sensing.sensing_matrix.pick_beams``).

ref: main/src/generate_sensing_matrix/Generate_Sensing_Matrix_with_candidate.m:1-45.
``generate_sensing_matrix`` (the simulation tree's sensing families) waits
for the Vs_M campaign slice; the ``"Bayes_Beam"`` pick waits for
``bayes_opt``.
"""

from __future__ import annotations

from typing import Optional

import torch


def pick_beams(generator: Optional[torch.Generator], method: str, m: int,
               cb_train, prior_k=None) -> torch.Tensor:
    """Indices of M beams out of ``cb_train`` (num, n), on its device.

    ``"Random_Phase_State"`` takes the first M rows: the codebook rows are
    already random (ref :12).  ``"Bayes_Beam"`` (A-optimal selection over
    a random candidate subset, ref :37-38) raises until ``bayes_opt`` is
    ported.
    """
    del generator, prior_k
    if method == "Random_Phase_State":
        return torch.arange(m, device=cb_train.device)
    if method == "Bayes_Beam":
        raise NotImplementedError(
            "Bayes_Beam needs sensing/bayes_opt.py, not ported yet "
            "(ROADMAP.md, modules queue item 3)")
    raise ValueError(f"unknown beam-pick method: {method}")
