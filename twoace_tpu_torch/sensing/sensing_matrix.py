"""Sensing-matrix construction and beam selection (port of
``twoace_tpu.sensing.sensing_matrix``).

- :func:`generate_sensing_matrix`, the simulation tree's mode dispatch
  (ref: main/src/generate_sensing_matrix/Generate_Sensing_Matrix.m:73-256)
  for ``Random_Phase_State`` and ``Directional_Beam_Angular``; the other
  modes raise until their codebook families and ``bayes_opt`` are ported;
- :func:`pick_beams`, beam picking out of a measured codebook
  (ref: Generate_Sensing_Matrix_with_candidate.m:1-45), the
  ``Random_Phase_State`` pick; ``Bayes_Beam`` waits for ``bayes_opt``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import ArrayConfig
from ..utils.rng import fold_in
from .codebooks import directional_beams_angular, random_sensing_rows

#: modes of the reference that wait for their codebook family or for
#: ``bayes_opt`` (ROADMAP.md, modules queue item 1)
UNPORTED_MODES = ("Directional_Beam", "Directional_Random_Beam",
                  "Region_Random_Beam", "Random_Beam_Bayes")


class SensingMatrix(NamedTuple):
    f: torch.Tensor               #: (nt, mt) Tx beams (zeros in random mode)
    #: (U, nr, mr) Rx combiners; zero in the Random_Phase_State mode, as in
    #: the reference, where the assignment is commented out
    #: (Generate_Sensing_Matrix.m:117)
    w: torch.Tensor
    fw: torch.Tensor              #: (U, mt*mr, nt*nr) measurement rows
    measurement_mat: torch.Tensor  #: (U, mt*mr, P) = FW @ AD


def _kron_fw(f, w):
    """FW = kron(F^T, W^H): row (i, j) = kron(F[:, i]^T, W[:, j]^H),
    Tx-probe major, Rx antenna index fastest
    (ref: Generate_Sensing_Matrix.m:177)."""
    rows = torch.einsum("ti,rj->ijtr", f, w.conj())
    return rows.reshape(f.shape[1] * w.shape[1], -1)


def generate_sensing_matrix(generator: Optional[torch.Generator], method: str,
                            mt: int, mr: int, cfg: ArrayConfig, ad,
                            aod_range=None, aoa_range=None,
                            batch: int = 1) -> SensingMatrix:
    """Sensing rows for a batch of U instances, on ``ad``'s device.

    - ``"Random_Phase_State"``: each of the mt*mr rows of each instance
      is an independent uniform 2-bit phase vector of length nt*nr
      (ref :109-121), drawn from ``fold_in(generator, u)``; rows are
      prefix-stable in the measurement count.
    - ``"Directional_Beam_Angular"``: angle-uniform sectors (ref :181-190),
      one FW shared by the batch (an expanded view, not a copy).

    ``Directional_Beam``, ``Directional_Random_Beam``,
    ``Region_Random_Beam`` and ``Random_Beam_Bayes`` raise
    ``NotImplementedError``.
    """
    n = cfg.n
    dev = ad.device
    m = mt * mr
    if method == "Random_Phase_State":
        fw = torch.stack([random_sensing_rows(fold_in(generator, i), m, n,
                                              cfg.phase_bit, device=dev)
                          for i in range(batch)])
        f = torch.zeros((cfg.nt, mt), dtype=fw.dtype, device=dev)
        w = torch.zeros((batch, cfg.nr, mr), dtype=fw.dtype, device=dev)
    elif method == "Directional_Beam_Angular":
        if aod_range is None or aoa_range is None:
            raise ValueError("directional modes need aod_range/aoa_range")
        f, w_single = directional_beams_angular(mt, mr, cfg, aod_range,
                                                aoa_range, device=dev)
        fw = _kron_fw(f, w_single)[None].expand(batch, m, n)
        w = w_single[None].expand(batch, cfg.nr, mr)
    elif method in UNPORTED_MODES:
        raise NotImplementedError(
            f"sensing mode {method} is not ported yet (ROADMAP.md, modules "
            "queue item 1)")
    else:
        raise ValueError(f"unknown sensing method: {method}")
    meas_mat = torch.einsum("umn,np->ump", fw, ad.to(fw.dtype))
    return SensingMatrix(f=f, w=w, fw=fw, measurement_mat=meas_mat)


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
            "(ROADMAP.md, modules queue item 1)")
    raise ValueError(f"unknown beam-pick method: {method}")
