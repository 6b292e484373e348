"""Sensing-matrix construction and beam selection (port of
``twoace_tpu.sensing.sensing_matrix``).

- :func:`generate_sensing_matrix`, the simulation tree's mode dispatch
  (ref: main/src/generate_sensing_matrix/Generate_Sensing_Matrix.m:73-256);
- :func:`directional_beam_bayes` and :func:`directional_beam_bayes_v2`,
  the multi-user Bayes beams (ref: Directional_Beam_Bayes{,_v2}.m);
- :func:`pick_beams`, beam picking out of a measured codebook
  (ref: Generate_Sensing_Matrix_with_candidate.m:1-45).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import ArrayConfig
from ..utils.metrics import quantize_ps
from ..utils.rng import fold_in
from .bayes_opt import (bayes_a_opt_select, noise_prior_from_vech,
                        prior_from_channel)
from .codebooks import (directional_beams_angular, directional_beams_spatial,
                        directional_random_beams, random_sensing_rows,
                        region_random_beams)


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
                            batch: int = 1, prior_k=None) -> SensingMatrix:
    """Sensing rows for a batch of U instances, on ``ad``'s device.

    - ``"Random_Phase_State"``: each of the mt*mr rows of each instance
      is an independent uniform 2-bit phase vector of length nt*nr
      (ref :109-121), drawn from ``fold_in(generator, u)``; rows are
      prefix-stable in the measurement count.
    - ``"Directional_Beam"`` (spatial-uniform, ref :169-179),
      ``"Directional_Beam_Angular"`` (angle-uniform, ref :181-190),
      ``"Directional_Random_Beam"`` and ``"Region_Random_Beam"``: one FW
      shared by the batch (an expanded view, not a copy); the random-gain
      beams draw their numpy seed from ``generator``.  The spatial and
      random modes take their span from ``aod_range``.
    - ``"Random_Beam_Bayes"``: max(4m, 256) random candidates (drawn from
      ``generator``) and the Bayesian A-optimal row exchange over them
      (ref :215-218, Bayes_Beam.m; its design draw from
      ``fold_in(generator, 1)``), shared by the batch.
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
    elif method in ("Directional_Beam", "Directional_Beam_Angular",
                    "Directional_Random_Beam", "Region_Random_Beam"):
        if aod_range is None or (method == "Directional_Beam_Angular"
                                 and aoa_range is None):
            raise ValueError("directional modes need aod_range/aoa_range")
        span = float(aod_range[1] - aod_range[0])
        if method == "Directional_Beam":
            f, w_single = directional_beams_spatial(mt, mr, cfg, span,
                                                    device=dev)
        elif method == "Directional_Random_Beam":
            f, w_single = directional_random_beams(generator, mt, mr, cfg,
                                                   span, device=dev)
        elif method == "Region_Random_Beam":
            f, w_single = region_random_beams(generator, mt, mr, cfg, span,
                                              device=dev)
        else:
            f, w_single = directional_beams_angular(mt, mr, cfg, aod_range,
                                                    aoa_range, device=dev)
        fw = _kron_fw(f, w_single)[None].expand(batch, m, n)
        w = w_single[None].expand(batch, cfg.nr, mr)
    elif method == "Random_Beam_Bayes":
        cand = random_sensing_rows(generator, max(4 * m, 256), n,
                                   cfg.phase_bit, device=dev)
        sel = bayes_a_opt_select(fold_in(generator, 1), cand, m,
                                 prior_k=prior_k)
        fw = cand[sel][None].expand(batch, m, n)
        f = torch.zeros((cfg.nt, mt), dtype=fw.dtype, device=dev)
        w = torch.zeros((batch, cfg.nr, mr), dtype=fw.dtype, device=dev)
    else:
        raise ValueError(f"unknown sensing method: {method}")
    meas_mat = torch.einsum("umn,np->ump", fw, ad.to(fw.dtype))
    return SensingMatrix(f=f, w=w, fw=fw, measurement_mat=meas_mat)


def directional_beam_bayes(generator: Optional[torch.Generator], mt: int,
                           mr: int, cfg: ArrayConfig, vec_h_users,
                           snr_db: float = 0.0, option: int = 2,
                           candidate_size: int = 90) -> SensingMatrix:
    """Multi-user Bayes-A-optimal probing beams over a Tx x Rx candidate
    kron, on ``vec_h_users``' device.

    ref: main/src/generate_sensing_matrix/Directional_Beam_Bayes.m:17-57:
    candidates are directional sectors (``option=1``, ref :25-28) or
    random Tx/Rx beams (``option=2``, ref :29-39; bits from
    ``fold_in(generator, 0)`` and ``fold_in(generator, 1)`` on
    ``phase_bit ** 2`` levels of pi/levels, as the reference and JAX
    write it), combined as ``kron(F^T, W^H)``; each user's prior is the
    diagonal noise precision ``db2pow(SNR) * diag(vecH_u^-1)``
    (ref :41-48).  The selection draws from ``fold_in(generator, 7)``.
    As in the reference, the selected rows are returned on the first user
    slot of ``fw`` (ref :55-56).
    """
    n = cfg.n
    m = mt * mr
    vh = torch.as_tensor(vec_h_users)
    if vh.dim() == 1:
        vh = vh[None]
    dev = vh.device
    batch = vh.shape[0]
    if option == 1:
        f_try, w_try = directional_beams_angular(
            candidate_size, candidate_size, cfg, (-90.0, 90.0),
            (-90.0, 90.0), device=dev)
    else:
        levels = cfg.phase_bit ** 2

        def beams(gen, n_ant):
            bits = torch.randint(0, levels, (n_ant, candidate_size),
                                 generator=gen).to(dev)
            ang = bits.to(torch.float32) * (math.pi / levels)
            return torch.polar(torch.ones_like(ang), ang) / math.sqrt(n_ant)

        f_try = beams(fold_in(generator, 0), cfg.nt)
        w_try = beams(fold_in(generator, 1), cfg.nr)
    cand = _kron_fw(f_try, w_try)                       # (cand^2, n)
    prior = noise_prior_from_vech(vh, snr_db)           # (U, n, n)
    sel = bayes_a_opt_select(fold_in(generator, 7), cand, m, prior_k=prior)
    fw = torch.zeros((batch, m, n), dtype=cand.dtype, device=dev)
    fw[0] = cand[sel]
    return SensingMatrix(f=torch.zeros((cfg.nt, mt), dtype=cand.dtype,
                                       device=dev),
                         w=torch.zeros((batch, cfg.nr, mr), dtype=cand.dtype,
                                       device=dev),
                         fw=fw, measurement_mat=fw)


def directional_beam_bayes_v2(generator: Optional[torch.Generator], mt: int,
                              mr: int, cfg: ArrayConfig, ad, h_users,
                              snr_db: float = 0.0,
                              n_users: Optional[int] = None):
    """Multi-user MISO Bayes beams: sub-array steering candidates, priors
    from each user's channel estimate, on ``ad``'s device.

    ref: main/src/generate_sensing_matrix/Directional_Beam_Bayes_v2.m:27-81:
    the Tx array is split into ``n_users`` contiguous groups of
    ``floor(nt/U)`` antennas, each carrying the same steering vector
    (ref :36-43); candidates live in the sparse domain ``F^T AD``
    (ref :51-56); per-user priors come from ``find_K`` on the user's
    channel estimate (ref :52-55); the selected columns are 2-bit
    quantized (ref :76-78).  The selection draws from
    ``fold_in(generator, 11)``.  Returns ``(f_selected, indices)``.
    """
    ad = torch.as_tensor(ad)
    dev = ad.device
    h_users = torch.as_tensor(h_users).to(dev)
    u = n_users if n_users is not None else (
        h_users.shape[0] if h_users.dim() == 3 else 1)
    if h_users.dim() == 2:
        h_users = h_users[None]
    p = ad.shape[1]
    m = mt * mr
    aod = torch.arange(-90.0, 91.0, dtype=torch.float64, device=dev)
    n_sep = cfg.nt // u
    phase = (-cfg.k_d * torch.sin(torch.deg2rad(aod))[:, None]
             * torch.arange(n_sep, dtype=torch.float64, device=dev)[None, :])
    base = torch.polar(torch.ones_like(phase), phase) / math.sqrt(cfg.nt)
    f_try = base.repeat(1, u)[:, :cfg.nt].T.to(torch.complex64)  # (nt, 181)
    scale = math.sqrt(10.0 ** (snr_db / 10.0))
    cand = (scale * f_try).T @ ad.to(f_try.dtype)                # (181, P)
    prior = torch.stack([prior_from_channel(h_users[i % h_users.shape[0]],
                                            cfg, p) for i in range(u)])
    sel = bayes_a_opt_select(fold_in(generator, 11), cand, m, prior_k=prior)
    return quantize_ps(f_try, cfg.phase_bit)[:, sel], sel


def pick_beams(generator: Optional[torch.Generator], method: str, m: int,
               cb_train, prior_k=None) -> torch.Tensor:
    """Indices of M beams out of ``cb_train`` (num, n), on its device.

    ``"Random_Phase_State"`` takes the first M rows: the codebook rows are
    already random (ref :12).  ``"Bayes_Beam"`` draws min(num, 40000)
    candidate rows with replacement from ``generator`` and runs the
    A-optimal selection over them (ref :37-38, Bayes_Beam.m:1-15; its
    design draw from ``fold_in(generator, 1)``).
    """
    num = cb_train.shape[0]
    if method == "Random_Phase_State":
        return torch.arange(m, device=cb_train.device)
    if method == "Bayes_Beam":
        cand_idx = torch.randint(0, num, (min(num, 40000),),
                                 generator=generator).to(cb_train.device)
        sel = bayes_a_opt_select(fold_in(generator, 1), cb_train[cand_idx],
                                 m, prior_k=prior_k)
        return cand_idx[sel]
    raise ValueError(f"unknown beam-pick method: {method}")
