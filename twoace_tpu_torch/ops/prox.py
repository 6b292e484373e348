"""Constraint-ladder selection of the spectral-profile prox.

Port of ``twoace_tpu.ops.prox.profile_ladder`` / ``profile_ladder_arrays``
(ref: inferLowRankV4_multi.m:437-464).  The selection is plain Python on
static shapes; the array form returns float32 tensors.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from .cplx import LadderArrays


def profile_ladder(nt: int, nr: int, m: int, n: int, use_rank_one: bool,
                   rank_mults: Sequence[float] = (0.5, 0.7, 1.0, 2.0),
                   fractions: Sequence[float] = (0.8, 0.9, 0.95, 0.995),
                   mode: str = "v4") -> Tuple[Tuple[int, float], ...]:
    """Static constraint ladder C(r, f).

    ``mode``: "v1" single constraint (ref: inferLowRank.m:407-418); "v2"
    adds the m >= 3n case and rank-1 mode (ref: inferLowRankV2.m:407-431);
    "v4" the full ladder with small-size fallbacks.
    """
    sz = min(nt, nr)
    rs = [math.ceil(math.sqrt(sz) * rank_mults[0]),
          math.ceil(math.sqrt(sz) * rank_mults[1]),
          math.ceil(math.sqrt(sz) * rank_mults[2]),
          min(sz, math.ceil(math.sqrt(sz) * rank_mults[3]))]
    fs = list(fractions)
    if mode == "v1":
        return ((rs[2], fs[2]),)
    if use_rank_one:
        return ((1, 0.95),)
    if m >= 3 * n:
        return ((rs[3], fs[3]),)
    if mode == "v2":
        return ((rs[2], fs[2]),)
    if rs[1] <= 2:
        return ((rs[2], fs[2]),)
    if rs[0] <= 2:
        return tuple(zip(rs[1:], fs[1:]))
    return tuple(zip(rs, fs))


def profile_ladder_arrays(nt: int, nr: int, m: int, n: int,
                          use_rank_one: bool,
                          rank_mults: Sequence[float] = (0.5, 0.7, 1.0, 2.0),
                          fractions: Sequence[float] = (0.8, 0.9, 0.95, 0.995),
                          mode: str = "v4", length: int = 4,
                          device=None) -> LadderArrays:
    """:func:`profile_ladder` padded to ``length`` levels with no-op
    entries (f = 0 never triggers a rescale), as float32 tensors."""
    lvl = profile_ladder(nt, nr, m, n, use_rank_one, rank_mults, fractions,
                         mode=mode)
    if len(lvl) > length:
        raise ValueError(f"ladder has {len(lvl)} levels > length={length}")
    pad = length - len(lvl)
    ranks = [float(rk) for rk, _ in lvl] + [float(min(nt, nr))] * pad
    fracs = [float(f) for _, f in lvl] + [0.0] * pad
    return LadderArrays(
        torch.tensor(ranks, dtype=torch.float32, device=device),
        torch.tensor(fracs, dtype=torch.float32, device=device))
