"""Incremental campaign checkpointing (a copy of
``twoace_tpu.utils.checkpoint``, host numpy).

The reference saves every probing round to ``result/*.mat`` so a crashed
campaign keeps its RSS (ref: main/main.py:134,177,220,263,280,355,483).
Here: an append-friendly npz-based store with atomic writes.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import numpy as np


class CampaignStore:
    """Directory of .npz checkpoints, one per (campaign, round)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, campaign: str, round_idx: Optional[int] = None) -> str:
        name = campaign if round_idx is None else f"{campaign}_{round_idx:05d}"
        return os.path.join(self.root, name + ".npz")

    def save(self, campaign: str, data: Dict[str, np.ndarray],
             round_idx: Optional[int] = None) -> str:
        """Atomic write: temp file + rename (a crash never corrupts)."""
        path = self._path(campaign, round_idx)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez_compressed(f, **data)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    def load(self, campaign: str, round_idx: Optional[int] = None
             ) -> Optional[Dict[str, np.ndarray]]:
        path = self._path(campaign, round_idx)
        if not os.path.exists(path):
            return None
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def completed_rounds(self, campaign: str) -> list:
        """Resume support: which rounds already have checkpoints."""
        out = []
        prefix = campaign + "_"
        for f in sorted(os.listdir(self.root)):
            if f.startswith(prefix) and f.endswith(".npz"):
                try:
                    out.append(int(f[len(prefix):-4]))
                except ValueError:
                    continue
        return out
