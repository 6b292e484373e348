"""Host timing of device work."""

from __future__ import annotations

import time

import torch


def synced_seconds(t0: float, device) -> float:
    """Host seconds since ``t0`` (a ``time.perf_counter()`` reading), read
    once ``device`` has finished the work queued on it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0
