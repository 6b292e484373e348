"""Profiling and timing utilities (port of ``twoace_tpu.utils.profiling``).

Replaces the reference's MATLAB ``profile on`` / ``tic-toc`` scaffolding
(ref: A2only.m:19, Vs_M_par.m:54,144,198) with named timers and
``torch.profiler`` trace capture.  CUDA launches return before the card
finishes, so a section that should time device work ends in a barrier:
:func:`sync` records a CUDA event on each card that holds a tensor of its
argument and waits for it (JAX needed a scalar host readback for that).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def sync(tree) -> None:
    """Device barrier: waits until the current stream of every card holding
    a tensor of ``tree`` (a tensor or nested lists, tuples, dicts and
    NamedTuples of them) has run the work queued on it, through one CUDA
    event a card.  CPU tensors need none."""
    for dev in {t.device for t in _leaves(tree) if t.device.type == "cuda"}:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        event.synchronize()


class Timer:
    """Named accumulating wall-clock timers with rate reporting."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync_tree=None):
        """Time the block on the host clock, ending in :func:`sync` of
        ``sync_tree`` when given."""
        t0 = time.perf_counter()
        yield
        if sync_tree is not None:
            sync(sync_tree)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def rate(self, name: str, units_per_call: float = 1.0) -> float:
        if self.totals[name] == 0:
            return float("nan")
        return self.counts[name] * units_per_call / self.totals[name]

    def report(self) -> str:
        rows = [
            {"section": k, "total_s": round(v, 4),
             "calls": self.counts[k],
             "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3)}
            for k, v in sorted(self.totals.items())
        ]
        return json.dumps(rows)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Write a ``torch.profiler`` Chrome trace (CPU and, with a card, CUDA
    activity) to ``log_dir`` when it is set; no-op otherwise."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
