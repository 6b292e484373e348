"""The port's in-memory trace recorder, and a device barrier.

The recorder keeps two kinds of record, and keeps them only while a
``torch.profiler`` session is open in the process (any activity: a CPU
session, or a CUDA-only one that traces the card's kernels):

- spans (:func:`span`): a name, start and end on ``time.perf_counter_ns()``
  (the host clock a device trace is tied to by a marker kernel), the index
  of the enclosing span and a call id, the index of the root span, which
  every span of one entry call shares;
- lane-trip records (:func:`record_trips`): one for each inner-ADMM loop,
  written where the loop ran: its path, shape, Z-prox, the lanes it
  carried, the lockstep trips it ran, and the trips each lane ran (a
  device tensor, kept by reference and read by :func:`snapshot`).

With no profiler open, :func:`span` checks one flag and returns a shared
no-op context, and :func:`record_trips` checks the same flag; recording
adds no tensor, no kernel and no synchronisation either way.  A span
name's prefix before the first dot is its group (``pair``, ``setup``,
``stage``, ``inner``, ``scaffold``).

CUDA launches return before the card finishes, so a section that should
time device work ends in a barrier: :func:`sync` records a CUDA event on
each card that holds a tensor of its argument and waits for it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

import torch

#: whether a torch.profiler session is open (a C++ flag read, ~0.1 us)
recording = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int       #: index of the enclosing span, -1 for a root
    call: int         #: index of the root span


class Trips(NamedTuple):
    path: str                 #: "per-op", "k3", "k3-plain" (K3 on the CPU)
    r: int
    m: int
    n: int
    zprox: str                #: "k2", "nuclear" or "none"
    lanes: int                #: G * P lanes the loop carried
    trips: Optional[int]      #: lockstep trips run (per-op loop), else None
    active: int               #: sum of the lanes' own trips
    span: int                 #: innermost span open at the record, -1 if none
    call: int                 #: its call id, -1 if none


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.spans: List[list] = []
        self.trips: List[list] = []

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def here(self) -> Tuple[int, int]:
        """(innermost open span, its call id) of this thread."""
        st = self.stack()
        return st[-1] if st else (-1, -1)


_REC = _Recorder()
_NULL = contextlib.nullcontext()


class _Open:
    """The context of one recorded span."""

    __slots__ = ("name", "item", "top")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        parent, call = _REC.here()
        with _REC.lock:
            index = len(_REC.spans)
            self.item = [self.name, time.perf_counter_ns(), None, parent,
                         index if parent < 0 else call]
            _REC.spans.append(self.item)
        self.top = (index, self.item[4])
        _REC.stack().append(self.top)

    def __exit__(self, *exc):
        self.item[2] = time.perf_counter_ns()
        st = _REC.stack()
        if st and st[-1] == self.top:
            st.pop()
        return False


def span(name: str):
    """A context that records the span ``name`` while a profiler session is
    open, else the shared no-op context."""
    if not recording():
        return _NULL
    return _Open(name)


def record_trips(path: str, r: int, m: int, n: int, zprox: str, lanes: int,
                 trips: Optional[int], it: torch.Tensor) -> None:
    """Record one inner loop's lane trips while a profiler session is
    open; ``it`` holds each lane's trips and is read by :func:`snapshot`."""
    if not recording():
        return
    where, call = _REC.here()
    with _REC.lock:
        _REC.trips.append([path, r, m, n, zprox, lanes, trips, it, where,
                           call])


def snapshot() -> Tuple[List[Span], List[Trips]]:
    """Every span and lane-trip record kept so far, as plain Python.  The
    first call after a loop reads its ``it`` from the device; a span still
    open has ``end_ns`` None."""
    with _REC.lock:
        for rec in _REC.trips:
            if torch.is_tensor(rec[7]):
                rec[7] = int(rec[7].sum())
        return ([Span(*s) for s in _REC.spans],
                [Trips(*t) for t in _REC.trips])


def reset() -> None:
    """Forget every record."""
    with _REC.lock:
        _REC.spans.clear()
        _REC.trips.clear()
    _REC.stack().clear()


# ---------------------------------------------------------------------------
# the device barrier

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
