"""The device trace of a ``--trace 1`` window, read from torch.profiler.

Only the device's own events are recorded (kernels, copies, sets): a
host op's device time would repeat its kernels', and recording the host's
ops of a window of ~10^5 launches slows the host path it measures.  The
raw events are summed as they come (``kineto_results``), without the
profiler's event tree, which takes minutes to build at that count.

The profiler's clock is not the host's: one marker kernel, launched on an
idle card right after the window opens, ties the two, so that idle gaps
can be named after the benchmark's own span the host was in.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple, Optional

import torch

#: the marker kernel ``torch.cuda._sleep`` launches
MARKER = "spin_kernel"


class Event(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int


class Trace(NamedTuple):
    events: List[Event]       #: device events, marker excluded
    t0_ns: int                #: host clock (perf_counter_ns) of the window
    t1_ns: int
    offset_ns: Optional[int]  #: device clock minus host clock, if tied


class Spans:
    """The benchmark's own spans on the host clock, kept in memory."""

    def __init__(self):
        self.items = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter_ns()))

    def at(self, t_ns: int) -> str:
        """The name of the span the host was in at ``t_ns``."""
        for name, t0, t1 in self.items:
            if t0 <= t_ns <= t1:
                return name
        return "between"


class Tracer:
    """Traces the device from :meth:`start` to :meth:`stop` when enabled;
    ``result`` holds the :class:`Trace` afterwards (None when off)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.result: Optional[Trace] = None
        self._prof = None

    def start(self):
        """Open the trace; the window's host clock starts here."""
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            torch.cuda.synchronize()
            self._mark = time.perf_counter_ns()
            torch.cuda._sleep(1)
        return time.perf_counter_ns()

    def stop(self, t0_ns: int, t1_ns: int):
        """Close the trace of the window [t0_ns, t1_ns]."""
        if not self.enabled:
            return
        self._prof.__exit__(None, None, None)
        from torch.autograd import DeviceType

        results = self._prof.profiler.kineto_results
        events, offset = [], None
        for e in (results.events() if results is not None else ()):
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            if offset is None and MARKER in e.name():
                offset = e.start_ns() - self._mark
                continue
            events.append(Event(e.name(), e.start_ns(), e.duration_ns()))
        self._prof = None
        self.result = Trace(events, t0_ns, t1_ns, offset)


def busy_intervals(events: List[Event]) -> List[tuple]:
    """The device's busy time as disjoint (start, end) intervals."""
    out = []
    for e in sorted(events, key=lambda e: e.start_ns):
        s, t = e.start_ns, e.start_ns + e.dur_ns
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [tuple(iv) for iv in out]


def busy_seconds(events: List[Event]) -> float:
    return sum(t - s for s, t in busy_intervals(events)) / 1e9


def window_seconds(trace: Trace) -> float:
    return (trace.t1_ns - trace.t0_ns) / 1e9


def device_seconds(trace: Trace, pattern: str) -> float:
    """Seconds of the device events whose name holds ``pattern``."""
    return sum(e.dur_ns for e in trace.events if pattern in e.name) / 1e9


def event_count(trace: Trace, pattern: str) -> int:
    return sum(1 for e in trace.events if pattern in e.name)


def top_ops(trace: Trace, count: int = 10) -> list:
    """[[name, seconds], ...] of the device operations that took most
    time, summed by name."""
    acc = {}
    for e in trace.events:
        acc[e.name] = acc.get(e.name, 0) + e.dur_ns
    top = sorted(acc.items(), key=lambda kv: -kv[1])[:count]
    return [[name[:160], ns / 1e9] for name, ns in top]


def idle_gaps(trace: Trace, spans: Spans, count: int = 10) -> list:
    """[[span, seconds], ...] of the longest idle stretches of the window,
    each named after the benchmark span the host was in at its middle
    ("untied" where the marker was not seen)."""
    if trace.offset_ns is None:
        lo, hi = None, None
    else:
        lo = trace.t0_ns + trace.offset_ns
        hi = trace.t1_ns + trace.offset_ns
    busy = busy_intervals(trace.events)
    gaps = []
    edges = ([(lo, lo)] if lo is not None else []) + busy + (
        [(hi, hi)] if hi is not None else [])
    for (_, end), (start, _) in zip(edges, edges[1:]):
        if start > end:
            gaps.append((start - end, (start + end) // 2))
    gaps.sort(key=lambda g: -g[0])
    out = []
    for length, mid in gaps[:count]:
        name = ("untied" if trace.offset_ns is None
                else spans.at(mid - trace.offset_ns))
        out.append([name, length / 1e9])
    return out


def idle_pct(trace: Trace) -> float:
    """Percent of the window with no device event."""
    return 100.0 * (1.0 - busy_seconds(trace.events) / window_seconds(trace))
