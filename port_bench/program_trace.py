"""The program's own trace of a ``--trace 1`` window, tied to the device's.

``twoace_tpu_torch.utils.profiling`` records spans and lane-trip records
while a torch.profiler session is open, which the tracer's is from
:meth:`.trace.Tracer.start` to :meth:`~.trace.Tracer.stop`: the window
alone.  This module reads them after the window (:func:`records`), maps
the device's idle time onto the program span the host was in
(:func:`idle_by_group`), and holds the work a lane trip needs of K1 and
K2 (K4's and K3's is in :mod:`.roofline`).  A program without the
recorder, or a window that recorded nothing, reads as None.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from . import roofline
from . import trace as tr

#: the groups of the idle time inside a root span, by span name prefix;
#: every other span under a root ("pair", "stage", "scaffold") is the
#: scaffold's
SETUP, INNER, SCAFFOLD = "setup", "inner", "scaffold"
#: levels of K2's ladder as the solvers pad it
#: (``ops.prox.profile_ladder_arrays``'s ``length``)
LADDER_LEVELS = 4


def records(run):
    """``(spans, trips)`` of the window from the program's recorder, or
    None when the program has none or it recorded nothing.  Read once a
    run: the first read takes each loop's trips off the device."""
    if hasattr(run, "_program_records"):
        return run._program_records
    try:
        from twoace_tpu_torch.utils import profiling
    except ImportError:
        profiling = None
    snap = getattr(profiling, "snapshot", None)
    out = None
    if snap is not None:
        spans, trips = snap()
        if spans:
            out = (spans, trips)
    run._program_records = out
    return out


def group(name: str) -> str:
    head = name.split(".", 1)[0]
    return head if head in (SETUP, INNER) else SCAFFOLD


def timeline(spans) -> List[tuple]:
    """Disjoint ``(start, end, index)`` host-clock segments, each with the
    innermost span open over it; spans nest, and a span still open is
    left out."""
    done = [i for i, sp in enumerate(spans) if sp.end_ns is not None]
    done.sort(key=lambda i: (spans[i].start_ns, -spans[i].end_ns))
    out, stack, t = [], [], None

    def close_until(t_ns):
        nonlocal t
        while stack and spans[stack[-1]].end_ns <= t_ns:
            top = stack.pop()
            end = spans[top].end_ns
            if end > t:
                out.append((t, end, top))
            t = end

    for i in done:
        sp = spans[i]
        close_until(sp.start_ns)
        if stack and sp.start_ns > t:
            out.append((t, sp.start_ns, stack[-1]))
        stack.append(i)
        t = sp.start_ns
    close_until(float("inf"))
    return out


def idle_intervals(trace: tr.Trace) -> List[tuple]:
    """The window's idle stretches on the host clock (the device's
    clock less ``offset_ns``)."""
    off = trace.offset_ns
    lo, hi = trace.t0_ns + off, trace.t1_ns + off
    out, t = [], lo
    for s, e in tr.busy_intervals(trace.events):
        if s > t:
            out.append((t - off, min(s, hi) - off))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t - off, hi - off))
    return [(s, e) for s, e in out if e > s]


def idle_by_span(trace: tr.Trace, spans) -> Dict[int, int]:
    """{span index: idle ns} of each span over the idle time when it was
    the innermost span the host was in; an idle stretch is cut where
    spans change.  Idle time outside every span is left out."""
    out: Dict[int, int] = {}
    segs = timeline(spans)
    k = 0
    for s, e in idle_intervals(trace):
        while k < len(segs) and segs[k][1] <= s:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < e:
            a, b, i = segs[j]
            cut = min(b, e) - max(a, s)
            if cut > 0:
                out[i] = out.get(i, 0) + cut
            j += 1
    return out


def idle_by_group(run, root: str) -> Optional[Dict[str, float]]:
    """Idle ns of the window under the roots named ``root``, by group
    (``setup``, ``inner``, ``scaffold``), and ``calls``, the roots; None
    without a tied trace or records."""
    rec = records(run)
    if run.trace is None or run.trace.offset_ns is None or rec is None:
        return None
    spans, _ = rec
    roots = {i for i, sp in enumerate(spans)
             if sp.parent < 0 and sp.name == root}
    if not roots:
        return None
    out = {SETUP: 0.0, INNER: 0.0, SCAFFOLD: 0.0, "calls": len(roots)}
    for i, ns in idle_by_span(run.trace, spans).items():
        if spans[i].call in roots:
            out[group(spans[i].name)] += ns
    return out


def idle_ms_per_call(run, root: str, name: str) -> Optional[float]:
    """Idle ms a call under the group ``name`` of the roots ``root``."""
    got = idle_by_group(run, root)
    if got is None:
        return None
    return got[name] / 1e6 / got["calls"]


def loop_trips(run, path: str):
    """The window's lane-trip records of ``path`` ("per-op" or "k3"), or
    None when there are none."""
    rec = records(run)
    if rec is None:
        return None
    trips = [t for t in rec[1] if t.path == path]
    return trips or None


# ---------------------------------------------------------------------------
# the work of one lane trip, read once and written once

def k1_bytes(r: int, m: int) -> float:
    """K1 (magnitude prox + M-dual) a lane trip: reads A X, the M-dual
    (r x m pairs each), b and mu, writes Y and the new M-dual."""
    return roofline.PAIR * 4.0 * r * m + 4.0 * m + 4.0


def k1_flops(r: int, m: int) -> float:
    """K1's float32 flops a lane trip: the prox of :func:`.roofline.
    lane_trip_rest`."""
    return 16.0 * r * m


def k2_bytes(r: int, n: int, nr: int, levels: int) -> float:
    """K2 (warm Z-prox) a lane trip: reads and writes the Z panel (r x n
    pairs) and the basis (nr x nr pairs), reads the ladder's ranks and
    fractions."""
    return roofline.PAIR * 2.0 * (r * n + nr * nr) + 8.0 * levels


def k2_flops(r: int, n: int, nr: int) -> float:
    """K2's float32 flops a lane trip: the Z-prox terms of
    :func:`.roofline.lane_trip_rest` (the panel Gram and the apply, the
    nr x nr chain)."""
    return 2.0 * r * n * nr * 8 + 7.0 * nr ** 3 * 8
