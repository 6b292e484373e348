"""K1's (``fused_prox_dual_t``) share of its roofline over the traced
window: the least time of the per-op loop's active lane trips, each
record's at its own r and m (:func:`port_bench.program_trace.k1_bytes`,
``k1_flops``), over the device time of K1's kernels (``prox_dual_t``)."""

from port_bench import program_trace as pt
from port_bench import roofline
from port_bench import trace as tr


def read(run):
    trips = pt.loop_trips(run, "per-op")
    if run.trace is None or trips is None:
        return None
    k1_s = tr.device_seconds(run.trace, "prox_dual_t")
    if k1_s <= 0:
        return None
    flops = sum(t.active * pt.k1_flops(t.r, t.m) for t in trips)
    n_bytes = sum(t.active * pt.k1_bytes(t.r, t.m) for t in trips)
    return 100.0 * roofline.least_seconds(0.0, flops, n_bytes) / k1_s
