"""K4's share of its roofline over the traced window, from counted work:
the least time of the products of the per-op loop's active lane trips,
each record's at its own r, m and n (:func:`port_bench.roofline.
lane_trip_products`, ``lane_trip_bytes``), over the device time of K4's
kernels (``pair_mm_*``).  ``k4_roofline_pct`` rebuilds the same work
from ``iters`` and K4's launches."""

from port_bench import program_trace as pt
from port_bench import roofline
from port_bench import trace as tr


def read(run):
    trips = pt.loop_trips(run, "per-op")
    if run.trace is None or trips is None:
        return None
    k4_s = tr.device_seconds(run.trace, "pair_mm_")
    if k4_s <= 0:
        return None
    flops = sum(t.active * roofline.lane_trip_products(t.r, t.m, t.n)
                for t in trips)
    n_bytes = sum(t.active * roofline.lane_trip_bytes(t.r, t.m, t.n)
                  for t in trips)
    return 100.0 * roofline.least_seconds(flops, 0.0, n_bytes) / k4_s
