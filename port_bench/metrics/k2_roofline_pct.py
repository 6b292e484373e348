"""K2's (``fused_zprox_t``) share of its roofline over the traced window:
the least time of the active lane trips of the per-op loops that ran K2,
each record's at its own r and n (:func:`port_bench.program_trace.
k2_bytes`, ``k2_flops``), over the device time of K2's kernels
(``zprox_kernel``)."""

from port_bench import program_trace as pt
from port_bench import roofline
from port_bench import trace as tr


def read(run):
    trips = pt.loop_trips(run, "per-op")
    if run.trace is None or trips is None:
        return None
    trips = [t for t in trips if t.zprox == "k2"]
    k2_s = tr.device_seconds(run.trace, "zprox_kernel")
    if not trips or k2_s <= 0:
        return None
    nr = run.config["nr"]
    flops = sum(t.active * pt.k2_flops(t.r, t.n, nr) for t in trips)
    n_bytes = sum(t.active * pt.k2_bytes(t.r, t.n, nr, pt.LADDER_LEVELS)
                  for t in trips)
    return 100.0 * roofline.least_seconds(0.0, flops, n_bytes) / k2_s
