"""K3's share of its roofline over the traced window, from counted work:
the least time of each launch's active lane trips at the launch's own r,
m and n (:func:`port_bench.roofline.lane_trip_products` on the tensor
cores, ``lane_trip_rest`` in float32) over the device time of K3's
kernels (the loop and its per-launch constant split).  Nothing is read
when the trace holds another count of loop kernels than K3 records: a
trace that dropped events would read too short."""

from port_bench import program_trace as pt
from port_bench import roofline
from port_bench import trace as tr

LOOP, SPLIT = "infer_admm_kernel", "split_kernel"


def read(run):
    trips = pt.loop_trips(run, "k3")
    if run.trace is None or trips is None:
        return None
    if tr.event_count(run.trace, LOOP) != len(trips):
        return None
    k3_s = tr.device_seconds(run.trace, LOOP) + tr.device_seconds(
        run.trace, SPLIT)
    if k3_s <= 0:
        return None
    nr = run.config["nr"]
    tc = sum(t.active * roofline.lane_trip_products(t.r, t.m, t.n)
             for t in trips)
    rest = sum(t.active * roofline.lane_trip_rest(t.r, t.m, t.n, nr)
               for t in trips)
    return 100.0 * roofline.least_seconds(tc, rest, 0.0) / k3_s
