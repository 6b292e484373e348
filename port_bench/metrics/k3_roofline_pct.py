"""K3's share of its roofline over the window: the least time of the
single solves' lane trips (:func:`..roofline.k3_work`: products in
3xTF32, the rest in float32) over the device time of K3's kernels (the
loop and its per-launch constant split) in the trace.  Nothing is read
when the trace holds fewer loop kernels than K3 launched: a trace that
dropped events would read too short."""

from port_bench import roofline
from port_bench import trace as tr

LOOP, SPLIT = "infer_admm_kernel", "split_kernel"


def read(run):
    if run.trace is None or not run.counters.get("iters"):
        return None
    if tr.event_count(run.trace, LOOP) != run.counters["k3_launches"]:
        return None
    k3_s = tr.device_seconds(run.trace, LOOP) + tr.device_seconds(
        run.trace, SPLIT)
    if k3_s <= 0:
        return None
    c = run.config
    tc, rest = roofline.k3_work(run.counters["iters"], c["admm_single"],
                                c["nt"], c["nr"], c["m"])
    return 100.0 * roofline.least_seconds(tc, rest, 0.0) / k3_s
