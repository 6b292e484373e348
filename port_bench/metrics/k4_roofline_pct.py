"""K4's share of its roofline over the window: the least time of the
products the batch solves' lane trips needed (:func:`..roofline.k4_work`,
3xTF32 on the tensor cores or the bytes) over the device time of K4's
kernels (``pair_mm_*``) in the trace."""

from port_bench import roofline
from port_bench import trace as tr


def read(run):
    if run.trace is None or not run.counters.get("iters"):
        return None
    k4_s = tr.device_seconds(run.trace, "pair_mm_")
    if k4_s <= 0:
        return None
    c = run.config
    flops, n_bytes = roofline.k4_work(
        run.counters["iters"], run.counters["k4_launches"], c["admm_batch"],
        c["nt"], c["nr"], c["m"])
    return 100.0 * roofline.least_seconds(flops, 0.0, n_bytes) / k4_s
