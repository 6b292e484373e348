"""Peaks of the card and the work the timed kernels have to do.

Published dense peaks of one NVIDIA H100 SXM at its 700 W limit: 495
TFLOP/s in TF32 on the tensor cores, 67 TFLOP/s in float32 on the CUDA
cores, 3.35 TB/s of HBM.  K4 and K3 compute their products in 3xTF32
(three TF32 products a float32-class product), so a product's least time
is three times its flops over the TF32 peak.

The work is counted from the lane trips the solver reports (``iters``)
and never above what the inputs need: each lane trip needs the loop's
four complex products, three of r x m x n and one of r x n x n, at 6
flops a complex multiply-add (the Karatsuba form the kernels use), and
reads its lane's operands and writes its outputs once.  Codebook and U
bytes, shared by a group's lanes, are not counted, and m is the train
split's, the smaller one.
"""

from __future__ import annotations

import math

PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
#: bytes of one complex float32 pair entry
PAIR = 8


def train_rows(m: int, cc_frac: float) -> int:
    """Rows of a restart's train split, the smaller m a trip can use."""
    return int(math.floor(m * cc_frac))


def lane_trip_products(r: int, m: int, n: int) -> float:
    """Flops of one lane trip's four products: A^H (Y - M/mu), the
    X-update against U, A X and A^H Y."""
    return 6.0 * r * (3.0 * m * n + n * n)


def lane_trip_bytes(r: int, m: int, n: int) -> float:
    """Bytes a lane trip's four products read and write for that lane:
    (r x m -> r x n), (r x n -> r x n), (r x n -> r x m), (r x m -> r x n)."""
    return PAIR * r * (3.0 * m + 5.0 * n)


def lane_trip_rest(r: int, m: int, n: int, nr: int) -> float:
    """Flops of a trip outside the products, as K3 runs them: the Z-prox's
    panel Gram and delta apply, its nr x nr chain, and the prox."""
    return 2.0 * r * n * nr * 8 + 7.0 * nr ** 3 * 8 + 16.0 * r * m


def least_seconds(flops_tc: float, flops_fp32: float, n_bytes: float) -> float:
    """The least time the card could take: the largest of the tensor-core
    products in 3xTF32, the float32 rest, and the bytes."""
    return max(3.0 * flops_tc / PEAK_TF32, flops_fp32 / PEAK_FP32,
               n_bytes / PEAK_BYTES)


def refine_trip_bound(iters: int, launches: int, restarts: int,
                      maxiter: int) -> int:
    """The most trips the one-column refine of an instance can have run
    in a lockstep batch solve, from its ``iters`` and the solve's K4
    launches.

    Each lockstep trip launches K4 four times, so the solve's passes,
    retry and refine ran at most launches / 4 trips together.  An
    instance's R restarts ride the passes side by side and its retried
    lanes the retry, so its iters - refine trips took at least
    (iters - refine) / R of those trips, and the refine its own:
    refine <= (R * launches / 4 - iters) / (R - 1).
    """
    bound = min(iters, maxiter)
    if restarts > 1:
        bound = min(bound, max(0, math.floor(
            (restarts * launches / 4.0 - iters) / (restarts - 1))))
    return bound


def k4_work(iters_per_call, launches_per_call, cfg: dict, nt: int, nr: int,
            m: int) -> tuple:
    """(flops, bytes) of K4's products over the batch solves of a window.

    ``iters_per_call``: one list of instance iters a call;
    ``launches_per_call``: K4 launches of each call.  The refine's trips
    run one column (r = 1); the rest run r columns.
    """
    n = nt * nr
    mt = train_rows(m, cfg["cc_frac"])
    flops = n_bytes = 0.0
    for iters, launches in zip(iters_per_call, launches_per_call):
        for it in iters:
            ref = refine_trip_bound(int(it), launches, cfg["n_restarts"],
                                    cfg["maxiter"])
            wide = int(it) - ref
            flops += (wide * lane_trip_products(cfg["rank"], mt, n)
                      + ref * lane_trip_products(1, mt, n))
            n_bytes += (wide * lane_trip_bytes(cfg["rank"], mt, n)
                        + ref * lane_trip_bytes(1, mt, n))
    return flops, n_bytes


def k3_work(iters_per_solve, cfg: dict, nt: int, nr: int, m: int) -> tuple:
    """(tensor-core flops, float32 flops) of K3 over the single solves of
    a window.  K3 keeps a lane's state on chip across its trips, so its
    bytes are not counted a trip.  K3 runs each inner solve in one
    launch, so no launch count bounds the refine: its trips are taken as
    many as it may have run, min(iters, maxiter), at one column."""
    n = nt * nr
    mt = train_rows(m, cfg["cc_frac"])
    r = cfg["rank"]
    tc = rest = 0.0
    for it in iters_per_solve:
        ref = min(int(it), cfg["maxiter"])
        wide = int(it) - ref
        tc += wide * lane_trip_products(r, mt, n) + ref * lane_trip_products(
            1, mt, n)
        rest += wide * lane_trip_rest(r, mt, n, nr) + ref * lane_trip_rest(
            1, mt, n, nr)
    return tc, rest
