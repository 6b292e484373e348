"""K7's (the per-op loop's trip glue) share of its roofline over the
traced window: the least time of the per-op loop's active lane trips,
each record's bytes at its own r, m, n and Z-prox (:func:`lane_trip_bytes`),
over the device time of the kernels whose names hold ``admm_trip``.  The
counted work is what one trip's glue has to read and write once, fixed by
the record whatever implements it; its flops are taken as 0.  A program
without those kernels, or a window without per-op records, reads None."""

from port_bench import program_trace as pt
from port_bench import roofline
from port_bench import trace as tr

#: the name every K7 kernel holds
KERNELS = "admm_trip"


def lane_trip_bytes(r: int, m: int, n: int, zprox: str) -> float:
    """Bytes one lane trip's glue reads and writes once, 8 an entry of a
    (re, im) float32 pair.  On the rows, 6 r x m pairs: Y and the M-dual
    read and Y - M/mu written; A X, Y_new and Y_old read for the sums.  On
    the columns, with a Z-prox, 14 r x n pairs: A^H T, Z and the N-dual
    read and the X-update's right-hand side written; X and the N-dual read
    and the Z-prox's input written; X, Z_new, Z_old, the N-dual, A^H Y_new
    and A^H Y_old read and the N-dual written.  Without a Z-prox
    (``zprox`` "none") 2: A^H Y_new and A^H Y_old.  And b, m floats.  The
    best-so-far copies depend on the data and are left out."""
    cols = 2 if zprox == "none" else 14
    return roofline.PAIR * (6.0 * r * m + cols * r * n) + 4.0 * m


def read(run):
    trips = pt.loop_trips(run, "per-op")
    if run.trace is None or trips is None:
        return None
    k7_s = tr.device_seconds(run.trace, KERNELS)
    if k7_s <= 0:
        return None
    n_bytes = sum(t.active * lane_trip_bytes(t.r, t.m, t.n, t.zprox)
                  for t in trips)
    return 100.0 * roofline.least_seconds(0.0, 0.0, n_bytes) / k7_s
