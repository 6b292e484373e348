"""Device idle ms a batch call while the host was in a set-up span
(``setup.*``: the active-row read, the splits, normalisation, U, the
spectral init and its CPU draw, the column orthonormalisation, the loop's
initialisation).  Each idle stretch of the traced window goes to the
innermost program span the host was in
(:func:`port_bench.program_trace.idle_by_group`)."""

from port_bench import program_trace as pt


def read(run):
    return pt.idle_ms_per_call(run, "pair.batch", pt.SETUP)
