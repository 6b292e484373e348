"""Device idle ms a single call while the host was in an inner-loop span
(``inner.*``: the loop, and its every-8-trips read of the converged
masks).  Each idle stretch of the traced window goes to the innermost
program span the host was in
(:func:`port_bench.program_trace.idle_by_group`)."""

from port_bench import program_trace as pt


def read(run):
    return pt.idle_ms_per_call(run, "pair.single", pt.INNER)
