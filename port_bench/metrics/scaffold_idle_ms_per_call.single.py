"""Device idle ms a single call while the host was in the scaffold,
outside every set-up and inner-loop span (``stage.*``, ``scaffold.*`` and
the root: quality, the host gate, the selection, the rollback).  Each
idle stretch of the traced window goes to the innermost program span the
host was in (:func:`port_bench.program_trace.idle_by_group`)."""

from port_bench import program_trace as pt


def read(run):
    return pt.idle_ms_per_call(run, "pair.single", pt.SCAFFOLD)
