"""Host time the per-op loop spends in its every-8-trips read of the
lanes' converged masks (``inner.check``, the host waiting for the card)
over its host time in the loop (``inner.solve`` spans that ran the per-op
loop), over the traced window."""

from port_bench import program_trace as pt


def read(run):
    trips = pt.loop_trips(run, "per-op")
    if trips is None:
        return None
    spans = pt.records(run)[0]
    solves = {t.span for t in trips if t.span >= 0}
    solve_ns = sum(spans[i].end_ns - spans[i].start_ns for i in solves)
    check_ns = sum(sp.end_ns - sp.start_ns for sp in spans
                   if sp.name == "inner.check" and sp.parent in solves)
    if solve_ns <= 0:
        return None
    return 100.0 * check_ns / solve_ns
