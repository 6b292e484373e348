"""The per-op loop's useful share: the trips its lanes ran (the sum of
``it``) over the lane trips it carried (its lockstep trips times its
lanes; a converged lane rides every later trip frozen), over the traced
window's batch calls.  K4, K1 and K2 are handed the carried ones."""

from port_bench import program_trace as pt


def read(run):
    trips = pt.loop_trips(run, "per-op")
    if trips is None:
        return None
    carried = sum(t.trips * t.lanes for t in trips)
    if carried <= 0:
        return None
    return 100.0 * sum(t.active for t in trips) / carried
