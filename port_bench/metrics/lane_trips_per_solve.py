"""Inner-ADMM trips a single solve's lanes ran: ``PairAdmmResult.iters``
over the window's solves."""


def read(run):
    iters = run.counters.get("iters")
    if not iters or not run.counters.get("solves"):
        return None
    return sum(iters) / run.counters["solves"]
