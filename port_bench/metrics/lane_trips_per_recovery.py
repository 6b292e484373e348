"""Inner-ADMM trips a recovery's lanes ran, over the window's batch
solves: ``PairAdmmResult.iters`` summed, over the recoveries."""


def read(run):
    iters = run.counters.get("iters")
    if not iters or not run.counters.get("recoveries"):
        return None
    return sum(sum(call) for call in iters) / run.counters["recoveries"]
