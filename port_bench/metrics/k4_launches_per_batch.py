"""K4 (``pair_matmul``) launches a batch solve: four a lockstep trip of
the per-op loop, so a straggling lane shows here."""


def read(run):
    launches = run.counters.get("k4_launches")
    if not launches or not sum(launches):
        return None
    return sum(launches) / len(launches)
