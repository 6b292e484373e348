"""The share of the traced window in which no operation ran on the
device (the single cells)."""

from port_bench import trace as tr


def read(run):
    if run.trace is None:
        return None
    return tr.idle_pct(run.trace)
