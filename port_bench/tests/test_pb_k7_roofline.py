"""``k7_roofline_pct``: the counted bytes of the per-op loop's trip glue
at the batch cells' shapes, the share it reads from a synthetic trace,
and None where there is no K7 kernel or no per-op record to read."""

import types

import pytest

from port_bench import harness
from port_bench import roofline
from port_bench import trace as tr
from twoace_tpu_torch.utils import profiling

T = profiling.Trips
NAME = "k7_roofline_pct"


def _bytes():
    path = harness.BENCH / "metrics" / f"{NAME}.py"
    ns = {}
    exec(compile(path.read_text(), str(path), "exec"), ns)
    return ns["lane_trip_bytes"]


def _run(trace, trips, monkeypatch):
    spans = [profiling.Span("pair.batch", 0, 10, -1, 0)]
    monkeypatch.setattr(profiling, "snapshot", lambda: (spans, trips))
    return types.SimpleNamespace(trace=trace, counters={},
                                 config={"nr": 16})


@pytest.mark.parametrize("r, m, n, zprox, want", [
    (20, 972, 256, "k2", 8 * (6 * 20 * 972 + 14 * 20 * 256) + 4 * 972),
    (20, 3891, 1024, "k2", 8 * (6 * 20 * 3891 + 14 * 20 * 1024) + 4 * 3891),
    (1, 1024, 256, "k2", 8 * (6 * 1024 + 14 * 256) + 4 * 1024),
    (20, 972, 256, "none", 8 * (6 * 20 * 972 + 2 * 20 * 256) + 4 * 972),
])
def test_counted_bytes_at_the_batch_shapes(r, m, n, zprox, want):
    """batch256's first pass (m 972, 16x16), batch32's (m 3891, 32x32),
    the refine's one column, and the Z-free loop."""
    assert _bytes()(r, m, n, zprox) == want


def test_batch256_trip_bound():
    """768 lanes of batch256's first pass: 1.16 GB, 0.346 ms at 3.35
    TB/s."""
    n_bytes = 768 * _bytes()(20, 972, 256, "k2")
    assert round(n_bytes / 1e9, 2) == 1.16
    assert round(1e3 * roofline.least_seconds(0.0, 0.0, n_bytes), 3) == 0.346


def test_share_over_the_k7_kernels(monkeypatch):
    trips = [T("per-op", 20, 972, 256, "k2", 768, 10, 7000, -1, -1),
             T("per-op", 1, 1024, 256, "k2", 256, 8, 2000, -1, -1),
             T("k3", 20, 972, 256, "k2", 3, None, 900, -1, -1)]
    events = [tr.Event("admm_trip_rows", 0, 4_000_000),
              tr.Event("pair_mm_tc<true>", 4_000_000, 9_000_000),
              tr.Event("void admm_trip_commit(...)", 13_000_000, 1_000_000)]
    run = _run(tr.Trace(events, 0, 20_000_000, 0), trips, monkeypatch)
    b = _bytes()
    n_bytes = 7000 * b(20, 972, 256, "k2") + 2000 * b(1, 1024, 256, "k2")
    want = 100.0 * n_bytes / roofline.PEAK_BYTES / 5e-3
    assert harness.reader(NAME)(run) == pytest.approx(want)


def test_nothing_to_read_reads_none(monkeypatch):
    trips = [T("per-op", 20, 972, 256, "k2", 768, 10, 7000, -1, -1)]
    no_k7 = tr.Trace([tr.Event("pair_mm_tc<true>", 0, 1000)], 0, 2000, 0)
    assert harness.reader(NAME)(_run(no_k7, trips, monkeypatch)) is None
    k7 = tr.Trace([tr.Event("admm_trip_rows", 0, 1000)], 0, 2000, 0)
    assert harness.reader(NAME)(_run(None, trips, monkeypatch)) is None
    single = [T("k3", 20, 972, 256, "k2", 3, None, 900, -1, -1)]
    assert harness.reader(NAME)(_run(k7, single, monkeypatch)) is None
    assert harness.reader(NAME)(_run(k7, [], monkeypatch)) is None
