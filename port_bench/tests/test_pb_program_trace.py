"""The program-trace readers on a synthetic trace and synthetic records:
idle time by innermost span, the three groups, the counted work of
K1-K4 and K3, and None where there is nothing to read."""

import math
import types

import pytest

from port_bench import program_trace as pt
from port_bench import roofline
from port_bench import harness
from port_bench import trace as tr
from twoace_tpu_torch.utils import profiling

S, T = profiling.Span, profiling.Trips


def synthetic():
    """Host window 0..1000 ns, device clock = host + 50.  Two batch calls;
    the first holds a set-up span with a child, an inner loop with a
    check, and a scaffold span; the second only its root."""
    spans = [S("pair.batch", 100, 600, -1, 0),              # 0
             S("setup.spectral_init", 120, 260, 0, 0),      # 1
             S("setup.spectral_init.draw", 150, 200, 1, 0),  # 2
             S("inner.solve", 300, 500, 0, 0),              # 3
             S("inner.check", 400, 420, 3, 0),              # 4
             S("scaffold.gate", 520, 560, 0, 0),            # 5
             S("pair.batch", 700, 900, -1, 6)]              # 6
    trips = [T("per-op", 20, 972, 256, "k2", 192, 10, 1500, 3, 0),
             T("per-op", 1, 1024, 256, "k2", 64, 8, 400, 3, 0)]
    # device busy (host clock): 0-110, 180-310, 410-415, 450-530, 650-750;
    # idle: 110-180, 310-410, 415-450, 530-650, 750-1000
    busy = [(0, 110), (180, 310), (410, 415), (450, 530), (650, 750)]
    events = [tr.Event("pair_mm_tc<true>", s + 50, e - s) for s, e in busy]
    return tr.Trace(events, 0, 1000, 50), spans, trips


def fake_run(trace, spans, trips, monkeypatch, config=None):
    monkeypatch.setattr(profiling, "snapshot", lambda: (spans, trips))
    return types.SimpleNamespace(trace=trace, counters={},
                                 config=config or {"nr": 16})


def test_idle_goes_to_the_innermost_span_cut_where_spans_change():
    trace, spans, _ = synthetic()
    assert pt.idle_intervals(trace) == [(110, 180), (310, 410), (415, 450),
                                        (530, 650), (750, 1000)]
    got = pt.idle_by_span(trace, spans)
    # 110-180: root 110-120, set-up 120-150, the draw 150-180
    # 310-410: the loop 310-400, its check 400-410; 415-450: check 415-420,
    # loop 420-450; 530-650: gate 530-560, root 560-600, outside 600-650
    # (left out), second root 700-... is busy until 750, then idle 750-900
    assert got == {0: 10 + 40, 1: 30, 2: 30, 3: 90 + 30, 4: 10 + 5,
                   5: 30, 6: 150}


def test_the_three_groups_cover_the_idle_time_inside_the_roots(monkeypatch):
    trace, spans, trips = synthetic()
    run = fake_run(trace, spans, trips, monkeypatch)
    got = pt.idle_by_group(run, "pair.batch")
    assert got == {"setup": 60, "inner": 135, "scaffold": 50 + 30 + 150,
                   "calls": 2}
    inside = sum(min(e, r1) - max(s, r0)
                 for s, e in pt.idle_intervals(trace)
                 for r0, r1 in ((100, 600), (700, 900)) if min(e, r1) > max(
                     s, r0))
    assert got["setup"] + got["inner"] + got["scaffold"] == inside
    assert harness.reader("setup_idle_ms_per_call.batch")(run) == (
        pytest.approx(60 / 1e6 / 2))
    assert harness.reader("inner_idle_ms_per_call.batch")(run) == (
        pytest.approx(135 / 1e6 / 2))
    assert harness.reader("scaffold_idle_ms_per_call.batch")(run) == (
        pytest.approx(230 / 1e6 / 2))
    # the single cell's readers find no single root here
    assert harness.reader("setup_idle_ms_per_call.single")(run) is None


NEW = ["setup_idle_ms_per_call.batch", "setup_idle_ms_per_call.single",
       "inner_idle_ms_per_call.batch", "inner_idle_ms_per_call.single",
       "scaffold_idle_ms_per_call.batch", "scaffold_idle_ms_per_call.single",
       "loop_check_wait_pct", "active_lane_trip_pct", "k1_roofline_pct",
       "k2_roofline_pct", "k4_roofline_pct.counted",
       "k3_roofline_pct.counted"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_reads_none(name, monkeypatch):
    trace, spans, trips = synthetic()
    untied = tr.Trace(trace.events, 0, 1000, None)
    empty = fake_run(trace, [], [], monkeypatch)
    assert harness.reader(name)(empty) is None
    run = fake_run(untied if "idle" in name else None, spans, trips,
                   monkeypatch)
    if name in ("loop_check_wait_pct", "active_lane_trip_pct"):
        return                                    # read from spans alone
    assert harness.reader(name)(run) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "snapshot")
    trace, _, _ = synthetic()
    run = types.SimpleNamespace(trace=trace, counters={}, config={"nr": 16})
    for name in NEW:
        assert harness.reader(name)(run) is None


def test_loop_share_and_check_wait(monkeypatch):
    trace, spans, trips = synthetic()
    run = fake_run(trace, spans, trips, monkeypatch)
    assert harness.reader("active_lane_trip_pct")(run) == pytest.approx(
        100.0 * 1900 / (10 * 192 + 8 * 64))
    assert harness.reader("loop_check_wait_pct")(run) == pytest.approx(
        100.0 * 20 / 200)


def test_k1_k2_work_at_the_kernel_tables_shapes():
    """192 lanes, r 20, m 972, 16x16: K1 0.0359 ms and K2 0.00493 ms of
    HBM traffic, each bound by its bytes."""
    lanes, r, m, n, nr = 192, 20, 972, 256, 16
    k1 = lanes * pt.k1_bytes(r, m) / roofline.PEAK_BYTES
    k2 = lanes * pt.k2_bytes(r, n, nr, pt.LADDER_LEVELS) / roofline.PEAK_BYTES
    assert round(k1 * 1e3, 4) == 0.0359
    assert round(k2 * 1e3, 5) == 0.00493
    assert lanes * pt.k1_flops(r, m) / roofline.PEAK_FP32 < k1
    assert lanes * pt.k2_flops(r, n, nr) / roofline.PEAK_FP32 < k2
    assert pt.k2_flops(r, n, nr) + pt.k1_flops(r, m) == (
        roofline.lane_trip_rest(r, m, n, nr))


def test_counted_k4_work_equals_k4_work_without_a_refine(monkeypatch):
    """With launches that leave the refine no trips, ``k4_work`` prices
    every trip at r and the train split's m, as the records do."""
    cfg = {"rank": 20, "cc_frac": 0.95, "n_restarts": 3, "maxiter": 500}
    nt = nr = 16
    m = 1024
    mt = roofline.train_rows(m, cfg["cc_frac"])
    iters = [[819, 700, 812]]
    launches = [4 * 700 // 3]                    # the refine bound is 0
    assert all(roofline.refine_trip_bound(it, launches[0], 3, 500) == 0
               for it in iters[0])
    flops, n_bytes = roofline.k4_work(iters, launches, cfg, nt, nr, m)
    trips = [T("per-op", 20, mt, 256, "k2", 3, 819, sum(iters[0]), -1, -1)]
    k4_s = 1e-3
    trace = tr.Trace([tr.Event("pair_mm_tc<true>", 0, int(k4_s * 1e9))], 0,
                     2_000_000, 0)
    run = fake_run(trace, [S("pair.batch", 0, 10, -1, 0)], trips,
                   monkeypatch)
    want = 100.0 * roofline.least_seconds(flops, 0.0, n_bytes) / k4_s
    assert harness.reader("k4_roofline_pct.counted")(run) == (
        pytest.approx(want))


def test_counted_k3_work_prices_each_launch_at_its_own_shape(monkeypatch):
    trips = [T("k3", 20, 972, 256, "k2", 3, None, 900, -1, -1),
             T("k3", 1, 1024, 256, "k2", 1, None, 80, -1, -1)]
    events = [tr.Event("infer_admm_kernel<...>", 0, 9_000_000),
              tr.Event("split_kernel", 9_000_000, 1_000_000),
              tr.Event("infer_admm_kernel<...>", 10_000_000, 1_000_000)]
    trace = tr.Trace(events, 0, 20_000_000, 0)
    run = fake_run(trace, [S("pair.single", 0, 10, -1, 0)], trips,
                   monkeypatch)
    tc = 900 * roofline.lane_trip_products(20, 972, 256) + (
        80 * roofline.lane_trip_products(1, 1024, 256))
    rest = 900 * roofline.lane_trip_rest(20, 972, 256, 16) + (
        80 * roofline.lane_trip_rest(1, 1024, 256, 16))
    want = 100.0 * roofline.least_seconds(tc, rest, 0.0) / 11e-3
    assert harness.reader("k3_roofline_pct.counted")(run) == (
        pytest.approx(want))
    dropped = tr.Trace(events[:2], 0, 20_000_000, 0)
    run = fake_run(dropped, [S("pair.single", 0, 10, -1, 0)], trips,
                   monkeypatch)
    assert harness.reader("k3_roofline_pct.counted")(run) is None
    assert math.isfinite(want)
