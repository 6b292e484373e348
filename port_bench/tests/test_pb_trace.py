"""The trace arithmetic on a synthetic trace."""

import pytest

from port_bench import trace as tr


def synthetic():
    ev = [tr.Event("pair_mm_tc<true>", 1_000, 2_000),        # 1000-3000
          tr.Event("add", 2_500, 1_000),                      # 2500-3500
          tr.Event("pair_mm_rows", 6_000, 1_000),             # 6000-7000
          tr.Event("(anon)::infer_admm_kernel(P)", 9_000, 500)]
    # host window 0..10_000 host ns; device clock = host + 100
    return tr.Trace(ev, 0, 10_000, 100)


def test_busy_and_idle():
    t = synthetic()
    assert tr.busy_intervals(t.events) == [(1_000, 3_500), (6_000, 7_000),
                                           (9_000, 9_500)]
    assert tr.busy_seconds(t.events) == pytest.approx(4_000e-9)
    assert tr.window_seconds(t) == pytest.approx(10_000e-9)
    assert tr.idle_pct(t) == pytest.approx(60.0)


def test_device_seconds_by_name():
    t = synthetic()
    assert tr.device_seconds(t, "pair_mm_") == pytest.approx(3_000e-9)
    assert tr.event_count(t, "infer_admm_kernel") == 1
    assert tr.top_ops(t, 2) == [["pair_mm_tc<true>", 2e-6],
                                ["add", 1e-6]]


def test_idle_gaps_named_by_span():
    t = synthetic()
    spans = tr.Spans()
    spans.items = [("draw", 0, 1_000), ("solve", 1_000, 8_000),
                   ("keep", 8_000, 10_000)]
    gaps = tr.idle_gaps(t, spans)
    # device gaps: 100-1000, 3500-6000, 7000-9000, 9500-10100
    assert gaps[0] == ["solve", pytest.approx(2_500e-9)]
    assert [g[0] for g in gaps] == ["solve", "solve", "draw", "keep"]
    assert sum(g[1] for g in gaps) == pytest.approx(
        tr.window_seconds(t) - tr.busy_seconds(t.events))
    untied = tr.Trace(t.events, 0, 10_000, None)
    assert {g[0] for g in tr.idle_gaps(untied, spans)} == {"untied"}
