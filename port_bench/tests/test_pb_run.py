"""Whole runs on the CPU at a tiny size, the harness's look for a card
skipped: the last line's keys, and ``correct`` false when the timed
path underneath is broken."""

import json

import pytest
import torch

from conftest import TINY_TRAFFIC, tiny
from port_bench import harness

CPU = torch.device("cpu")
E2E = {"batch": ["recoveries_per_s", "setup_s"],
       "single": ["solve_ms_p50", "solve_ms_p95", "setup_s"]}
LAYER = {"batch": ["lane_trips_per_recovery", "k4_launches_per_batch",
                   "k4_roofline_pct", "device_idle_pct.batch"],
         "single": ["lane_trips_per_solve", "k3_roofline_pct",
                    "device_idle_pct.single"]}


def run(kind, trace=False, seed=2**31 + 17, seconds=0.05):
    e2e = [{"name": n, "unit": "u"} for n in E2E[kind]]
    layer = [{"name": n, "unit": "u"} for n in LAYER[kind]]
    return harness.run_cell(tiny(), TINY_TRAFFIC[kind], e2e, layer, seed,
                            seconds, trace, CPU, 0.0)


@pytest.mark.parametrize("kind", ["batch", "single"])
def test_last_line(kind):
    result, compared = run(kind)
    line = json.loads(harness.result_line(result, compared))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert sorted(line["metrics"]) == sorted(E2E[kind])
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    (name,) = line["compared"]
    assert line["compared"][name]["value"] < line["compared"][name]["limit"]
    assert harness.compared_lines(compared).startswith("nmse_db_worst ")


@pytest.mark.parametrize("kind", ["batch", "single"])
def test_traced_line_holds_the_counters(kind):
    result, _ = run(kind, trace=True)
    # no device trace on the CPU: only the program's counters are read
    want = {"batch": {"lane_trips_per_recovery"},
            "single": {"lane_trips_per_solve"}}[kind]
    assert set(result["metrics"]) == want
    assert result["metrics"][want.pop()]["value"] > 0
    assert {"busy_s", "window_s"} <= set(result["device"])


def _broken(kind, fault):
    entry = harness.entry(TINY_TRAFFIC[kind]["entry"])
    solve = entry.SOLVE

    def broken(generator, a, b, nt, nr, cfg):
        if fault == "state unchanged":        # returns what it started from
            res = solve(generator, a, b, nt, nr, cfg)
            return res._replace(x=type(res.x)(torch.zeros_like(res.x.re),
                                              torch.zeros_like(res.x.im)))
        if fault == "half the batch":         # solves half, repeats it
            half = b.shape[0] // 2
            res = solve(generator, a, b[:half], nt, nr, cfg)
            x = type(res.x)(torch.cat([res.x.re, res.x.re]),
                            torch.cat([res.x.im, res.x.im]))
            return res._replace(x=x, iters=torch.cat([res.iters, res.iters]))
        res = solve(generator, a, b, nt, nr, cfg)     # an answer altered
        re = res.x.re.clone()
        re[..., 0] += 1e-3 * re.abs().max()
        return res._replace(x=type(res.x)(re, res.x.im))

    return entry, broken


@pytest.mark.parametrize("kind,fault", [
    ("batch", "state unchanged"), ("batch", "half the batch"),
    ("batch", "answer altered"), ("single", "state unchanged"),
    ("single", "answer altered")])
def test_faults_come_out_not_correct(kind, fault, monkeypatch):
    entry, broken = _broken(kind, fault)
    monkeypatch.setattr(entry, "SOLVE", broken)
    result, compared = run(kind)
    assert result["correct"] is False
    assert result["failed"] >= 1
    (value, limit), = compared.values()
    assert value > limit


def test_raising_solve_is_reported(monkeypatch):
    entry = harness.entry("batch")
    calls = []

    def raises(*args):                 # the warm call passes, then raises
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("device lost")
        return solve(*args)

    solve = entry.SOLVE

    monkeypatch.setattr(entry, "SOLVE", raises)
    result, _ = run("batch")
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] == 4
