"""BENCHMARK.json against the benchmark's contract, and every
configuration, traffic mix, entry and metric found by name."""

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level(spec):
    assert set(spec) == KEYS
    assert spec["command"] == ["python3", "port_bench/run.py"]
    assert spec["paths"] == ["port_bench"]
    assert 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    rs = spec["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units(spec):
    names = [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics]
    for n in names + [w["traffic"] for w in spec["workloads"]]:
        assert NAME.match(n), n
    assert len(set(c["name"] for c in spec["configs"])) == len(spec["configs"])
    assert len(set(w["name"] for w in spec["workloads"])) == len(
        spec["workloads"])
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_entries_have_only_their_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert not c["reduced"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_enough(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in spec["workloads"]:
        mine = [m for m in spec["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        layer = [m for m in spec["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
        for m in layer:        # what it moves, this cell reports
            assert m["moves"] in [e["name"] for e in mine]


@pytest.mark.parametrize("kind", ["configs", "workloads", "per_layer"])
def test_found_by_name(spec, kind):
    from port_bench import harness

    for item in spec[kind]:
        if kind == "configs":
            config = json.loads((ROOT / item["file"]).read_text())
            assert config["name"] == item["name"]
            assert config["source"] == item["source"]
            assert config["limits"]["nmse_db_worst"] < 0
        elif kind == "workloads":
            _, config, traffic, e2e, per_layer = harness.resolve(
                spec, item["name"])
            assert harness.entry(traffic["entry"]).SOLVE
        else:
            assert callable(harness.reader(item["name"]))


def test_files_named_from_name_characters():
    for p in (ROOT / "port_bench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel
