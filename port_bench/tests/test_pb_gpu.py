"""A short run of each cell on the card, through the benchmark's command:
the last line holds the cell's metrics and ``correct``."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_runs(spec, trace, cuda):
    for w in spec["workloads"]:
        proc = subprocess.run(
            [sys.executable, "port_bench/run.py", "--workload", w["name"],
             "--seed", str(2**31 + 77), "--seconds", "3", "--trace",
             str(trace)], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["correct"] is True
        kind = "per_layer" if trace else "end_to_end"
        want = {m["name"] for m in spec[kind]
                if w["name"] in m.get("workloads", [w["name"]])}
        assert set(line["metrics"]) == want
        assert line["device"]["platform"] == "gpu"
        if trace:
            assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
