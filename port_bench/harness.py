"""One run of one cell: find its files by name, set up, measure, judge,
and build the result line.

Everything a cell needs is data found by name in ``BENCHMARK.json``:
``configs/<config>.json`` (the deployment: array, codebook, solver
settings, precision, the comparison's limits), ``traffic/<traffic>.json``
(the mix: which entry drives the window, batch size, channel draws),
``entries/<entry>.py`` (the loop around one public entry point of the
program) and ``metrics/<name>.py`` (one reader a per-layer metric).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from . import draw, reference, trace as tr

BENCH = Path(__file__).resolve().parent
#: top-level modules no run may load: JAX and the JAX package, and the
#: repository's JAX scripts
FORBIDDEN = ("jax", "jaxlib", "flax", "twoace_tpu", "bench", "chip_smoke")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


class Window:
    """What an entry's window produced: counts, the end-to-end numbers it
    measured, counters for the per-layer readers, and the recoveries
    kept for the comparison beside the channels they came from."""

    def __init__(self):
        self.attempted = 0
        self.failed = 0
        self.error: Optional[str] = None
        self.window_s = 0.0
        self.end_to_end = {}
        self.counters = {}
        self._x = []
        self._h = []

    def keep(self, re, im, h):
        self._x.append((re, im))
        self._h.append(h)

    def recoveries(self):
        """(x, h): every kept recovery and its channel, (K, n) complex."""
        if not self._x:
            return None, None
        x = torch.cat([torch.complex(re.double(), im.double())
                       for re, im in self._x])
        return x, torch.cat(self._h)


class Cell:
    """A cell's inputs and the program state its entry sets up."""

    def __init__(self, config, traffic, seed, device, trace):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.tracer = tr.Tracer(trace and device.type == "cuda")
        self.codebook = None


class Run:
    """What a per-layer reader sees: the cell's data, the window's
    counters and its device trace (None untraced)."""

    def __init__(self, cell: Cell, window: Window):
        self.config, self.traffic = cell.config, cell.traffic
        self.counters = window.counters
        self.trace = cell.tracer.result


# ---------------------------------------------------------------------------
# finding things by name

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec_path() -> Path:
    return BENCH.parent / "BENCHMARK.json"


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec: dict, cell: str):
    """(workload, config, traffic, end_to_end, per_layer) of ``cell``."""
    found = [w for w in spec["workloads"] if w["name"] == cell]
    if not found:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in spec['workloads']]}")
    wl = found[0]
    (conf,) = [c for c in spec["configs"] if c["name"] == wl["config"]]
    config = load_json(BENCH.parent / conf["file"])
    traffic = load_json(BENCH / "traffic" / f"{wl['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if applies(m, cell)]
    per_layer = [m for m in spec["per_layer"] if applies(m, cell)]
    return wl, config, traffic, e2e, per_layer


def entry(name: str):
    """The entry module ``entries/<name>.py``."""
    return importlib.import_module(f"{__package__}.entries.{name}")


def reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is in FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the run

def judge(window: Window, config: dict) -> dict:
    """The comparison: each recovery's NMSE against the channel it was
    measured from (:func:`.reference.nmse_db`), worst first.  Counts the
    recoveries over the limit, or not finite, into ``window.failed``.
    Returns ``{name: (value, limit)}``."""
    limit = config["limits"]["nmse_db_worst"]
    x, h = window.recoveries()
    if x is None:
        return {"nmse_db_worst": (math.inf, limit)}
    db = reference.nmse_db(x, h)
    bad = ~torch.isfinite(db) | (db > limit)
    window.failed += int(bad.sum())
    worst = float(db.max()) if bool(torch.isfinite(db).all()) else math.inf
    return {"nmse_db_worst": (worst, limit)}


def device_block(device: torch.device, trace_on: bool, cell: Cell,
                 window: Window, peak: int) -> dict:
    if device.type == "cuda":
        out = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                   count=1, memory_peak_bytes=peak)
    else:
        out = dict(platform="cpu", kind="cpu", count=0, memory_peak_bytes=0)
    if trace_on:
        t = cell.tracer.result
        out.update(busy_s=tr.busy_seconds(t.events) if t else 0.0,
                   window_s=tr.window_seconds(t) if t else window.window_s)
    return out


def run_cell(config: dict, traffic: dict, end_to_end: list, per_layer: list,
             seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float):
    """One run; returns ``(result, compared)`` where ``result`` is the
    last line's object without ``compared``, and ``compared`` is
    ``{name: (value, limit)}``."""
    cell = Cell(config, traffic, seed, device, trace)
    mod = entry(traffic["entry"])
    cell.codebook = draw.codebook(config, seed, device)
    mod.prepare(cell)
    sync(device)
    setup_s = time.perf_counter() - t_start
    spans = tr.Spans()
    window = mod.window(cell, seconds, spans)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    cell.pair = cell.admm = None                 # the program's state
    compared = judge(window, config)

    metrics = {}
    if trace:
        run = Run(cell, window)
        for m in per_layer:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        numbers = dict(window.end_to_end, setup_s=setup_s)
        for m in end_to_end:
            if m["name"] not in numbers:
                raise RuntimeError(f"the window measured no {m['name']}"
                                   + (f":\n{window.error}" if window.error
                                      else ""))
            metrics[m["name"]] = {"value": numbers[m["name"]],
                                  "unit": m["unit"]}
    result = {
        "correct": (window.failed == 0 and window.attempted > 0
                    and window.error is None),
        "attempted": window.attempted, "failed": window.failed,
        "metrics": metrics,
        "device": device_block(device, trace, cell, window, peak)}
    t = cell.tracer.result
    if t is not None:
        result["breakdown"] = {"device_ops": tr.top_ops(t),
                               "idle_gaps": tr.idle_gaps(t, spans)}
    if window.error:
        print(window.error, file=sys.stderr)
    return result, compared


def result_line(result: dict, compared: dict) -> str:
    """The last line: the result with the compared numbers last."""
    out = dict(result)
    out["compared"] = {k: {"value": v if math.isfinite(v) else None,
                           "limit": lim}
                       for k, (v, lim) in compared.items()}
    return json.dumps(out)


def compared_lines(compared: dict) -> str:
    return "\n".join(f"{k} {v!r} limit {lim!r}"
                     for k, (v, lim) in compared.items())
