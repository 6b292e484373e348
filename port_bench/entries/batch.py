"""Back-to-back batch recoveries through one codebook.

One caller, closed loop: each call of ``solve_lowrank_multi_pair_batch``
takes the next ``batch`` fresh channels' magnitudes, drawn in the window,
and the next call starts when it returns.  The window ends when the last
call that started inside ``seconds`` returns.

Reports ``recoveries_per_s`` (every recovery of the window over all of its
time) and, for the per-layer readers, the iters of each instance and K4's
launches of each call.
"""

from __future__ import annotations

import time
import traceback

from twoace_tpu_torch import Pair, solve_lowrank_multi_pair_batch
from twoace_tpu_torch.interop import admm_config_from_dict
from twoace_tpu_torch.ops.kernels import launch_counts

from .. import draw
from ..harness import Window, sync

#: the entry the window drives; the tests put a broken one in its place
SOLVE = solve_lowrank_multi_pair_batch


def _solve(cell, index: int, b):
    c = cell.config
    return SOLVE(draw.solver_generator(cell.seed, index), cell.pair, b,
                 c["nt"], c["nr"], cell.admm)


def prepare(cell):
    """One warm call at the cell's shapes: the seed's call -1, which the
    window never draws."""
    cell.admm = admm_config_from_dict(cell.config["admm_batch"])
    cell.pair = Pair(cell.codebook.re, cell.codebook.im)
    d = draw.channel_batch(cell.config, cell.traffic, cell.codebook,
                           cell.seed, -1, cell.traffic["batch"])
    _solve(cell, -1, d.b)
    sync(cell.device)


def window(cell, seconds: float, spans) -> Window:
    out = Window()
    k4, iters = [], []
    index = 0
    t0 = cell.tracer.start()
    while True:
        with spans.span("draw"):
            d = draw.channel_batch(cell.config, cell.traffic, cell.codebook,
                                   cell.seed, index, cell.traffic["batch"])
        before = launch_counts()["pair_matmul"]
        out.attempted += d.b.shape[0]
        try:
            with spans.span("solve"):
                res = _solve(cell, index, d.b)
                sync(cell.device)
        except Exception:                      # reported, the window ends
            out.failed += d.b.shape[0]
            out.error = traceback.format_exc()
            t1 = time.perf_counter_ns()
            break
        with spans.span("keep"):
            k4.append(launch_counts()["pair_matmul"] - before)
            out.keep(res.x.re, res.x.im, d.h)
            iters.append(res.iters)
        index += 1
        t1 = time.perf_counter_ns()
        if t1 - t0 >= seconds * 1e9:
            break
    cell.tracer.stop(t0, t1)
    out.window_s = (t1 - t0) / 1e9
    done = out.attempted - out.failed
    out.end_to_end["recoveries_per_s"] = done / out.window_s
    out.counters.update(
        recoveries=done, k4_launches=k4,
        iters=[[int(v) for v in it.cpu()] for it in iters])
    return out
