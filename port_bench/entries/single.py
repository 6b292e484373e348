"""Back-to-back cold single recoveries through one codebook.

One caller, closed loop: each ``solve_lowrank_multi_pair`` call takes one
fresh channel's magnitudes, drawn in the window before the call, and its
time runs from the call to the ``torch.cuda.synchronize()`` after it.
The window ends when the last solve that started inside ``seconds``
returns.

Reports ``solve_ms_p50`` and ``solve_ms_p95`` over every solve of the
window and, for the per-layer readers, the iters of each solve and K3's
launches.
"""

from __future__ import annotations

import statistics
import time
import traceback

from twoace_tpu_torch import Pair, solve_lowrank_multi_pair
from twoace_tpu_torch.interop import admm_config_from_dict
from twoace_tpu_torch.ops.kernels import launch_counts

from .. import draw
from ..harness import Window, sync

#: the entry the window drives; the tests put a broken one in its place
SOLVE = solve_lowrank_multi_pair


def _solve(cell, index: int, b):
    c = cell.config
    return SOLVE(draw.solver_generator(cell.seed, index), cell.pair, b,
                 c["nt"], c["nr"], cell.admm)


def prepare(cell):
    """Warm solves at the cell's shapes: the seed's calls -1 and -2, which
    the window never draws."""
    cell.admm = admm_config_from_dict(cell.config["admm_single"])
    cell.pair = Pair(cell.codebook.re, cell.codebook.im)
    for index in (-1, -2):
        d = draw.channel_batch(cell.config, cell.traffic, cell.codebook,
                               cell.seed, index, 1)
        _solve(cell, index, d.b[0])
        sync(cell.device)


def window(cell, seconds: float, spans) -> Window:
    out = Window()
    ms, iters = [], []
    before = launch_counts()["fused_infer_admm"]
    index = 0
    t0 = cell.tracer.start()
    while True:
        with spans.span("draw"):
            d = draw.channel_batch(cell.config, cell.traffic, cell.codebook,
                                   cell.seed, index, 1)
        out.attempted += 1
        try:
            with spans.span("solve"):
                s0 = time.perf_counter_ns()
                res = _solve(cell, index, d.b[0])
                sync(cell.device)
                s1 = time.perf_counter_ns()
        except Exception:                      # reported, the window ends
            out.failed += 1
            out.error = traceback.format_exc()
            t1 = time.perf_counter_ns()
            break
        with spans.span("keep"):
            ms.append((s1 - s0) / 1e6)
            out.keep(res.x.re[None], res.x.im[None], d.h)
            iters.append(res.iters)
        index += 1
        t1 = time.perf_counter_ns()
        if t1 - t0 >= seconds * 1e9:
            break
    cell.tracer.stop(t0, t1)
    out.window_s = (t1 - t0) / 1e9
    if ms:
        p95 = (statistics.quantiles(ms, n=100, method="inclusive")[94]
               if len(ms) > 1 else ms[0])
        out.end_to_end.update(solve_ms_p50=statistics.median(ms),
                              solve_ms_p95=p95)
    out.counters.update(
        solves=len(ms),
        k3_launches=launch_counts()["fused_infer_admm"] - before,
        iters=[int(it) for it in iters])
    return out
