"""K5's inputs and two host-side timers, shared by ``chip_smoke.py`` phase
2 and ``scripts/torch_batch_ab.py``'s ``k5`` and ``k6`` cells.

Imports torch and nothing of the port, so an A/B worker running in
another checkout (whose own ``chip_smoke.py`` may predate this module)
uses this copy.  Not a command: nothing runs it on its own.
"""

from __future__ import annotations

import time

import torch

#: the calls ``host_us`` times
HOST_CALLS = 2000


def k5_inputs(m, r, dtype, seed=5):
    """K5's inputs of phase 2's kind at (m, r): ax and M normal, b in
    [0.5, 1.5) with 9 padded (b = 0) rows, row 3 all zero, mu 0.41."""
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ax, md = (torch.randn(m, r, dtype=dtype, generator=gen, device="cuda")
              for _ in range(2))
    b = torch.rand(m, dtype=rdt, generator=gen, device="cuda") + 0.5
    b[m - 9:] = 0.0
    ax[3] = 0.0
    md[3] = 0.0
    return ax, b, md, torch.tensor(0.41, dtype=rdt, device="cuda")


def host_us(fn, calls=HOST_CALLS):
    """The host's cost of a call of ``fn``: ``calls`` calls back to back
    (no sync between them), timed by CUDA events and by the host clock;
    returns both in microseconds a call.  Where the device runs each call
    in less time than the host takes to issue it, the two agree."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    stop.record()
    torch.cuda.synchronize()
    return dict(events_us=start.elapsed_time(stop) * 1e3 / calls,
                clock_us=(t1 - t0) * 1e6 / calls)


def launch_floor_ms(device_ms):
    """The device ms of a one-element elementwise op as ``device_ms`` (the
    profiler's reader) gives it: a floor for reading a kernel whose work
    is far below one launch."""
    x = torch.ones(1, device="cuda")
    return device_ms(lambda: x * 2.0)
