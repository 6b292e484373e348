"""Joining a multi-process run, spawning ranks, and the scaling benchmark.

The reference scales by adding MATLAB parfor workers on one machine
(ref: Vs_M_par.m:145).  The port's processes join one
``torch.distributed`` world (:func:`initialize_multihost`), lay out a
(batch x rows) mesh over its ranks (:mod:`.mesh`), and solve their
blocks (:mod:`.sharded_pair`, :mod:`.sharded_admm`).  Nothing on a
machine tells a process of the others: the coordinator's address, the
world size and each process's rank are given.

:func:`spawn_ranks` starts such a world on one host (the tests, the
entry module's ``dryrun_multichip`` and ``chip_smoke.py`` use it), and
:func:`scaling_benchmark` measures recoveries per second at 1 .. N ranks
(efficiency = speedup / N).
"""

from __future__ import annotations

import dataclasses
import math
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..config import AdmmConfig
from .mesh import default_backend, make_mesh, problem_sharding
from .sharded_admm import solve_lowrank_sharded


def _join(coordinator: str, num_processes: int, process_id: int,
          backend: str) -> None:
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Join a multi-process run: ``init_process_group`` on
    ``tcp://coordinator`` (``host:port``) as rank ``process_id`` of
    ``num_processes``.  Does nothing for a single process.  ``backend``
    defaults to NCCL where CUDA is available, else gloo."""
    if num_processes is not None and num_processes > 1:
        if coordinator is None or process_id is None:
            raise ValueError("a multi-process run needs the coordinator's "
                             "address and this process's id")
        _join(coordinator, num_processes, process_id,
              backend or default_backend(
                  "cuda" if torch.cuda.is_available() else "cpu"))


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device, fn, args, out):
    """A spawned rank: bind its card, join the world, run
    ``fn(rank, world, *args)`` and put ``(rank, ok, value or traceback)``
    on ``out``."""
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        elif "OMP_NUM_THREADS" not in os.environ:
            # ranks on one host share its cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        coordinator = f"127.0.0.1:{port}"
        if world > 1:
            initialize_multihost(coordinator, world, rank, backend)
        else:
            _join(coordinator, 1, 0, backend)
        value = fn(rank, world, *args)
        out.put((rank, True, value))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, args=(), *, device="cpu",
                backend: Optional[str] = None, timeout: float = 600.0):
    """Run ``fn(rank, world, *args)`` in ``world`` processes (the
    ``spawn`` start method: a fork after CUDA is initialized fails),
    joined into one ``torch.distributed`` world on a free localhost port
    (:func:`initialize_multihost`; a world of one joins alone).  A rank
    on CUDA binds card ``rank % device_count``, so ranks may share a card
    (over gloo: NCCL refuses two ranks on one device); a rank on the CPU
    takes ``os.cpu_count() // world`` threads, or ``OMP_NUM_THREADS``
    where that is set.

    ``fn`` must be importable by name (a module-level function) and
    return something picklable.  Returns the ranks' values in rank order.
    Raises if a rank raises or dies, or if the ranks outlast ``timeout``
    seconds; every process is stopped before it returns.
    """
    backend = backend or default_backend(device)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(k, world, port, backend, str(device), fn,
                               tuple(args), out))
             for k in range(world)]
    for p in procs:
        p.start()
    values, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(values) < world and failure is None:
            try:
                rank, ok, value = out.get(timeout=0.5)
            except queue.Empty:
                dead = [k for k, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and k not in values]
                if dead:
                    failure = (f"rank {dead[0]} died with exit code "
                               f"{procs[dead[0]].exitcode}")
                elif time.monotonic() > deadline:
                    failure = (f"the ranks outlasted {timeout} s "
                               f"({len(values)} of {world} done)")
                continue
            if ok:
                values[rank] = value
            else:
                failure = f"rank {rank} raised:\n{value}"
    finally:
        for p in procs:
            p.join(timeout=5.0 if failure is None else 0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [values[k] for k in range(world)]


@dataclasses.dataclass
class ScalingPoint:
    devices: int
    recoveries_per_s: float
    speedup: float
    efficiency: float


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def scaling_benchmark(nt: int = 8, nr: int = 8, m: int = 256,
                      batch_per_device: int = 4, device_counts=None,
                      cfg: AdmmConfig = AdmmConfig(maxiter=100),
                      reps: int = 2, device="cuda"
                      ) -> Dict[int, ScalingPoint]:
    """Weak scaling of the sharded solver over the ranks of the world.

    For each device count d (default 1, 2 and the world's size), solve
    ``batch_per_device * d`` independent recoveries
    (:func:`.sharded_admm.solve_lowrank_sharded`) over a (d x 1) mesh of
    the first d ranks and report recoveries per second; efficiency is
    rate(d) / (d * rate(first d)).  The ranks are the devices: counts
    above the world's size are skipped and printed.  Every rank of the
    world calls this; each time ends in ``torch.cuda.synchronize()`` on
    the card, and a count's time is the slowest rank's.
    """
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world == 0:
        raise RuntimeError("scaling_benchmark needs an initialized "
                           "torch.distributed world")
    n = nt * nr
    if device_counts is None:
        device_counts = sorted({1, 2, world})
    skipped = [d for d in device_counts if d > world]
    if skipped and dist.get_rank() == 0:
        print(f"scaling_benchmark: skipped device counts {skipped}, above "
              f"the world's {world} ranks", flush=True)
    out: Dict[int, ScalingPoint] = {}
    base = None
    for d in device_counts:
        if d > world:
            continue
        mesh = make_mesh(batch=d, rows=1, device=device)
        batch = batch_per_device * d
        gen = torch.Generator().manual_seed(0)
        bits = torch.randint(0, 4, (batch, m, n), generator=gen)
        a = torch.exp(1j * bits * (math.pi / 2)).to(torch.complex64) \
            / math.sqrt(n)
        x_true = torch.randn((batch, n), generator=gen).to(torch.complex64)
        b = torch.abs(torch.einsum("umn,un->um", a, x_true))
        dt = torch.zeros(1, dtype=torch.float64, device=mesh.device)
        if mesh.member:
            a_l, b_l = (t.to(mesh.device)
                        for t in problem_sharding(mesh, a, b))
            solve_lowrank_sharded(mesh, a_l, b_l, nt, nr, cfg)    # warm-up
            _sync(mesh.device)
            t0 = time.perf_counter()
            for _ in range(reps):
                solve_lowrank_sharded(mesh, a_l, b_l, nt, nr, cfg)
            _sync(mesh.device)
            dt[0] = (time.perf_counter() - t0) / reps
        dist.all_reduce(dt, op=dist.ReduceOp.MAX)
        rate = batch / float(dt[0])
        if base is None:
            base = rate / d                      # per-device baseline rate
        speedup = rate / base
        out[d] = ScalingPoint(devices=d, recoveries_per_s=rate,
                              speedup=speedup, efficiency=speedup / d)
    return out
