"""The (batch x rows) process mesh on ``torch.distributed``.

The reference's only parallelism is a MATLAB ``parfor`` pool over
Monte-Carlo channel instances (ref: Numerical_Simulation/main_programs/
Vs_M_par.m:145).  The port lays the processes of a
``torch.distributed`` world on a 2-D mesh, as the JAX package lays its
devices:

- the ``batch`` axis holds independent problem instances (data
  parallelism, the parfor replacement) and needs no collective;
- the ``rows`` axis shards the measurement rows of each solve; the
  A^H (...) sums and the residual norms become all-reduces over the
  ranks that share a batch index (:class:`RowReduce`).

Rank ``k`` of the mesh sits at (k // rows, k % rows).  A mesh smaller
than the world leaves the last ranks out (``Mesh.member`` False): they
take part in building the groups and nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

BATCH_AXIS = "batch"
ROWS_AXIS = "rows"


@dataclasses.dataclass
class Mesh:
    """This rank's place on a (batch x rows) mesh."""

    batch: int
    rows: int
    #: this rank's (batch, rows) coordinates; None outside the mesh
    coords: Optional[Tuple[int, int]]
    #: the ranks that share this rank's batch index (the rows axis); the
    #: batch axis makes no collective, so it has no group
    rows_group: object
    device: torch.device
    #: the row-reduction hook of this rank's solves (None outside the
    #: mesh); its counters add up over the solves
    reduce: Optional["RowReduce"] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.batch, self.rows)

    @property
    def member(self) -> bool:
        return self.coords is not None


class RowReduce:
    """All-reduces over the rows group, counted: the hook of the row-
    sharded loops (``ops/admm_loop.py``, ``ops/admm.py``).

    ``calls`` counts the all-reduces made, ``trips`` the loop trips run
    with the hook (the loops add to it); set both to 0 to count afresh."""

    def __init__(self, group):
        self.group = group
        self.calls = 0
        self.trips = 0

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the rows group, in place; returns ``t``."""
        dist.all_reduce(t, group=self.group)
        self.calls += 1
        return t

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """Max of ``t`` over the rows group, in place; returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        self.calls += 1
        return t


def default_backend(device) -> str:
    """NCCL on CUDA, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda') needs a CUDA "
                               "device; pass device='cpu' for the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(batch: Optional[int] = None, rows: int = 1,
              device="cuda", backend: Optional[str] = None) -> Mesh:
    """A (batch x rows) mesh over the ranks of the initialized world.

    ``batch=None`` takes every rank the rows axis leaves.  A mesh of
    fewer ranks than the world holds ranks 0 .. batch*rows - 1.  Every
    rank of the world must call this, in the same order, since it builds
    the rows groups (``dist.new_group``) with ``backend`` (default: the
    world's).  ``device``: where this rank's tensors live (``"cuda"``:
    the current CUDA device).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "world (initialize_multihost or "
                           "init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if batch is None:
        if world % rows != 0:
            raise ValueError(f"{world} ranks not divisible by rows={rows}")
        batch = world // rows
    if batch < 1 or rows < 1 or batch * rows > world:
        raise ValueError(f"a ({batch} x {rows}) mesh does not fit a world "
                         f"of {world} ranks")
    backend = backend or dist.get_backend()
    rows_group = None
    for b in range(batch):
        g = dist.new_group([b * rows + k for k in range(rows)],
                           backend=backend)
        if rank // rows == b:
            rows_group = g
    coords = (rank // rows, rank % rows) if rank < batch * rows else None
    return Mesh(batch=batch, rows=rows, coords=coords,
                rows_group=rows_group, device=_device(device),
                reduce=RowReduce(rows_group) if coords else None)


def _block(size: int, parts: int, index: int, what: str) -> slice:
    if size % parts != 0:
        raise ValueError(f"{what} {size} is not divisible by the mesh's "
                         f"{parts}")
    step = size // parts
    return slice(index * step, (index + 1) * step)


def _cut(x, *slices):
    if isinstance(x, tuple):                         # a Pair
        return type(x)(*(t[slices] for t in x))
    return x[slices]


def batch_sharding(mesh: Mesh, x):
    """This rank's contiguous block of a global (B, ...) tensor or Pair,
    as ``P(BATCH)`` places it; raises when B % batch != 0."""
    if not mesh.member:
        raise ValueError("this rank lies outside the mesh")
    lead = (x[0] if isinstance(x, tuple) else x).shape[0]
    return _cut(x, _block(lead, mesh.batch, mesh.coords[0], "batch size"))


def problem_sharding(mesh: Mesh, a, b):
    """This rank's blocks of a global problem, as ``P(BATCH, ROWS, None)``
    and ``P(BATCH, ROWS)`` place them: ``a`` (B, m, n) (a tensor or a
    Pair) and ``b`` (B, m) cut to (B/batch, m/rows, n) and
    (B/batch, m/rows).  Raises when B % batch or m % rows is not 0."""
    if not mesh.member:
        raise ValueError("this rank lies outside the mesh")
    shape = (a[0] if isinstance(a, tuple) else a).shape
    bs = _block(shape[0], mesh.batch, mesh.coords[0], "batch size")
    rs = _block(shape[1], mesh.rows, mesh.coords[1], "row count m")
    return _cut(a, bs, rs), _cut(b, bs, rs)
