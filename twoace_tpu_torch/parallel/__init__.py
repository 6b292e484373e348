"""The multi-process path on ``torch.distributed`` (port of
``twoace_tpu.parallel``): a (batch x rows) mesh of ranks (:mod:`.mesh`),
the row- and batch-sharded A2 pair solvers (:mod:`.sharded_pair`), their
complex twin (:mod:`.sharded_admm`), and joining, spawning and the
scaling benchmark (:mod:`.distributed`)."""

from .mesh import (  # noqa: F401
    BATCH_AXIS,
    ROWS_AXIS,
    Mesh,
    RowReduce,
    batch_sharding,
    make_mesh,
    problem_sharding,
)
from .sharded_admm import solve_lowrank_sharded  # noqa: F401
from .sharded_pair import (  # noqa: F401
    solve_lowrank_multi_sharded_pair,
    solve_lowrank_sharded_pair,
)
from .distributed import (  # noqa: F401
    ScalingPoint,
    initialize_multihost,
    scaling_benchmark,
    spawn_ranks,
)
