"""Multi-device and multi-process execution: lane-sharded solves over a
device mesh, tensor parallelism over a process group, and the B&B's bound
pool across processes."""

from sypha_tpu_torch.parallel.distributed import (
    BoundPool,
    PooledBounds,
    initialize_distributed,
    run_spmd,
)
from sypha_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    pooled_stats,
    shard_batch,
    shard_shared_batch,
    solve_lp_batch_sharded,
    solve_node_batch_sharded,
    solve_shared_batch_sharded,
    solve_shared_batch_tensor_parallel,
)

__all__ = [
    "BoundPool",
    "PooledBounds",
    "initialize_distributed",
    "run_spmd",
    "Mesh",
    "make_mesh",
    "pooled_stats",
    "shard_batch",
    "shard_shared_batch",
    "solve_lp_batch_sharded",
    "solve_node_batch_sharded",
    "solve_shared_batch_sharded",
    "solve_shared_batch_tensor_parallel",
]
