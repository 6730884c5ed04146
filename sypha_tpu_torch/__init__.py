"""sypha_tpu_torch: the PyTorch / CUDA port of sypha_tpu.

The LP and MILP paths of the JAX package (sypha_tpu), on PyTorch: read an
SCP instance, pad its standard form (dense or padded ELL), solve stacked
LPs with the per-lane Mehrotra IPM and many LP lanes that share one
constraint matrix (or one per instance group, ``stack_shared_batches``) with
the shared-matrix one, and run
branch and bound with presolve, heuristics, cuts and the exact-cover
closure over batched node windows.  The user entry points are those of the
JAX package: ``solve_lp``/``solve_lp_batch``, the OR-Tools-style ``Solver``
and the CLI (``python -m sypha_tpu_torch``); ``parallel`` lane-shards solves
and node windows over a device mesh, runs the IPM tensor-parallel over a
``torch.distributed`` process group, and pools B&B bounds across processes.  Every entry point runs on the
CUDA card unless the caller passes ``device="cpu"`` (``--device cpu``);
without a card it raises rather than fall back.  The f32 normal matrix of every IPM
iteration comes from a hand-written Hopper kernel (ops.gram, csrc/gram.cu);
the rest of the device work is plain PyTorch, the host work numpy and the
C++ engine of csrc/sypha_host.cpp.  Nothing here imports JAX, and importing
the package has no side effects: the kernel and the host library are built
at first use.
"""

from sypha_tpu_torch.api import ResultStatus, Solver, SolverParameters
from sypha_tpu_torch.config import IpmOptions, SolverConfig
from sypha_tpu_torch.core.problem import PaddedLp, ScpModel
from sypha_tpu_torch.core.status import IpmStatus, MilpStatus
from sypha_tpu_torch.io.scp_reader import parse_scp_text, read_scp_file
from sypha_tpu_torch.io.standard_form import pad_lp, scp_standard_form, stack_lps
from sypha_tpu_torch.ipm.dense import initial_point, mehrotra_solve
from sypha_tpu_torch.ipm.driver import IpmResult, solve_lp, solve_lp_batch
from sypha_tpu_torch.ipm.node_batch import solve_node_batch
from sypha_tpu_torch.ipm.shared import (
    IpmState,
    SharedLpBatch,
    fix_columns,
    make_shared_batch,
    make_shared_batch_auto,
    make_shared_batch_sparse,
    mehrotra_solve_shared,
    stack_shared_batches,
)
from sypha_tpu_torch.milp import MilpResult, branch_and_bound
from sypha_tpu_torch.ops.ell import EllMatrix
from sypha_tpu_torch.parallel import (
    BoundPool,
    initialize_distributed,
    make_mesh,
    pooled_stats,
    shard_batch,
    shard_shared_batch,
    solve_lp_batch_sharded,
    solve_shared_batch_sharded,
    solve_shared_batch_tensor_parallel,
)

__all__ = [
    "Solver",
    "SolverParameters",
    "ResultStatus",
    "IpmOptions",
    "SolverConfig",
    "PaddedLp",
    "ScpModel",
    "IpmStatus",
    "MilpStatus",
    "parse_scp_text",
    "read_scp_file",
    "pad_lp",
    "scp_standard_form",
    "stack_lps",
    "IpmResult",
    "initial_point",
    "mehrotra_solve",
    "solve_lp",
    "solve_lp_batch",
    "solve_node_batch",
    "IpmState",
    "SharedLpBatch",
    "fix_columns",
    "make_shared_batch",
    "make_shared_batch_auto",
    "make_shared_batch_sparse",
    "mehrotra_solve_shared",
    "stack_shared_batches",
    "MilpResult",
    "branch_and_bound",
    "EllMatrix",
    "BoundPool",
    "initialize_distributed",
    "make_mesh",
    "pooled_stats",
    "shard_batch",
    "shard_shared_batch",
    "solve_lp_batch_sharded",
    "solve_shared_batch_sharded",
    "solve_shared_batch_tensor_parallel",
]
