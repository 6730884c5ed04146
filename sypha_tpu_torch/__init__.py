"""sypha_tpu_torch: the PyTorch / CUDA port of sypha_tpu.

The batched LP relaxation path of the JAX package (sypha_tpu), on PyTorch:
read an SCP instance, pad its standard form, and solve many LP lanes that
share one constraint matrix with the Mehrotra IPM, the B&B node window
included.  The f32 normal matrix of every IPM iteration comes from a
hand-written Hopper kernel (ops.gram, csrc/gram.cu); the rest is plain
PyTorch.  Nothing here imports JAX, and importing the package has no side
effects: kernels are built at first use.
"""

from sypha_tpu_torch.config import IpmOptions, SolverConfig
from sypha_tpu_torch.core.problem import PaddedLp, ScpModel
from sypha_tpu_torch.core.status import IpmStatus, MilpStatus
from sypha_tpu_torch.io.scp_reader import parse_scp_text, read_scp_file
from sypha_tpu_torch.io.standard_form import pad_lp, scp_standard_form, stack_lps
from sypha_tpu_torch.ipm.node_batch import solve_node_batch
from sypha_tpu_torch.ipm.shared import (
    IpmState,
    SharedLpBatch,
    fix_columns,
    make_shared_batch,
    mehrotra_solve_shared,
)

__all__ = [
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
    "solve_node_batch",
    "IpmState",
    "SharedLpBatch",
    "fix_columns",
    "make_shared_batch",
    "mehrotra_solve_shared",
]
