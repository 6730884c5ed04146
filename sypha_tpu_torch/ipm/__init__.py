"""Single-LP and batched drivers, the per-lane dense Mehrotra IPM, the
shared-matrix batched Mehrotra IPM and B&B node batches."""

from sypha_tpu_torch.ipm.dense import initial_point, mehrotra_solve
from sypha_tpu_torch.ipm.driver import IpmResult, solve_lp, solve_lp_batch

__all__ = ["IpmResult", "initial_point", "mehrotra_solve", "solve_lp", "solve_lp_batch"]
