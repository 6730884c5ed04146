"""Single-LP and batched drivers, the shared-matrix batched Mehrotra IPM and
B&B node batches."""

from sypha_tpu_torch.ipm.driver import IpmResult, solve_lp, solve_lp_batch

__all__ = ["IpmResult", "solve_lp", "solve_lp_batch"]
