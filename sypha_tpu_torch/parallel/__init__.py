"""Coordination of the B&B across processes (one process in the port so far)."""

from sypha_tpu_torch.parallel.distributed import BoundPool, PooledBounds

__all__ = ["BoundPool", "PooledBounds"]
