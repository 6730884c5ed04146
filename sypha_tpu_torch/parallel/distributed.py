"""Bound pooling of the B&B across processes: the port of
sypha_tpu/parallel/distributed.py, for one process.

Across processes the B&B shares only an incumbent objective, a proven dual
bound and a stop flag (the JAX package publishes them in the
jax.distributed key-value store).  The port runs one process so far: the
pool's process count is the ``torch.distributed`` world size when a process
group is initialised, else 1, and more than one process raises
NotImplementedError.  ``sync`` and ``finalize`` keep the single-process
semantics of the JAX package (they return the caller's own values), so the
B&B driver calls them unconditionally.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class PooledBounds:
    incumbent: float
    dual_bound: float
    stop: bool
    # every process has announced departure (finished its own search)
    all_departed: bool = False
    # 0/1 column-selection bits of the process owning the pooled incumbent
    # (None when that process did not publish a solution)
    incumbent_solution: np.ndarray | None = None


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class BoundPool:
    """Scalar bound pooling across processes; one process only for now."""

    def __init__(self):
        self.n_processes = _world_size()
        if self.n_processes > 1:
            raise NotImplementedError(
                f"the bound pool runs in one process; this process group has "
                f"{self.n_processes} (multi-process B&B is not ported yet)"
            )

    def sync(
        self,
        incumbent: float,
        dual_bound: float,
        stop: bool,
        departed: bool = False,
        wait: bool = False,
        wait_timeout_sec: float = 600.0,
        solution=None,
    ) -> PooledBounds:
        """Publish our scalars and fold the peers' latest: with one process,
        our own values."""
        return PooledBounds(float(incumbent), float(dual_bound), bool(stop), departed)

    def finalize(
        self,
        incumbent: float,
        dual_bound: float,
        stop_peers: bool,
        poll_sec: float = 0.2,
        drain_timeout_sec: float | None = None,
        solution=None,
    ) -> PooledBounds:
        """Announce departure and wait for every process to depart: with one
        process, returns at once with our final values."""
        return self.sync(incumbent, dual_bound, stop_peers, departed=True, solution=solution)
