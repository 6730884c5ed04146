"""Batched B&B node LP solves on the shared-matrix IPM.

The port of sypha_tpu/ipm/node_batch.py.  The padded base LP lives on the
device once and branch decisions are column fixings: fixing x_j = 0 masks
column j out of every A-product; fixing x_j = 1 substitutes it into the rhs
(b -= A_j) and the objective offset.  A whole frontier window solves as ONE
shared-matrix batched IPM call with no per-node model builds.
"""

from __future__ import annotations

import torch

from sypha_tpu_torch.config import IpmOptions
from sypha_tpu_torch.core.problem import PaddedLp
from sypha_tpu_torch.ipm.shared import (
    IpmState,
    fix_columns,
    make_shared_batch,
    mehrotra_solve_shared,
)
from sypha_tpu_torch.utils.telemetry import span


def solve_node_batch(
    base: PaddedLp,
    fix0,  # [B, n_pad] 1.0 where a column is fixed to 0 (or masked)
    fix1,  # [B, n_pad] 1.0 where a column is fixed to 1
    opts: IpmOptions,
    warm=None,  # optional (x0, y0, s0) [B, ...] parent iterates
    resume: IpmState | None = None,  # optional state of a previous chunked solve
    iter_limit=None,  # optional iteration cap (chunked solves)
):
    """Solve one batch of B&B node LPs sharing the base matrix.

    Returns (state, x_full, pobj, dobj): ``x_full`` restores fixed-to-1
    columns to 1.0 and zeroes masked columns, so the caller sees each node's
    solution in the original variable space; pobj/dobj include the
    objective offset of the fixed-to-1 substitutions.

    ``warm`` warm-starts each lane from its parent's iterate shifted back to
    the interior.  ``resume``/``iter_limit`` run a window solve in chunks,
    with a wall-clock check between them.  A call is the span
    ``ipm.node_batch``.
    """
    with span("ipm.node_batch"):
        batch = make_shared_batch(base, fix0.shape[0])
        batch = fix_columns(batch, fix0, fix1)
        if resume is not None:
            st = mehrotra_solve_shared(batch, opts, state0=resume, iter_limit=iter_limit)
        elif warm is not None:
            xw, yw, sw = warm
            eps = 1e-3
            dt = batch.c.dtype
            x0 = torch.clamp(xw.to(dt), min=eps)
            s0 = torch.clamp(sw.to(dt), min=eps)
            st = mehrotra_solve_shared(
                batch, opts, x0, yw.to(dt), s0, iter_limit=iter_limit
            )
        else:
            st = mehrotra_solve_shared(batch, opts, iter_limit=iter_limit)
        x_masked = st.x * batch.col_mask
        x_full = x_masked + torch.as_tensor(fix1, dtype=st.x.dtype, device=st.x.device)
        pobj = torch.sum(batch.c * x_masked, dim=-1) + batch.obj_offset
        dobj = torch.sum(batch.b * st.y, dim=-1) + batch.obj_offset
        return st, x_full, pobj, dobj
