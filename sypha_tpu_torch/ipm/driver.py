"""Solve drivers: one padded LP, or a stacked batch of them.

The port of sypha_tpu/ipm/driver.py on the port's one IPM engine,
``mehrotra_solve_shared``: the JAX package's dense single-LP IPM
(``ipm/dense.mehrotra_solve``) is not ported as a second engine.  A single
LP is a one-lane shared batch, so on the card every solve forms its normal
matrix with the Gram kernel.  A stacked batch (``io.standard_form.stack_lps``,
where lanes may carry different ``A``) is split into groups of lanes with
equal ``A`` and ``row_pad``, and each group is one shared-matrix call.

Results come back to the host in one packed device-to-host copy per group
(the per-lane scalars, the iterates, ``c`` and ``b``), where the JAX
package fetched each field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from sypha_tpu_torch.config import IpmOptions
from sypha_tpu_torch.core.problem import PaddedLp
from sypha_tpu_torch.core.status import IpmStatus
from sypha_tpu_torch.ipm.shared import (
    IpmState,
    SharedLpBatch,
    make_shared_batch,
    mehrotra_solve_shared,
)


@dataclass
class IpmResult:
    """Host-side result mirror of the reference SolverExecutionResult
    (src/sypha_solver_sparse.h:22-47)."""

    status: IpmStatus
    primal_objective: float
    dual_objective: float
    iterations: int
    mu: float
    gap: float
    res_primal: float
    res_dual: float
    x: np.ndarray  # primal values over real columns (incl. surplus cols)
    y: np.ndarray  # duals over real rows

    @property
    def converged(self) -> bool:
        return self.status == IpmStatus.CONVERGED


_SCALARS = ("status", "iterations", "mu", "gap", "res_p", "res_d")


def _results(batch: SharedLpBatch, st: IpmState, n_real, m_real) -> List[IpmResult]:
    """Per-lane IpmResults of one shared call from ONE device-to-host copy:
    the lane scalars, n_real/m_real, x, y, c and b packed into one f64
    [B, k] tensor (int32 values are exact in f64) and split on the host."""
    B = st.x.shape[0]
    f64 = torch.float64
    scalars = [getattr(st, k).to(f64) for k in _SCALARS]
    dims = [torch.as_tensor(v, device=st.x.device).to(f64).expand(B) for v in (n_real, m_real)]
    packed = torch.cat(
        [torch.stack(scalars + dims, dim=1), st.x, st.y, batch.c, batch.b], dim=1
    ).cpu().numpy()
    k = len(_SCALARS) + 2
    n, m = st.x.shape[1], st.y.shape[1]
    out = []
    for row in packed:
        x = row[k : k + n]
        y = row[k + n : k + n + m]
        c = row[k + n + m : k + 2 * n + m]
        b = row[k + 2 * n + m :]
        status, iters, mu, gap, res_p, res_d, nr, mr = row[:k]
        nr, mr = int(nr), int(mr)
        out.append(
            IpmResult(
                status=IpmStatus(int(status)),
                primal_objective=float(c[:nr] @ x[:nr]),
                dual_objective=float(b[:mr] @ y[:mr]),
                iterations=int(iters),
                mu=float(mu),
                gap=float(gap),
                res_primal=float(res_p),
                res_dual=float(res_d),
                x=x[:nr].copy(),
                y=y[:mr].copy(),
            )
        )
    return out


def solve_lp(lp: PaddedLp, opts: Optional[IpmOptions] = None) -> IpmResult:
    """Solve one padded LP (dense or ELL ``A``, on the device it lives on);
    returns a host-side IpmResult."""
    opts = opts or IpmOptions()
    batch = make_shared_batch(lp, 1)
    st = mehrotra_solve_shared(batch, opts)
    return _results(batch, st, lp.n_real, lp.m_real)[0]


def _groups(lp: PaddedLp) -> List[List[int]]:
    """Lanes of a stacked dense PaddedLp grouped by equal (A, row_pad), in
    order of first appearance; one pass of ``torch.equal`` against each
    group's first lane."""
    groups: List[List[int]] = []
    for i in range(lp.A.shape[0]):
        for g in groups:
            r = g[0]
            if torch.equal(lp.A[r], lp.A[i]) and torch.equal(lp.row_pad[r], lp.row_pad[i]):
                g.append(i)
                break
        else:
            groups.append([i])
    return groups


def _group_batch(lp: PaddedLp, idx: torch.Tensor, first: int) -> SharedLpBatch:
    n = lp.n_pad
    col = torch.arange(n, device=lp.c.device)
    mask = (col[None, :] < lp.n_real[idx][:, None]).to(lp.c.dtype)
    return SharedLpBatch(
        A=lp.A[first],
        b=lp.b[idx],
        c=lp.c[idx],
        col_mask=mask,
        row_pad=lp.row_pad[first],
        obj_offset=torch.zeros((len(idx),), dtype=lp.c.dtype, device=lp.c.device),
    )


def solve_lp_batch(
    lp: PaddedLp,
    opts: Optional[IpmOptions] = None,
    warm_start: Optional[tuple] = None,
    as_results: bool = True,
):
    """Solve a stacked batch of padded LPs (leading [B] axis on every leaf,
    as ``stack_lps`` builds it; lanes may have different ``A``).

    Lanes with equal ``A`` (and pad rows) solve together as one
    shared-matrix call.  ``warm_start`` is an optional (x0, y0, s0) batch,
    split the same way.  Results come back in the original lane order: a
    list of IpmResults, or with ``as_results=False`` one IpmState with [B]
    leaves, on the device.
    """
    opts = opts or IpmOptions()
    if lp.A.ndim != 3:
        raise ValueError("solve_lp_batch expects a stacked PaddedLp with a leading [B] axis")
    dev = lp.c.device
    B = lp.A.shape[0]
    parts = []
    for g in _groups(lp):
        idx = torch.tensor(g, dtype=torch.long, device=dev)
        batch = _group_batch(lp, idx, g[0])
        if warm_start is not None:
            x0, y0, s0 = (torch.as_tensor(v, device=dev)[idx] for v in warm_start)
            st = mehrotra_solve_shared(batch, opts, x0, y0, s0)
        else:
            st = mehrotra_solve_shared(batch, opts)
        parts.append((g, idx, batch, st))

    if not as_results:
        if len(parts) == 1 and parts[0][0] == list(range(B)):
            return parts[0][3]
        fields = {}
        for name in IpmState.__dataclass_fields__:
            like = getattr(parts[0][3], name)
            out = torch.empty((B,) + tuple(like.shape[1:]), dtype=like.dtype, device=dev)
            for _, idx, _, st in parts:
                out[idx] = getattr(st, name)
            fields[name] = out
        return IpmState(**fields)

    results: List[Optional[IpmResult]] = [None] * B
    for g, idx, batch, st in parts:
        for lane, res in zip(g, _results(batch, st, lp.n_real[idx], lp.m_real[idx])):
            results[lane] = res
    return results
