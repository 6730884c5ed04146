"""Solve drivers: one padded LP, or a stacked batch of them.

The port of sypha_tpu/ipm/driver.py.  As in the JAX package, both run the
per-lane dense IPM (ipm.dense.mehrotra_solve): ``solve_lp`` on a one-lane
stack, ``solve_lp_batch`` in one call over the whole stack, each lane with
its own ``A`` (where the JAX package jits the engine, and vmaps it over the
stack).  On the card every iteration forms the lanes' normal matrices with
the Gram kernel in its per-lane form.  ``solve_lp`` also takes a padded-ELL
LP (io.standard_form.pad_standard_form_ell), which the JAX driver does not:
that runs as a one-lane batch of the shared-matrix engine
(ipm.shared.mehrotra_solve_shared), the engine of the ELL operator.

Results come back to the host in one packed device-to-host copy (the
per-lane scalars, the iterates, ``c`` and ``b``), where the JAX package
fetched each field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from sypha_tpu_torch.config import IpmOptions
from sypha_tpu_torch.core.problem import PaddedLp
from sypha_tpu_torch.core.status import IpmStatus
from sypha_tpu_torch.ipm.dense import mehrotra_solve
from sypha_tpu_torch.ipm.shared import IpmState, make_shared_batch, mehrotra_solve_shared
from sypha_tpu_torch.ops.ell import EllMatrix


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


def _results(c: torch.Tensor, b: torch.Tensor, st: IpmState, n_real, m_real) -> List[IpmResult]:
    """Per-lane IpmResults from ONE device-to-host copy: the lane scalars,
    n_real/m_real, x, y and the lanes' c [B, n] and b [B, m] packed into one
    f64 [B, k] tensor (int32 values are exact in f64) and split on the host."""
    B = st.x.shape[0]
    f64 = torch.float64
    scalars = [getattr(st, k).to(f64) for k in _SCALARS]
    dims = [torch.as_tensor(v, device=st.x.device).to(f64).expand(B) for v in (n_real, m_real)]
    packed = torch.cat(
        [torch.stack(scalars + dims, dim=1), st.x, st.y, c, b], dim=1
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
    if isinstance(lp.A, EllMatrix):
        batch = make_shared_batch(lp, 1)
        st = mehrotra_solve_shared(batch, opts)
        return _results(batch.c, batch.b, st, lp.n_real, lp.m_real)[0]
    one = PaddedLp(**{f.name: getattr(lp, f.name)[None] for f in dataclasses.fields(lp)})
    return _results(one.c, one.b, mehrotra_solve(one, opts), one.n_real, one.m_real)[0]


def solve_lp_batch(
    lp: PaddedLp,
    opts: Optional[IpmOptions] = None,
    warm_start: Optional[tuple] = None,
    as_results: bool = True,
):
    """Solve a stacked batch of dense padded LPs (leading [B] axis on every
    field, as ``stack_lps`` builds it; lanes may have different ``A``) in
    one call of the per-lane engine.

    ``warm_start`` is an optional (x0, y0, s0) batch.  Returns a list of
    IpmResults in lane order, or with ``as_results=False`` the IpmState with
    [B] leaves, on the device.
    """
    opts = opts or IpmOptions()
    st = mehrotra_solve(lp, opts, *(warm_start or ()))
    if not as_results:
        return st
    return _results(lp.c, lp.b, st, lp.n_real, lp.m_real)
