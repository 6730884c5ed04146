"""Flexible preconditioned CG for the IPM normal equations.

The port of sypha_tpu/ops/spd.py:pcg_solve.  With the f32 Cholesky factor
as preconditioner it recovers f64 accuracy for the dense-factor strategy;
with a Jacobi diagonal it is the matrix-free CG strategy.  The JAX package's
``spd_factor``, ``spd_solve`` and ``normal_eq_*`` serve only its per-lane IPM
and its tests, and are not ported.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

_count_lock = threading.Lock()


def pcg_solve(
    precond: Callable[[torch.Tensor], torch.Tensor],
    matvec: Callable[[torch.Tensor], torch.Tensor],
    f: torch.Tensor,
    tol: torch.Tensor | float = 1e-10,
    max_steps: int = 40,
    agree: Callable[[torch.Tensor], bool] = bool,
):
    """Flexible (Polak-Ribiere) PCG in f.dtype, matrix-free and batch-first.

    Returns (x, rel): the solution and the relative residual each lane
    reached, which the IPM's step-quality gates read.

    Loop semantics are those of the JAX ``lax.while_loop``: before each step
    the loop tests ``k < max_steps`` and whether ANY lane's residual is above
    its threshold, and while one is, every lane steps, converged ones too.
    In eager PyTorch that test is a device-to-host sync per step;
    ``pcg_solve.steps`` counts the steps taken, over all calls (exactly under
    host threads).  ``agree`` turns the local "any lane above" flag into the
    host's decision; tensor parallelism passes one that reduces it over the
    ranks, so that every rank takes the same number of steps.
    """
    norm_f = torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    thresh = tol * torch.clamp(norm_f, min=1e-300)

    x = precond(f)
    r = f - matvec(x)
    z = precond(r)
    p = z
    rz = torch.sum(r * z, dim=-1, keepdim=True)

    k = 0
    while k < max_steps and agree(
        (torch.linalg.vector_norm(r, dim=-1, keepdim=True) > thresh).any()
    ):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap, dim=-1, keepdim=True)
        ok = pAp > 0.0
        alpha = torch.where(ok, rz / torch.where(ok, pAp, 1.0), 0.0)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        rz_new = torch.sum(r_new * z_new, dim=-1, keepdim=True)
        # flexible (Polak-Ribiere) beta: robust to an inexact preconditioner
        num = torch.sum((r_new - r) * z_new, dim=-1, keepdim=True)
        nz = torch.abs(rz) > 0
        beta = torch.where(nz, num / torch.where(nz, rz, 1.0), 0.0)
        p = z_new + beta * p
        r, rz = r_new, rz_new
        k += 1
    with _count_lock:
        pcg_solve.steps += k
    rel = torch.linalg.vector_norm(r, dim=-1) / torch.clamp(norm_f[..., 0], min=1e-300)
    return x, rel


pcg_solve.steps = 0
