"""Mixed-precision SPD solves for the IPM normal equations.

The port of sypha_tpu/ops/spd.py.  A Jacobi-equilibrated copy of the normal
matrix is factored in f32 (with a small ridge so the factor always exists),
and flexible preconditioned CG in f64 with that factor as preconditioner
recovers f64 accuracy.  With a Jacobi diagonal instead of the factor the
same loop is the matrix-free CG strategy.

Everything is batch-first ([..., m, m] / [..., m]).  ``pcg_solve`` (and
``spd_solve``, ``normal_eq_solve`` on top of it) has three loop semantics:
batch-wide, as the JAX package's loop runs on a batched call (the
shared-matrix IPM), per lane, as ``jax.vmap`` of that loop runs (the
per-lane IPM of ipm.dense), and per instance group, as ``jax.vmap`` over
groups of a batch-wide loop runs (the grouped shared-matrix IPM).

``normal_eq_factor`` in f32 forms its Gram matrix with the Gram kernel
(ops.gram), one matrix per lane or one shared by every lane.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable

import torch

from sypha_tpu_torch.ops.gram import gram
from sypha_tpu_torch.ops.linalg import block_chol_inverse

_count_lock = threading.Lock()


@dataclass(frozen=True)
class SpdFactor:
    """Equilibrated factor of an SPD matrix M = Dg Ms Dg.

    Ms: [..., m, m] f64 equilibrated matrix (unit-ish diagonal)
    Linv: [..., m, m] inverse Cholesky factor of Ms (+ ridge), possibly f32
    dinv: [..., m] 1/sqrt(diag M) equilibration scales (f64)
    """

    Ms: torch.Tensor
    Linv: torch.Tensor
    dinv: torch.Tensor


def spd_factor(
    M: torch.Tensor,
    factor_dtype=torch.float32,
    ridge: float = 2e-6,
    leaf_size: int = 64,
) -> SpdFactor:
    """Equilibrate and factor M (SPD, f64)."""
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    dinv = torch.rsqrt(torch.clamp(diag, min=1e-300))
    Ms = M * dinv[..., None, :] * dinv[..., :, None]
    m = M.shape[-1]
    Mf = Ms.to(factor_dtype) + ridge * torch.eye(m, dtype=factor_dtype, device=M.device)
    return SpdFactor(Ms=Ms, Linv=block_chol_inverse(Mf, leaf_size=leaf_size), dinv=dinv)


def _apply_precond(Linv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """P r = L^{-T} L^{-1} r, computed in the factor dtype, returned in r.dtype."""
    z = torch.einsum("...ij,...j->...i", Linv, r.to(Linv.dtype))
    z = torch.einsum("...ji,...j->...i", Linv, z)
    return z.to(r.dtype)


@dataclass(frozen=True)
class NormalEqFactor:
    """Preconditioner factor of the normal matrix M = A D^2 A^T + diag(r),
    built entirely in the factor dtype; the f64 side of the Newton solve
    stays matrix-free (``normal_eq_solve``).

    Linv: [..., m, m] inverse Cholesky of the equilibrated M (factor dtype)
    dinv: [..., m] equilibration scales 1/sqrt(diag M) (factor dtype)
    """

    Linv: torch.Tensor
    dinv: torch.Tensor


def factor_gram(M: torch.Tensor, row_reg: torch.Tensor, ridge: float, leaf_size: int):
    """(Linv, dinv) of a batched Gram matrix M [B, m, m] in its own dtype:
    add diag(row_reg), equilibrate by 1/sqrt(diag), add the ridge, factor."""
    ft = M.dtype
    m = M.shape[-1]
    M = M + torch.diag_embed(row_reg.to(ft))
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    dinv = torch.rsqrt(torch.clamp(diag, min=1e-30))
    Ms = M * dinv[..., None, :] * dinv[..., :, None]
    Ms = Ms + ridge * torch.eye(m, dtype=ft, device=M.device)
    return block_chol_inverse(Ms, leaf_size=leaf_size), dinv


def normal_eq_factor(
    A: torch.Tensor,
    d2: torch.Tensor,
    row_reg: torch.Tensor,
    factor_dtype=torch.float32,
    ridge: float = 2e-6,
    leaf_size: int = 64,
    a_bf16_exact: bool | None = None,
) -> NormalEqFactor:
    """Factor M = A diag(d2) A^T + diag(row_reg) in ``factor_dtype``.

    A: [B, m, n] (a matrix per lane) or [m, n] (shared), in any float dtype
    (pass it already in the factor dtype to skip the cast); d2: [B, n] >= 0;
    row_reg: [B, m].  M is formed as Aw Aw^T with Aw = A * sqrt(d2), so it
    is symmetric and PSD; in f32 by the Gram kernel, in f64 by an einsum.
    ``a_bf16_exact`` is ``ops.gram.bf16_exact`` of A in f32 when the caller
    decided it once per solve (None: the Gram kernel's wrapper decides).
    """
    ft = factor_dtype
    A = A.to(ft)
    w = torch.sqrt(d2).to(ft)
    if ft == torch.float32:
        M = gram(A.contiguous(), w.contiguous(), a_bf16_exact=a_bf16_exact)
    else:
        Aw = A * w[:, None, :]
        M = torch.einsum("bik,bjk->bij", Aw, Aw)
    Linv, dinv = factor_gram(M, row_reg, ridge, leaf_size)
    return NormalEqFactor(Linv=Linv, dinv=dinv)


def _apply_normal_precond(fac: NormalEqFactor, r: torch.Tensor) -> torch.Tensor:
    """P r = Dg L^{-T} L^{-1} Dg r in the factor dtype, returned in r.dtype."""
    rf = fac.dinv * r.to(fac.dinv.dtype)
    z = torch.einsum("...ij,...j->...i", fac.Linv, rf)
    z = torch.einsum("...ji,...j->...i", fac.Linv, z)
    return (fac.dinv * z).to(r.dtype)


def pcg_solve(
    precond: Callable[[torch.Tensor], torch.Tensor],
    matvec: Callable[[torch.Tensor], torch.Tensor],
    f: torch.Tensor,
    tol: torch.Tensor | float = 1e-10,
    max_steps: int = 40,
    agree: Callable[[torch.Tensor], bool] = bool,
    per_lane: bool | torch.Tensor = False,
    per_group: bool = False,
):
    """Flexible (Polak-Ribiere) PCG in f.dtype, matrix-free and batch-first.

    Returns (x, rel): the solution and the relative residual each lane
    reached, which the IPM's step-quality gates read.  ``tol`` is a float or
    a per-lane [..., 1] tensor.

    Loop semantics, all those of the JAX ``lax.while_loop``:

    * ``per_lane=False`` (batch-wide, the loop of a batched call): before
      each step the loop tests ``k < max_steps`` and whether ANY lane's
      residual is above its threshold, and while one is, every lane steps,
      converged ones too.
    * ``per_lane=True``, or a bool [...] tensor of the lanes to solve (the
      loop under ``jax.vmap``): a lane steps while its own residual is above
      its threshold and it has taken fewer than ``max_steps`` steps; from
      then on its x, r, p and rz stay as they were, and ``rel`` is read from
      its frozen r.  Lanes outside the tensor never step.  The loop still
      runs while any lane is active.
    * ``per_group=True`` with f [G, L, m] (the batch-wide loop under
      ``jax.vmap`` over instance groups): a group steps while ANY of its
      lanes is above its threshold and ``k < max_steps``, and then every
      lane of the group steps, converged ones too; from then on the group's
      x, r, p and rz stay as they were.  Every group that still steps has
      taken k steps, so one count serves them all.

    In eager PyTorch the loop's test is one device-to-host sync per step;
    ``pcg_solve.steps`` counts the steps taken, over all calls (exactly under
    host threads).  ``agree`` turns the local "any lane" flag into the host's
    decision; tensor parallelism passes one that reduces it over the ranks,
    so that every rank takes the same number of steps.
    """
    norm_f = torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    thresh = tol * torch.clamp(norm_f, min=1e-300)

    if per_group and per_lane is not False:
        raise ValueError("pcg_solve takes per_lane or per_group, not both")

    def above(r):
        """The loop's test: per lane [..., 1], or per group [G, 1, 1]."""
        hi = torch.linalg.vector_norm(r, dim=-1, keepdim=True) > thresh
        return hi.any(dim=-2, keepdim=True) if per_group else hi

    x = precond(f)
    r = f - matvec(x)
    z = precond(r)
    p = z
    rz = torch.sum(r * z, dim=-1, keepdim=True)

    if per_lane is False and not per_group:
        active = None
    else:
        active = above(r)
        if isinstance(per_lane, torch.Tensor):
            active = active & per_lane[..., None]

    k = 0
    while k < max_steps and agree((above(r) if active is None else active).any()):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap, dim=-1, keepdim=True)
        ok = pAp > 0.0
        alpha = torch.where(ok, rz / torch.where(ok, pAp, 1.0), 0.0)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        rz_new = torch.sum(r_new * z_new, dim=-1, keepdim=True)
        # flexible (Polak-Ribiere) beta: robust to an inexact preconditioner
        num = torch.sum((r_new - r) * z_new, dim=-1, keepdim=True)
        nz = torch.abs(rz) > 0
        beta = torch.where(nz, num / torch.where(nz, rz, 1.0), 0.0)
        p_new = z_new + beta * p
        if active is None:
            x, r, p, rz = x_new, r_new, p_new, rz_new
        else:
            x = torch.where(active, x_new, x)
            r = torch.where(active, r_new, r)
            p = torch.where(active, p_new, p)
            rz = torch.where(active, rz_new, rz)
            active = active & above(r)
        k += 1
    with _count_lock:
        pcg_solve.steps += k
    rel = torch.linalg.vector_norm(r, dim=-1) / torch.clamp(norm_f[..., 0], min=1e-300)
    return x, rel


pcg_solve.steps = 0


def normal_eq_solve(
    fac: NormalEqFactor,
    matvec: Callable[[torch.Tensor], torch.Tensor],
    f: torch.Tensor,
    tol: torch.Tensor | float = 1e-10,
    max_steps: int = 40,
    per_lane: bool | torch.Tensor = False,
) -> torch.Tensor:
    """Solve M x = f with the f32 factor as PCG preconditioner.

    ``matvec`` applies the exact f64 operator v -> A (d2 * (A^T v)) + reg*v;
    the factor is only a preconditioner, so the result converges to f64
    accuracy at two matvecs per step.
    """
    return pcg_solve(
        lambda r: _apply_normal_precond(fac, r), matvec, f, tol, max_steps, per_lane=per_lane
    )[0]


def spd_solve(
    fac: SpdFactor,
    f: torch.Tensor,
    tol: torch.Tensor | float = 1e-12,
    max_steps: int = 50,
    per_lane: bool | torch.Tensor = False,
) -> torch.Tensor:
    """Solve M x = f to relative residual ``tol`` (on the equilibrated
    system) by flexible PCG in f64 preconditioned by the factor; the JAX
    package's loop, whose body is ``pcg_solve``'s.  Returns x in f64."""
    Ms = fac.Ms
    x, _ = pcg_solve(
        lambda r: _apply_precond(fac.Linv, r),
        lambda v: torch.einsum("...ij,...j->...i", Ms, v),
        fac.dinv * f,
        tol,
        max_steps,
        per_lane=per_lane,
    )
    return fac.dinv * x
