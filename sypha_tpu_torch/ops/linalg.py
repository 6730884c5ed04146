"""Batched inverse Cholesky factor by 2x2 block recursion.

The port of sypha_tpu/ops/linalg.py:block_chol_inverse, with the same
recursion, leaf size and split:

    M = [[M11, M21^T], [M21, M22]],   L = chol(M) = [[L11, 0], [L21, L22]]
    L11 = chol(M11)
    L21 = M21 L11^{-T}
    S   = M22 - L21 L21^T
    Linv = [[L11inv, 0], [-L22inv L21 L11inv, L22inv]]

Returning L^{-1} explicitly makes every later Newton-preconditioner apply two
batched GEMVs.  The leaves are torch.linalg (cuSOLVER / cuBLAS on the card);
a hand kernel for this region waits for an H100 profile that shows it
matters.
"""

from __future__ import annotations

import torch


def _leaf_chol_inverse(M: torch.Tensor) -> torch.Tensor:
    """Base case: Cholesky and a triangular inverse of small blocks.

    Like ``jax.lax.linalg.cholesky``, the input is symmetrised first and a
    lane that is not positive definite gets a factor whose lower triangle is
    NaN, so the failure reaches the IPM's finiteness gates instead of
    raising for the whole batch (``torch.linalg.cholesky``) or leaving a
    partial factor behind (``cholesky_ex``).
    """
    L, info = torch.linalg.cholesky_ex((M + M.mT) / 2)
    m = M.shape[-1]
    lower = torch.ones(m, m, dtype=torch.bool, device=M.device).tril()
    L = L.masked_fill((info != 0)[..., None, None] & lower, float("nan"))
    eye = torch.eye(m, dtype=M.dtype, device=M.device).expand(M.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False, left=True)


def block_chol_inverse(M: torch.Tensor, leaf_size: int = 64) -> torch.Tensor:
    """Return L^{-1} where M = L L^T, via 2x2 block recursion.

    M: [..., m, m] SPD.
    """
    m = M.shape[-1]
    if m <= leaf_size:
        return _leaf_chol_inverse(M)

    h = m // 2
    # the split is rounded to a multiple of 8, as in the JAX package
    h -= h % 8
    if h == 0:
        return _leaf_chol_inverse(M)

    M11 = M[..., :h, :h]
    M21 = M[..., h:, :h]
    M22 = M[..., h:, h:]

    L11inv = block_chol_inverse(M11, leaf_size)
    # L21 = M21 L11^{-T}
    L21 = M21 @ L11inv.mT
    # Schur complement S = M22 - L21 L21^T
    S = M22 - L21 @ L21.mT
    L22inv = block_chol_inverse(S, leaf_size)
    # bottom-left of L^{-1}: -L22^{-1} L21 L11^{-1}
    B = -(L22inv @ (L21 @ L11inv))

    top = torch.cat(
        [L11inv, torch.zeros(M.shape[:-2] + (h, m - h), dtype=M.dtype, device=M.device)],
        dim=-1,
    )
    bot = torch.cat([B, L22inv], dim=-1)
    return torch.cat([top, bot], dim=-2)
