"""Standard-form construction and fixed-shape padding.

``scp_standard_form`` converts an ScpModel to  min c.x, A x = b, x >= 0 with
A = [A0 | -I] and b = 1: every covering row gains a surplus column with
coefficient -1.

``pad_lp`` then pads to a fixed (m_pad, n_pad) bucket; see
core.problem.PaddedLp for the padding convention.  The buckets are those of
sypha_tpu/io/standard_form.py (rows to a multiple of 8, columns to 128), so
the port's lanes line up with the JAX package's, iterate for iterate.

The JAX package's padded-ELL builder (``pad_standard_form_ell``) comes with
the sparse operator in a later slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sypha_tpu_torch.core.problem import PaddedLp, ScpModel


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_dims(
    m: int,
    n: int,
    row_multiple: int = 8,
    col_multiple: int = 128,
    extra_rows: int = 0,
) -> Tuple[int, int]:
    """Padded dims for a standard-form LP with m rows, n columns.

    ``extra_rows`` reserves space for B&B branch rows / cuts (each added row
    also adds one surplus column).
    """
    mp = _round_up(m + extra_rows, row_multiple)
    np_ = _round_up(n + extra_rows, col_multiple)
    return mp, np_


def scp_standard_form(model: ScpModel) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense standard form (A, b, c) with A = [A0 | -I], b = 1, c = [costs, 0]."""
    m, n0 = model.nrows, model.ncols
    n = n0 + m
    A = np.zeros((m, n), dtype=np.float64)
    for i, cols in enumerate(model.rows):
        A[i, cols] = 1.0
        A[i, n0 + i] = -1.0
    b = np.ones(m, dtype=np.float64)
    c = np.concatenate([model.costs.astype(np.float64), np.zeros(m)])
    return A, b, c


def pad_standard_form(
    A: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    n_struct: int,
    m_pad: Optional[int] = None,
    n_pad: Optional[int] = None,
    extra_rows: int = 0,
    device: torch.device | str = "cpu",
) -> PaddedLp:
    """Pad an explicit standard-form (A, b, c) into a PaddedLp on ``device``."""
    m, n = A.shape
    auto_mp, auto_np = bucket_dims(m, n, extra_rows=extra_rows)
    mp = m_pad if m_pad is not None else auto_mp
    np_ = n_pad if n_pad is not None else auto_np
    if mp < m or np_ < n:
        raise ValueError(f"padded dims ({mp},{np_}) smaller than real dims ({m},{n})")

    Ap = np.zeros((mp, np_), dtype=np.float64)
    Ap[:m, :n] = A
    bp = np.zeros(mp, dtype=np.float64)
    bp[:m] = b
    cp = np.ones(np_, dtype=np.float64)  # pad columns get cost 1 (kept interior, -> 0)
    cp[:n] = c
    row_pad = np.zeros(mp, dtype=np.float64)
    row_pad[m:] = 1.0

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return PaddedLp(
        A=f64(Ap),
        b=f64(bp),
        c=f64(cp),
        row_pad=f64(row_pad),
        m_real=i32(m),
        n_real=i32(n),
        n_struct=i32(n_struct),
    )


def pad_lp(
    model: ScpModel,
    m_pad: Optional[int] = None,
    n_pad: Optional[int] = None,
    extra_rows: int = 0,
    device: torch.device | str = "cpu",
) -> PaddedLp:
    """ScpModel -> padded LP on ``device`` (standard form + bucket padding)."""
    A, b, c = scp_standard_form(model)
    return pad_standard_form(
        A, b, c, n_struct=model.ncols, m_pad=m_pad, n_pad=n_pad,
        extra_rows=extra_rows, device=device,
    )


def stack_lps(lps: Sequence[PaddedLp]) -> PaddedLp:
    """Stack same-bucket PaddedLps into one batched PaddedLp with leading [B]."""
    shapes = {(lp.m_pad, lp.n_pad) for lp in lps}
    if len(shapes) != 1:
        raise ValueError(f"cannot stack LPs from different buckets: {sorted(shapes)}")
    return PaddedLp(
        A=torch.stack([lp.A for lp in lps]),
        b=torch.stack([lp.b for lp in lps]),
        c=torch.stack([lp.c for lp in lps]),
        row_pad=torch.stack([lp.row_pad for lp in lps]),
        m_real=torch.stack([lp.m_real for lp in lps]),
        n_real=torch.stack([lp.n_real for lp in lps]),
        n_struct=torch.stack([lp.n_struct for lp in lps]),
    )
