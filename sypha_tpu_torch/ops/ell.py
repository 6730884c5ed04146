"""Padded ELL (ELLPACK) sparse operator: the port of sypha_tpu/ops/ell.py.

Every row stores exactly ``Kr`` (column-index, value) slots and every column
``Kc`` (row-index, value) slots, padding with index 0 and value 0, so a
product is one gather along the last axis, a multiply and a fixed-width sum
over the slot axis.  Both orientations are kept (row-ELL for A.v,
column-ELL for A^T.u), so no product transposes.

Values are stored in f32: standard-form SCP coefficients are small integers
(+-1 and the small integer coefficients of cut rows), exact in f32, and
every product with an f64 vector comes out in f64, as in the JAX package.
The products are plain PyTorch (``index_select`` + sum); in the JAX package
they were XLA gather ops, not Pallas kernels.  ``ell_column_slabs`` cuts an
operator into the per-rank column slabs of tensor parallelism.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from sypha_tpu_torch.core.device import resolve_device


@dataclass(frozen=True)
class EllMatrix:
    """Fixed-width sparse [m_pad, n_pad] matrix in both orientations.

    row_idx/row_val: [m_pad, Kr], for each row its column indices and values;
    col_idx/col_val: [n_pad, Kc], for each column its row indices and values.
    Indices are int32, values f32 (or the dtype given at build); pad slots
    hold index 0 and value 0.  All four tensors live on one device.
    """

    row_idx: torch.Tensor
    row_val: torch.Tensor
    col_idx: torch.Tensor
    col_val: torch.Tensor

    @property
    def m_pad(self) -> int:
        return self.row_idx.shape[0]

    @property
    def n_pad(self) -> int:
        return self.col_idx.shape[0]

    @property
    def shape(self):
        return (self.m_pad, self.n_pad)

    @property
    def device(self):
        return self.row_val.device

    # ---- products (leading batch axes broadcast through) ----

    @staticmethod
    def _gather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        g = torch.index_select(v, -1, idx.reshape(-1))
        return g.reshape(v.shape[:-1] + idx.shape)

    def Av(self, v: torch.Tensor) -> torch.Tensor:
        """[..., n_pad] -> [..., m_pad]: A @ v."""
        return torch.sum(self._gather(v, self.row_idx) * self.row_val, dim=-1)

    def ATu(self, u: torch.Tensor) -> torch.Tensor:
        """[..., m_pad] -> [..., n_pad]: A^T @ u."""
        return torch.sum(self._gather(u, self.col_idx) * self.col_val, dim=-1)

    def sqAv(self, d: torch.Tensor) -> torch.Tensor:
        """[..., n_pad] -> [..., m_pad]: (A∘A) @ d, the Jacobi diagonal of
        A diag(d) A^T."""
        return torch.sum(
            self._gather(d, self.row_idx) * (self.row_val * self.row_val), dim=-1
        )

    def todense(self, dtype=None) -> torch.Tensor:
        """Scatter to a dense [m_pad, n_pad] tensor.  With dtype=float32 this
        is how the ELL operator feeds the f32 Gram factor: a transient dense
        f32 matrix, while every f64 product stays matrix-free.  Slots add up
        (pad slots add 0 at column 0)."""
        dtype = dtype or self.row_val.dtype
        out = torch.zeros((self.m_pad, self.n_pad), dtype=dtype, device=self.device)
        rows = torch.arange(self.m_pad, device=self.device)[:, None].expand(self.row_idx.shape)
        return out.index_put_(
            (rows, self.row_idx.long()), self.row_val.to(dtype), accumulate=True
        )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _to_device(row_idx, row_val, col_idx, col_val, device) -> EllMatrix:
    return EllMatrix(
        row_idx=torch.from_numpy(row_idx).to(device),
        row_val=torch.from_numpy(row_val).to(device),
        col_idx=torch.from_numpy(col_idx).to(device),
        col_val=torch.from_numpy(col_val).to(device),
    )


def ell_from_rows(
    rows: List[Tuple[np.ndarray, np.ndarray]],
    n_struct: int,
    m_pad: int,
    n_pad: int,
    dtype=np.float32,
    lane_multiple: int = 8,
    device: torch.device | str | None = None,
) -> EllMatrix:
    """Build the standard form [A | -I] as an EllMatrix from host row data.

    ``rows``: per covering or cut row, (structural column indices, values);
    row i also gets its surplus column ``n_struct + i`` with -1.  The dense
    matrix is never built.  Widths Kr/Kc are rounded up to ``lane_multiple``.
    The tensors go to ``device`` (default ``cuda``).
    """
    device = resolve_device(device)
    m = len(rows)
    if n_struct + m > n_pad:
        raise ValueError("n_pad too small for structural + surplus columns")
    kr = max((len(idx) + 1 for idx, _ in rows), default=1)
    kr = _round_up(kr, lane_multiple)

    row_idx = np.zeros((m_pad, kr), dtype=np.int32)
    row_val = np.zeros((m_pad, kr), dtype=dtype)
    col_count = np.zeros(n_pad, dtype=np.int64)
    for i, (idx, val) in enumerate(rows):
        k = len(idx)
        row_idx[i, :k] = idx
        row_val[i, :k] = val
        row_idx[i, k] = n_struct + i  # surplus column
        row_val[i, k] = -1.0
        col_count[idx] += 1
        col_count[n_struct + i] += 1

    kc = int(max(1, col_count.max()))
    kc = _round_up(kc, lane_multiple)
    col_idx = np.zeros((n_pad, kc), dtype=np.int32)
    col_val = np.zeros((n_pad, kc), dtype=dtype)
    fill = np.zeros(n_pad, dtype=np.int64)
    for i, (idx, val) in enumerate(rows):
        for j, v in zip(idx, val):
            col_idx[j, fill[j]] = i
            col_val[j, fill[j]] = v
            fill[j] += 1
        sj = n_struct + i
        col_idx[sj, fill[sj]] = i
        col_val[sj, fill[sj]] = -1.0
        fill[sj] += 1

    return _to_device(row_idx, row_val, col_idx, col_val, device)


def ell_column_slabs(ell: EllMatrix, k: int, lane_multiple: int = 8) -> EllMatrix:
    """Split an EllMatrix into ``k`` column slabs for tensor parallelism.

    Returns one EllMatrix whose four tensors carry a LEADING shard axis of
    size ``k`` (shard j owns global columns [j*n_pad/k, (j+1)*n_pad/k)), on
    ``ell``'s device; ``EllMatrix(row_idx=slabs.row_idx[j], ...)`` is shard
    j's operator:

    - col_idx/col_val [k, n_pad/k, Kc]: the column orientation splits by a
      reshape (its stored row indices are global, and rows are replicated
      under column sharding);
    - row_idx/row_val [k, m_pad, Kr']: the row orientation is rebuilt per
      shard with SHARD-LOCAL column indices (global - j*n_pad/k), so each
      rank's ``Av`` gathers from its own x slab and the partial row-space
      products sum over the ranks (ipm.shared's reducers).  Kr' is the
      largest per-shard row width, rounded up to ``lane_multiple`` and common
      to all shards.

    Built on the host with numpy, as in the JAX package."""
    n_pad = ell.n_pad
    if n_pad % k:
        raise ValueError(f"n_pad {n_pad} not divisible into {k} slabs")
    nl = n_pad // k
    row_idx = ell.row_idx.cpu().numpy()
    row_val = ell.row_val.cpu().numpy()
    m_pad = row_idx.shape[0]
    shard_of = row_idx // nl
    valid = row_val != 0
    kr = 1
    for j in range(k):
        cnt = ((shard_of == j) & valid).sum(axis=1)
        kr = max(kr, int(cnt.max()) if cnt.size else 0)
    kr = _round_up(kr, lane_multiple)
    if kr > row_idx.shape[1]:
        # a lane_multiple larger than the one the EllMatrix was built with
        # can round kr past the source row width: pad the source (zero
        # values are invalid slots) so the slices below stay rectangular
        pad = kr - row_idx.shape[1]
        row_idx = np.pad(row_idx, ((0, 0), (0, pad)))
        row_val = np.pad(row_val, ((0, 0), (0, pad)))
        shard_of = row_idx // nl
        valid = row_val != 0
    new_ri = np.zeros((k, m_pad, kr), dtype=np.int32)
    new_rv = np.zeros((k, m_pad, kr), dtype=row_val.dtype)
    lane = np.arange(kr)[None, :]
    for j in range(k):
        sel = (shard_of == j) & valid
        # left-compact each row's selected slots in one pass: a stable
        # argsort on ~sel moves them to the front in their original order
        order = np.argsort(~sel, axis=1, kind="stable")
        ri_s = np.take_along_axis(row_idx, order, axis=1)[:, :kr]
        rv_s = np.take_along_axis(row_val, order, axis=1)[:, :kr]
        mask = lane < sel.sum(axis=1)[:, None]
        new_ri[j] = np.where(mask, ri_s - j * nl, 0)
        new_rv[j] = np.where(mask, rv_s, 0)
    kc = ell.col_idx.shape[1]
    return EllMatrix(
        row_idx=torch.from_numpy(new_ri).to(ell.device),
        row_val=torch.from_numpy(new_rv).to(ell.device),
        col_idx=ell.col_idx.reshape(k, nl, kc),
        col_val=ell.col_val.reshape(k, nl, kc),
    )


def ell_from_dense(
    A: np.ndarray,
    m_pad=None,
    n_pad=None,
    lane_multiple: int = 8,
    device: torch.device | str | None = None,
) -> EllMatrix:
    """Convert a host dense matrix to an EllMatrix on ``device`` (default
    ``cuda``; tests and small inputs; no surplus columns added; values keep
    A's dtype)."""
    device = resolve_device(device)
    A = np.asarray(A)
    m, n = A.shape
    m_pad = m_pad or m
    n_pad = n_pad or n
    rows = []
    for i in range(m):
        idx = np.flatnonzero(A[i])
        rows.append((idx.astype(np.int32), A[i, idx]))
    kr = _round_up(max((len(r[0]) for r in rows), default=1), lane_multiple)
    row_idx = np.zeros((m_pad, kr), dtype=np.int32)
    row_val = np.zeros((m_pad, kr), dtype=A.dtype)
    for i, (idx, val) in enumerate(rows):
        row_idx[i, : len(idx)] = idx
        row_val[i, : len(idx)] = val
    col_count = (A != 0).sum(axis=0)
    kc = _round_up(int(max(1, col_count.max() if n else 1)), lane_multiple)
    col_idx = np.zeros((n_pad, kc), dtype=np.int32)
    col_val = np.zeros((n_pad, kc), dtype=A.dtype)
    for j in range(n):
        idx = np.flatnonzero(A[:, j])
        col_idx[j, : len(idx)] = idx
        col_val[j, : len(idx)] = A[idx, j]
    return _to_device(row_idx, row_val, col_idx, col_val, device)
