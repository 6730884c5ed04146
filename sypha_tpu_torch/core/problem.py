"""Problem containers.

``ScpModel`` is the host-side parsed set-covering instance (numpy, ragged).
``PaddedLp`` is the fixed-shape standard-form LP the IPM consumes, a frozen
dataclass of tensors.

Padding convention (that of sypha_tpu/core/problem.py):
  * pad columns are genuine LP variables with cost 1 and an all-zero
    constraint column; the optimum leaves them at 0 and the interior-point
    dynamics keep them strictly interior;
  * pad rows are ``0 = 0`` constraints; ``row_pad`` carries 1.0 on pad rows
    and is added to the diagonal of A D^2 A^T (and A A^T in the initial
    point) so the Cholesky factor stays SPD with dy = 0 on pad rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch


@dataclass
class ScpModel:
    """A parsed set-covering instance: min c.x  s.t.  sum_{j in row i} x_j >= 1.

    ``rows[i]`` holds the 0-based column indices covering row i (the on-disk
    format is 1-based).
    """

    nrows: int
    ncols: int
    costs: np.ndarray  # [ncols] float64
    rows: List[np.ndarray]  # nrows arrays of int32 column indices (0-based)
    name: str = ""

    @property
    def nnz(self) -> int:
        return int(sum(len(r) for r in self.rows))

    def dense_matrix(self) -> np.ndarray:
        """The 0/1 covering matrix [nrows, ncols] (before standard form)."""
        A = np.zeros((self.nrows, self.ncols), dtype=np.float64)
        for i, cols in enumerate(self.rows):
            A[i, cols] = 1.0
        return A


@dataclass(frozen=True)
class PaddedLp:
    """Fixed-shape standard-form LP:  min c.x  s.t.  A x = b, x >= 0.

    For SCP this is ``[A0 | -I]`` with b = 1.  A stacked batch has a leading
    [B] axis on every field.

      A: [m_pad, n_pad] f64, or an ops.ell.EllMatrix of that shape (built by
         io.standard_form.pad_standard_form_ell); b: [m_pad] f64; c: [n_pad] f64;
      row_pad: [m_pad] f64 (1.0 on pad rows, else 0);
      m_real, n_real, n_struct: int32 scalars (n_struct = structural columns
      before the surplus columns).
    """

    A: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    row_pad: torch.Tensor
    m_real: torch.Tensor
    n_real: torch.Tensor
    n_struct: torch.Tensor

    @property
    def m_pad(self) -> int:
        return self.A.shape[-2]

    @property
    def n_pad(self) -> int:
        return self.A.shape[-1]

    @property
    def batch_shape(self):
        return tuple(self.A.shape[:-2])
