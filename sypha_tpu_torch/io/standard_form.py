"""Standard-form construction and fixed-shape padding.

``scp_standard_form`` converts an ScpModel to  min c.x, A x = b, x >= 0 with
A = [A0 | -I] and b = 1: every covering row gains a surplus column with
coefficient -1.

``pad_lp`` then pads to a fixed (m_pad, n_pad) bucket; see
core.problem.PaddedLp for the padding convention.  The buckets are those of
sypha_tpu/io/standard_form.py (rows to a multiple of 8, columns to 128), so
the port's lanes line up with the JAX package's, iterate for iterate.

``pad_standard_form_ell`` is the padded-ELL counterpart of
``pad_standard_form``: same padding, with ``A`` an ops.ell.EllMatrix, kept
in a small content-addressed cache so that equal rows on one device share
one operator.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sypha_tpu_torch.core.device import resolve_device
from sypha_tpu_torch.core.problem import PaddedLp, ScpModel
from sypha_tpu_torch.ops.ell import ell_from_rows

# EllMatrix operators keyed by (content digest, device), see
# pad_standard_form_ell; an insertion-ordered dict of at most 4 entries,
# the oldest dropped first
_ELL_DEVICE_CACHE: dict = {}
# parallel/mesh runs one host thread per shard
_ELL_CACHE_LOCK = threading.Lock()


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


def _padded_lp(A, bp: np.ndarray, cp: np.ndarray, m: int, n: int, n_struct: int, device) -> PaddedLp:
    """PaddedLp of a padded A (tensor or EllMatrix) and host b, c on ``device``;
    rows from m on are pad rows."""
    row_pad = np.zeros(len(bp), dtype=np.float64)
    row_pad[m:] = 1.0

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return PaddedLp(
        A=A,
        b=f64(bp),
        c=f64(cp),
        row_pad=f64(row_pad),
        m_real=i32(m),
        n_real=i32(n),
        n_struct=i32(n_struct),
    )


def pad_standard_form(
    A: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    n_struct: int,
    m_pad: Optional[int] = None,
    n_pad: Optional[int] = None,
    extra_rows: int = 0,
    device: torch.device | str | None = None,
) -> PaddedLp:
    """Pad an explicit standard-form (A, b, c) into a PaddedLp on ``device``
    (default ``cuda``; see core.device.resolve_device)."""
    device = resolve_device(device)
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
    return _padded_lp(
        torch.as_tensor(Ap, dtype=torch.float64, device=device), bp, cp, m, n, n_struct, device
    )


def pad_lp(
    model: ScpModel,
    m_pad: Optional[int] = None,
    n_pad: Optional[int] = None,
    extra_rows: int = 0,
    device: torch.device | str | None = None,
) -> PaddedLp:
    """ScpModel -> padded LP on ``device`` (standard form + bucket padding),
    by default the card: ``pad_lp(model, device="cpu")`` for the CPU."""
    device = resolve_device(device)
    A, b, c = scp_standard_form(model)
    return pad_standard_form(
        A, b, c, n_struct=model.ncols, m_pad=m_pad, n_pad=n_pad,
        extra_rows=extra_rows, device=device,
    )


def _ell_key(row_data, n_struct: int, m_pad: int, n_pad: int, device: torch.device):
    """The operator's cache key: a blake2b digest of (dims, each row's indices
    as int32 and values as f64), the JAX package's key, and the device (a
    CUDA device with its index, so that shards on different cards never
    share an operator)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray([n_struct, m_pad, n_pad, len(row_data)], dtype=np.int64).tobytes())
    for idx, val in row_data:
        h.update(np.ascontiguousarray(idx, dtype=np.int32).tobytes())
        h.update(np.ascontiguousarray(val, dtype=np.float64).tobytes())
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return h.digest(), device


def pad_standard_form_ell(
    row_data,
    rhs: np.ndarray,
    costs: np.ndarray,
    n_struct: int,
    m_pad: int,
    n_pad: int,
    device: torch.device | str | None = None,
) -> PaddedLp:
    """Sparse (padded-ELL) counterpart of pad_standard_form, on ``device``.

    ``row_data``: per row, (structural column indices, values); each row i
    also gains its surplus column n_struct + i with -1.  ``costs``:
    structural costs [n_struct]; surplus columns cost 0, pad columns 1 (the
    conventions of pad_standard_form).  The dense [m_pad, n_pad] f64 matrix
    never exists: every product on the returned LP goes through the
    EllMatrix.  ``device`` defaults to ``cuda``.

    The EllMatrix depends only on the rows and the padding, and the B&B
    rebuilds the same one again and again: every refresh that only masks
    columns (the mask lives in c, not A) and every core-search child.  So,
    as in the JAX package, the operator is cached by an exact content key
    (``_ell_key``), at most four of them, the oldest dropped first; b, c and
    row_pad are built anew on every call.  A cached operator is shared by
    every LP built from the same rows, so no consumer writes into its
    tensors.  ``pad_standard_form_ell.builds`` and ``.hits`` count the
    operators built and reused.
    """
    device = resolve_device(device)
    m = len(row_data)
    n = n_struct + m
    if m_pad < m or n_pad < n:
        raise ValueError(f"padded dims ({m_pad},{n_pad}) smaller than real ({m},{n})")
    key = _ell_key(row_data, n_struct, m_pad, n_pad, device)
    with _ELL_CACHE_LOCK:
        A = _ELL_DEVICE_CACHE.get(key)
        if A is None:
            A = ell_from_rows(row_data, n_struct=n_struct, m_pad=m_pad, n_pad=n_pad, device=device)
            if len(_ELL_DEVICE_CACHE) >= 4:
                _ELL_DEVICE_CACHE.pop(next(iter(_ELL_DEVICE_CACHE)))
            _ELL_DEVICE_CACHE[key] = A
            pad_standard_form_ell.builds += 1
        else:
            pad_standard_form_ell.hits += 1
    bp = np.zeros(m_pad, dtype=np.float64)
    bp[:m] = rhs
    cp = np.ones(n_pad, dtype=np.float64)
    cp[:n_struct] = costs
    cp[n_struct:n] = 0.0
    return _padded_lp(A, bp, cp, m, n, n_struct, device)


pad_standard_form_ell.builds = 0
pad_standard_form_ell.hits = 0


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
