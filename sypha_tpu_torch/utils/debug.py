"""Debug matrix/vector printers (reference utils_printDmat/Dvec/Ivec,
src/common.cpp:6-91, with its 1e-20 zero clamp).

The port of sypha_tpu/utils/debug.py.  Both printers take numpy arrays and
tensors on any device (a tensor is copied to the host first)."""

from __future__ import annotations

import sys

import numpy as np
import torch

ZERO_CLAMP = 1e-20  # reference src/common.cpp prints |v| < 1e-20 as 0


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def print_mat(M, name: str = "", max_rows: int = 16, max_cols: int = 16, file=None):
    """Pretty-print a (host or device) matrix with the zero clamp."""
    file = file or sys.stderr
    M = _host(M)
    if name:
        print(f"{name} [{M.shape[0]}x{M.shape[1]}]:", file=file)
    r = min(max_rows, M.shape[0])
    c = min(max_cols, M.shape[1])
    for i in range(r):
        vals = [0.0 if abs(v) < ZERO_CLAMP else float(v) for v in M[i, :c]]
        tail = " ..." if c < M.shape[1] else ""
        print("  " + " ".join(f"{v:10.4g}" for v in vals) + tail, file=file)
    if r < M.shape[0]:
        print("  ...", file=file)


def print_vec(v, name: str = "", max_elems: int = 32, file=None):
    file = file or sys.stderr
    v = _host(v).ravel()
    k = min(max_elems, len(v))
    vals = [0.0 if abs(x) < ZERO_CLAMP else float(x) for x in v[:k]]
    tail = " ..." if k < len(v) else ""
    head = f"{name} [{len(v)}]: " if name else ""
    print(head + " ".join(f"{x:.6g}" for x in vals) + tail, file=file)
