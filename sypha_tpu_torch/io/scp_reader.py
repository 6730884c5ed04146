"""SCP instance reader (OR-Library / sypha text format).

Format:
  token 1, 2: nrows ncols
  next ncols tokens: column costs
  then per row: a count k followed by k 1-based column indices.
Tokens may be split across lines arbitrarily; we parse a flat token stream.

The port of sypha_tpu/io/scp_reader.py: ``read_scp_file`` first tries the
native C++ reader (sypha_tpu_torch.native) and falls back to the Python
tokenizer ``parse_scp_text``.  Both give the same ScpModel.
"""

from __future__ import annotations

import os

import numpy as np

from sypha_tpu_torch.core.problem import ScpModel


def parse_scp_text(text: str, name: str = "") -> ScpModel:
    it = iter(text.split())

    def tok() -> str:
        try:
            return next(it)
        except StopIteration:
            raise ValueError(f"SCP parse error in '{name}': unexpected end of file")

    nrows = int(tok())
    ncols = int(tok())
    if nrows <= 0 or ncols <= 0:
        raise ValueError(f"SCP parse error in '{name}': bad dimensions {nrows}x{ncols}")

    costs = np.empty(ncols, dtype=np.float64)
    for j in range(ncols):
        costs[j] = float(tok())

    rows = []
    for i in range(nrows):
        k = int(tok())
        idx = np.empty(k, dtype=np.int32)
        for t in range(k):
            v = int(tok()) - 1  # on-disk indices are 1-based
            if not 0 <= v < ncols:
                raise ValueError(
                    f"SCP parse error in '{name}': row {i} column index {v + 1} "
                    f"out of range 1..{ncols}"
                )
            idx[t] = v
        rows.append(np.unique(idx))  # dedupe + sort; duplicates would double coefficients

    return ScpModel(nrows=nrows, ncols=ncols, costs=costs, rows=rows, name=name)


def read_scp_file(path: str) -> ScpModel:
    name = os.path.splitext(os.path.basename(path))[0]

    # the native reader of csrc/sypha_host.cpp when the library is
    # available, else the Python tokenizer; both give the same model
    from sypha_tpu_torch import native

    parsed = native.read_scp_file_native(path)
    if parsed is not None:
        costs, row_ptr, row_idx, nrows, ncols = parsed
        rows = [np.unique(row_idx[row_ptr[i] : row_ptr[i + 1]]) for i in range(nrows)]
        return ScpModel(nrows=nrows, ncols=ncols, costs=costs, rows=rows, name=name)

    with open(path, "r") as f:
        text = f.read()
    return parse_scp_text(text, name=name)
