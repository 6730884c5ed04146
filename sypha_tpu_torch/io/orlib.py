"""OR-Library-style SCP parser (reference benchmark/scp_parser.py:11-72).

The port of sypha_tpu/io/orlib.py.  The on-disk token stream is the same as
the sypha format (``nrows ncols``, column costs, then per-row counts +
1-based column indices); this module provides the benchmark harness's
*set-wise* view of it: ``{'num_sets', 'num_elements', 'costs', 'sets'}``
where ``sets[j]`` lists the (1-based) elements column j covers.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from sypha_tpu_torch.core.problem import ScpModel
from sypha_tpu_torch.io.scp_reader import read_scp_file


def parse_scp_file(filepath: str) -> Dict:
    """Benchmark-harness-compatible dict view of an SCP instance."""
    model = read_scp_file(filepath)
    sets: List[List[int]] = [[] for _ in range(model.ncols)]
    for elem, cols in enumerate(model.rows, start=1):
        for j in cols:
            sets[int(j)].append(elem)
    return {
        "num_sets": model.ncols,
        "num_elements": model.nrows,
        "costs": [float(c) for c in model.costs],
        "sets": sets,
    }


def orlib_to_model(parsed: Dict, name: str = "") -> ScpModel:
    """Inverse view: benchmark dict -> ScpModel."""
    nrows = parsed["num_elements"]
    ncols = parsed["num_sets"]
    rows: List[List[int]] = [[] for _ in range(nrows)]
    for j, elems in enumerate(parsed["sets"]):
        for e in elems:
            rows[e - 1].append(j)
    return ScpModel(
        nrows=nrows,
        ncols=ncols,
        costs=np.asarray(parsed["costs"], dtype=np.float64),
        rows=[np.asarray(sorted(r), dtype=np.int32) for r in rows],
        name=name,
    )
