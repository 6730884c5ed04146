"""Host-side MILP base model: the mutable covering+cuts relaxation.

Functional counterpart of the reference's BaseRelaxationModel
(src/sypha_solver_heuristics.h:36-47) and its CSR-rebuild machinery
(reduce_base_model, src/sypha_solver_bnb.cpp:99-176).  Two deliberate
departures for the TPU build:

* Column "removal" is *masking*: the host tracks an ``active`` flag per
  structural column, and the device LP sees inactive columns with a large
  cost (they behave like the padding columns — driven to 0 by the IPM) so
  the padded LP shape stays identical for the whole B&B run (one compile).
  No oldToNew remapping of nodes/cuts is ever needed.
* Branch decisions and cuts become rows inside a pre-reserved row budget of
  the padded LP, rather than per-node CSR rebuilds + device uploads
  (reference build_branch_model, src/sypha_solver_bnb.cpp:418-490).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from sypha_tpu_torch.core.problem import ScpModel

# Cost assigned to masked (inactive) columns on the device LP.  Large enough
# that no optimal LP/MILP solution touches them, small enough to keep the
# problem well-scaled.
MASK_COST_FACTOR = 1e4


@dataclass
class Cut:
    """A >= cut over structural columns (CG cuts have integer coeffs/rhs)."""

    indices: np.ndarray  # int32 structural column indices
    values: np.ndarray  # float64 coefficients
    rhs: float
    kind: str = "cut"


@dataclass
class BranchDecision:
    var: int  # structural column index
    value: int  # 0 or 1


@dataclass
class BranchNode:
    """Node state (reference BranchNodeState, src/sypha_solver_heuristics.h:23-34).

    Unlike the reference there is no per-node cut list: because branch
    decisions are column fixings rather than appended rows, every cut a
    node's LP separates aggregates only ORIGINAL (global) rows and is
    therefore valid for the whole tree — the driver appends such cuts to
    the shared BaseModel (in-tree separation) instead of carrying them on
    the node (reference build_branch_model appends node-cut rows,
    src/sypha_solver_bnb.cpp:418-490)."""

    decisions: List[BranchDecision] = field(default_factory=list)
    depth: int = 0
    parent_dual_bound: float = -np.inf
    parent_dual_bound_raw: float = -np.inf
    # optional warm-start iterate (padded x, y, s from the parent solve)
    warm: Optional[tuple] = None
    # fractional LP value of the branched variable AT THE PARENT (set when
    # the child is created); feeds the pseudocost branching statistics —
    # the observed bound gain normalizes by the rounding distance
    branch_frac: float = -1.0

    def child(self, var: int, value: int) -> Optional["BranchNode"]:
        """append_decision_if_consistent (src/sypha_solver_bnb.cpp:335-348)."""
        for d in self.decisions:
            if d.var == var:
                return self if d.value == value else None
        return BranchNode(
            decisions=self.decisions + [BranchDecision(var, value)],
            depth=self.depth + 1,
            parent_dual_bound=self.parent_dual_bound,
            parent_dual_bound_raw=self.parent_dual_bound_raw,
        )


class BaseModel:
    """The current relaxation: covering rows + global cuts over structural
    columns, with an activity mask for presolve-removed columns."""

    def __init__(self, model: ScpModel):
        self.nrows_cover = model.nrows
        self.ncols = model.ncols
        self.costs = model.costs.astype(np.float64).copy()
        # rows_by_col[j]: sorted covering-row indices of column j
        rows_by_col: List[List[int]] = [[] for _ in range(model.ncols)]
        for i, cols in enumerate(model.rows):
            for j in cols:
                rows_by_col[j].append(i)
        self.rows_by_col = [np.asarray(r, dtype=np.int32) for r in rows_by_col]
        self.cols_by_row = [np.asarray(r, dtype=np.int32) for r in model.rows]
        self.active = np.ones(model.ncols, dtype=bool)
        self.cuts: List[Cut] = []
        # bitset row masks per column for fast subset/union checks
        self._nwords = (model.nrows + 63) // 64
        self.col_masks = np.zeros((model.ncols, self._nwords), dtype=np.uint64)
        for j, rows in enumerate(self.rows_by_col):
            w, b = np.divmod(rows.astype(np.int64), 64)
            np.bitwise_or.at(self.col_masks[j], w, np.uint64(1) << b.astype(np.uint64))

    # ---------- masking (replaces reference column removal/remap) ----------

    def deactivate(self, cols: np.ndarray) -> int:
        """Mask columns out of the model; returns how many were newly masked."""
        cols = np.asarray(cols, dtype=np.int64)
        newly = self.active[cols].sum()
        self.active[cols] = False
        return int(newly)

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def effective_costs(self) -> np.ndarray:
        """Costs the device LP sees: masked columns get a large cost."""
        out = self.costs.copy()
        mask_cost = MASK_COST_FACTOR * max(1.0, float(self.costs.max()))
        out[~self.active] = mask_cost
        return out

    # ---------- standard form for the device ----------

    @property
    def nrows(self) -> int:
        """All relaxation rows: covering + global cuts."""
        return self.nrows_cover + len(self.cuts)

    def row_arrays(self) -> List[Tuple[np.ndarray, np.ndarray, float]]:
        """All rows as (indices, values, rhs) over structural columns."""
        rows = [
            (r, np.ones(len(r), dtype=np.float64), 1.0) for r in self.cols_by_row
        ]
        rows += [(c.indices, c.values, float(c.rhs)) for c in self.cuts]
        return rows

    def standard_form(
        self, node: Optional[BranchNode] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Dense standard form [A | -I] including global cuts and (optionally)
        a node's branch/cut rows.  Returns (A, b, c, n_struct)."""
        rows = self.row_arrays()
        if node is not None:
            for d in node.decisions:
                coeff = -1.0 if d.value == 0 else 1.0
                rows.append(
                    (
                        np.asarray([d.var], dtype=np.int32),
                        np.asarray([coeff], dtype=np.float64),
                        float(d.value),
                    )
                )

        m = len(rows)
        n0 = self.ncols
        n = n0 + m
        A = np.zeros((m, n), dtype=np.float64)
        b = np.empty(m, dtype=np.float64)
        for i, (idx, val, rhs) in enumerate(rows):
            A[i, idx] = val
            A[i, n0 + i] = -1.0
            b[i] = rhs
        c = np.concatenate([self.effective_costs(), np.zeros(m)])
        return A, b, c, n0

    def add_cuts(self, cuts: List[Cut]) -> None:
        self.cuts.extend(cuts)
        self._rel_cache = None

    def rel_csr(self):
        """All relaxation rows (covering + global cuts) as a scipy CSR over
        structural columns, plus the rhs vector.  Cached until cuts change."""
        import scipy.sparse

        cache = getattr(self, "_rel_cache", None)
        if cache is not None:
            return cache
        rows = self.row_arrays()
        indptr = np.zeros(len(rows) + 1, dtype=np.int64)
        for i, (idx, _, _) in enumerate(rows):
            indptr[i + 1] = indptr[i] + len(idx)
        indices = np.concatenate([idx for idx, _, _ in rows]) if rows else np.zeros(0, np.int32)
        data = np.concatenate([val for _, val, _ in rows]) if rows else np.zeros(0)
        rhs = np.asarray([r for _, _, r in rows], dtype=np.float64)
        A = scipy.sparse.csr_matrix(
            (data, indices, indptr), shape=(len(rows), self.ncols)
        )
        self._rel_cache = (A, rhs)
        return self._rel_cache

    # ---------- queries used by presolve/heuristics ----------

    def coverage_of(self, chosen: np.ndarray) -> np.ndarray:
        """Coverage count per covering row for a 0/1 structural solution."""
        cov = np.zeros(self.nrows_cover, dtype=np.float64)
        for j in np.flatnonzero(chosen > 0.5):
            cov[self.rows_by_col[j]] += 1.0
        return cov

    def is_cover(self, chosen: np.ndarray, tol: float = 1e-9) -> bool:
        if not np.all(self.coverage_of(chosen) + tol >= 1.0):
            return False
        # cuts must also hold for a valid incumbent of the cut model; cuts
        # are valid inequalities for all integer covers, so checking covering
        # rows suffices for feasibility of the original SCP.
        return True

    def objective_of(self, chosen: np.ndarray) -> float:
        return float(self.costs @ (chosen > 0.5))
