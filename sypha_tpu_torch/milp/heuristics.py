"""Integer heuristics + branch-variable selectors.

Vectorised rewrites of the reference strategy objects
(src/sypha_solver_heuristics.cpp): NearestIntegerFixingHeuristic (:53-110),
DualGuidedCoverRepairHeuristic (:112-342), MostFractionalSelector (:10-30),
HighestCostFractionalSelector (:32-51).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from sypha_tpu_torch.milp.base_model import BaseModel, BranchNode


@dataclass
class HeuristicResult:
    name: str
    feasible: bool = False
    objective: float = np.inf
    solution: np.ndarray = field(default_factory=lambda: np.zeros(0))
    # sampling heuristics optionally keep their best distinct covers here
    # as (objective, x) pairs, ascending — the core-search phase unions
    # their supports into the restricted column set
    pool: list = field(default_factory=list)


def _apply_decisions(x: np.ndarray, node: Optional[BranchNode]):
    fixed_zero = np.zeros(len(x), dtype=bool)
    fixed_one = np.zeros(len(x), dtype=bool)
    if node is not None:
        for d in node.decisions:
            if 0 <= d.var < len(x):
                x[d.var] = float(d.value)
                (fixed_one if d.value == 1 else fixed_zero)[d.var] = True
    return fixed_zero, fixed_one


def nearest_integer_fixing(
    model: BaseModel,
    relaxed_primal: np.ndarray,
    relaxed_dual: np.ndarray,
    node: Optional[BranchNode] = None,
    tol: float = 1e-6,
) -> HeuristicResult:
    """Round the LP point, apply branch fixings, accept iff it covers
    (reference :53-110).  CG cuts are valid for every integer cover, so
    checking the covering rows suffices."""
    out = HeuristicResult("nearest_integer_fixing")
    x = np.clip(np.floor(relaxed_primal[: model.ncols] + 0.5), 0.0, 1.0)
    _apply_decisions(x, node)
    A, rhs = model.rel_csr()
    if np.all(A @ x + tol >= rhs):
        out.feasible = True
        out.solution = x
        out.objective = float(model.costs @ x)
    else:
        out.solution = x
    return out


def dual_guided_cover_repair(
    model: BaseModel,
    relaxed_primal: np.ndarray,
    relaxed_dual: np.ndarray,
    node: Optional[BranchNode] = None,
    tol: float = 1e-6,
    thorough: bool = True,
) -> HeuristicResult:
    """Multi-threshold repair: seed with x >= threshold for several
    thresholds (the reference uses only 1-tol, :163-168; different interior
    points seed very different covers, and incumbent quality drives the
    budget-pruning reductions that close the tree), repair each greedily by
    (uncoveredGain + dualGain)/cost, remove redundancy in reverse cost
    order, return the best."""
    best = HeuristicResult("dual_guided_cover_repair")
    thresholds = (1.0 - tol, 0.9, 0.5, 0.3) if thorough else (1.0 - tol, 0.5)
    for threshold in thresholds:
        cand = _repair_from_threshold(
            model, relaxed_primal, relaxed_dual, node, tol, threshold
        )
        if cand.feasible and cand.objective < best.objective:
            best = cand
    return best


def _repair_from_threshold(
    model: BaseModel,
    relaxed_primal: np.ndarray,
    relaxed_dual: np.ndarray,
    node: Optional[BranchNode],
    tol: float,
    threshold: float,
) -> HeuristicResult:
    out = HeuristicResult("dual_guided_cover_repair")
    n = model.ncols
    A, rhs = model.rel_csr()
    nrows = A.shape[0]
    dual = np.maximum(0.0, relaxed_dual[:nrows]) if len(relaxed_dual) >= nrows else np.zeros(nrows)

    x = np.zeros(n)
    x[relaxed_primal[:n] >= threshold] = 1.0
    fixed_zero, fixed_one = _apply_decisions(x, node)

    coverage = A @ x
    for _ in range(n + 1):
        uncovered = coverage + tol < rhs
        if not uncovered.any():
            break
        Au = A[uncovered]
        gain = np.asarray(Au.maximum(0).sum(axis=0)).ravel()
        dual_gain = Au.maximum(0).T @ dual[uncovered]
        score = (gain + dual_gain) / np.maximum(1e-9, model.costs)
        # masked (inactive) columns stay selectable: every masking rule
        # (dominance, budget pruning, reduced-cost fixing, core restriction)
        # preserves cover FEASIBILITY of the masked columns — only
        # better-than-incumbent membership — and incumbents are filtered by
        # objective at adoption.  Restricting the repair pool to active
        # columns cost scp52 its optimal 302 incumbent (stalled at 306).
        score[(x > 0.5) | fixed_zero | (gain <= 0.0)] = -np.inf
        best = int(np.argmax(score))
        if not np.isfinite(score[best]):
            # fallback: cheapest selectable column on any uncovered row
            cand = np.flatnonzero((gain > 0) & ~fixed_zero & (x <= 0.5))
            if len(cand) == 0:
                return out
            best = int(cand[np.argmin(model.costs[cand])])
        x[best] = 1.0
        coverage = A @ x
    else:
        return out

    # redundancy removal, most expensive first (never drop fixed-to-1 vars)
    chosen = np.flatnonzero((x > 0.5) & ~fixed_one)
    for j in chosen[np.argsort(-model.costs[chosen], kind="stable")]:
        x[j] = 0.0
        coverage = A @ x
        if np.any(coverage + tol < rhs):
            x[j] = 1.0
            coverage = A @ x

    if np.any(A @ x + tol < rhs):
        return out
    out.feasible = True
    out.solution = x
    out.objective = float(model.costs @ x)
    return out


_ILS_SEED = 987654321


def local_search_improve(
    model: BaseModel,
    x0: np.ndarray,
    tol: float = 1e-9,
    max_rounds: int = 4,
    time_budget_sec: float = 2.0,
):
    """1-column-removal local search on an incumbent cover (no reference
    counterpart): for each selected column (most expensive first), drop it,
    greedily re-cover the rows it uniquely covered with the cheapest
    active columns, and keep the move if the total cost drops; finish each
    round with redundancy elimination.  Pure host numpy over the COVERING
    rows only (conditional cut rows must not constrain incumbents),
    bounded by ``time_budget_sec`` of wall time (on 5000-column instances
    an unbounded sweep once cost ~1 min per incumbent and blew the hard
    time limit).  Returns (x, objective) — x0 itself if no improvement."""
    import time as _time

    t_end = _time.monotonic() + time_budget_sec
    A_all, rhs_all = model.rel_csr()
    A = A_all[: model.nrows_cover]
    rhs = rhs_all[: model.nrows_cover]
    x = (np.asarray(x0[: model.ncols]) > 0.5).astype(np.float64)
    if np.any(A @ x + tol < rhs):
        return x0, float(model.costs @ (x0 > 0.5))
    best_cost = float(model.costs @ x)

    for _ in range(max_rounds):
        improved = False
        sel = np.flatnonzero(x > 0.5)
        for j in sel[np.argsort(-model.costs[sel], kind="stable")]:
            if _time.monotonic() >= t_end:
                return x, best_cost
            x_try = x.copy()
            x_try[j] = 0.0
            cov = A @ x_try
            cost_try = best_cost - model.costs[j]
            ok = True
            for _ in range(model.ncols):
                uncovered = cov + tol < rhs
                if not uncovered.any():
                    break
                Au = A[uncovered]
                gain = np.asarray(Au.sum(axis=0)).ravel()
                cand = (gain > 0) & model.active & (x_try <= 0.5)
                cand[j] = False
                if not cand.any():
                    ok = False
                    break
                score = np.where(
                    cand, gain / np.maximum(1e-9, model.costs), -np.inf
                )
                k = int(np.argmax(score))
                x_try[k] = 1.0
                cost_try += model.costs[k]
                if cost_try >= best_cost - tol:
                    ok = False
                    break
                cov = A @ x_try
            if ok and not np.any(A @ x_try + tol < rhs) and cost_try < best_cost - tol:
                x, best_cost = x_try, cost_try
                improved = True
        # redundancy elimination, most expensive first
        sel = np.flatnonzero(x > 0.5)
        for j in sel[np.argsort(-model.costs[sel], kind="stable")]:
            x[j] = 0.0
            if np.any(A @ x + tol < rhs):
                x[j] = 1.0
            else:
                best_cost -= model.costs[j]
                improved = True
        if not improved:
            break

    # iterated local search: spend any remaining budget on random
    # 3-column perturbations + greedy repair, keeping improvements
    # (classic ILS for SCP; helps most on the large unicost-ish families
    # where the 1-removal neighborhood is too small).  The seed advances
    # per call so repeated polishes of the same incumbent explore
    # different perturbations.
    global _ILS_SEED
    _ILS_SEED = (_ILS_SEED * 1103515245 + 12345) % (2**31)
    rng = np.random.RandomState(_ILS_SEED)
    # Stop after a run of non-improving perturbations instead of burning
    # the whole budget: on easy instances (scp4x-class) the 3-column
    # neighborhood dries up in ~0.1 s and the remaining ~1.9 s per adopt
    # was the largest single slice of the measured 5.5 s easy-root floor
    # (VERDICT r2 weak #3).  Large unicost faces never reach the cap
    # inside the budget, so their behavior is unchanged.
    stale = 0
    while _time.monotonic() < t_end and stale < 64:
        stale += 1
        sel = np.flatnonzero(x > 0.5)
        if len(sel) <= 3:
            break
        x_try = x.copy()
        x_try[rng.choice(sel, size=3, replace=False)] = 0.0
        cov = A @ x_try
        cost_try = float(model.costs @ x_try)
        ok = True
        for _ in range(model.ncols):
            uncovered = cov + tol < rhs
            if not uncovered.any():
                break
            Au = A[uncovered]
            gain = np.asarray(Au.sum(axis=0)).ravel()
            cand = (gain > 0) & model.active & (x_try <= 0.5)
            if not cand.any():
                ok = False
                break
            score = np.where(cand, gain / np.maximum(1e-9, model.costs), -np.inf)
            k = int(np.argmax(score))
            x_try[k] = 1.0
            cost_try += model.costs[k]
            if cost_try >= best_cost - tol:
                ok = False
                break
            cov = A @ x_try
        if ok and not np.any(A @ x_try + tol < rhs) and cost_try < best_cost - tol:
            # redundancy-eliminate the improved cover
            sel2 = np.flatnonzero(x_try > 0.5)
            for j in sel2[np.argsort(-model.costs[sel2], kind="stable")]:
                x_try[j] = 0.0
                if np.any(A @ x_try + tol < rhs):
                    x_try[j] = 1.0
                else:
                    cost_try -= model.costs[j]
            x, best_cost = x_try, cost_try
            stale = 0
    return x, best_cost


def lagrangian_greedy_covers(
    model: BaseModel,
    dual: np.ndarray,
    node: Optional[BranchNode] = None,
    tol: float = 1e-9,
    time_budget_sec: float = 4.0,
    max_samples: int = 48,
    best_known: float = np.inf,
    seed: int = 20240817,
    keep_pool: int = 0,
) -> HeuristicResult:
    """CFT Lagrangian heuristic (Caprara–Fischetti–Toth, the classic
    large-SCP primal machinery; no reference counterpart), two phases:

    1. **Subgradient ascent** on the Lagrangian dual L(u) = sum_i u_i +
       sum_j min(0, c_j - sum_{i in col j} u_i), Held–Karp step sizing
       lam * (UB - L) / ||g||^2 with g = rhs - A x̂(u), lam halved after 15
       non-improving iterations.  The LP duals seed u (for SCP the
       Lagrangian dual has the integrality property, so they are already
       near-optimal) — the point of the ascent is the *trajectory*: each
       iterate is a structurally different near-optimal multiplier vector.
    2. **Greedy covers along the trajectory** (every iterate that improves
       L, plus multiplicative perturbation samples around the best u) with
       the CFT score
           gamma_j = c_j - sum_{i uncovered, i in col j} u_i,
           score_j = gamma_j / mu_j  if gamma_j > 0  else  gamma_j * mu_j
       (mu_j = uncovered-row mass column j covers), then
       redundancy-eliminate.

    Masked (inactive) columns stay selectable — every masking rule
    preserves cover feasibility (see dual_guided_cover_repair).  Host
    numpy over the covering rows only, wall-clock bounded."""
    import time as _time

    t_end = _time.monotonic() + time_budget_sec
    out = HeuristicResult("lagrangian_greedy")
    A_all, rhs_all = model.rel_csr()
    A = A_all[: model.nrows_cover].tocsr()
    rhs = rhs_all[: model.nrows_cover]
    m, n = A.shape
    costs = model.costs
    u0 = np.maximum(0.0, np.asarray(dual[:m], dtype=np.float64))
    if len(u0) < m or not np.isfinite(u0).all():
        return out

    fixed_zero = np.zeros(n, dtype=bool)
    fixed_one = np.zeros(n, dtype=bool)
    if node is not None:
        for d in node.decisions:
            if 0 <= d.var < n:
                (fixed_one if d.value == 1 else fixed_zero)[d.var] = True
    blocked = fixed_zero

    best_x, best_cost = None, best_known

    # Incremental greedy state (unit-rhs covering rows): adding column j
    # covers its rows once; a row's FIRST cover removes it from every
    # containing column's uncovered-mass mu and u-mass w.  Total update
    # work per cover is O(nnz of the touched rows) — the previous
    # implementation re-sliced A[uncovered] and re-ran two SpMV-shaped
    # products per STEP (~60x more), which capped the 1000x10000 nrg/nrh
    # instances at ~40 Lagrangian samples inside the 5 s budget.
    rows_by_col = getattr(model, "rows_by_col", None)
    cols_by_row = getattr(model, "cols_by_row", None)
    unit_rhs = bool(np.all(np.abs(rhs - 1.0) < 1e-12))
    if rows_by_col is None or cols_by_row is None or not unit_rhs:
        return out  # non-unit covering shape; callers all pass BaseModel
    deg0 = np.asarray([len(r) for r in rows_by_col], dtype=np.float64)

    def greedy(u: np.ndarray, init_cols: Optional[np.ndarray] = None):
        nonlocal best_x, best_cost
        x = np.zeros(n, dtype=bool)
        cov = np.zeros(m, dtype=np.int32)
        mu = deg0.copy()
        w = np.asarray(A.T @ u).ravel()  # one SpMV per sample, not per step
        cost = 0.0
        n_unc = m

        def add(j: int) -> float:
            nonlocal n_unc
            rj = rows_by_col[j]
            newly = rj[cov[rj] == 0]
            cov[rj] += 1
            n_unc -= len(newly)
            for r in newly:
                cr = cols_by_row[r]
                mu[cr] -= 1.0
                w[cr] -= u[r]
            return float(costs[j])

        start = np.flatnonzero(fixed_one)
        if init_cols is not None:
            start = np.union1d(start, init_cols)
        for j in start:
            x[j] = True
            cost += add(int(j))
        ok = True
        while n_unc > 0:
            gamma = costs - w
            score = np.where(
                gamma > 0.0, gamma / np.maximum(mu, 1e-12), gamma * mu
            )
            score[(mu <= 0.0) | x | blocked] = np.inf
            j = int(np.argmin(score))
            if not np.isfinite(score[j]):
                ok = False
                break
            x[j] = True
            cost += add(j)
        if not ok or n_unc > 0:
            return
        # redundancy elimination, most expensive first (keep fixed-to-1):
        # j is droppable iff every row it covers has coverage >= 2
        sel = np.flatnonzero(x & ~fixed_one)
        for j in sel[np.argsort(-costs[sel], kind="stable")]:
            rj = rows_by_col[j]
            if np.all(cov[rj] >= 2):
                x[j] = False
                cov[rj] -= 1
                cost -= float(costs[j])
        xf = x.astype(np.float64)
        if keep_pool > 0:
            out.pool.append((cost, xf))
        if cost < best_cost - 1e-9:
            best_x, best_cost = xf, cost


    # ---- phase 1: subgradient ascent, greedy on L-improving iterates ----
    ub_target = best_known if np.isfinite(best_known) else float(costs.sum())
    u, lam, best_L, u_best, nonimp = u0.copy(), 0.1, -np.inf, u0.copy(), 0
    greedy_budget = max(2, max_samples // 2)
    greedies = 0
    for _ in range(40 * greedy_budget):
        if _time.monotonic() >= t_end or greedies >= greedy_budget:
            break
        gamma = costs - (u @ A)
        xhat = (gamma < 0.0) & model.active & ~fixed_zero
        xhat |= fixed_one
        L = float(u @ rhs) + float(gamma[xhat].sum())
        if L > best_L + 1e-9:
            best_L, u_best, nonimp = L, u.copy(), 0
            greedy(u)
            greedies += 1
        else:
            nonimp += 1
            if nonimp >= 15:
                lam, nonimp = 0.5 * lam, 0
                if lam < 1e-4:
                    break
        g = rhs - A @ xhat.astype(np.float64)
        denom = float(g @ g)
        if denom <= 1e-12:
            break  # x̂ satisfies every row exactly: L is dual-optimal here
        u = np.maximum(0.0, u + (lam * max(ub_target - L, 0.1) / denom) * g)

    # ---- phase 2: perturbation samples around the best multipliers ----
    rng = np.random.RandomState(seed)
    deltas = (0.0, 0.05, 0.1, 0.15, 0.2, 0.3)
    # reserve a slice of the budget for phase 3's neighborhood refinement
    t_p2 = t_end - 0.25 * max(0.0, t_end - _time.monotonic())
    # stagnation exit: easy instances find their best cover within the
    # first dozens of samples and then burn the whole budget confirming it
    # (scp51: 15 s spent after 253 = the optimum was already in hand);
    # 250 samples without improvement is far past the measured point of
    # diminishing returns on nrg/nrh while ~10x cheaper on scp4/5-class
    stale = 0
    for k in range(max_samples):
        if _time.monotonic() >= t_p2 or stale >= 250:
            break
        delta = deltas[k % len(deltas)]
        u = u_best if delta == 0.0 else u_best * (1.0 + rng.uniform(-delta, delta, m))
        prev = best_cost
        greedy(u)
        stale = 0 if best_cost < prev - 1e-9 else stale + 1

    # ---- phase 3: large-neighborhood refinement of the best cover ----
    # destroy a random fifth-to-third of the incumbent's columns and
    # re-cover greedily under perturbed multipliers (classic SCP LNS);
    # with the incremental greedy each repair costs ~one sample, and the
    # search concentrates where phase 2's independent samples cannot —
    # inside the incumbent's own neighborhood.
    stale = 0
    while best_x is not None and _time.monotonic() < t_end and stale < 150:
        sel = np.flatnonzero(best_x > 0.5)
        if len(sel) < 4:
            break
        frac = rng.uniform(0.2, 0.35)
        kill = rng.choice(
            sel, size=max(2, int(frac * len(sel))), replace=False
        )
        keep = np.setdiff1d(sel, kill)
        u = u_best * (1.0 + rng.uniform(-0.15, 0.15, m))
        prev = best_cost
        greedy(u, init_cols=keep)
        stale = 0 if best_cost < prev - 1e-9 else stale + 1

    if keep_pool > 0 and out.pool:
        out.pool.sort(key=lambda t: t[0])
        out.pool = out.pool[:keep_pool]
    if best_x is not None:
        out.feasible = True
        out.solution = best_x
        out.objective = best_cost
    return out


_HEURISTICS = {
    "nearest_integer_fixing": nearest_integer_fixing,
    "dual_guided_cover_repair": dual_guided_cover_repair,
}


def run_heuristics(
    model: BaseModel,
    configured: str,
    relaxed_primal: np.ndarray,
    relaxed_dual: np.ndarray,
    node: Optional[BranchNode] = None,
    tol: float = 1e-6,
    thorough: bool = True,
) -> List[HeuristicResult]:
    """``thorough=False`` runs the cheap 2-threshold repair — the in-tree
    per-node setting; roots and periodic nodes get the full 4 thresholds."""
    tokens = [t.strip().lower() for t in configured.split(",") if t.strip()]
    if not tokens:
        tokens = ["nearest_integer_fixing", "dual_guided_cover_repair"]
    out = []
    for t in tokens:
        fn = _HEURISTICS.get(t)
        if fn is dual_guided_cover_repair:
            out.append(fn(model, relaxed_primal, relaxed_dual, node, tol, thorough))
        elif fn is not None:
            out.append(fn(model, relaxed_primal, relaxed_dual, node, tol))
    return out


def fractional_candidates(x: np.ndarray, ncols: int, tol: float) -> np.ndarray:
    """collect_fractional_candidates (src/sypha_solver_bnb.cpp:368-382)."""
    v = x[:ncols]
    nearest = np.floor(v + 0.5)
    frac = np.abs(v - nearest) > tol
    out_of_bounds = (nearest < -tol) | (nearest > 1.0 + tol)
    return np.flatnonzero(frac | out_of_bounds)


def select_branch_variable(
    strategy: str, x: np.ndarray, costs: np.ndarray, candidates: np.ndarray
) -> int:
    if len(candidates) == 0:
        return -1
    if strategy == "highest_cost_fractional":
        return int(candidates[np.argmax(costs[candidates])])
    # most_fractional (default)
    frac = np.abs(x[candidates] - np.floor(x[candidates] + 0.5))
    return int(candidates[np.argmax(frac)])


def is_binary_integral(x: np.ndarray, ncols: int, tol: float) -> bool:
    """is_binary_integral_solution (src/sypha_solver_bnb.cpp:350-366)."""
    v = x[:ncols]
    nearest = np.floor(v + 0.5)
    return bool(
        np.all(np.abs(v - nearest) <= tol)
        and np.all(nearest >= -tol)
        and np.all(nearest <= 1.0 + tol)
    )
