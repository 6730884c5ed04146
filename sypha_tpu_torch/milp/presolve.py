"""SCP presolve: greedy cover + column-elimination rules.

Vectorised (bitset / numpy) reimplementation of the reference's rule objects
(src/sypha_preprocessor.cpp): greedy_set_cover_heuristic (:11-98),
SingleColumnDominanceRule (:217-266), TwoColumnDominanceRule (:268-337),
CostDrivenReplacementRule (:338-488), IncumbentBudgetPruningRule (:490-665).
All rules are deadline-bounded like the reference
(--preprocess-time-limit-sec, default 5 s).

Deliberate deviations (documented):
* Pair/triplet searches restrict candidates to columns sharing a row with
  the target (the reference's cost_driven rule does this; its two_column
  rule scans all pairs — the restricted search finds the same dominations
  once single-column dominance has run, in a fraction of the time).
* Columns are masked via BaseModel.deactivate instead of CSR rebuilds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from sypha_tpu_torch.milp.base_model import BaseModel


@dataclass
class GreedyResult:
    feasible: bool = False
    objective: float = np.inf
    selected: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))


def greedy_set_cover(model: BaseModel) -> GreedyResult:
    """Sort active columns by (cost, -coverage, index); single greedy sweep
    adding any column that covers an uncovered row
    (reference src/sypha_preprocessor.cpp:11-98)."""
    from sypha_tpu_torch import native

    res = native.greedy_set_cover(model)
    if res is not None:
        obj, selected = res
        if np.isfinite(obj):
            return GreedyResult(True, obj, selected)
        return GreedyResult()

    act = np.flatnonzero(model.active)
    if len(act) == 0:
        return GreedyResult()
    coverage = np.array([len(model.rows_by_col[j]) for j in act])
    order = act[np.lexsort((act, -coverage, model.costs[act]))]

    covered = np.zeros(model.nrows_cover, dtype=bool)
    uncovered = model.nrows_cover
    total = 0.0
    selected = []
    for j in order:
        if uncovered <= 0:
            break
        rows = model.rows_by_col[j]
        new = ~covered[rows]
        if new.any():
            covered[rows] = True
            uncovered -= int(new.sum())
            total += model.costs[j]
            selected.append(j)

    if uncovered == 0:
        return GreedyResult(True, total, np.asarray(selected, dtype=np.int64))
    return GreedyResult()


def _subset_mask(target_mask: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """For each row of ``masks``: does it contain every bit of target_mask?"""
    return ~np.any(target_mask[None, :] & ~masks, axis=1)


class _Deadline:
    def __init__(self, seconds: Optional[float]):
        self.t_end = time.monotonic() + seconds if seconds and seconds > 0 else None

    def expired(self) -> bool:
        return self.t_end is not None and time.monotonic() >= self.t_end

    def remaining(self) -> float:
        """Seconds left (0 disables for the native rules' convention)."""
        if self.t_end is None:
            return 0.0
        return max(1e-9, self.t_end - time.monotonic())


def single_column_dominance(model: BaseModel, tol: float, dl: _Deadline) -> int:
    """Column j is dominated when another active column covers a superset of
    its rows at cost <= cost_j (+tol); equal-cost ties keep the lower index
    (reference :217-266)."""
    from sypha_tpu_torch import native

    r = native.single_column_dominance(model, tol, dl.remaining())
    if r is not None:
        return r

    removed = 0
    costs = model.costs
    for target in range(model.ncols):
        if dl.expired():
            break
        if not model.active[target]:
            continue
        tmask = model.col_masks[target]
        cand = model.active.copy()
        cand[target] = False
        cand &= costs <= costs[target] + tol
        idx = np.flatnonzero(cand)
        if len(idx) == 0:
            continue
        covers = _subset_mask(tmask, model.col_masks[idx])
        if not covers.any():
            continue
        ok = idx[covers]
        # tie-break: equal cost only dominates from a lower index
        strictly_cheaper = costs[ok] < costs[target] - tol
        lower_index = ok < target
        if np.any(strictly_cheaper | lower_index):
            model.active[target] = False
            removed += 1
    return removed


def _row_sharing_candidates(model: BaseModel, target: int) -> np.ndarray:
    """Active columns (!= target) sharing at least one covering row with target."""
    rows = model.rows_by_col[target]
    if len(rows) == 0:
        return np.zeros(0, dtype=np.int64)
    cand = np.unique(np.concatenate([model.cols_by_row[r] for r in rows]))
    cand = cand[(cand != target) & model.active[cand]]
    return cand


def _pair_triplet_dominated(
    model: BaseModel,
    target: int,
    budget: float,
    cand: np.ndarray,
    triplets: bool,
    dl: _Deadline,
) -> bool:
    """Is some pair (or triplet) of candidates with total cost <= budget whose
    union covers the target's rows?  Candidates must be cost-sorted asc."""
    tmask = model.col_masks[target]
    costs = model.costs[cand]
    masks = model.col_masks[cand]
    n = len(cand)
    for i in range(n):
        if dl.expired():
            return False
        ci = costs[i]
        if ci > budget:
            break
        rem = tmask & ~masks[i]
        if not rem.any():
            continue  # single coverage is the single-column rule's job
        jmax = np.searchsorted(costs, budget - ci, side="right")
        if jmax > i + 1:
            sub = masks[i + 1 : jmax]
            hit = ~np.any(rem[None, :] & ~sub, axis=1)
            if hit.any():
                return True
        if triplets:
            for j in range(i + 1, n):
                cij = ci + costs[j]
                if cij > budget:
                    break
                rem2 = rem & ~masks[j]
                if not rem2.any():
                    continue
                kmax = np.searchsorted(costs, budget - cij, side="right")
                if kmax > j + 1:
                    sub = masks[j + 1 : kmax]
                    hit = ~np.any(rem2[None, :] & ~sub, axis=1)
                    if hit.any():
                        return True
    return False


def two_column_dominance(model: BaseModel, tol: float, dl: _Deadline) -> int:
    """Pair (a,b) with cost_a + cost_b < cost_target - tol covering the
    target's rows dominates it (reference :268-337)."""
    from sypha_tpu_torch import native

    r = native.two_column_dominance(model, tol, dl.remaining())
    if r is not None:
        return r

    removed = 0
    for target in range(model.ncols):
        if dl.expired():
            break
        if not model.active[target]:
            continue
        cand = _row_sharing_candidates(model, target)
        if len(cand) < 2:
            continue
        cand = cand[np.argsort(model.costs[cand], kind="stable")]
        budget = model.costs[target] - tol - 1e-300
        if _pair_triplet_dominated(model, target, budget, cand, False, dl):
            model.active[target] = False
            removed += 1
    return removed


def cost_driven_replacement(model: BaseModel, tol: float, dl: _Deadline) -> int:
    """Pair and triplet replacement, targets scanned most-expensive-first,
    with total cost <= cost_target + tol (reference :338-488)."""
    from sypha_tpu_torch import native

    r = native.cost_driven_replacement(model, tol, dl.remaining())
    if r is not None:
        return r

    removed = 0
    order = np.flatnonzero(model.active)
    order = order[np.argsort(-model.costs[order], kind="stable")]
    for target in order:
        if dl.expired():
            break
        if not model.active[target]:
            continue
        cand = _row_sharing_candidates(model, target)
        if len(cand) < 2:
            continue
        cand = cand[np.argsort(model.costs[cand], kind="stable")]
        budget = model.costs[target] + tol
        if _pair_triplet_dominated(model, target, budget, cand, True, dl):
            model.active[target] = False
            removed += 1
    return removed


def incumbent_budget_pruning(
    model: BaseModel,
    incumbent: float,
    tol: float = 1e-12,
    time_limit_sec: Optional[float] = 5.0,
) -> int:
    """Remove columns that cannot appear in any integer solution strictly
    better than the incumbent (reference IncumbentBudgetPruningRule,
    src/sypha_preprocessor.cpp:490-665): per column j, the remaining budget
    is floor(incumbent) - 1 - floor(cost_j); tiered exact checks for
    budget in {<0, 0, 1} and a max-of-min-row-cost lower bound for >= 2."""
    if not np.isfinite(incumbent):
        return 0
    dl = _Deadline(time_limit_sec)

    from sypha_tpu_torch import native

    r = native.budget_pruning(model, incumbent, tol, dl.remaining())
    if r is not None:
        return r

    removed = 0
    inc_floor = np.floor(incumbent)

    order = np.flatnonzero(model.active)
    order = order[np.argsort(-model.costs[order], kind="stable")]

    # cheapest active cost per covering row (recomputed lazily)
    def row_min_costs() -> np.ndarray:
        rm = np.full(model.nrows_cover, np.inf)
        for r in range(model.nrows_cover):
            cols = model.cols_by_row[r]
            cols = cols[model.active[cols]]
            if len(cols):
                rm[r] = model.costs[cols].min()
        return rm

    rmin = row_min_costs()
    stale = 0

    cost1 = np.flatnonzero(model.active & (np.abs(model.costs - 1.0) <= tol))
    full_mask = np.zeros(model._nwords, dtype=np.uint64)
    all_rows = np.arange(model.nrows_cover, dtype=np.int64)
    w, b = np.divmod(all_rows, 64)
    np.bitwise_or.at(full_mask, w, np.uint64(1) << b.astype(np.uint64))

    for target in order:
        if dl.expired():
            break
        if not model.active[target]:
            continue
        budget = inc_floor - 1.0 - np.floor(model.costs[target])
        if budget < -tol:
            model.active[target] = False
            removed += 1
            continue

        tmask = model.col_masks[target]
        uncovered_mask = full_mask & ~tmask
        if not uncovered_mask.any():
            continue  # covers everything on its own

        if budget < tol:  # budget == 0
            model.active[target] = False
            removed += 1
            stale += 1
            continue

        if budget < 1.0 + tol:  # budget == 1: one cost-1 column must finish the job
            c1 = cost1[model.active[cost1]]
            c1 = c1[c1 != target]
            found = (
                len(c1) > 0
                and _subset_mask(uncovered_mask, model.col_masks[c1]).any()
            )
            if not found:
                model.active[target] = False
                removed += 1
                stale += 1
            continue

        # budget >= 2: every uncovered row needs an affordable column, and the
        # max of per-row min costs must fit in the budget.
        if stale > 64:
            rmin = row_min_costs()
            stale = 0
        uncovered_rows = all_rows[
            (tmask[w] & (np.uint64(1) << b.astype(np.uint64))) == 0
        ]
        worst = rmin[uncovered_rows].max() if len(uncovered_rows) else 0.0
        if not np.isfinite(worst) or worst > budget + tol:
            model.active[target] = False
            removed += 1
            stale += 1
    return removed


_RULES = {
    "single_column_dominance": single_column_dominance,
    "single": single_column_dominance,
    "two_column_dominance": two_column_dominance,
    "pair": two_column_dominance,
    "two": two_column_dominance,
    "cost_driven_replacement": cost_driven_replacement,
    "cost_driven": cost_driven_replacement,
}


def apply_presolve_rules(
    model: BaseModel,
    strategies: str = "single_column_dominance,two_column_dominance",
    tol: float = 1e-12,
    time_limit_sec: Optional[float] = 5.0,
) -> int:
    """Apply the CSV-configured rule list (reference makeColumnPreprocessRules,
    src/sypha_preprocessor.cpp:669-712).  'none' disables everything."""
    tokens = [t.strip().lower() for t in strategies.split(",") if t.strip()]
    if "none" in tokens:
        return 0
    if not tokens:
        tokens = ["single_column_dominance", "two_column_dominance"]
    dl = _Deadline(time_limit_sec)
    removed = 0
    for t in tokens:
        rule = _RULES.get(t)
        if rule is None:
            continue
        removed += rule(model, tol, dl)
    return removed


def exact_small_cover(
    model: BaseModel,
    budget: float,
    time_limit_sec: float = 3.0,
    max_cols: int = 384,
    duals=None,
    cuts=None,
):
    """Implicit enumeration over the ACTIVE columns: find a cover with cost
    <= budget, or prove that none exists (no reference counterpart; host
    bitset DFS in the style of the presolve rules).

    The B&B driver calls this once reduced-cost fixing has shrunk the
    active set to the LP-optimal face at cutoff incumbent-1: on that face
    "is there an improving integer cover?" is a tiny exact problem, and
    answering it deterministically closes the last integer unit that
    plateau searches otherwise grind on (scp44/scp49-class flakiness).

    Returns (verdict, solution): verdict True = found (solution is a 0/1
    structural vector with cost <= budget); False = PROVEN none exists
    among active columns; None = inconclusive (timeout / too large).

    The native engine (csrc sypha_exact_cover, ~100x the Python DFS)
    handles the real faces; the Python implementation below is the
    documented fallback and the oracle the tests exercise both against.
    """
    import time as _time

    from sypha_tpu_torch import native

    # cuts (w, coef, rhs) arm the native engine's static cut-row Lagrangian
    # term; the Python fallback DFS below ignores them (its bounds are then
    # merely weaker — cuts never change which covers exist at the budget)
    nat = native.exact_cover(
        model, budget, time_limit_sec, duals=duals, cuts=cuts
    )
    if nat is not None:
        # the native engine ran: trust its verdict, including an
        # inconclusive (None, None) timeout — re-running the much slower
        # Python DFS would just burn the budget again
        return nat

    act = np.flatnonzero(model.active)
    if len(act) == 0:
        return False, None
    if len(act) > max_cols:
        return None, None
    t_end = _time.monotonic() + time_limit_sec
    nwords = model._nwords
    full = np.zeros(nwords, dtype=np.uint64)
    for r in range(model.nrows_cover):
        full[r >> 6] |= np.uint64(1) << np.uint64(r & 63)

    masks = model.col_masks[act]
    costs = model.costs[act]
    order = np.argsort(costs, kind="stable")
    masks, costs, act = masks[order], costs[order], act[order]
    k = len(act)

    # per-row candidate lists (indices into the sorted arrays, cost asc)
    by_row = [[] for _ in range(model.nrows_cover)]
    for i in range(k):
        for r in model.rows_by_col[act[i]]:
            by_row[r].append(i)
    # rows no active column covers => infeasible outright
    for r in range(model.nrows_cover):
        if not by_row[r]:
            return False, None
    # admissible per-row weights for the lower bound: spreading each
    # column's cost uniformly over its rows, any cover of the uncovered
    # set U pays at least sum_{r in U} min_j cost_j/|rows_j| — the
    # fractional-weight bound; also keep the max-of-min-cover-cost bound
    # and take the larger of the two per node
    row_min = np.array([costs[b[0]] for b in by_row])
    spread = np.array(
        [
            min(
                costs[i] / max(1, len(model.rows_by_col[act[i]]))
                for i in b
            )
            for b in by_row
        ]
    )
    best = None
    chosen: list = []
    calls = 0

    n_cands = np.array([len(b) for b in by_row])

    # LP-dual (Lagrangian) bound — mirror of the native engine's: with
    # y >= 0 per covering row and rc_i = c_i - sum_{rows(i)} y_r, any DFS
    # completion of a partial cover with uncovered set U pays at least
    # sum_{r in U} (y_r + neg_rc) on top (|added| <= |U|, each y_r of U
    # paid at least once).  Zero duals degrade to the bound-free case.
    if duals is not None:
        y_d = np.nan_to_num(
            np.asarray(duals, dtype=np.float64)[: model.nrows_cover],
            nan=0.0, posinf=0.0, neginf=0.0,
        ).clip(min=0.0)
        if len(y_d) < model.nrows_cover:
            y_d = np.concatenate([y_d, np.zeros(model.nrows_cover - len(y_d))])
    else:
        y_d = np.zeros(model.nrows_cover)
    rc_d = np.array(
        [costs[i] - y_d[model.rows_by_col[act[i]]].sum() for i in range(k)]
    )
    neg_rc = min(0.0, rc_d.min()) if k else 0.0
    dualw = y_d + neg_rc
    dual_eps = 1e-7 * max(1.0, abs(budget))
    # integral costs => integral completion remainders => every fractional
    # lower bound tightens to its ceil (mirror of the native engine's lbr)
    costs_integral = bool(np.all(np.abs(costs - np.round(costs)) <= 1e-9))

    def lbr(v: float) -> float:
        return np.ceil(v - dual_eps) if costs_integral else v

    def scan(cov):
        """One pass over the uncovered rows: (branch row = the row with
        the fewest candidate columns — most-constrained-first slashes the
        tree vs first-bit order — , admissible lower bound)."""
        lb_spread = 0.0
        lb_max = 0.0
        lb_dual = 0.0
        r_pick = -1
        pick_c = 1 << 30
        for w in range(nwords):
            miss = int(full[w] & ~cov[w])
            while miss:
                low = miss & -miss
                rr = (w << 6) + low.bit_length() - 1
                lb_spread += spread[rr]
                lb_dual += dualw[rr]
                if row_min[rr] > lb_max:
                    lb_max = row_min[rr]
                if n_cands[rr] < pick_c:
                    pick_c = n_cands[rr]
                    r_pick = rr
                miss ^= low
        return r_pick, max(lb_spread, lb_max, lb_dual - dual_eps), lb_dual

    def dfs(cov, cost):
        nonlocal best, calls
        calls += 1
        if calls % 2048 == 0 and _time.monotonic() > t_end:
            raise TimeoutError
        r, lb, lb_dual = scan(cov)
        if r < 0:
            best = list(chosen)
            return True
        if cost + lbr(lb) > budget + 1e-9:
            return False
        for i in by_row[r]:
            if cost + costs[i] > budget + 1e-9:
                break  # sorted by cost: nothing cheaper follows
            # child bound >= cost + lb_dual + rc_i: skip without recursing
            if cost + lbr(lb_dual + rc_d[i]) > budget + 1e-9:
                continue
            chosen.append(i)
            if dfs(cov | masks[i], cost + costs[i]):
                return True
            chosen.pop()
        return False

    try:
        found = dfs(np.zeros(nwords, dtype=np.uint64), 0.0)
    except TimeoutError:
        return None, None
    except RecursionError:
        return None, None
    if not found:
        return False, None
    x = np.zeros(model.ncols)
    x[act[best]] = 1.0
    return True, x


def sample_cover(
    model: BaseModel,
    x_star: np.ndarray,
    budget: float,
    tries: int = 400,
    seed: int = 20240817,
    time_limit_sec: float = 2.0,
):
    """LP-guided randomized rounding: sample covers with P(pick j) ~
    x*_j, greedily repair, redundancy-eliminate, return the first one
    with cost <= budget (None if none found).  The workhorse for FINDING
    an integer point on the LP-optimal face once reduced-cost fixing has
    shrunk the model onto it — the refute side is the LP bound's job
    (reduced-root floor > budget), so find+LP together close the last
    integer unit without an exponential enumeration."""
    import time as _time

    t_end = _time.monotonic() + time_limit_sec
    act = np.flatnonzero(model.active)
    if len(act) == 0:
        return None
    A, rhs_all = model.rel_csr()
    A = A[: model.nrows_cover][:, act]
    rhs = rhs_all[: model.nrows_cover]
    costs = model.costs[act]
    xs = np.clip(np.asarray(x_star)[act], 0.0, 1.0)
    rng = np.random.RandomState(seed)

    for t in range(tries):
        if _time.monotonic() > t_end:
            return None
        # anneal the sampling sharpness across tries
        p = np.clip(xs ** (0.5 + 1.5 * (t % 4)), 0.0, 1.0)
        pick = rng.random_sample(len(act)) < p
        x = pick.astype(np.float64)
        cov = A @ x
        cost = float(costs @ x)
        ok = True
        for _ in range(len(act)):
            uncovered = cov + 1e-9 < rhs
            if not uncovered.any():
                break
            Au = A[uncovered]
            gain = np.asarray(Au.sum(axis=0)).ravel()
            cand = (gain > 0) & (x <= 0.5)
            if not cand.any():
                ok = False
                break
            score = np.where(cand, gain / np.maximum(1e-9, costs), -np.inf)
            k = int(np.argmax(score))
            x[k] = 1.0
            cost += costs[k]
            cov = A @ x
        if not ok or np.any(A @ x + 1e-9 < rhs):
            continue
        # redundancy elimination, most expensive first
        sel = np.flatnonzero(x > 0.5)
        for j in sel[np.argsort(-costs[sel], kind="stable")]:
            x[j] = 0.0
            if np.any(A @ x + 1e-9 < rhs):
                x[j] = 1.0
            else:
                cost -= costs[j]
        if cost <= budget + 1e-9:
            out = np.zeros(model.ncols)
            out[act[x > 0.5]] = 1.0
            return out
    return None
