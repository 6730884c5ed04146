"""Plain reference for set-covering MILPs: an exact best-first branch and
bound over the plain LP reference (``lp.py``), in NumPy and PyTorch.

It imports nothing of the program.  Given an instance (the benchmark's
arrays) and a cover to start from, it returns the optimum: the cheapest
cover, proven by exhausting the tree.  The start cover only seeds the
incumbent; the search finds the optimum from any feasible start, so a
program's cover that is not optimal is beaten, and one that is optimal is
proven so.

Bounds are Lagrangian: for any y >= 0 and binary x, the cost of a node is at
least  offset + r.y + sum_{j free} min(0, c_j - A_j.y),  which holds whatever
the LP solve's accuracy (y is the LP's dual, clipped at 0).  Costs are
integers, so a node is pruned once its bound exceeds U - 1 (U the incumbent's
cost) by more than 1e-6.  The same bound fixes columns by reduced cost, a
greedy repair of each LP solution proposes covers, and the most fractional
free column is branched on.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import lp

_MARGIN = 1e-6


def is_cover(A: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Per row, whether the 0/1 vector x covers it."""
    return (A @ (x > 0.5).astype(np.float64)) > 0.5


def greedy_cover(A: np.ndarray, costs: np.ndarray, start: np.ndarray, banned: np.ndarray):
    """Extend ``start`` (bool [n]) to a cover by cost per newly covered row,
    never taking a ``banned`` column, then drop redundant columns, dearest
    first.  None where no cover exists."""
    x = start.copy()
    covered = is_cover(A, x)
    allowed = ~banned & ~x
    while not covered.all():
        gain = A[~covered][:, allowed].sum(axis=0)
        if not gain.any():
            return None
        ratio = np.where(gain > 0, costs[allowed] / np.maximum(gain, 1), np.inf)
        j = np.flatnonzero(allowed)[int(np.argmin(ratio))]
        x[j] = True
        allowed[j] = False
        covered |= A[:, j] > 0.5
    count = A @ x.astype(np.float64)
    for j in sorted(np.flatnonzero(x), key=lambda j: -costs[j]):
        rows = A[:, j] > 0.5
        if np.all(count[rows] >= 2):
            x[j] = False
            count[rows] -= 1
    return x


def first_cover(A: np.ndarray, costs: np.ndarray, *, device="cpu"):
    """The root LP's greedy repair alone, with no search: the control of a
    B&B cell, an answer whose optimality nothing proves."""
    n = A.shape[1]
    none = np.zeros((1, n))
    sol = lp.solve(A, costs, none, none, device=device)
    x = greedy_cover(A, costs, sol["x"][0] > 0.5, np.zeros(n, dtype=bool))
    return x, float(costs @ x)


def optimum(A: np.ndarray, costs: np.ndarray, start: np.ndarray, *, device="cpu", block=64,
            max_nodes=20000):
    """(optimal cost, an optimal cover, proven, nodes) from the feasible cover
    ``start``.  ``proven`` is False only where ``max_nodes`` ran out."""
    m, n = A.shape
    costs = costs.astype(np.float64)
    best = start > 0.5
    if not is_cover(A, best).all():
        raise ValueError("optimum() needs a feasible start cover")
    U = float(costs @ best)
    # open nodes: (bound, fix0 mask, fix1 mask)
    frontier = [(-np.inf, np.zeros(n, dtype=bool), np.zeros(n, dtype=bool))]
    nodes = 0
    while frontier and nodes < max_nodes:
        frontier.sort(key=lambda t: t[0])
        batch, frontier = frontier[:block], frontier[block:]
        batch = [t for t in batch if t[0] <= U - 1 + _MARGIN]
        if not batch:
            continue
        nodes += len(batch)
        f0 = np.stack([t[1] for t in batch]).astype(np.float64)
        f1 = np.stack([t[2] for t in batch]).astype(np.float64)
        sol = lp.solve(A, costs, f0, f1, device=device, block=block)
        for k, (_, fix0, fix1) in enumerate(batch):
            if not sol["feasible"][k]:
                continue
            free = sol["free"][k]
            yp = np.maximum(sol["y"][k], 0.0)
            rc = np.where(free, costs - yp @ A, 0.0)
            L = sol["offset"][k] + sol["r"][k] @ yp + np.minimum(rc, 0.0).sum()
            if L > U - 1 + _MARGIN:
                continue
            fix0 = fix0 | (free & (L + np.maximum(rc, 0.0) > U - 1 + _MARGIN))
            fix1 = fix1 | (free & (L + np.maximum(-rc, 0.0) > U - 1 + _MARGIN))
            xl = sol["x"][k]
            cand = greedy_cover(A, costs, fix1 | (free & ~fix0 & (xl > 0.5)), fix0)
            if cand is not None and costs @ cand < U:
                best, U = cand, float(costs @ cand)
                if L > U - 1 + _MARGIN:
                    continue
            open_ = free & ~fix0 & ~fix1
            frac = np.where(open_, np.abs(xl - 0.5), np.inf)
            j = int(np.argmin(frac))
            if not np.isfinite(frac[j]) or frac[j] > 0.5 - 1e-6:
                # every open column at 0 or 1: the LP optimum is a cover of
                # its node, which the greedy repair above has taken
                continue
            a0, a1 = fix0.copy(), fix1.copy()
            a0[j] = True
            a1[j] = True
            frontier.append((L, a0, fix1))
            frontier.append((L, fix0, a1))
    frontier = [t for t in frontier if t[0] <= U - 1 + _MARGIN]
    return U, best, not frontier, nodes
