"""The comparisons that decide ``correct``: each answer judged by what it
says, against the plain references.  Nothing here imports the program;
answers arrive as plain arrays and status names.

An LP lane's answer is (status, primal objective, dual objective, relative
dual residual), with the status one of ``converged``, ``stalled``,
``max_iter``, ``infeasible`` (infeasible or numerical trouble) and
``running``.  What it says:

- ``converged``: both objectives are the lane's optimum;
- ``stalled`` or ``max_iter`` with finite objectives, the dual one not above
  the primal by more than 1e-6, and a dual residual of at most 1e-7: the
  dual objective less max(1e-9, 1e-7 |dual|) is a lower bound on the
  optimum (the branch and bound's weak-duality rule, which it prunes by);
- anything else: nothing, which is sound but gives the caller no bound.

Two numbers follow over every answer judged: ``answer_err``, the largest
relative error of what the answers say (an optimum off the reference's, a
bound above it; an optimum claimed for a lane with none is infinite), and
``converged_pct``, the share of answers for feasible lanes that claim the
optimum at the port's 1e-8 (each of them held to it by ``answer_err``),
which a solve that stops making progress, or one in a precision that cannot
reach 1e-8, empties.

A branch-and-bound solve's answer is (status, objective, cover).  It says
that the cover is feasible, costs the objective, and is optimal: every row
covered, the cost equal, the objective equal to the reference optimum
(``milp.optimum``), the status ``optimal`` (``milp_numbers``).
"""

from __future__ import annotations

import numpy as np

WEAK_RES_D = 1e-7


def usable_bound(status, pobj, dobj, res_d):
    """Per answer, the lower bound it gives (nan where it gives none)."""
    status = np.asarray(status)
    pobj = np.asarray(pobj, dtype=np.float64)
    dobj = np.asarray(dobj, dtype=np.float64)
    res_d = np.asarray(res_d, dtype=np.float64)
    sane = np.isfinite(pobj) & np.isfinite(dobj) & (dobj <= pobj + 1e-6)
    weak = sane & np.isin(status, ("stalled", "max_iter")) & (res_d <= WEAK_RES_D)
    slack = np.maximum(1e-9, 1e-7 * np.abs(dobj))
    out = np.full(pobj.shape, np.nan)
    conv = status == "converged"
    out[conv] = dobj[conv]
    out[weak] = dobj[weak] - slack[weak]
    return out


def lp_numbers(status, pobj, dobj, res_d, z, feasible) -> dict:
    """``answer_err`` and ``converged_pct`` over answers (arrays of one shape;
    ``z`` and ``feasible`` the reference's optimum and feasibility of each
    answer's lane)."""
    status = np.asarray(status)
    z = np.asarray(z, dtype=np.float64)
    feasible = np.asarray(feasible, dtype=bool)
    pobj = np.asarray(pobj, dtype=np.float64)
    dobj = np.asarray(dobj, dtype=np.float64)
    scale = np.maximum(1.0, np.abs(np.where(feasible, z, 0.0)))
    conv = status == "converged"
    err = np.zeros(status.shape)
    zf = np.where(feasible, z, 0.0)
    ce = np.maximum(np.abs(pobj - zf), np.abs(dobj - zf)) / scale
    err = np.where(conv & feasible, ce, err)
    err = np.where(conv & ~feasible, np.inf, err)
    bound = usable_bound(status, pobj, dobj, res_d)
    weak = ~conv & np.isfinite(bound) & feasible
    err = np.where(weak, np.maximum(0.0, (bound - zf) / scale), err)
    err = np.where(np.isnan(err), np.inf, err)
    n_feas = int(feasible.sum())
    return {
        "answer_err": float(err.max()) if err.size else 0.0,
        "converged_pct": 100.0 * int((feasible & conv).sum()) / n_feas if n_feas else 100.0,
    }


def milp_numbers(solves, optima) -> dict:
    """Numbers over B&B solves.  ``solves``: dicts with ``instance``,
    ``status`` (name), ``objective``, ``cover`` (0/1 [n]), ``A`` and
    ``costs``; ``optima``: instance -> (optimum, proven) from the reference.

    ``cover_err``: rows the cover leaves uncovered plus the distance between
    the objective and the cover's cost (a missing cover counts every row);
    ``opt_excess``: the distance between the objective and the optimum
    (infinite where the reference could not prove its optimum);
    ``not_optimal``: solves whose status is not ``optimal``."""
    cover_err = excess = 0.0
    not_optimal = 0
    for s in solves:
        A, costs, x = s["A"], s["costs"], np.asarray(s["cover"]) > 0.5
        not_optimal += int(s["status"] != "optimal")
        if x.shape != (A.shape[1],):
            cover_err = max(cover_err, float(A.shape[0]))
            continue
        uncovered = float((A @ x.astype(np.float64) < 0.5).sum())
        cover_err = max(cover_err, uncovered + abs(float(s["objective"]) - float(costs @ x)))
        opt, proven = optima[s["instance"]]
        excess = max(excess, abs(float(s["objective"]) - opt) if proven else np.inf)
    return {"cover_err": cover_err, "opt_excess": excess, "not_optimal": float(not_optimal)}


def verdict(numbers: dict, limits: dict):
    """[(name, value, side, limit, ok)] for every number with a limit, and
    whether all hold.  A limit is {"max": x} (the number may not exceed x)
    or {"min": x} (it may not fall below x); a number with no limit, or a
    limit with no number, fails."""
    rows = []
    for name in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(name), limits.get(name) or {}
        side = "min" if "min" in lim else "max"
        bound = lim.get(side)
        ok = v is not None and bound is not None and bool(np.isfinite(v))
        ok = ok and (v >= bound if side == "min" else v <= bound)
        rows.append((name, v, side, bound, bool(ok)))
    return rows, all(r[-1] for r in rows)
