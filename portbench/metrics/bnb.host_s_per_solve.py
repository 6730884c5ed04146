"""bnb.host_s_per_solve: per solve, the call's wall less the wall the B&B
spent in node windows (the port's ``_NodeLpSolver.window_stats["seconds"]``,
host copies included): presolve, heuristics, cuts, closure, warm-up, the
tree's host work.  Untraced window."""


def read(ctx):
    calls = ctx["calls"]
    if not calls:
        return None
    return sum(c["wall_s"] - c["window_seconds"] for c in calls) / len(calls)
