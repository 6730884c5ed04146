"""bnb.windows_per_solve: node windows per solve (served and failed, the
port's ``_NodeLpSolver.window_stats``), untraced window."""


def read(ctx):
    calls = ctx["calls"]
    return sum(c["windows"] for c in calls) / len(calls) if calls else None
