"""pcg.steps_per_iter: PCG steps (the port's counter ``pcg_solve.steps``)
over IPM loop iterations, in the untraced window."""


def read(ctx):
    calls = [c for c in ctx["calls"] if c.get("ipm_iters")]
    it = sum(c["ipm_iters"] for c in calls)
    return sum(c["pcg_steps"] for c in calls) / it if it else None
