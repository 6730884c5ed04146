"""ipm.ms_per_iter: host wall of the untraced window's calls over their IPM
loop iterations, in ms."""


def read(ctx):
    calls = [c for c in ctx["calls"] if c.get("ipm_iters")]
    it = sum(c["ipm_iters"] for c in calls)
    return 1e3 * sum(c["wall_s"] for c in calls) / it if it else None
