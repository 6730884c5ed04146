"""time_to_optimum_s: the mean time to a proven optimum over the instances of
the cell's set.  Each instance's mean over its solves in the window, the mean
of those over the instances, scaled by the window over the solves' summed
walls so that the window's whole time is counted.  Every instance weighs the
same, however many times it came round before the window closed."""


def read(ctx):
    by = {}
    for c in ctx["calls"]:
        by.setdefault(c["instance"], []).append(c["wall_s"])
    if not by:
        return None
    mean = sum(sum(v) / len(v) for v in by.values()) / len(by)
    return mean * ctx["window_s"] / sum(c["wall_s"] for c in ctx["calls"])
