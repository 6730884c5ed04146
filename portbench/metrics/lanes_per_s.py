"""lanes_per_s: LP lanes of the calls completed in the window over the whole
window, which ends when the call in progress at ``--seconds`` ends."""


def read(ctx):
    lanes = sum(c["lanes"] for c in ctx["calls"])
    return lanes / ctx["window_s"] if lanes else None
