"""ipm.iters_per_call: IPM loop iterations per call (the most any lane took,
which is how long the batched loop ran), mean over the untraced window."""


def read(ctx):
    it = [c["ipm_iters"] for c in ctx["calls"] if c.get("ipm_iters") is not None]
    return sum(it) / len(it) if it else None
