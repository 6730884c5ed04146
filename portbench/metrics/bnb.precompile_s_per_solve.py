"""bnb.precompile_s_per_solve: the B&B's warm-up of its node windows, in s
per solve, in the traced window, read from the port's own spans
(``sypha_tpu_torch.utils.telemetry``, recorded while the profiler runs): the
summed durations of the ``bnb.precompile`` spans over the outermost
``bnb.solve`` spans (a nested search, core or compact, is part of its
solve).  A span is (name, thread, start_ns, end_ns, parent index).  Nothing
to read where the port records no spans."""


def port_spans() -> list:
    try:
        from sypha_tpu_torch.utils import telemetry
    except ImportError:
        return []
    spans = getattr(telemetry, "spans", None)
    return list(spans()) if spans is not None else []


def value(log):
    inside = []  # parents come before their children in the log
    solves = precompile = 0
    for s in log:
        outer = s[4] >= 0 and inside[s[4]]
        inside.append(s[0] == "bnb.solve" or outer)
        if s[0] == "bnb.solve" and not outer:
            solves += 1
        elif s[0] == "bnb.precompile" and s[3] is not None:
            precompile += s[3] - s[2]
    return precompile / 1e9 / solves if solves else None


def read(ctx):
    return value(port_spans())
