"""ipm.sync_wait_pct: the share of the IPM's host time spent blocked on the
device, in %, in the traced window, read from the port's own spans
(``sypha_tpu_torch.utils.telemetry``, recorded while the profiler runs): the
summed durations of the spans named ``<layer>.sync`` inside ``ipm.solve``
spans over the summed durations of the outermost ``ipm.solve`` spans.  A span
is (name, thread, start_ns, end_ns, parent index).  Nothing to read where the
port records no spans."""


def port_spans() -> list:
    try:
        from sypha_tpu_torch.utils import telemetry
    except ImportError:
        return []
    spans = getattr(telemetry, "spans", None)
    return list(spans()) if spans is not None else []


def value(log):
    inside = []  # parents come before their children in the log
    wait = solve = 0
    for s in log:
        outer = s[4] >= 0 and inside[s[4]]
        inside.append(s[0] == "ipm.solve" or outer)
        if s[3] is None:
            continue
        if s[0] == "ipm.solve" and not outer:
            solve += s[3] - s[2]
        elif outer and s[0].endswith(".sync"):
            wait += s[3] - s[2]
    return 100.0 * wait / solve if solve else None


def read(ctx):
    return value(port_spans())
