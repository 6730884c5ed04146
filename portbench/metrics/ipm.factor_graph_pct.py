"""ipm.factor_graph_pct: the share of the shared IPM's factor calls replayed
from a CUDA graph in the traced window, in %, read from the port's own spans
(``sypha_tpu_torch.utils.telemetry``, recorded while the profiler runs): the
``ipm.factor`` spans inside outermost ``ipm.solve`` spans that hold a
``factor.replay`` span, over all such ``ipm.factor`` spans.  A span is
(name, thread, start_ns, end_ns, parent index).  Nothing to read where the
port records no ``factor.*`` span."""


def port_spans() -> list:
    try:
        from sypha_tpu_torch.utils import telemetry
    except ImportError:
        return []
    spans = getattr(telemetry, "spans", None)
    return list(spans()) if spans is not None else []


def value(log):
    inside = []  # parents come before their children in the log
    factors = {}  # log index of an ipm.factor inside ipm.solve -> replayed
    found = False
    for i, s in enumerate(log):
        outer = s[4] >= 0 and inside[s[4]]
        inside.append(s[0] == "ipm.solve" or outer)
        found = found or s[0].startswith("factor.")
        if outer and s[0] == "ipm.factor":
            factors[i] = False
        elif s[0] == "factor.replay":
            j = s[4]
            while j >= 0 and log[j][0] != "ipm.factor":
                j = log[j][4]
            if j in factors:
                factors[j] = True
    if not found or not factors:
        return None
    return 100.0 * sum(factors.values()) / len(factors)


def read(ctx):
    return value(port_spans())
