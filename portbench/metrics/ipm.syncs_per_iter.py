"""ipm.syncs_per_iter: device-to-host syncs per IPM iteration in the traced
window, read from the port's own spans (``sypha_tpu_torch.utils.telemetry``,
recorded while the profiler runs): the spans named ``<layer>.sync`` that lie
inside an ``ipm.solve`` span (the IPM's loop tests ``ipm.sync``, the PCG's
``pcg.sync``, K1's exactness read ``k1.sync``) over the ``ipm.iteration``
spans.  A span is (name, thread, start_ns, end_ns, parent index).  Nothing
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
    for s in log:
        inside.append(s[0] == "ipm.solve" or (s[4] >= 0 and inside[s[4]]))
    syncs = sum(1 for s, ok in zip(log, inside) if ok and s[0].endswith(".sync"))
    iters = sum(1 for s in log if s[0] == "ipm.iteration")
    return syncs / iters if iters else None


def read(ctx):
    return value(port_spans())
