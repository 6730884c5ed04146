"""dense.host_ms_per_iter: host time of the dense operator's products per IPM
iteration in the traced window, in ms, read from the port's own spans
(``sypha_tpu_torch.utils.telemetry``, recorded while the profiler runs): the
summed durations of the spans named ``dense.*`` (``dense.Av``,
``dense.ATu``, ``dense.sqAv``, in ``ops/ell.products`` on a dense A) inside
outermost ``ipm.solve`` spans, over the ``ipm.iteration`` spans inside them.
A product replayed from a CUDA graph opens no span, so on the card this is
the eager products outside the PCG.  A span is (name, thread, start_ns,
end_ns, parent index).  Nothing to read where the port records no such
span."""


def port_spans() -> list:
    try:
        from sypha_tpu_torch.utils import telemetry
    except ImportError:
        return []
    spans = getattr(telemetry, "spans", None)
    return list(spans()) if spans is not None else []


def value(log):
    inside = []  # parents come before their children in the log
    dense = iters = 0
    found = False
    for s in log:
        outer = s[4] >= 0 and inside[s[4]]
        inside.append(s[0] == "ipm.solve" or outer)
        if not outer:
            continue
        if s[0] == "ipm.iteration":
            iters += 1
        elif s[0].startswith("dense.") and s[3] is not None:
            dense += s[3] - s[2]
            found = True
    return dense / 1e6 / iters if found and iters else None


def read(ctx):
    return value(port_spans())
