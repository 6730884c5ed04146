"""ell.device_ms_per_iter: device time of everything launched inside the
spans around the ELL operator's products (Av, ATu, sqAv, todense) in the
traced window, over that window's IPM loop iterations, in ms."""


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    dev = sum(v for k, v in t["span_device_s"].items() if k.startswith("ell."))
    it = sum(c["ipm_iters"] or 0 for c in ctx["traced_calls"])
    return 1e3 * dev / it if dev > 0 and it else None
