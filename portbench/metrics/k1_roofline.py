"""k1_roofline: K1's share of its roofline in the traced window, in %: the
summed least times of its calls (``roofline.k1_bound_s`` of each call's
shapes) over the device time of everything launched inside the spans around
``gram()``.  Nothing to read without K1 calls, device time in their spans, or
a peak for the card."""

from portbench.roofline import k1_bound_s


def read(ctx):
    t = ctx["trace"]
    if not t or not t["gram_shapes"]:
        return None
    dev = t["span_device_s"].get("gram", 0.0)
    bounds = [k1_bound_s(a, w, t["device_kind"]) for a, w in t["gram_shapes"]]
    if dev <= 0 or any(b is None for b in bounds):
        return None
    return 100.0 * sum(bounds) / dev
