"""window.p95_ms: the 95th percentile of the call walls of the untraced
window, every call counted, in ms (numpy's linear interpolation)."""

import numpy as np


def read(ctx):
    walls = [c["wall_s"] for c in ctx["calls"] if c.get("lanes")]
    return 1e3 * float(np.percentile(walls, 95)) if len(walls) >= 2 else None
