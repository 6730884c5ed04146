"""The traced part of a ``--trace 1`` run: spans from the benchmark's own
wrappers around the port's entry functions, one ``torch.profiler`` window,
and its reduction to the numbers the per-layer metrics read.

Spans come only from here: while a ``Tracer`` is active, each function in
``FUNCTIONS`` is replaced, in every loaded module of the port that holds it
except the one that defines it (so that the counters the port keeps on its
own function objects stay where they are), by a wrapper that opens a
``record_function`` span named ``pb.<span>``; each method in ``METHODS`` is
wrapped on its class.  The untraced run calls the port untouched.  A name
the port no longer has is skipped, and the metric that reads its span then
finds nothing.

The reduction reads the profiler's raw events: each device operation (kernel,
copy, set) is charged to the spans that were open on the host when the
operation that launched it began (its linked correlation id), so a span's
device time is that of everything launched inside it, whatever implements
it.  Device busy time is the union of the device operations' intervals
inside the traced window.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import sys
import time
from collections import defaultdict

import torch

# (defining module, function, span)
FUNCTIONS = (
    ("sypha_tpu_torch.ipm.node_batch", "solve_node_batch", "solve_node_batch"),
    ("sypha_tpu_torch.ipm.shared", "mehrotra_solve_shared", "mehrotra_solve_shared"),
    ("sypha_tpu_torch.ipm.shared", "shared_initial_point", "initial_point"),
    ("sypha_tpu_torch.ipm.shared", "fix_columns", "fix_columns"),
    ("sypha_tpu_torch.ops.spd", "pcg_solve", "pcg_solve"),
    ("sypha_tpu_torch.ops.spd", "factor_gram", "factor"),
    ("sypha_tpu_torch.ops.spd", "normal_eq_factor", "factor"),
    ("sypha_tpu_torch.ops.gram", "gram", "gram"),
    ("sypha_tpu_torch.milp.presolve", "apply_presolve_rules", "presolve"),
    ("sypha_tpu_torch.milp.presolve", "greedy_set_cover", "greedy_set_cover"),
    ("sypha_tpu_torch.milp.heuristics", "run_heuristics", "heuristics"),
    ("sypha_tpu_torch.milp.cuts", "separate_cuts", "cuts"),
)
# (module, class, method, span)
METHODS = (
    ("sypha_tpu_torch.ops.ell", "EllMatrix", "Av", "ell.Av"),
    ("sypha_tpu_torch.ops.ell", "EllMatrix", "ATu", "ell.ATu"),
    ("sypha_tpu_torch.ops.ell", "EllMatrix", "sqAv", "ell.sqAv"),
    ("sypha_tpu_torch.ops.ell", "EllMatrix", "todense", "ell.todense"),
    ("sypha_tpu_torch.milp.bnb", "_NodeLpSolver", "solve_nodes", "bnb.window"),
)
PREFIX = "pb."


def span(name: str):
    """A span of the benchmark's own, around harness code."""
    return torch.profiler.record_function(PREFIX + name)


class Tracer:
    """Installs the span wrappers on enter and removes them on exit;
    ``gram_shapes`` lists (A32 shape, w shape) of every wrapped gram call."""

    def __init__(self):
        self.gram_shapes = []
        self._undo = []

    def _wrapper(self, fn, name):
        label = PREFIX + name
        shapes = self.gram_shapes if name == "gram" else None

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if shapes is not None and len(args) >= 2:
                shapes.append((tuple(args[0].shape), tuple(args[1].shape)))
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)

        return wrapped

    def __enter__(self):
        port = [m for n, m in list(sys.modules.items()) if n.split(".")[0] == "sypha_tpu_torch" and m]
        for mod_name, attr, name in FUNCTIONS:
            try:
                fn = getattr(importlib.import_module(mod_name), attr)
            except (ImportError, AttributeError):
                continue
            wrapped = self._wrapper(fn, name)
            for mod in port:
                if mod.__name__ != mod_name and getattr(mod, attr, None) is fn:
                    setattr(mod, attr, wrapped)
                    self._undo.append((mod, attr, fn))
        for mod_name, cls_name, attr, name in METHODS:
            try:
                cls = getattr(importlib.import_module(mod_name), cls_name)
                fn = cls.__dict__[attr]
            except (ImportError, AttributeError, KeyError):
                continue
            setattr(cls, attr, self._wrapper(fn, name))
            self._undo.append((cls, attr, fn))
        return self

    def __exit__(self, *exc):
        for obj, attr, fn in reversed(self._undo):
            setattr(obj, attr, fn)
        self._undo.clear()
        return False


def profile():
    """The profiler for the traced window: host and device activity (host
    alone on a machine without a card, where the tests run)."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _end_ns(e) -> int:
    try:
        return int(e.end_ns())
    except AttributeError:
        return int(e.start_ns()) + int(e.duration_ns())


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class _Index:
    """Merged intervals of one span name, for point queries."""

    def __init__(self, intervals):
        self.iv = _merge(intervals)
        self.starts = [s for s, _ in self.iv]

    def holds(self, t: int) -> bool:
        k = bisect.bisect_right(self.starts, t) - 1
        return k >= 0 and t <= self.iv[k][1]


class _Idle:
    """Idle time of the device inside the window, for interval queries."""

    def __init__(self, busy, w0: int, w1: int):
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        self.iv = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        self.starts = [a for a, _ in self.iv]
        self.cum = [0]
        for a, b in self.iv:
            self.cum.append(self.cum[-1] + b - a)

    def upto(self, t: int) -> int:
        k = bisect.bisect_right(self.starts, t) - 1
        if k < 0:
            return 0
        a, b = self.iv[k]
        return self.cum[k] + min(t, b) - a

    def total(self) -> int:
        return self.cum[-1]


def reduce_events(events, window_name: str = "window") -> dict:
    """The per-layer numbers of one traced window from the profiler's raw
    events (``prof.profiler.kineto_results.events()``).

    Returns ``window_s`` (the span ``pb.<window_name>``), ``busy_s`` (union
    of device operations inside it), ``span_device_s`` and ``span_count`` by
    span name (without the prefix), ``device_ops`` (device seconds by
    operation name, largest first), ``idle_gaps`` (idle device seconds by the
    innermost span open on the host at the time), ``k1_records`` (kernels
    named ``gram_kernel``), ``device_records``, and how the device
    operations were charged to the host: ``linked`` (through the operator
    that launched them), ``via_runtime`` (through the CUDA runtime or driver
    call that launched them, for launches outside any operator, such as
    K1's through ctypes) and ``unattributed``."""
    from torch.autograd import DeviceType

    spans = defaultdict(list)
    host_start = {}  # correlation id of a host operator -> its start
    runtime = {}  # correlation id of a CUDA runtime or driver call -> its start
    device = []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(PREFIX):
                spans[name[len(PREFIX):]].append((int(e.start_ns()), _end_ns(e)))
            if name.startswith("cu"):
                runtime[e.correlation_id()] = int(e.start_ns())
            elif e.linked_correlation_id() == 0:
                host_start[e.correlation_id()] = int(e.start_ns())
        elif not name.startswith(PREFIX):  # not a span's device-side shadow
            device.append((int(e.start_ns()), _end_ns(e), name, e.linked_correlation_id(),
                           e.correlation_id()))
    out = {"window_s": None, "busy_s": None, "span_device_s": {}, "span_count": {},
           "device_ops": [], "idle_gaps": [], "k1_records": 0, "device_records": len(device),
           "linked": 0, "via_runtime": 0, "unattributed": 0}
    if window_name not in spans:
        return out
    w0, w1 = spans[window_name][0][0], spans[window_name][-1][1]
    out["window_s"] = (w1 - w0) / 1e9
    out["span_count"] = {k: len(v) for k, v in spans.items()}
    index = {k: _Index(v) for k, v in spans.items()}
    per_span = defaultdict(int)
    per_op = defaultdict(int)
    inside = []
    for s, e, name, link, corr in device:
        if e < w0 or s > w1:
            continue
        inside.append((max(s, w0), min(e, w1)))
        per_op[name] += e - s
        if "gram_kernel" in name:
            out["k1_records"] += 1
        t = host_start.get(link) if link else None
        if t is not None:
            out["linked"] += 1
        else:
            t = runtime.get(corr)
            if t is None:
                out["unattributed"] += 1
                continue
            out["via_runtime"] += 1
        for k, ix in index.items():
            if ix.holds(t):
                per_span[k] += e - s
    busy = _merge(inside)
    out["busy_s"] = sum(e - s for s, e in busy) / 1e9
    out["span_device_s"] = {k: v / 1e9 for k, v in per_span.items()}
    out["device_ops"] = [[k[:64], v / 1e9] for k, v in sorted(per_op.items(), key=lambda kv: -kv[1])]
    # idle time charged to the innermost span open on the host at each
    # moment: one sweep over span starts and ends
    idle = _Idle(busy, w0, w1)
    marks = sorted([(s, 0, k) for k, v in spans.items() for s, _ in v]
                   + [(e, 1, k) for k, v in spans.items() for _, e in v])
    gaps = defaultdict(int)
    stack = []
    prev = w0
    for t, kind, name in marks:
        t = min(max(t, w0), w1)
        if t > prev:
            gaps[stack[-1] if stack else "outside spans"] += idle.upto(t) - idle.upto(prev)
            prev = t
        if kind == 0:
            stack.append(name)
        else:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == name:
                    del stack[i]
                    break
    if w1 > prev:
        gaps["outside spans"] += idle.upto(w1) - idle.upto(prev)
    out["idle_gaps"] = [[k, v / 1e9] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1]) if v > 0]
    return out


def traced_window(run_calls, tracer: Tracer) -> tuple:
    """Run ``run_calls()`` under the span wrappers and the profiler, inside
    the span ``pb.window``; returns (its result, the reduction, seconds spent
    reading the trace)."""
    with tracer, profile() as prof:
        with span("window"):
            result = run_calls()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    t0 = time.perf_counter()
    red = reduce_events(prof.profiler.kineto_results.events())
    return result, red, time.perf_counter() - t0
