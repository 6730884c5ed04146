"""Device telemetry, the solver's spans and counters, and profiler hooks:
the port of sypha_tpu/utils/telemetry.py.

``device_memory_stats`` reads the CUDA caching allocator
(``torch.cuda.memory_stats``) and the driver's view of the card
(``torch.cuda.mem_get_info``); it returns None for a CPU device, as the JAX
package does.  ``profile_trace`` records a ``torch.profiler`` trace
(viewable in TensorBoard or Perfetto) and, beside it, ``spans.json``.

Spans.  ``span(name)`` marks a phase of the solver, named by its layer
(``ipm.iteration``, ``pcg.solve``, ``k1.gram``, ``ell.Av``, ``dense.Av``,
``bnb.precompile``, ``native.exact_cover``, ...).  It records only while
tracing is on: while a ``torch.profiler`` session records the calling
thread, or inside ``tracing()``.  Otherwise it returns one shared no-op
context, and the flag checks are its only cost.  A recorded span opens a
profiler range of its name when the profiler records (a CPU operation in
the trace, as ``record_function`` would make, but of the function scope, so
that no copy of it lands on the device's timeline), so that it sits in the
profiler's trace beside the device work it launched, and appends ``Span(name, thread, start_ns, end_ns, parent)`` to an in-memory
log: ``thread`` is the native thread id, the times are ``time.time_ns()``,
the clock of the profiler's host events, and ``parent`` is the log index of
the span that encloses it in the same thread (-1 for none).  The log holds
at most ``LOG_CAP`` spans; later ones are dropped and counted
(``telemetry.spans_dropped`` in ``counters()``).  Spans named
``<layer>.sync`` enclose one device-to-host sync each: the IPM's loop test
(``ipm.sync``), the PCG's (``pcg.sync``, one a read of the chunked loop's
flag) and K1's exactness read (``k1.sync``).  ``pcg.capture`` holds the
capture of a key's CUDA graphs of the PCG, ``factor.capture`` that of a
key's CUDA graph of the factor, and ``factor.replay`` a replay of it with
its copies in and out.

The profiler records only the thread that started it: a thread that the
solver starts (the B&B's closure worker) records into the log when its
target is wrapped by ``carried`` in a thread that records.

Counters stay attributes of the function or class that counts
(``pcg_solve.steps``, ``gram.launches``, ``_NodeLpSolver.window_stats``,
...); ``counters()`` gathers all of them into one dict of dotted names.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Optional

import torch


@dataclass
class DeviceMemoryStats:
    bytes_in_use: int = 0
    peak_bytes_in_use: int = 0
    bytes_limit: int = 0

    @property
    def free_bytes(self) -> int:
        return max(0, self.bytes_limit - self.bytes_in_use)

    def __str__(self) -> str:
        gb = 1 << 30
        return (
            f"in_use={self.bytes_in_use / gb:.3f}GiB "
            f"peak={self.peak_bytes_in_use / gb:.3f}GiB "
            f"limit={self.bytes_limit / gb:.3f}GiB"
        )


def device_memory_stats(device=None) -> Optional[DeviceMemoryStats]:
    """Memory stats of a CUDA device (default: the current one); None on a
    CPU device or when no CUDA device is available.  ``bytes_limit`` is the
    card's total memory."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return DeviceMemoryStats(
        bytes_in_use=int(stats.get("allocated_bytes.all.current", 0)),
        peak_bytes_in_use=int(stats.get("allocated_bytes.all.peak", 0)),
        bytes_limit=int(total),
    )


class MemorySampler:
    """Before/after sampling of device memory around a solver phase."""

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = device
        self.before: Optional[DeviceMemoryStats] = None
        self.after: Optional[DeviceMemoryStats] = None

    def __enter__(self) -> "MemorySampler":
        if self.enabled:
            self.before = device_memory_stats(self.device)
        return self

    def __exit__(self, *exc) -> None:
        if self.enabled:
            self.after = device_memory_stats(self.device)

    def report(self) -> str:
        if not self.enabled or self.before is None or self.after is None:
            return "memory sampling unavailable"
        return f"before: {self.before} | after: {self.after}"


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """torch.profiler trace of the host and, where there is one, the CUDA
    device, written into ``log_dir`` when the block ends, with the solver's
    spans in it; beside it ``spans.json``: ``span_summary()`` of the spans
    the block recorded and the changes of ``counters()`` over the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    c0 = counters()
    with _lock:
        first = len(_names)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield
    c1 = counters()
    log = spans()
    summary = {
        "spans": span_summary(log, min(first, len(log))),
        "counters": {k: c1[k] - c0[k] for k in c1},
    }
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class Span(NamedTuple):
    name: str
    thread: int  # native thread id
    start_ns: int  # time.time_ns(), the profiler's host clock
    end_ns: Optional[int]  # None while the span is open
    parent: int  # log index of the enclosing span in the same thread, or -1


LOG_CAP = 1 << 20

_profiling = torch._C._autograd._profiler_enabled
# a profiler range of the function scope: record_function's user scope would
# also put a copy of every span on the device's timeline of the trace
_Range = torch._C._profiler._RecordFunctionFast
_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
# the log, one list per field of Span: appending strings and ints adds no
# object that the garbage collector walks
_names: list = []
_threads: list = []
_starts: list = []
_ends: list = []
_parents: list = []
_dropped = 0
_generation = 0  # bumped by reset_spans: older stack entries lose their index
_tracing = 0  # depth of tracing() blocks, over every thread
_carried = 0  # threads running a ``carried`` target
_local = threading.local()  # .stack of (generation, index), .tid


class _Span:
    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped
        local = _local
        try:
            stack = local.stack
        except AttributeError:
            stack = local.stack = []
            # once a thread: the native id is a system call
            local.tid = threading.get_native_id()
        gen, parent = stack[-1] if stack else (_generation, -1)
        self.rf = _Range(self.name) if _profiling() else None
        start = time.time_ns()
        if self.rf is not None:
            self.rf.__enter__()
        with _lock:
            if len(_names) < LOG_CAP:
                index = len(_names)
                _names.append(self.name)
                _threads.append(local.tid)
                _starts.append(start)
                _ends.append(None)
                _parents.append(parent if gen == _generation else -1)
            else:
                index = -1
                _dropped += 1
            stack.append((_generation, index))
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.time_ns()
        gen, index = _local.stack.pop()
        with _lock:
            if index >= 0 and gen == _generation:
                _ends[index] = end
        return False


def span(name: str):
    """A context that records the phase ``name`` while tracing is on, and
    the shared no-op context while it is off."""
    if _tracing or _profiling() or (_carried and getattr(_local, "carried", False)):
        return _Span(name)
    return _NOOP


def enabled() -> bool:
    """Whether ``span`` records in the calling thread now."""
    return bool(_tracing or _profiling() or getattr(_local, "carried", False))


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Record spans in every thread while the block runs, without the
    profiler (span statistics alone)."""
    global _tracing
    with _lock:
        _tracing += 1
    try:
        yield
    finally:
        with _lock:
            _tracing -= 1


def carried(fn):
    """``fn`` as a thread's target: if the calling thread records spans now,
    the thread that runs it records its spans into the log too (without
    a profiler range: the profiler does not see that thread)."""
    if not enabled():
        return fn

    def run(*args, **kwargs):
        global _carried
        _local.carried = True
        with _lock:
            _carried += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _local.carried = False
            with _lock:
                _carried -= 1

    return run


def spans() -> list:
    """The log: one ``Span`` per recorded span, in the order they opened."""
    with _lock:
        return [Span(*e) for e in zip(_names, _threads, _starts, _ends, _parents)]


def reset_spans() -> None:
    """Empty the log and its dropped count."""
    global _dropped, _generation
    with _lock:
        for column in (_names, _threads, _starts, _ends, _parents):
            column.clear()
        _dropped = 0
        _generation += 1


def span_summary(log: Optional[list] = None, first: int = 0) -> dict:
    """Per span name: ``count``, ``total_s`` and ``self_s`` (each span's
    duration less the part of it that its children cover), over the closed
    spans of ``log`` (default: ``spans()``) from index ``first`` on."""
    log = spans() if log is None else log
    child = [0] * len(log)
    for s in log[first:]:
        if s.end_ns is not None and s.parent >= first:
            child[s.parent] += s.end_ns - s.start_ns
    out = {}
    for i in range(first, len(log)):
        s = log[i]
        if s.end_ns is None:
            continue
        d = s.end_ns - s.start_ns
        o = out.setdefault(s.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        o["count"] += 1
        o["total_s"] += d / 1e9
        o["self_s"] += (d - child[i]) / 1e9
    return out


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------


def counters() -> dict:
    """Every counter of the port, by dotted name: PCG steps, reads of its
    flag and masked steps, and its CUDA graphs captured and replayed,
    the factor's calls and its CUDA graphs captured and replayed, the IPMs'
    iterations and syncs, the shared IPM's solves by operator,
    K1's launches by path, the B&B's node windows, the ELL operator cache,
    the spans dropped from the log."""
    from sypha_tpu_torch.io.standard_form import pad_standard_form_ell
    from sypha_tpu_torch.ipm.dense import mehrotra_solve
    from sypha_tpu_torch.ipm.shared import mehrotra_solve_shared
    from sypha_tpu_torch.milp.bnb import _NodeLpSolver
    from sypha_tpu_torch.ops.gram import gram
    from sypha_tpu_torch.ops.spd import factor_gram, pcg_solve

    owners = {
        "pcg_solve": (pcg_solve, ("steps", "syncs", "masked_steps", "graph_captures",
                                  "graph_replays")),
        "factor_gram": (factor_gram, ("calls", "graph_captures", "graph_replays")),
        "mehrotra_solve_shared": (mehrotra_solve_shared, ("iterations", "syncs", "solves_dense",
                                                          "solves_ell", "solves_grouped")),
        "mehrotra_solve": (mehrotra_solve, ("iterations", "syncs")),
        "gram": (gram, ("launches", "launches_per_lane", "launches_grouped",
                        "launches_bf16x3", "launches_split_k")),
        "pad_standard_form_ell": (pad_standard_form_ell, ("builds", "hits")),
    }
    out = {f"{owner}.{a}": getattr(fn, a) for owner, (fn, attrs) in owners.items() for a in attrs}
    ws = _NodeLpSolver.window_stats
    for k in ("ell", "dense", "failed", "seconds", "host_copies"):
        out[f"window_stats.{k}"] = ws.get(k, 0)
    out["telemetry.spans_dropped"] = _dropped
    return out
