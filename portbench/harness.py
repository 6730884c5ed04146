"""The general harness: finds a cell's files by the names in BENCHMARK.json,
runs its set-up, its measured window and (with ``--trace 1``) a traced
window, reads the metrics, checks the answers, and builds the result line.

Everything that belongs to one configuration, traffic mix, kind of call or
metric is a file of its own, found by name:

- ``portbench/configs/<config>.json``: the configuration (class sizes);
- ``portbench/traffic/<traffic>.json``: the traffic mix, whose ``kind``
  names ``portbench/kinds/<kind>.py``;
- ``portbench/limits/<workload>.json``: the limit of each number compared;
- ``portbench/metrics/<metric>.py``: a reader, ``read(ctx) -> float | None``.

A reader's ``ctx`` holds ``setup_s``; ``window_s`` and ``calls`` (one record
per timed call: ``wall_s``, ``lanes``, ``ipm_iters``, ``instance`` and the
port's counters' changes ``pcg_steps``, ``gram_launches``, ``windows``,
``window_seconds``); with ``--trace 1`` also ``trace`` (``trace.reduce_events``
of the traced window, with ``gram_shapes`` and ``device_kind``) and
``traced_calls``.  A reader that finds nothing to read returns None, and the
metric is left out of the line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import trace as tr
from portbench.reference import judge

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent
# top-level module names that no run may hold once its window has closed
FOREIGN = ("jax", "jaxlib", "flax", "sypha_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(sp: dict, name: str) -> dict:
    for w in sp["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_files(w: dict, pkg: Path = PKG):
    """(config, traffic, limits) of a workload, by name."""
    return (
        load_json(pkg / "configs" / f"{w['config']}.json"),
        load_json(pkg / "traffic" / f"{w['traffic']}.json"),
        load_json(pkg / "limits" / f"{w['name']}.json"),
    )


def kind(name: str):
    return importlib.import_module(f"portbench.kinds.{name}")


def reader(metric: str, pkg: Path = PKG):
    """``read`` of ``portbench/metrics/<metric>.py``."""
    path = pkg / "metrics" / f"{metric}.py"
    sp = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def metrics_for(sp: dict, w: dict, traced: bool) -> list:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced):
    those that list the cell, or list no cells."""
    group = sp["per_layer"] if traced else sp["end_to_end"]
    return [m for m in group if w["name"] in m.get("workloads", [w["name"]])]


def foreign_modules() -> list:
    """Loaded modules whose top-level name is in FOREIGN, compared whole:
    ``sypha_tpu_torch`` is not ``sypha_tpu``."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FOREIGN))


def counters() -> dict:
    """The port's own counters: PCG steps, K1 launches, node windows served
    (and failed) and their wall seconds.  A counter the port lacks reads 0."""
    from sypha_tpu_torch.milp import bnb
    from sypha_tpu_torch.ops import gram, spd

    ws = getattr(getattr(bnb, "_NodeLpSolver", None), "window_stats", None) or {}
    return {
        "pcg_steps": int(getattr(spd.pcg_solve, "steps", 0)),
        "gram_launches": int(getattr(gram.gram, "launches", 0)),
        "windows": int(ws.get("ell", 0) + ws.get("dense", 0) + ws.get("failed", 0)),
        "window_seconds": float(ws.get("seconds", 0.0)),
    }


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_call(cell, device) -> dict:
    c0 = counters()
    t0 = time.perf_counter()
    rec = cell.call()
    sync(device)
    rec["wall_s"] = time.perf_counter() - t0
    c1 = counters()
    rec.update({k: c1[k] - c0[k] for k in c0})
    return rec


def window(cell, seconds: float, device):
    """Closed-loop calls until ``seconds`` have passed; the window ends when
    the call in progress then ends.  Returns (records, window seconds)."""
    records = []
    t0 = time.perf_counter()
    while True:
        records.append(timed_call(cell, device))
        t = time.perf_counter()
        if t - t0 >= seconds:
            return records, t - t0


def device_info(device, chips: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
    }


def run_cell(name: str, seed: int, seconds: float, traced: bool, device, *, t_start: float,
             root: Path = ROOT, files=None, entry=None, log=None):
    """One run of one cell.  Returns (result line, check rows).  ``files``
    overrides (config, traffic, limits) and ``entry`` the workload's entry
    (the tests' small sizes)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    sp = spec(root)
    w = entry or workload(sp, name)
    config, traffic, limits = files or cell_files(w)
    cell = kind(traffic["kind"]).setup(config, traffic, seed, device)
    cell.warm()
    sync(device)
    setup_s = time.perf_counter() - t_start
    records, window_s = window(cell, seconds, device)
    ctx = {"setup_s": setup_s, "window_s": window_s, "calls": records, "trace": None,
           "traced_calls": []}
    log(f"[window] {len(records)} calls in {window_s:.3f} s after {setup_s:.3f} s of set-up")
    log("[calls] instance:wall_s " + " ".join(f"{r['instance']}:{r['wall_s']:.4f}" for r in records))
    if traced:
        tracer = tr.Tracer()
        n = int(traffic.get("trace_calls", 1))

        def run_calls():
            out = []
            for _ in range(n):
                with tr.span("call"):
                    out.append(timed_call(cell, device))
            return out

        ctx["traced_calls"], red, read_s = tr.traced_window(run_calls, tracer)
        red["gram_shapes"] = tracer.gram_shapes
        red["device_kind"] = torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu"
        ctx["trace"] = red
        k1 = sum(r["gram_launches"] for r in ctx["traced_calls"])
        log(f"[trace] {n} calls, window {red['window_s']} s, busy {red['busy_s']} s, "
            f"{red['device_records']} device records ({red['linked']} through a host operator, "
            f"{red['via_runtime']} through a runtime call, {red['unattributed']} unattributed), "
            f"K1 launches {k1} against {red['k1_records']} K1 kernel records, read in {read_s:.3f} s")
    info = device_info(device, int(w["chips"]))
    cell.release()
    t0 = time.perf_counter()
    numbers, attempted, failed = cell.check(limits)
    log(f"[check] {attempted} calls judged in {time.perf_counter() - t0:.3f} s")
    rows, ok = judge.verdict(numbers, limits)
    metrics = {}
    for m in metrics_for(sp, w, traced):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if traced:
        red = ctx["trace"]
        info["busy_s"] = red["busy_s"]
        info["window_s"] = red["window_s"]
    result = {"correct": bool(ok and failed == 0), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": info}
    if traced:
        result["breakdown"] = {"device_ops": ctx["trace"]["device_ops"][:10],
                               "idle_gaps": ctx["trace"]["idle_gaps"][:10]}
    result["checks"] = {n: {"value": v, "limit": lim, "side": side} for n, v, side, lim, _ in rows}
    return result, rows


def check_lines(rows) -> list:
    sign = {"max": "<=", "min": ">="}
    return [f"check {n}: {v!r} limit {sign[side]} {lim!r} {'ok' if ok else 'FAILED'}"
            for n, v, side, lim, ok in rows]


def finite(x):
    """JSON-safe numbers: inf and nan as strings."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not np.isfinite(x):
        return str(x)
    return x
