"""Replay dumped exact-closure faces against the native DFS engine: the port
of the JAX package's benchmark/face_replay.py.

    python3 -m sypha_tpu_torch.benchmark.face_replay FACE.npz [FACE.npz ...] \\
        [--budget B] [--deadline S] [--no-duals] [--no-cuts] [--lib LIB.so]

Faces come from SYPHA_TPU_DUMP_FACES=dir during a MILP run (the
``native.exact_cover`` hook) or from ``face_make``.  This tool tunes the
sypha_exact_cover engine (csrc/sypha_host.cpp) offline, on the host: each
probe of a plateau face can be re-run alone, with other budgets, while the
engine is being changed, with no MILP re-run per data point.  ``--lib``
binds an alternate build of the library through ``native._bind``.  Prints
one line per face: FOUND (a cover within the budget), REFUTED (none
exists) or TIMEOUT.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time

import numpy as np

from sypha_tpu_torch import native

VERDICTS = {1: "FOUND", 0: "REFUTED", -1: "TIMEOUT"}


def replay(path: str, budget=None, deadline=None, use_duals=True, lib_path=None, use_cuts=True):
    """Run one face through the engine; returns (return code, seconds)."""
    z = np.load(path)
    lib = native._bind(ctypes.CDLL(lib_path)) if lib_path else native.get_lib()
    if lib is None:
        raise RuntimeError("the native library is unavailable (SYPHA_TPU_NO_NATIVE, or g++ failed)")
    masks = np.ascontiguousarray(z["masks"])
    costs = np.ascontiguousarray(z["costs"])
    active = np.ascontiguousarray(z["active"])
    col_ptr = np.ascontiguousarray(z["col_ptr"])
    col_idx = np.ascontiguousarray(z["col_idx"])
    nrows = int(z["nrows"])
    nwords = int(z["nwords"])
    b = float(z["budget"]) if budget is None else float(budget)
    dl = float(z["deadline"]) if deadline is None else float(deadline)
    y = np.ascontiguousarray(z["duals"]) if use_duals else np.zeros(nrows)
    out = np.zeros(len(costs), dtype=np.uint8)
    ncuts = 0
    t0 = time.perf_counter()
    if use_cuts and "cut_w" in z and hasattr(lib, "sypha_exact_cover_cuts"):
        cut_w = np.ascontiguousarray(z["cut_w"])
        cut_coef = np.ascontiguousarray(z["cut_coef"])
        cut_rhs = np.ascontiguousarray(z["cut_rhs"])
        ncuts = len(cut_w)
        rc = lib.sypha_exact_cover_cuts(
            masks, ctypes.c_int64(nwords), costs, active,
            ctypes.c_int64(len(costs)), col_ptr, col_idx,
            ctypes.c_int64(nrows), b, dl, y, out,
            cut_w, cut_coef, cut_rhs, ctypes.c_int64(ncuts),
        )
    else:
        rc = lib.sypha_exact_cover(
            masks, ctypes.c_int64(nwords), costs, active,
            ctypes.c_int64(len(costs)), col_ptr, col_idx,
            ctypes.c_int64(nrows), b, dl, y, out,
        )
    dt = time.perf_counter() - t0
    cost = float(costs @ out) if rc == 1 else float("nan")
    print(
        f"{path}: n_active={int(active.sum())} nrows={nrows} budget={b:g} "
        f"cuts={ncuts} -> {VERDICTS[rc]} in {dt:.3f}s"
        + (f" (cover cost {cost:g})" if rc == 1 else "")
    )
    return rc, dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sypha_tpu_torch.benchmark.face_replay")
    ap.add_argument("faces", nargs="+")
    ap.add_argument("--budget", type=float, default=None)
    ap.add_argument("--deadline", type=float, default=None)
    ap.add_argument("--no-duals", action="store_true")
    ap.add_argument("--no-cuts", action="store_true")
    ap.add_argument("--lib", default=None, help="alternate libsypha_host .so")
    a = ap.parse_args(argv)
    for f in a.faces:
        replay(f, a.budget, a.deadline, use_duals=not a.no_duals, lib_path=a.lib, use_cuts=not a.no_cuts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
