"""ctypes bindings for the native host runtime (csrc/sypha_host.cpp).

The port's counterpart of sypha_tpu/native.py.  It builds and loads the same
C++ source as the JAX package, with g++, into ``sypha_tpu_torch/_build/``
under a name keyed by a hash of the source, the flags and the host CPU's
features; the build writes
a temporary file and moves it into place, so concurrent builders (test
workers) never load half a library.  Nothing is built at import: the first
call to ``get_lib`` builds.

The library is a host-side speed-up and nothing else: if it is missing and
cannot be built, or SYPHA_TPU_NO_NATIVE is set, every entry point returns
None and its callers use their numpy implementations, with identical
results.

Two switches serve the offline tuning of the exact-cover engine
(sypha_tpu_torch.benchmark.face_replay, tune_exact_cover), as in the JAX
package: SYPHA_TPU_NATIVE_LIB names an alternate build of the library,
loaded (built there first, if absent) in place of the hashed one, and
SYPHA_TPU_DUMP_FACES names a directory where every ``exact_cover`` call
saves its exact arguments as ``face_<ns>.npz`` before the native call.

Each call into the library is the span ``native.<entry>`` (utils.telemetry),
the build ``native.build``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from sypha_tpu_torch.utils.telemetry import span

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "sypha_host.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: -march=native code built on one CPU can
    fault on another, so a checkout shared between hosts keeps one library
    per CPU kind."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path() -> Path:
    """Where the library built from csrc/sypha_host.cpp lives for this host."""
    key = _SRC.read_bytes() + " ".join(GXX_FLAGS).encode() + _cpu_flags()
    return BUILD_DIR / f"libsypha_host_{hashlib.sha256(key).hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        with span("native.build"):
            subprocess.run(
                ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                check=True,
                capture_output=True,
                timeout=300,
            )
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sypha_scp_open.restype = ctypes.c_void_p
    lib.sypha_scp_open.argtypes = [ctypes.c_char_p]
    lib.sypha_scp_dims.restype = None
    lib.sypha_scp_dims.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sypha_scp_fill.restype = None
    lib.sypha_scp_fill.argtypes = [ctypes.c_void_p, f64p, i64p, i32p]
    lib.sypha_scp_close.restype = None
    lib.sypha_scp_close.argtypes = [ctypes.c_void_p]

    lib.sypha_greedy_set_cover.restype = ctypes.c_int
    lib.sypha_greedy_set_cover.argtypes = [
        i64p, i32p, f64p, u8p,
        ctypes.c_int, ctypes.c_int,
        i32p, ctypes.POINTER(ctypes.c_double),
    ]

    lib.sypha_single_column_dominance.restype = ctypes.c_int
    lib.sypha_single_column_dominance.argtypes = [
        u64p, ctypes.c_int, f64p, u8p, ctypes.c_int,
        ctypes.c_double, ctypes.c_double,
    ]
    shared = [
        u64p, ctypes.c_int, f64p, u8p, ctypes.c_int,
        i64p, i32p, ctypes.c_int, i64p, i32p,
        ctypes.c_double, ctypes.c_double,
    ]
    lib.sypha_two_column_dominance.restype = ctypes.c_int
    lib.sypha_two_column_dominance.argtypes = shared
    lib.sypha_cost_driven_replacement.restype = ctypes.c_int
    lib.sypha_cost_driven_replacement.argtypes = shared
    lib.sypha_budget_pruning.restype = ctypes.c_int
    lib.sypha_budget_pruning.argtypes = [
        u64p, ctypes.c_int, f64p, u8p, ctypes.c_int,
        i64p, i32p, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
    ]
    lib.sypha_exact_cover.restype = ctypes.c_int
    lib.sypha_exact_cover.argtypes = [
        u64p, ctypes.c_int64, f64p, u8p, ctypes.c_int64,
        i64p, i32p, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, f64p, u8p,
    ]
    # an alternate build (SYPHA_TPU_NATIVE_LIB, face_replay --lib) may
    # predate the cut-row entry: face_replay then replays a face without its
    # cut rows, and exact_cover refuses cut rows
    if hasattr(lib, "sypha_exact_cover_cuts"):
        lib.sypha_exact_cover_cuts.restype = ctypes.c_int
        lib.sypha_exact_cover_cuts.argtypes = [
            u64p, ctypes.c_int64, f64p, u8p, ctypes.c_int64,
            i64p, i32p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, f64p, u8p,
            f64p, f64p, f64p, ctypes.c_int64,
        ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use; None if unavailable.
    Disable with SYPHA_TPU_NO_NATIVE=1; SYPHA_TPU_NATIVE_LIB=path loads (or
    builds at) that path instead of ``library_path()``."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("SYPHA_TPU_NO_NATIVE"):
            return None
        override = os.environ.get("SYPHA_TPU_NATIVE_LIB")
        lib = Path(override) if override else library_path()
        if not lib.exists() and not _build(lib):
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(lib)))
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# high-level wrappers (None return = use the Python fallback)
# ---------------------------------------------------------------------------


def read_scp_file_native(path: str):
    """(costs, row_ptr, row_idx, nrows, ncols) or None."""
    lib = get_lib()
    if lib is None:
        return None
    with span("native.read_scp_file"):
        h = lib.sypha_scp_open(path.encode())
        if not h:
            return None
        try:
            nrows = ctypes.c_int()
            ncols = ctypes.c_int()
            nnz = ctypes.c_int64()
            lib.sypha_scp_dims(h, ctypes.byref(nrows), ctypes.byref(ncols), ctypes.byref(nnz))
            costs = np.empty(ncols.value, dtype=np.float64)
            row_ptr = np.empty(nrows.value + 1, dtype=np.int64)
            row_idx = np.empty(max(nnz.value, 1), dtype=np.int32)
            lib.sypha_scp_fill(h, costs, row_ptr, row_idx)
            return costs, row_ptr, row_idx[: nnz.value], nrows.value, ncols.value
        finally:
            lib.sypha_scp_close(h)


class _ModelArrays:
    """Flat-array view of a BaseModel for the native rules (cached per model
    until its cut set changes; the rules only touch covering rows)."""

    def __init__(self, model):
        self.masks = np.ascontiguousarray(model.col_masks)
        self.nwords = model._nwords
        self.costs = np.ascontiguousarray(model.costs)
        nrows = model.nrows_cover
        ncols = model.ncols
        self.nrows = nrows
        self.ncols = ncols
        self.row_ptr = np.zeros(nrows + 1, dtype=np.int64)
        for i, cols in enumerate(model.cols_by_row):
            self.row_ptr[i + 1] = self.row_ptr[i] + len(cols)
        self.row_idx = (
            np.concatenate(model.cols_by_row).astype(np.int32)
            if nrows
            else np.zeros(0, np.int32)
        )
        self.col_ptr = np.zeros(ncols + 1, dtype=np.int64)
        for j, rows in enumerate(model.rows_by_col):
            self.col_ptr[j + 1] = self.col_ptr[j] + len(rows)
        self.col_idx = (
            np.concatenate(model.rows_by_col).astype(np.int32)
            if ncols
            else np.zeros(0, np.int32)
        )


def _arrays(model) -> _ModelArrays:
    cache = getattr(model, "_native_arrays", None)
    if cache is None:
        cache = _ModelArrays(model)
        model._native_arrays = cache
    return cache


def _run_rule(model, fn_name: str, tol: float, deadline_sec: float) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    ar = _arrays(model)
    active = model.active.astype(np.uint8)
    fn = getattr(lib, fn_name)
    with span("native." + fn_name.removeprefix("sypha_")):
        if fn_name == "sypha_single_column_dominance":
            removed = fn(ar.masks, ar.nwords, ar.costs, active, ar.ncols,
                         tol, deadline_sec)
        else:
            removed = fn(ar.masks, ar.nwords, ar.costs, active, ar.ncols,
                         ar.row_ptr, ar.row_idx, ar.nrows, ar.col_ptr, ar.col_idx,
                         tol, deadline_sec)
    model.active[:] = active.astype(bool)
    return int(removed)


def single_column_dominance(model, tol, deadline_sec) -> Optional[int]:
    return _run_rule(model, "sypha_single_column_dominance", tol, deadline_sec)


def two_column_dominance(model, tol, deadline_sec) -> Optional[int]:
    return _run_rule(model, "sypha_two_column_dominance", tol, deadline_sec)


def cost_driven_replacement(model, tol, deadline_sec) -> Optional[int]:
    return _run_rule(model, "sypha_cost_driven_replacement", tol, deadline_sec)


def budget_pruning(model, incumbent, tol, deadline_sec) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    ar = _arrays(model)
    active = model.active.astype(np.uint8)
    with span("native.budget_pruning"):
        removed = lib.sypha_budget_pruning(
            ar.masks, ar.nwords, ar.costs, active, ar.ncols,
            ar.row_ptr, ar.row_idx, ar.nrows,
            float(incumbent), tol, deadline_sec,
        )
    model.active[:] = active.astype(bool)
    return int(removed)


def greedy_set_cover(model):
    """(objective, selected) or None."""
    lib = get_lib()
    if lib is None:
        return None
    ar = _arrays(model)
    active = model.active.astype(np.uint8)
    selected = np.zeros(ar.ncols, dtype=np.int32)
    obj = ctypes.c_double()
    with span("native.greedy_set_cover"):
        nsel = lib.sypha_greedy_set_cover(
            ar.col_ptr, ar.col_idx, ar.costs, active,
            ar.nrows, ar.ncols, selected, ctypes.byref(obj),
        )
    if nsel < 0:
        return (np.inf, np.zeros(0, dtype=np.int64))
    return (float(obj.value), selected[:nsel].astype(np.int64))


def save_face(path, ar, active, budget, deadline_sec, duals, cuts=None):
    """Save one exact-cover face, the native call's arguments, as ``path``
    (.npz) for offline replay (benchmark.face_replay), with the JAX
    package's keys: ``ar`` the model's ``_arrays``, ``active`` uint8,
    ``duals`` per covering row, ``cuts`` an optional (w, coef, rhs)."""
    extra = {}
    if cuts is not None:
        extra = dict(
            cut_w=np.asarray(cuts[0], dtype=np.float64),
            cut_coef=np.asarray(cuts[1], dtype=np.float64),
            cut_rhs=np.asarray(cuts[2], dtype=np.float64),
        )
    np.savez_compressed(
        path,
        masks=ar.masks, costs=ar.costs, active=active,
        col_ptr=ar.col_ptr, col_idx=ar.col_idx,
        nrows=np.int64(ar.nrows), nwords=np.int64(ar.nwords),
        budget=np.float64(budget), deadline=np.float64(deadline_sec),
        duals=duals, **extra,
    )


def exact_cover(model, budget: float, deadline_sec: float, duals=None,
                cuts=None):
    """Native implicit enumeration (sypha_exact_cover): find a cover with
    cost <= budget among active columns or prove none exists.  ``duals``
    (optional, per covering row) arms the LP-dual Lagrangian bound; any
    y >= 0 is admissible.  ``cuts`` (optional, requires duals)
    = (w[nc], coef[nc, ncols], rhs[nc]) arms the static cut-row Lagrangian
    term.

    Returns (True, x) / (False, None), (None, None) when the deadline fired
    (inconclusive), or None when the library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    ar = _arrays(model)
    active = np.ascontiguousarray(model.active.astype(np.uint8))
    out = np.zeros(model.ncols, dtype=np.uint8)
    if duals is None:
        y = np.zeros(ar.nrows, dtype=np.float64)
    else:
        y = np.ascontiguousarray(
            np.nan_to_num(np.asarray(duals, dtype=np.float64)[: ar.nrows],
                          nan=0.0, posinf=0.0, neginf=0.0)
        )
        if len(y) < ar.nrows:
            y = np.concatenate([y, np.zeros(ar.nrows - len(y))])
    if cuts is not None and not hasattr(lib, "sypha_exact_cover_cuts"):
        # only an alternate build (SYPHA_TPU_NATIVE_LIB) can lack it; the
        # plain entry would search without the cut rows
        raise RuntimeError(
            f"the native library {getattr(lib, '_name', lib)} has no sypha_exact_cover_cuts entry, "
            "and exact_cover was given cut rows"
        )
    dump_dir = os.environ.get("SYPHA_TPU_DUMP_FACES")
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
        save_face(os.path.join(dump_dir, f"face_{time.monotonic_ns()}"), ar, active, budget, deadline_sec, y, cuts)
    if cuts is not None:
        cut_w, cut_coef, cut_rhs = cuts
        cut_w = np.ascontiguousarray(
            np.nan_to_num(np.asarray(cut_w, dtype=np.float64),
                          nan=0.0, posinf=0.0, neginf=0.0)
        )
        cut_coef = np.ascontiguousarray(
            np.asarray(cut_coef, dtype=np.float64)
        )
        cut_rhs = np.ascontiguousarray(np.asarray(cut_rhs, dtype=np.float64))
        nc = int(len(cut_w))
        if cut_coef.shape != (nc, model.ncols):
            raise ValueError(f"cut coefficients {cut_coef.shape}, expected {(nc, model.ncols)}")
        with span("native.exact_cover_cuts"):
            rc = lib.sypha_exact_cover_cuts(
                ar.masks, ctypes.c_int64(ar.nwords), ar.costs, active,
                ctypes.c_int64(ar.ncols), ar.col_ptr, ar.col_idx,
                ctypes.c_int64(ar.nrows),
                float(budget), float(deadline_sec), y, out,
                cut_w, cut_coef, cut_rhs, ctypes.c_int64(nc),
            )
    else:
        with span("native.exact_cover"):
            rc = lib.sypha_exact_cover(
                ar.masks, ctypes.c_int64(ar.nwords), ar.costs, active,
                ctypes.c_int64(ar.ncols), ar.col_ptr, ar.col_idx,
                ctypes.c_int64(ar.nrows),
                float(budget), float(deadline_sec), y, out,
            )
    if rc == 1:
        return True, out.astype(np.float64)
    if rc == 0:
        return False, None
    return (None, None)  # ran but inconclusive (deadline)
