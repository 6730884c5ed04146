"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m portbench.run ...          (the same, from the checkout's root)

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks`` (each number compared, with
its limit); the same numbers end standard error.  Exits non-zero, printing no
result, where there is no CUDA card or fewer than the cell asks for, where
the port is not beside this folder, or where jax, jaxlib, flax or the JAX
package was loaded.  Caches of the build tools go under ``.portbench_cache/``
in the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# run as a script, this folder is first on the path, where its module names
# (trace, run) would shadow the standard library's
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


# threads of the host's math libraries (OpenMP, BLAS): one, so that the
# run's host work is one thread's load on cores that other processes share
HOST_THREADS = "1"


def _environment():
    """Fixed cache directories inside the checkout, one thread for the math
    libraries, and the port's default paths: no alternate host library, no
    face dumps."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = HOST_THREADS
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    for var in ("SYPHA_TPU_NATIVE_LIB", "SYPHA_TPU_DUMP_FACES", "SYPHA_TPU_NO_NATIVE"):
        os.environ.pop(var, None)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py", description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()

    import torch

    from portbench import harness

    w = harness.workload(harness.spec(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"portbench: {args.workload} needs {w['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import sypha_tpu_torch  # noqa: F401  (fails here where the port is absent)

    result, rows = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                    "cuda", t_start=T_START)
    # read once the window has closed, so that set-up does not carry it
    print(f"portbench: {args.workload} seed {args.seed} on {_power_limit()}, "
          f"torch {torch.__version__}", file=sys.stderr, flush=True)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"portbench: the run loaded {', '.join(foreign)}; no result", file=sys.stderr)
        return 3
    for line in harness.check_lines(rows):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(harness.finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
