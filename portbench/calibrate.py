"""Readings that the limits of ``correct`` are set from: for each seed, the
numbers that the check computes on the program's answers (the lower
readings) and on the control's (the upper readings), in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds <s> \
        [--fault <name>] [--no-control] [--out file]

Per seed it builds the cell from the seed, runs its timed path for
``--seconds`` at the cell's own size and load, judges the answers as a run
does, then puts the control in the program's place on the same inputs (the
plain reference in float32 for an LP cell, under both status rules of
``kinds.control_status``; the reference's unproven root cover for a B&B
cell) and judges that.  ``--fault`` plants one of ``faults.FAULTS`` under the
timed path first.  One JSON line per seed, on standard output and appended
to ``--out``, with the answers by status and the calls' IPM iterations.
Needs the card; the benchmark's own runs never run this.
"""

from __future__ import annotations

import sys
from pathlib import Path

if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def readings(name: str, seed: int, seconds: float, device, fault=None, control=True) -> dict:
    """One seed's numbers for the program (with ``fault`` planted) and for
    the control."""
    from portbench import faults, harness

    w = harness.workload(harness.spec(ROOT), name)
    config, traffic, limits = harness.cell_files(w)
    t0 = time.perf_counter()
    cell = harness.kind(traffic["kind"]).setup(config, traffic, seed, device)
    undo = faults.plant(fault, traffic["kind"]) if fault else None
    try:
        cell.warm()
        records, window_s = harness.window(cell, seconds, device)
    finally:
        if undo:
            undo()
    cell.release()
    program, attempted, failed = cell.check(limits)
    row = {"workload": name, "seed": seed, "fault": fault, "calls": len(records),
           "window_s": window_s, "attempted": attempted, "failed": failed, "program": program,
           "correct": harness.judge.verdict(program, limits)[1] and failed == 0,
           "ipm_iters": [r["ipm_iters"] for r in records],
           "statuses": dict(cell.statuses()) if hasattr(cell, "statuses") else None}
    if control:
        row["control"] = {rule: cell.control(rule) for rule in ("claims", "program")}
    row["seconds_total"] = time.perf_counter() - t0
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", default=None, help="a fault of faults.FAULTS to plant")
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        row = harness.finite(readings(args.workload, seed, args.seconds, "cuda", args.fault,
                                      not args.no_control))
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
