"""Root cut-round study: the dual bound per separation round.  The port of
the JAX package's benchmark/root_cut_study.py.

    python3 -m sypha_tpu_torch.benchmark.root_cut_study scpnre1 --synthetic \\
        [--rounds 6] [--max-cuts 24] [--deadline 600] [--iters 0] \\
        [--separators all|zerohalf] [--dump-points PREFIX] [--device cpu]

``instance`` is a path to an SCP file, or an OR-Library name looked up in
``--data-dir`` (or made with ``--synthetic``).  Solves the root LP on the
B&B's node-LP solver, separates, appends the cuts, re-solves, and prints one
JSON line per round with the dual bound and wall seconds, and one per
separation with the cuts it appended.  It bypasses the driver's
cut_skip_gap policy, so a separator can be graded on the instances that
policy skips.  ``--dump-points`` saves each round's LP point (x, y) as
``<prefix>_r<round>.npz`` for grading separators offline.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from sypha_tpu_torch.benchmark import add_common_args, label, load, require_source


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sypha_tpu_torch.benchmark.root_cut_study")
    ap.add_argument("instance", help="SCP file, or an OR-Library name in --data-dir / --synthetic")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--max-cuts", type=int, default=24)
    ap.add_argument("--deadline", type=float, default=600.0)
    ap.add_argument("--iters", type=int, default=0, help="total IPM iteration budget per solve (0 = opts.max_iter)")
    ap.add_argument(
        "--separators", default="all",
        help="all | zerohalf (zerohalf-only isolates the new family)",
    )
    ap.add_argument(
        "--dump-points", default="",
        help="npz path prefix: save the LP point (x, y) of every round "
        "for offline separator grading on CPU",
    )
    add_common_args(ap)
    return ap


def _model(args):
    """(model, its label): a file given by path, else a named instance."""
    from sypha_tpu_torch.io.scp_reader import read_scp_file

    if os.path.exists(args.instance):
        return read_scp_file(args.instance), args.instance
    src = require_source(args.instance, args.data_dir, args.synthetic)
    return load(src, args.instance), label(args.instance, src)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    from sypha_tpu_torch.config import SolverConfig
    from sypha_tpu_torch.core.device import resolve_device
    from sypha_tpu_torch.milp.base_model import BaseModel, BranchNode
    from sypha_tpu_torch.milp.bnb import _NodeLpSolver
    from sypha_tpu_torch.milp.cuts import separate_cuts, zero_half_mod2
    from sypha_tpu_torch.utils.logging import Logger

    dev = resolve_device(args.device)
    model, name = _model(args)
    print(f"{name}: {model.nrows} x {model.ncols}", flush=True)
    base = BaseModel(model)
    cfg = SolverConfig(verbosity=0)
    solver = _NodeLpSolver(base, cfg, Logger(verbosity=0), device=dev)
    ipm_opts = cfg.ipm.replace(newton_max_steps=max(cfg.ipm.newton_max_steps, 48))

    deadline = time.monotonic() + args.deadline
    total_cuts = 0
    for rnd in range(args.rounds + 1):
        t0 = time.monotonic()
        res = solver.solve_nodes([BranchNode()], ipm_opts, deadline, total_iters=args.iters or None)[0]
        solve_s = time.monotonic() - t0
        dual = float(res["dobj"])
        row = {
            "round": rnd,
            "dual": dual,
            "pobj": float(res["pobj"]),
            "status": str(res["status"]),
            "cuts_total": total_cuts,
            "solve_s": round(solve_s, 2),
        }
        print(json.dumps(row), flush=True)
        if args.dump_points:
            np.savez_compressed(f"{args.dump_points}_r{rnd}.npz", x=res["x"], y=res["y"], dual=dual)
        if rnd == args.rounds or time.monotonic() > deadline:
            break
        t1 = time.monotonic()
        separate = zero_half_mod2 if args.separators == "zerohalf" else separate_cuts
        cuts = separate(base, res["x"], res["y"], 1e-6, max_cuts=args.max_cuts)
        room = solver.room_for_cuts()
        cuts = cuts[:room]
        sep_s = time.monotonic() - t1
        print(
            json.dumps({"round": rnd, "separated": len(cuts), "room": room, "sep_s": round(sep_s, 2)}),
            flush=True,
        )
        if not cuts:
            break
        base.add_cuts(cuts)
        total_cuts += len(cuts)
        solver.refresh()
    return 0


if __name__ == "__main__":
    sys.exit(main())
