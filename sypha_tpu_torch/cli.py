"""Command-line interface: the port of sypha_tpu/cli.py.

Flags replicate the reference's boost::program_options table
(src/sypha_environment.cpp:110-149) name-for-name with the same defaults
(src/sypha_environment_defaults.h), as the JAX package's CLI does, plus one
of the port's own: ``--device`` (``cuda`` by default, ``cpu`` to run on the
CPU).  With ``cuda`` and no card, ``main`` prints the error to stderr and
returns non-zero; it never solves on the CPU unasked.  Output mirrors
src/main.cpp:64-78 and adds the uppercase ``PRIMAL:`` / ``DUAL:`` /
``ITERATIONS:`` / ``TIME ...`` lines the reference's own test harness greps
for (python/sypha_unit_tests.py:96-115).

Usage:  python -m sypha_tpu_torch --model SCP --input-file data/scp41.txt [flags]
"""

from __future__ import annotations

import argparse
import contextlib
import math
import sys
import time

from sypha_tpu_torch.config import BnbOptions, CgOptions, IpmOptions, SolverConfig

BANNER = r"""
	 ___ _   _ _ __ | |__   __ _
	/ __| | | | '_ \| '_ \ / _` |
	\__ \ |_| | |_) | | | | (_| |
	|___/\__, | .__/|_| |_|\__,_|
	     |___/|_|    batched IPM / B&B  on GPU
"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sypha_tpu_torch",
        description="GPU interior-point solver for Set Covering Problems",
    )
    # reference flag table, src/sypha_environment.cpp:111-149
    p.add_argument("--unit-tests", default="none", help="launch unit tests")
    p.add_argument("--unit-tests-rep", type=int, default=1,
                   help="set number of repeats for each test")
    p.add_argument("--input-file", help="set input file path")
    p.add_argument("--model", default="SCP", help="set input model type (scp)")
    p.add_argument("--sparse", type=int, default=1,
                   help="import model as sparse model")
    p.add_argument("--time-limit", type=float, default=0.0, help="set time limit")
    p.add_argument("--seed", type=int, default=0, help="set random seed")
    p.add_argument("--thread", type=int, default=1, help="set number of thread")
    p.add_argument("--tol", type=float, default=1e-8, help="set tolerance")
    p.add_argument("--verbosity", type=int, default=5, help="set verbosity level")
    p.add_argument("--debug", type=int, default=0, help="set debug level")
    p.add_argument("--show-solution", action="store_true", default=False,
                   help="show final solution summary")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the solve to this "
                        "directory (TensorBoard/Perfetto viewable); the "
                        "upgrade of the reference's GPU-memory telemetry "
                        "(src/sypha_solver.cpp:209-216)")
    p.add_argument("--mehrotra-max-iter", type=int, default=60,
                   help="set max iterations for Mehrotra IPM")
    p.add_argument("--dense-memory-threshold", type=float, default=2.0 / 3.0,
                   help="(accepted for compatibility; strategy selection is "
                        "by padded problem size, not GPU memory)")
    p.add_argument("--linear-solver", default="auto",
                   help="linear solver strategy: auto|dense|cg "
                        "(reference adds sparse_qr, a cusolverSp artifact)")
    p.add_argument("--krylov-max-cg-iter", type=int, default=500,
                   help="max CG iterations for Krylov solver")
    p.add_argument("--krylov-cg-tol-initial", type=float, default=1e-2,
                   help="initial CG relative tolerance")
    p.add_argument("--krylov-cg-tol-final", type=float, default=1e-8,
                   help="final CG relative tolerance")
    p.add_argument("--krylov-cg-tol-decay", type=float, default=0.5,
                   help="CG tolerance decay rate per IPM iteration")
    p.add_argument("--disable-bnb", action="store_true", default=False,
                   help="disable branch-and-bound and solve LP relaxation only")
    p.add_argument("--bnb-auto-fallback-lp", type=int, default=1,
                   help="fallback to LP relaxation if BnB finds no incumbent")
    p.add_argument("--bnb-max-nodes", type=int, default=100000,
                   help="set max number of BnB nodes to process")
    p.add_argument("--bnb-device-queue", type=int, default=1000,
                   help="active BnB node window capacity (solved as one "
                        "batched IPM call; capped at 128 lanes)")
    p.add_argument("--bnb-gap-stall-iters", type=int, default=5,
                   help="branch if gap does not improve for this many iters")
    p.add_argument("--bnb-gap-stall-pct", type=float, default=1.0,
                   help="minimum gap improvement pct to reset stall counter")
    p.add_argument("--bnb-int-tol", type=float, default=1e-6,
                   help="integrality tolerance for BnB")
    p.add_argument("--bnb-var-select", default="most_fractional",
                   help="most_fractional|highest_cost_fractional")
    p.add_argument("--bnb-int-heur-every", type=int, default=1,
                   help="run integer heuristics every n BnB nodes")
    p.add_argument("--bnb-int-heuristics",
                   default="nearest_integer_fixing,dual_guided_cover_repair",
                   help="comma-separated integer heuristics")
    p.add_argument("--bnb-log-interval-sec", type=float, default=5.0,
                   help="seconds between BnB progress logs (<=0 disables)")
    p.add_argument("--bnb-hard-time-limit-sec", type=float, default=0.0,
                   help="hard BnB time limit in seconds (<=0 disables)")
    p.add_argument("--bnb-gap-stagnation-window", type=int, default=50,
                   help="reduce LP iterations when MIP gap stagnates this long")
    p.add_argument("--bnb-cuts", type=int, default=1,
                   help="enable cutting planes at root node")
    p.add_argument("--bnb-cut-rounds-root", type=int, default=5,
                   help="max cut separation rounds at root node")
    p.add_argument("--bnb-tree-cut-nodes", type=int, default=2,
                   help="in-tree cut separation: fractional nodes separated "
                   "per window round (0 = root-only cuts, the reference "
                   "behavior)")
    p.add_argument("--bnb-mesh-devices", type=int, default=0,
                   help="dispatch node windows lane-sharded over this many "
                   "devices (0 = single device; more is not ported yet and "
                   "raises NotImplementedError)")
    p.add_argument("--bnb-precompile", type=int, default=1,
                   help="warm up node-LP windows (kernel build, first "
                   "windows) before starting the solve clock (1, default) "
                   "or let the warm-up land in the time budget (0)")
    p.add_argument("--bnb-checkpoint", default="",
                   help="checkpoint/resume path for the search state "
                   "('' disables)")
    p.add_argument("--bnb-max-cuts-per-round", type=int, default=50,
                   help="max cuts added per separation round")
    p.add_argument("--bnb-warm-start-nodes", type=int, default=0,
                   help="warm-start node LPs from parent iterates (0, "
                   "default: cold starts)")
    p.add_argument("--bnb-core-time-frac", type=float, default=0.45,
                   help="fraction of remaining budget for the restricted "
                   "core (kernel) search on large-gap instances (0 "
                   "disables)")
    p.add_argument("--bnb-core-time-cap-sec", type=float, default=60.0,
                   help="hard cap on the core-search slice")
    p.add_argument("--bnb-core-rounds", type=int, default=3,
                   help="max core-search rounds (CFT core refresh: rebuild "
                   "around the new support after each improvement)")
    p.add_argument("--bnb-root-time-frac", type=float, default=0.5,
                   help="optional root phases (Lagrangian, cut rounds, "
                   "core search) may spend at most this fraction of the "
                   "hard budget before the tree starts (0 disables)")
    p.add_argument("--bnb-exact-closure", type=int, default=1,
                   help="enable the exact-closure engine (host bitset DFS "
                   "budget probing over reduced faces); 0 = pure tree "
                   "search with cuts and rc-fixing")
    p.add_argument("--bnb-cut-skip-gap", type=float, default=10.0,
                   help="skip root cut rounds when the integer gap exceeds "
                   "this many objective units (0 disables the skip)")
    p.add_argument("--bnb-lagrangian-budget-sec", type=float, default=5.0,
                   help="wall budget for the CFT subgradient/greedy root "
                   "heuristic (0 disables)")
    p.add_argument("--preprocess-columns",
                   default="single_column_dominance,two_column_dominance",
                   help="comma-separated preprocessing rules (or none)")
    p.add_argument("--preprocess-time-limit-sec", type=float, default=5.0,
                   help="time limit for column preprocessing (<=0 disables)")
    p.add_argument("--device", default="cuda",
                   help="torch device to solve on: cuda (default; fails "
                   "when there is no card) or cpu")
    return p


def config_from_args(args) -> SolverConfig:
    var_select = (
        "highest_cost"
        if args.bnb_var_select == "highest_cost_fractional"
        else args.bnb_var_select
    )
    return SolverConfig(
        verbosity=args.verbosity,
        time_limit_sec=args.time_limit,
        seed=args.seed,
        linear_solver=args.linear_solver,
        disable_bnb=args.disable_bnb,
        show_solution=args.show_solution,
        preprocess_time_limit_sec=args.preprocess_time_limit_sec,
        preprocess_column_strategies=args.preprocess_columns,
        ipm=IpmOptions(
            max_iter=args.mehrotra_max_iter,
            tol_gap=args.tol,
            tol_feas=args.tol,
            linear_solver=args.linear_solver,
            cg_max_iter=args.krylov_max_cg_iter,
            cg_tol_initial=args.krylov_cg_tol_initial,
            cg_tol_final=args.krylov_cg_tol_final,
            cg_tol_decay=args.krylov_cg_tol_decay,
        ),
        cg=CgOptions(
            max_cg_iter=args.krylov_max_cg_iter,
            tol_initial=args.krylov_cg_tol_initial,
            tol_final=args.krylov_cg_tol_final,
            tol_decay_rate=args.krylov_cg_tol_decay,
        ),
        bnb=BnbOptions(
            max_nodes=args.bnb_max_nodes,
            node_batch=max(1, min(args.bnb_device_queue, 128)),
            gap_stall_branch_iters=args.bnb_gap_stall_iters,
            gap_stall_min_improv_pct=args.bnb_gap_stall_pct,
            integrality_tol=args.bnb_int_tol,
            heuristic_every_n_nodes=args.bnb_int_heur_every,
            log_interval_sec=args.bnb_log_interval_sec,
            hard_time_limit_sec=(
                args.bnb_hard_time_limit_sec
                if args.bnb_hard_time_limit_sec > 0
                else args.time_limit
            ),
            gap_stagnation_window=args.bnb_gap_stagnation_window,
            auto_fallback_lp=bool(args.bnb_auto_fallback_lp),
            cuts_enabled=bool(args.bnb_cuts),
            cut_rounds_root=args.bnb_cut_rounds_root,
            max_cuts_per_round=args.bnb_max_cuts_per_round,
            var_selection=var_select,
            int_heuristics=args.bnb_int_heuristics,
            tree_cut_nodes_per_round=args.bnb_tree_cut_nodes,
            mesh_devices=args.bnb_mesh_devices,
            precompile=bool(args.bnb_precompile),
            checkpoint_path=args.bnb_checkpoint,
            warm_start_nodes=bool(args.bnb_warm_start_nodes),
            core_time_frac=args.bnb_core_time_frac,
            core_time_cap_sec=args.bnb_core_time_cap_sec,
            root_time_frac=args.bnb_root_time_frac,
            core_rounds=args.bnb_core_rounds,
            cut_skip_gap=args.bnb_cut_skip_gap,
            lagrangian_budget_sec=args.bnb_lagrangian_budget_sec,
            exact_closure=bool(args.bnb_exact_closure),
        ),
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.input_file:
        print("error: --input-file is required", file=sys.stderr)
        return -1
    if args.model.upper() != "SCP":
        print(f"error: unsupported model type '{args.model}'", file=sys.stderr)
        return -1

    from sypha_tpu_torch.core.device import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.verbosity > 1:
        print(BANNER)

    from sypha_tpu_torch.io.scp_reader import read_scp_file
    from sypha_tpu_torch.utils.logging import Logger
    from sypha_tpu_torch.utils.telemetry import MemorySampler, profile_trace

    log = Logger(verbosity=args.verbosity)
    cfg = config_from_args(args)
    t_start = time.monotonic()

    log.info(f"Environment initialized (device {dev})")
    log.info("Reading model")
    t_read0 = time.monotonic()
    try:
        model = read_scp_file(args.input_file)
    except (OSError, ValueError) as e:
        log.error(f"Model read failed: {e}")
        return 1
    t_pre = time.monotonic() - t_read0

    log.info("Launching solver")
    t_sol0 = time.monotonic()
    trace_cm = (
        profile_trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    )
    t_compile = 0.0
    # memory sampling around the solve phase at verbosity >= 4 (reference
    # samples around every linear solve, src/sypha_solver.cpp:209-216)
    sampler = MemorySampler(enabled=args.verbosity >= 4, device=dev)
    with trace_cm, sampler:
        if args.disable_bnb:
            from sypha_tpu_torch.io.standard_form import pad_lp
            from sypha_tpu_torch.ipm.driver import solve_lp

            res = solve_lp(pad_lp(model, device=dev), cfg.ipm)
            primal, dual = res.primal_objective, res.dual_objective
            mip_gap = math.nan
            iterations = res.iterations
            solution = res.x[: model.ncols]
        else:
            from sypha_tpu_torch.milp.bnb import branch_and_bound

            r = branch_and_bound(model, cfg, log, device=dev)
            primal, dual = r.objective, r.dual_bound
            mip_gap = r.mip_gap
            iterations = r.total_lp_iterations
            solution = r.solution
            t_compile = r.compile_time_sec
    t_solver = time.monotonic() - t_sol0
    t_total = time.monotonic() - t_start
    if args.verbosity >= 4:
        log.debug(f"Device memory {sampler.report()}")
    if args.profile_dir:
        log.info(f"Profiler trace written to {args.profile_dir}")

    log.info("--- Solution ---")
    log.info(f"  Primal:     {primal:.20g}")
    log.info(f"  Dual:       {dual:.20g}")
    if math.isfinite(mip_gap):
        log.info(f"  MIP gap:    {mip_gap * 100.0:.6f}%")
    else:
        log.info("  MIP gap:    n/a")
    log.info("--- Run statistics ---")
    log.info(f"  Iterations: {iterations}")
    log.info(
        f"  Time (s):   start 0.000  pre {t_pre:.2f}  "
        f"compile {t_compile:.2f}  solver {t_solver - t_compile:.2f}  "
        f"total {t_total:.2f}"
    )
    # uppercase grep-compatible lines for the reference's test harness
    print(f"PRIMAL: {primal:.20g}")
    print(f"DUAL: {dual:.20g}")
    print(f"ITERATIONS: {iterations}")
    print("TIME START SOL: 0.0")
    print(f"TIME PRE SOL: {t_pre * 1000.0:.3f}")
    # solver time net of the one-time warm-up (the kernel build and the
    # first node windows), which is reported on its own line
    print(f"TIME SOLVER: {(t_solver - t_compile) * 1000.0:.3f}")
    print(f"TIME COMPILE: {t_compile * 1000.0:.3f}")

    if args.show_solution and solution is not None and len(solution):
        import numpy as np

        chosen = [int(j) for j in np.flatnonzero(solution > 0.5)]
        print(f"SELECTED COLUMNS ({len(chosen)}): {chosen}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
