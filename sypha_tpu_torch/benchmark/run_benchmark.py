"""LP / MILP rows per OR-Library family, as CSV: the port of the JAX
package's benchmark/run_benchmark.py, with its columns and file names.

    python3 -m sypha_tpu_torch.benchmark.run_benchmark --synthetic \\
        [--families scp4,scp5] [--instances scp41,scp48] [--lp-only] \\
        [--time-limit 120] [--out DIR] [--merge] [--no-warmup] \\
        [--device cpu] [--data-dir DIR]

LP rows are ``solve_lp(pad_lp(model))``; MILP rows ``branch_and_bound``
with the hard time limit.  ``time_compile_s`` is the solver's one-time
warm-up (``MilpResult.compile_time_sec``: the Gram kernel's build and one
short window per variant), outside its time budget, and ``time_solver_s``
is net of it.  ``FAMILY_BNB_OVERRIDES`` sets BnbOptions per family (the
warm-up's and the timed rows', ``--synthetic`` stand-ins included), as in
the JAX tool.  Before each family's timed rows its first instance is
solved once, untimed, unless ``--no-warmup``.  The CSV is rewritten after
every row.  The default ``--out`` is ``sypha_tpu_torch/benchmark/results/``
(git-ignored): ``benchmark/results/`` holds the JAX package's rows, from
which README's tables are generated.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

from sypha_tpu_torch.benchmark import RESULTS_DIR, add_common_args, family_instances, label, load, row_name

FIELDS = [
    "instance", "num_sets", "num_elements", "primal", "dual",
    "mip_gap_pct", "iterations", "time_pre_s", "time_solver_s",
    "time_compile_s", "time_total_s", "incumbent", "status",
]

# Per-family BnbOptions overrides, the JAX tool's: scpnrg's node windows run
# on the dense operator, where ``auto`` would pick padded ELL (1.83%
# density).  On the H100 the ELL operator is 0.87-0.98x the dense one's
# speed at this class (ell_vs_dense, 64 and 128 lanes).
FAMILY_BNB_OVERRIDES = {
    "scpnrg": {"node_operator": "dense"},
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sypha_tpu_torch.benchmark.run_benchmark")
    ap.add_argument("--families", default="scp4,scp5")
    ap.add_argument(
        "--instances", default="",
        help="comma-separated instance names (e.g. scp48,scp49) to restrict "
        "the sweep to; rows for other instances are untouched if --merge",
    )
    ap.add_argument(
        "--merge", action="store_true",
        help="merge the new rows into an existing output CSV instead of "
        "overwriting it (keyed by instance name)",
    )
    ap.add_argument("--lp-only", action="store_true")
    ap.add_argument("--time-limit", type=float, default=120.0)
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument(
        "--no-warmup", action="store_true",
        help="skip the per-family warm-up run (first instance, untimed) that "
        "builds the kernel and the library handles before the timed rows",
    )
    add_common_args(ap)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    from sypha_tpu_torch.config import BnbOptions, IpmOptions, SolverConfig
    from sypha_tpu_torch.core.device import resolve_device
    from sypha_tpu_torch.core.status import IpmStatus, MilpStatus
    from sypha_tpu_torch.io.standard_form import pad_lp
    from sypha_tpu_torch.ipm.driver import solve_lp
    from sypha_tpu_torch.milp.bnb import branch_and_bound

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    mode = "lp" if args.lp_only else "milp"
    fam_tag = args.families.replace(",", "_")
    out_csv = os.path.join(args.out, f"sypha_tpu_{mode}_{fam_tag}_results.csv")
    keep = {s.strip() for s in args.instances.split(",") if s.strip()}
    merge_base = _read_base(out_csv) if args.merge else None

    def milp_cfg(fam: str, limit: float) -> SolverConfig:
        return SolverConfig(
            verbosity=1,
            bnb=BnbOptions(hard_time_limit_sec=limit, **FAMILY_BNB_OVERRIDES.get(fam, {})),
        )

    rows = []
    for fam in args.families.split(","):
        fam = fam.strip()
        found = family_instances(fam, args.data_dir, args.synthetic, keep)
        if found and not args.no_warmup:
            wname, wsrc = found[0]
            t_w = time.monotonic()
            wm = load(wsrc, wname)
            if args.lp_only:
                solve_lp(pad_lp(wm, device=dev), IpmOptions())
            else:
                branch_and_bound(wm, milp_cfg(fam, min(30.0, args.time_limit)), device=dev)
            print(
                f"[{fam}] warmup on {label(wname, wsrc)}: {time.monotonic() - t_w:.1f}s "
                "(kernel build, library handles; excluded from timed rows)"
            )
        for name, src in found:
            t0 = time.monotonic()
            model = load(src, name)
            t_pre = time.monotonic() - t0

            t1 = time.monotonic()
            t_compile = 0.0
            if args.lp_only:
                res = solve_lp(pad_lp(model, device=dev), IpmOptions())
                t_solver = time.monotonic() - t1
                status = "OPTIMAL" if res.status == IpmStatus.CONVERGED else res.status.name
                row = dict(
                    instance=row_name(name, src),
                    num_sets=model.ncols,
                    num_elements=model.nrows,
                    primal=f"{res.primal_objective:.10g}",
                    dual=f"{res.dual_objective:.10g}",
                    mip_gap_pct="",
                    iterations=res.iterations,
                    incumbent="",
                    status=status,
                )
            else:
                r = branch_and_bound(model, milp_cfg(fam, args.time_limit), device=dev)
                t_solver = time.monotonic() - t1
                t_compile = r.compile_time_sec
                status = {
                    MilpStatus.OPTIMAL: "OPTIMAL",
                    MilpStatus.FEASIBLE: "FEASIBLE",
                    MilpStatus.NOT_SOLVED: "NO_INCUMBENT",
                }.get(r.status, "ERROR")
                row = dict(
                    instance=row_name(name, src),
                    num_sets=model.ncols,
                    num_elements=model.nrows,
                    primal=f"{r.objective:.10g}",
                    dual=f"{r.dual_bound:.10g}",
                    mip_gap_pct=f"{r.mip_gap * 100.0:.6f}",
                    iterations=r.total_lp_iterations,
                    incumbent=f"{r.objective:.10g}",
                    status=status,
                )
            row["time_pre_s"] = f"{t_pre:.2f}"
            # time_solver_s is net of the one-time warm-up: the solver extends
            # its hard deadline by exactly those seconds, reported apart in
            # time_compile_s
            row["time_solver_s"] = f"{t_solver - t_compile:.2f}"
            row["time_compile_s"] = f"{t_compile:.2f}"
            row["time_total_s"] = f"{time.monotonic() - t0:.2f}"
            rows.append(row)
            print(
                f"{label(name, src)}: {row['status']} primal={row['primal']} "
                f"dual={row['dual']} solver={row['time_solver_s']}s "
                f"compile={row['time_compile_s']}s total={row['time_total_s']}s"
            )
            # rewritten after every row, so a run cut short keeps its rows
            _write_csv(out_csv, rows, merge_base)

    _write_csv(out_csv, rows, merge_base)
    print(f"wrote {out_csv} ({len(rows)} rows)")
    return 0


def _read_base(out_csv: str) -> list:
    """The rows of an existing output CSV: --merge's base, read once before
    the first row so that the rewrites after each row do not merge against
    themselves."""
    if not os.path.exists(out_csv):
        return []
    with open(out_csv, newline="") as f:
        return list(csv.DictReader(f))


def _write_csv(out_csv: str, rows: list, merge_base) -> None:
    """(Re)write the CSV from the rows so far; with a ``merge_base`` its rows
    stay, replaced by instance where a new row has the same one."""
    out_rows = list(rows)
    if merge_base is not None:
        new_by_name = {r["instance"]: r for r in out_rows}
        out_rows = [new_by_name.pop(r["instance"], r) for r in merge_base] + list(new_by_name.values())
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        w.writerows(out_rows)


if __name__ == "__main__":
    sys.exit(main())
