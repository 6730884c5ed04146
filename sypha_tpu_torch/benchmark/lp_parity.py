"""LP parity: the port of the JAX package's benchmark/lp_parity.py.

    python3 -m sypha_tpu_torch.benchmark.lp_parity [--families scp4,scp5] \\
        [--scipy] [--csv-dir DIR] [--synthetic] [--device cpu] [--data-dir DIR]

Solves each instance's LP relaxation with ``solve_lp(pad_lp(model))`` twice
(the first solve builds the kernel and the library handles at its bucket;
the second is the warm per-LP time) and compares its primal and dual
objectives with the golden table (``testing.GOLDEN_LP``, the reference's
own numbers for the OR-Library files) or, with ``--scipy``, with
``scipy.optimize.linprog`` (HiGHS), at 0.1% relative / 0.01 absolute, as the
reference's benchmark/test_cuda_solver.py (:142-153) does.  A lane must also
end CONVERGED, or GAP_STALLED with a gap of at most 1e-5.  The golden values
belong to the real files, so ``--synthetic`` needs ``--scipy``.  Exits 1 if
any instance fails.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

from sypha_tpu_torch.benchmark import add_common_args, family_instances, label, load, row_name

REL_TOL = 0.001  # 0.1% (reference test_cuda_solver.py)
ABS_TOL = 0.01


def scipy_lp(model) -> float:
    import numpy as np
    from scipy.optimize import linprog

    res = linprog(
        model.costs,
        A_ub=-model.dense_matrix(),
        b_ub=-np.ones(model.nrows),
        bounds=[(0, None)] * model.ncols,
        method="highs",
    )
    return res.fun


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sypha_tpu_torch.benchmark.lp_parity")
    ap.add_argument("--families", default="scp4,scp5")
    ap.add_argument("--scipy", action="store_true", help="use scipy as oracle")
    ap.add_argument(
        "--csv-dir", default="",
        help="write per-family CSVs (the reference's scp4_sypha_results.csv "
        "schema) with the first solve's wall time apart from the warm one",
    )
    add_common_args(ap)
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.synthetic and not args.scipy:
        ap.error("--synthetic needs --scipy: the golden values belong to the OR-Library files")

    from sypha_tpu_torch.config import IpmOptions
    from sypha_tpu_torch.core.device import resolve_device
    from sypha_tpu_torch.core.status import IpmStatus
    from sypha_tpu_torch.io.standard_form import pad_lp
    from sypha_tpu_torch.ipm.driver import solve_lp
    from sypha_tpu_torch.testing import GOLDEN_LP

    dev = resolve_device(args.device)
    failures = 0
    checked = 0
    for fam in args.families.split(","):
        fam = fam.strip()
        rows = []
        for name, src in family_instances(fam, args.data_dir, args.synthetic):
            model = load(src, name)
            t0 = time.monotonic()
            res = solve_lp(pad_lp(model, device=dev), IpmOptions())
            t_first = time.monotonic() - t0
            t1 = time.monotonic()
            res = solve_lp(pad_lp(model, device=dev), IpmOptions())
            t_warm = time.monotonic() - t1
            ref = scipy_lp(model) if args.scipy else GOLDEN_LP.get(name)
            if ref is None:
                continue
            checked += 1
            # the reference's parity tool checks values only; a clean status
            # is required too, accepting GAP_STALLED lanes whose duality gap
            # still reached <= 1e-5 (a Mehrotra endgame stall on a degenerate
            # optimal face, as the JAX tool records)
            ok_status = res.status == IpmStatus.CONVERGED or (
                res.status == IpmStatus.GAP_STALLED and res.gap <= 1e-5
            )
            tol = max(ABS_TOL, REL_TOL * abs(ref))
            ok_p = abs(res.primal_objective - ref) <= tol
            ok_d = abs(res.dual_objective - ref) <= tol
            verdict = "PASS" if (ok_status and ok_p and ok_d) else "FAIL"
            if verdict == "FAIL":
                failures += 1
            print(
                f"{label(name, src):<10} ref={ref:>14.6f} primal={res.primal_objective:>14.6f} "
                f"dual={res.dual_objective:>14.6f} iters={res.iterations:>3} "
                f"warm={t_warm:.3f}s {verdict}"
            )
            gap = abs(res.primal_objective - res.dual_objective) / max(1.0, abs(res.primal_objective))
            rows.append(
                {
                    "instance": row_name(name, src),
                    "exit_code": 0 if verdict == "PASS" else 1,
                    "sypha_primal": f"{res.primal_objective:.6f}",
                    "sypha_dual": f"{res.dual_objective:.6f}",
                    "sypha_gap_pct": f"{gap * 100:.6f}",
                    "sypha_iterations": int(res.iterations),
                    "sypha_total_time_s": f"{t_warm:.3f}",
                    "wall_time_s": f"{t_first:.3f}",
                    "status": res.status.name,
                }
            )
        if args.csv_dir and rows:
            os.makedirs(args.csv_dir, exist_ok=True)
            out = os.path.join(args.csv_dir, f"{fam}_sypha_tpu_lp_results.csv")
            with open(out, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
                w.writeheader()
                w.writerows(rows)
            print(f"wrote {out}")
    print(f"\n{checked - failures}/{checked} passed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
