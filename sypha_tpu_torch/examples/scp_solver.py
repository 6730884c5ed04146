#!/usr/bin/env python3
"""Acceptance demo for the port's modeling API: the copy of
examples/scp_solver.py on ``sypha_tpu_torch``, the Python counterpart of the
reference's examples/scp_solver.cpp:10-137.  Parse an SCP file, build the
model via MakeBoolVar / MakeRowConstraint / SetMinimization, Solve() on the
card (``--device cpu`` for the CPU), and print status / objective / dual
bound / gap / selected columns.

Usage:  python -m sypha_tpu_torch.examples.scp_solver <scp-file> [--lp-only] [--device cpu]
"""

import sys

from sypha_tpu_torch.api import ResultStatus, Solver
from sypha_tpu_torch.io.scp_reader import read_scp_file


def main(argv):
    if len(argv) < 2:
        print(f"usage: {argv[0]} <scp-file> [--lp-only] [--device cpu]", file=sys.stderr)
        return 2
    path = argv[1]
    lp_only = "--lp-only" in argv[2:]
    device = argv[argv.index("--device") + 1] if "--device" in argv[2:-1] else None

    model = read_scp_file(path)
    print(f"Parsed {path}: {model.nrows} rows x {model.ncols} columns")

    solver = Solver("scp_solver_example", device=device)
    solver.parameters().verbosity = 1
    solver.parameters().disable_bnb = lp_only

    xs = [solver.MakeBoolVar(f"x{j}") for j in range(model.ncols)]
    objective = solver.MutableObjective()
    for x, cost in zip(xs, model.costs):
        objective.SetCoefficient(x, float(cost))
    objective.SetMinimization()
    for row in model.rows:
        ct = solver.MakeRowConstraint(1.0, Solver.infinity())
        for j in row:
            ct.SetCoefficient(xs[int(j)], 1.0)

    status = solver.Solve()

    print(f"Status:       {status.value}")
    print(f"Objective:    {solver.objective_value():.10g}")
    print(f"Dual bound:   {solver.dual_objective_value():.10g}")
    print(f"MIP gap:      {solver.mip_gap():.6g}")
    print(f"Iterations:   {solver.iterations()}")
    print(f"Nodes:        {solver.nodes()}")
    print(f"Wall time:    {solver.wall_time():.2f}s")
    if status in (ResultStatus.OPTIMAL, ResultStatus.FEASIBLE) and not lp_only:
        chosen = [j for j, x in enumerate(xs) if x.solution_value() > 0.5]
        print(f"Selected columns ({len(chosen)}): {chosen}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
