"""The port's modeling API (sypha_tpu_torch.api) against the JAX package's on
the CPU.

Every model of tests/test_api.py, except scp41 (its data file is absent) and
the wall-clock test (copied below with CPU headroom), is built once per
package by one builder function.  Both solve; statuses must be equal and
objective values and dual bounds within 1e-6.  For LPs the solution values
and constraint duals must agree within 1e-6 too; for MILPs the objective is
checked against a brute-force enumeration of the integer points.
"""

import itertools
import math
import time

import numpy as np
import pytest
import torch

from sypha_tpu.api import Solver as JSolver
from sypha_tpu_torch.api import INFINITY, ResultStatus, Solver, SolverParameters
from sypha_tpu.api import SolverParameters as JSolverParameters

TINY_COSTS = [2.0, 3.0, 4.0, 5.0]
TINY_ROWS = [[0, 1], [1, 2], [0, 2, 3]]


def _scp(s, integer):
    make = s.MakeBoolVar if integer else (lambda name: s.MakeNumVar(0.0, s.infinity(), name))
    xs = [make(f"x{j}") for j in range(len(TINY_COSTS))]
    obj = s.MutableObjective()
    for x, c in zip(xs, TINY_COSTS):
        obj.SetCoefficient(x, c)
    obj.SetMinimization()
    for r in TINY_ROWS:
        ct = s.MakeRowConstraint(1.0, s.infinity())
        for j in r:
            ct.SetCoefficient(xs[j], 1.0)


def tiny_lp(s):
    _scp(s, integer=False)


def tiny_milp(s):
    _scp(s, integer=True)


def maximize_with_offset(s):
    x = s.MakeNumVar(0.0, s.infinity(), "x")
    y = s.MakeNumVar(0.0, s.infinity(), "y")
    ct1 = s.MakeRowConstraint(-s.infinity(), 4.0)
    ct1.SetCoefficient(x, 1.0)
    ct1.SetCoefficient(y, 1.0)
    ct2 = s.MakeRowConstraint(-s.infinity(), 3.0)
    ct2.SetCoefficient(x, 1.0)
    obj = s.MutableObjective()
    obj.SetCoefficient(x, 2.0)
    obj.SetCoefficient(y, 1.0)
    obj.SetOffset(10.0)
    obj.SetMaximization()


def equality_and_range_rows(s):
    x = s.MakeNumVar(0.0, s.infinity(), "x")
    y = s.MakeNumVar(0.0, s.infinity(), "y")
    eq = s.MakeRowConstraint(2.0, 2.0)
    eq.SetCoefficient(x, 1.0)
    eq.SetCoefficient(y, 1.0)
    rng = s.MakeRowConstraint(0.5, 1.5)
    rng.SetCoefficient(x, 1.0)
    obj = s.MutableObjective()
    obj.SetCoefficient(x, 1.0)
    obj.SetCoefficient(y, 2.0)
    obj.SetMinimization()


def _knapsack(s, vals, wts, cap_val, ub_rows=False):
    xs = [s.MakeBoolVar(f"x{j}") for j in range(len(vals))]
    cap = s.MakeRowConstraint(-s.infinity(), cap_val)
    for x, w in zip(xs, wts):
        cap.SetCoefficient(x, float(w))
    if ub_rows:
        for x in xs:
            ub = s.MakeRowConstraint(-s.infinity(), 1.0)
            ub.SetCoefficient(x, 1.0)
    obj = s.MutableObjective()
    for x, v in zip(xs, vals):
        obj.SetCoefficient(x, float(v))
    obj.SetMaximization()


def generic_binary_milp(s):
    _knapsack(s, [6.0, 10.0, 12.0], [1.0, 2.0, 3.0], 4.0, ub_rows=True)


def infeasible_lp(s):
    x = s.MakeNumVar(0.0, s.infinity(), "x")
    c1 = s.MakeRowConstraint(2.0, s.infinity())
    c1.SetCoefficient(x, 1.0)
    c2 = s.MakeRowConstraint(-s.infinity(), 1.0)
    c2.SetCoefficient(x, 1.0)
    s.MutableObjective().SetCoefficient(x, 1.0)


def generic_milp_binary_upper_bounds(s):
    xs = [s.MakeBoolVar(f"x{j}") for j in range(2)]
    ct = s.MakeRowConstraint(3.0, s.infinity())
    ct.SetCoefficient(xs[0], 1.0)
    ct.SetCoefficient(xs[1], 2.0)
    obj = s.MutableObjective()
    for x in xs:
        obj.SetCoefficient(x, 1.0)
    obj.SetMinimization()


def generic_milp_proves_optimal_with_gap(s):
    rng = np.random.RandomState(7)
    vals = rng.randint(5, 30, size=12).astype(float)
    wts = rng.randint(1, 10, size=12).astype(float)
    _knapsack(s, vals, wts, float(wts.sum() // 2))


def general_integer_bounds_binarized(s):
    a = s.MakeIntVar(0.0, 3.0, "a")
    b = s.MakeIntVar(0.0, 4.0, "b")
    ct = s.MakeRowConstraint(5.0, s.infinity())
    ct.SetCoefficient(a, 1.0)
    ct.SetCoefficient(b, 1.0)
    obj = s.MutableObjective()
    obj.SetCoefficient(a, 2.0)
    obj.SetCoefficient(b, 3.0)
    obj.SetMinimization()


def general_integer_nonzero_lower_bound_and_maximize(s):
    x = s.MakeIntVar(1.0, 4.0, "x")
    y = s.MakeIntVar(2.0, 5.0, "y")
    ct = s.MakeRowConstraint(-s.infinity(), 11.0)
    ct.SetCoefficient(x, 2.0)
    ct.SetCoefficient(y, 1.0)
    obj = s.MutableObjective()
    obj.SetCoefficient(x, 4.0)
    obj.SetCoefficient(y, 1.0)
    obj.SetOffset(7.0)
    obj.SetMaximization()


def general_integer_pinned(s):
    x = s.MakeIntVar(2.0, 2.0, "x")
    y = s.MakeBoolVar("y")
    ct = s.MakeRowConstraint(3.0, s.infinity())
    ct.SetCoefficient(x, 1.0)
    ct.SetCoefficient(y, 1.0)
    obj = s.MutableObjective()
    obj.SetCoefficient(x, 1.0)
    obj.SetCoefficient(y, 1.0)
    obj.SetMinimization()


def general_integer_empty_range(s):
    z = s.MakeIntVar(0.4, 0.6, "z")
    ct = s.MakeRowConstraint(0.0, 1.0)
    ct.SetCoefficient(z, 1.0)
    s.MutableObjective().SetCoefficient(z, 1.0)
    s.MutableObjective().SetMinimization()


def general_integer_unbounded_rejected(s):
    x = s.MakeIntVar(0.0, s.infinity(), "x")
    ct = s.MakeRowConstraint(1.0, s.infinity())
    ct.SetCoefficient(x, 2.0)
    s.MutableObjective().SetCoefficient(x, 1.0)
    s.MutableObjective().SetMinimization()


def covering_with_unbounded_integers(s):
    xs = [s.MakeIntVar(0.0, s.infinity(), f"x{j}") for j in range(4)]
    obj = s.MutableObjective()
    for x, c in zip(xs, TINY_COSTS):
        obj.SetCoefficient(x, c)
    obj.SetMinimization()
    for r in TINY_ROWS:
        ct = s.MakeRowConstraint(1.0, s.infinity())
        for j in r:
            ct.SetCoefficient(xs[j], 1.0)


# builder -> the status both packages must reach
MODELS = {
    tiny_lp: ResultStatus.OPTIMAL,
    tiny_milp: ResultStatus.OPTIMAL,
    maximize_with_offset: ResultStatus.OPTIMAL,
    equality_and_range_rows: ResultStatus.OPTIMAL,
    generic_binary_milp: ResultStatus.OPTIMAL,
    infeasible_lp: None,  # INFEASIBLE or FEASIBLE, never OPTIMAL
    generic_milp_binary_upper_bounds: ResultStatus.OPTIMAL,
    generic_milp_proves_optimal_with_gap: ResultStatus.OPTIMAL,
    general_integer_bounds_binarized: ResultStatus.OPTIMAL,
    general_integer_nonzero_lower_bound_and_maximize: ResultStatus.OPTIMAL,
    general_integer_pinned: ResultStatus.OPTIMAL,
    general_integer_empty_range: ResultStatus.INFEASIBLE,
    general_integer_unbounded_rejected: ResultStatus.ABNORMAL,
    covering_with_unbounded_integers: ResultStatus.OPTIMAL,
}


def _brute_force(s):
    """Optimum of an all-integer model by enumeration (covering variables
    unbounded above are capped at 1, where an optimal cover lies)."""
    ranges = []
    for v in s._variables:
        ub = 1.0 if v.ub() >= INFINITY / 2 else v.ub()
        ranges.append(range(math.ceil(v.lb() - 1e-9), math.floor(ub + 1e-9) + 1))
    obj = s.MutableObjective()
    sign = -1.0 if obj._maximize else 1.0
    best = math.inf
    for point in itertools.product(*ranges):
        ok = all(
            c.lb() - 1e-9 <= sum(a * point[j] for j, a in c._coeffs.items()) <= c.ub() + 1e-9
            for c in s._constraints
        )
        if ok:
            best = min(best, sign * sum(a * point[j] for j, a in obj._coeffs.items()))
    return sign * best + obj._offset


@pytest.mark.parametrize("build", list(MODELS), ids=lambda f: f.__name__)
def test_model_matches_jax(build):
    t = Solver(build.__name__, device="cpu")
    j = JSolver(build.__name__)
    for s in (t, j):
        build(s)
        s.parameters().verbosity = 0
    ts, js = t.Solve(), j.Solve()
    assert ts.value == js.value, (ts, js)
    expected = MODELS[build]
    if expected is None:
        assert ts != ResultStatus.OPTIMAL
        return
    assert ts == expected, ts
    if ts != ResultStatus.OPTIMAL:
        return
    np.testing.assert_allclose(t.objective_value(), j.objective_value(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.dual_objective_value(), j.dual_objective_value(), rtol=0, atol=1e-6)
    assert t.MutableObjective().Value() == t.objective_value()
    assert t.MutableObjective().BestBound() == t.dual_objective_value()
    tv = [v.solution_value() for v in t._variables]
    if not any(v.integer() for v in t._variables):
        np.testing.assert_allclose(tv, [v.solution_value() for v in j._variables], rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            [c.dual_value() for c in t._constraints],
            [c.dual_value() for c in j._constraints],
            rtol=0, atol=1e-6,
        )
        assert t.nodes() == 0
    else:
        np.testing.assert_allclose(t.objective_value(), _brute_force(t), rtol=0, atol=1e-6)
        assert all(float(v).is_integer() for v in tv), tv
        sign = -1.0 if t.MutableObjective()._maximize else 1.0
        attained = sum(a * tv[k] for k, a in t.MutableObjective()._coeffs.items())
        np.testing.assert_allclose(attained + t.MutableObjective()._offset, t.objective_value(), atol=1e-6)
        assert sign * (t.objective_value() - t.dual_objective_value()) <= 1e-6
    assert t.wall_time() > 0.0 and t.iterations() > 0


def test_solver_parameters_mirror_jax():
    import dataclasses

    assert dataclasses.asdict(SolverParameters()) == dataclasses.asdict(JSolverParameters())
    assert dataclasses.asdict(SolverParameters().to_config()) == dataclasses.asdict(
        JSolverParameters().to_config()
    )


def test_generic_milp_time_limit_is_hard():
    """The port's copy of test_api.py's hard-limit test with CPU headroom: a
    strongly correlated 60-item knapsack under a 2 s limit returns within
    2 + 5 s of solve time (the warm-up excluded via compile_time()),
    FEASIBLE or OPTIMAL, with a finite bound that bounds the incumbent.

    The solve runs on one intra-op thread.  Its 64-lane windows are tiny
    (64 x 256), and beside five other test workers a default team of one
    thread per core makes each of their IPM iterations take seconds (a
    one-iteration window took 5.5 s on an 8-core host), which no chunking
    can fit in the limit's slack."""
    rng = np.random.RandomState(3)
    wts = rng.uniform(10.0, 30.0, size=60)
    s = Solver("hard_knapsack", device="cpu")
    _knapsack(s, wts + 10.0, wts, float(wts.sum() / 2.0))
    s.parameters().verbosity = 0
    s.parameters().bnb_hard_time_limit_sec = 2.0

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.monotonic()
        status = s.Solve()
        wall = time.monotonic() - t0
    finally:
        torch.set_num_threads(threads)

    assert wall - s.compile_time() <= 2.0 + 5.0, (wall, s.compile_time())
    assert s.compile_time() > 0.0
    assert status in (ResultStatus.FEASIBLE, ResultStatus.OPTIMAL), status
    assert np.isfinite(s.objective_value())
    assert np.isfinite(s.MutableObjective().BestBound())
    assert s.MutableObjective().BestBound() >= s.objective_value() - 1e-6


def test_generic_milp_windows_copy_once(monkeypatch):
    """Each node window of the generic route comes to the host in one packed
    copy: ``_window_to_host`` is called once per window, and its dict holds
    every per-lane field the search reads."""
    import sypha_tpu_torch.api as tapi

    seen = []
    pack = tapi._window_to_host

    def counted(*a):
        out = pack(*a)
        seen.append(out)
        return out

    monkeypatch.setattr(tapi, "_window_to_host", counted)
    s = Solver("knapsack12", device="cpu")
    generic_milp_proves_optimal_with_gap(s)
    s.parameters().verbosity = 0
    assert s.Solve() == ResultStatus.OPTIMAL
    assert seen and all(set(h) == {"status", "it", "pobj", "dobj", "res_d", "x"} for h in seen)
    assert s.nodes() >= len(seen)


@pytest.mark.parametrize("lp_only", [True, False], ids=["lp", "milp"])
def test_example_scp_solver(capsys, lp_only):
    """The port's copy of examples/scp_solver.py on demo_small, on the CPU."""
    import pathlib

    from sypha_tpu_torch.examples.scp_solver import main

    path = str(pathlib.Path(__file__).resolve().parent.parent / "data" / "demo_small.txt")
    argv = ["scp_solver.py", path] + (["--lp-only"] if lp_only else []) + ["--device", "cpu"]
    assert main(argv) == 0
    out = dict(l.split(":", 1) for l in capsys.readouterr().out.splitlines() if ":" in l)
    assert out["Status"].strip() == "OPTIMAL"
    j = JSolver("demo")
    from sypha_tpu.io.scp_reader import read_scp_file

    m = read_scp_file(path)
    xs = [j.MakeBoolVar(f"x{k}") for k in range(m.ncols)]
    for x, c in zip(xs, m.costs):
        j.MutableObjective().SetCoefficient(x, float(c))
    for row in m.rows:
        ct = j.MakeRowConstraint(1.0, j.infinity())
        for k in row:
            ct.SetCoefficient(xs[int(k)], 1.0)
    j.parameters().verbosity = 0
    j.parameters().disable_bnb = lp_only
    j.Solve()
    assert abs(float(out["Objective"]) - j.objective_value()) <= 1e-6
    assert ("Selected columns (" in "".join(out)) is not lp_only
