"""The MILP host modules of the PyTorch port (base_model, presolve,
heuristics, cuts, native) against the JAX package's on the same seeded
inputs: outputs identical, and the port's native library built from
csrc/sypha_host.cpp agreeing with the JAX package's."""

import pathlib

import numpy as np
import pytest
import scipy.optimize

import sypha_tpu.core.problem as jproblem
import sypha_tpu.milp.base_model as jbm
import sypha_tpu.milp.cuts as jcuts
import sypha_tpu.milp.heuristics as jheur
import sypha_tpu.milp.presolve as jpre
import sypha_tpu.native as jnative
import sypha_tpu_torch.core.problem as tproblem
import sypha_tpu_torch.io.scp_reader as treader
import sypha_tpu_torch.milp.base_model as tbm
import sypha_tpu_torch.milp.cuts as tcuts
import sypha_tpu_torch.milp.heuristics as theur
import sypha_tpu_torch.milp.presolve as tpre
import sypha_tpu_torch.native as tnative
from sypha_tpu_torch.testing import synthetic_scp

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
TINY = "3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n"


def _random_instance(seed, nrows=14, ncols=36):
    rng = np.random.default_rng(seed)
    rows = [
        np.sort(rng.choice(ncols, size=int(rng.integers(2, 7)), replace=False)).astype(np.int32)
        for _ in range(nrows)
    ]
    return nrows, ncols, rng.integers(1, 20, ncols).astype(np.float64), rows


def _from_text(text):
    m = treader.parse_scp_text(text)
    return m.nrows, m.ncols, m.costs, m.rows


INSTANCES = {
    "tiny": lambda: _from_text(TINY),
    "rand77": lambda: _random_instance(77),
    "syn40x80": lambda: _from_text(synthetic_scp(40, 80, 0.08, 9)),
}


def _models(name):
    nrows, ncols, costs, rows = INSTANCES[name]()
    kw = dict(nrows=nrows, ncols=ncols, name=name)
    jm = jproblem.ScpModel(costs=costs.copy(), rows=[r.copy() for r in rows], **kw)
    tm = tproblem.ScpModel(costs=costs.copy(), rows=[r.copy() for r in rows], **kw)
    return jm, tm


def _lp_point(model):
    """HiGHS primal and covering-row duals of the LP relaxation."""
    A = model.dense_matrix()
    res = scipy.optimize.linprog(
        model.costs, A_ub=-A, b_ub=-np.ones(model.nrows), bounds=(0, 1), method="highs"
    )
    assert res.status == 0
    return res.x, np.maximum(0.0, -np.asarray(res.ineqlin.marginals))


def _same(a, b, what):
    """Deep equality of the outputs of both packages (arrays exactly)."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            _same(getattr(a, f), getattr(b, f), f"{what}.{f}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)
    else:
        assert a == b or (a != a and b != b), (what, a, b)


def _run_base_model(pkg_bm, model, x, y):
    base = pkg_bm.BaseModel(model)
    out = [base.standard_form(None), base.row_arrays(), base.effective_costs()]
    node = pkg_bm.BranchNode().child(0, 1).child(1, 0)
    out.append(base.standard_form(node))
    base.deactivate(np.arange(0, base.ncols, 5))
    base.add_cuts([pkg_bm.Cut(np.array([0, 1, 2], np.int32), np.array([1.0, 2.0, 1.0]), 2.0)])
    A, rhs = base.rel_csr()
    out += [A.toarray(), rhs, base.effective_costs(), base.n_active, base.nrows]
    x01 = (x > 0.5).astype(np.float64)
    out += [base.coverage_of(x01), base.is_cover(x01), base.objective_of(x01)]
    return out


def _run_presolve(pkg, model, x, y):
    base = pkg["bm"].BaseModel(model)
    g = pkg["pre"].greedy_set_cover(base)
    out = [g]
    out.append(pkg["pre"].apply_presolve_rules(base, "cost_driven_replacement", 1e-12, None))
    out.append(pkg["pre"].apply_presolve_rules(base, "single_column_dominance,two_column_dominance", 1e-12, None))
    out.append(pkg["pre"].incumbent_budget_pruning(base, g.objective, 1e-12, None))
    out.append(base.active.copy())
    out.append(pkg["pre"].exact_small_cover(base, g.objective, time_limit_sec=60.0, duals=y))
    out.append(pkg["pre"].exact_small_cover(base, g.objective - 1.0, time_limit_sec=60.0))
    out.append(pkg["pre"].sample_cover(base, x, g.objective, time_limit_sec=60.0))
    return out


def _run_heuristics(pkg, model, x, y):
    base = pkg["bm"].BaseModel(model)
    h = pkg["heur"]
    out = [h.run_heuristics(base, "nearest_integer_fixing,dual_guided_cover_repair", x, y)]
    node = pkg["bm"].BranchNode().child(int(np.argmax(x)), 1)
    out.append(h.run_heuristics(base, "nearest_integer_fixing,dual_guided_cover_repair", x, y, node, thorough=False))
    out.append(h.lagrangian_greedy_covers(base, y, time_budget_sec=60.0, max_samples=16, keep_pool=4))
    greedy = pkg["pre"].greedy_set_cover(base)
    x0 = np.zeros(base.ncols)
    x0[greedy.selected] = 1.0
    out.append(h.local_search_improve(base, x0, time_budget_sec=60.0))
    cands = h.fractional_candidates(x, base.ncols, 1e-6)
    out += [cands, h.is_binary_integral(x, base.ncols, 1e-6)]
    for strategy in ("most_fractional", "highest_cost_fractional"):
        out.append(h.select_branch_variable(strategy, x, base.costs, cands))
    return out


def _run_cuts(pkg, model, x, y):
    base = pkg["bm"].BaseModel(model)
    inc = pkg["pre"].greedy_set_cover(base).objective
    out = [pkg["cuts"].separate_cuts(base, x, y, incumbent=inc, obj_is_integral=True)]
    out.append(pkg["cuts"].zero_half_mod2(base, x, y, 1e-6))
    out.append(pkg["cuts"].mod_k_cuts(base, x, y, 1e-6, k=3))
    return out


JAX = {"bm": jbm, "pre": jpre, "heur": jheur, "cuts": jcuts}
PORT = {"bm": tbm, "pre": tpre, "heur": theur, "cuts": tcuts}
RUNS = {
    "base_model": lambda pkg, *a: _run_base_model(pkg["bm"], *a),
    "presolve": _run_presolve,
    "heuristics": _run_heuristics,
    "cuts": _run_cuts,
}


@pytest.mark.parametrize("instance", sorted(INSTANCES))
@pytest.mark.parametrize("module", sorted(RUNS) + ["presolve_numpy"])
def test_host_module_matches_jax(module, instance, monkeypatch):
    if module == "presolve_numpy":
        # both packages on their numpy implementations, no native library
        for native in (tnative, jnative):
            monkeypatch.setattr(native, "_lib", None)
            monkeypatch.setattr(native, "_tried", True)
        module = "presolve"
    jm, tm = _models(instance)
    x, y = _lp_point(tm)
    _same(RUNS[module](PORT, tm, x, y), RUNS[module](JAX, jm, x, y), module)


def test_native_builds_and_matches_jax():
    lib = tnative.get_lib()
    assert lib is not None, "the native library did not build from csrc/sypha_host.cpp"
    path = tnative.library_path()
    assert path.exists() and path.parent == tnative.BUILD_DIR
    assert pathlib.Path(lib._name) == path
    jlib = jnative.get_lib()
    if jlib is None:
        pytest.skip("the JAX package's native library is unavailable")
    for name in ("rand77", "syn40x80"):
        jm, tm = _models(name)
        jb, tb = jbm.BaseModel(jm), tbm.BaseModel(tm)
        _same(tnative.greedy_set_cover(tb), jnative.greedy_set_cover(jb), "greedy")
        obj = tnative.greedy_set_cover(tb)[0]
        _, y = _lp_point(tm)
        for budget in (obj, obj - 1.0):
            _same(
                tnative.exact_cover(tb, budget, 60.0, duals=y),
                jnative.exact_cover(jb, budget, 60.0, duals=y),
                f"exact_cover {name} {budget}",
            )


def test_native_reader_matches_python_tokenizer():
    assert tnative.available()
    path = DATA / "demo_small.txt"
    native_model = treader.read_scp_file(str(path))
    py_model = treader.parse_scp_text(path.read_text(), name="demo_small")
    assert (native_model.nrows, native_model.ncols) == (py_model.nrows, py_model.ncols)
    np.testing.assert_array_equal(native_model.costs, py_model.costs)
    for a, b in zip(native_model.rows, py_model.rows, strict=True):
        np.testing.assert_array_equal(a, b)
