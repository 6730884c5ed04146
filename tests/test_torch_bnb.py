"""Branch and bound in the PyTorch port against the JAX package: node windows
of _NodeLpSolver on both node operators, whole B&B runs against
scipy.optimize.milp, a run that has to branch, and the device seams that
the port handles differently (the mesh's devices, CUDA device loss).

B&B runs are bounded by wall-clock deadlines inside presolve and the
heuristics, so runs compare by the proven optimum and by sound bounds,
never by node counts."""

import numpy as np
import pytest
import scipy.optimize

import sypha_tpu.config as jconfig
import sypha_tpu.core.problem as jproblem
import sypha_tpu.milp.base_model as jbm
from sypha_tpu.milp.bnb import _NodeLpSolver as JNodeLpSolver
from sypha_tpu.milp.bnb import branch_and_bound as jbnb
from sypha_tpu.utils.logging import Logger as JLogger
import sypha_tpu_torch.config as tconfig
import sypha_tpu_torch.core.problem as tproblem
import sypha_tpu_torch.io.scp_reader as treader
import sypha_tpu_torch.milp.base_model as tbm
from sypha_tpu_torch.core.status import IpmStatus, MilpStatus
from sypha_tpu_torch.milp import bnb as tbnb_mod
from sypha_tpu_torch.milp.bnb import _NodeLpSolver as TNodeLpSolver
from sypha_tpu_torch.milp.bnb import branch_and_bound as tbnb
from sypha_tpu_torch.testing import synthetic_scp
from sypha_tpu_torch.utils.logging import Logger as TLogger

TINY = "3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n"
# root LP 377.5, MILP optimum 385: the tree has to close a gap
GAP_TEXT = synthetic_scp(40, 80, 0.08, 9)


def _random_8x16(trial):
    """The seeded 8 x 16 instances of tests/test_milp.py (rng 5, trials 0-2)."""
    rng = np.random.default_rng(5)
    for t in range(trial + 1):
        rows = [
            np.sort(rng.choice(16, size=rng.integers(2, 5), replace=False)).astype(np.int32)
            for _ in range(8)
        ]
        costs = rng.integers(1, 12, 16).astype(np.float64)
    return 8, 16, costs, rows


def _from_text(text):
    m = treader.parse_scp_text(text)
    return m.nrows, m.ncols, m.costs, m.rows


INSTANCES = {
    "tiny": lambda: _from_text(TINY),
    "rand0": lambda: _random_8x16(0),
    "rand1": lambda: _random_8x16(1),
    "rand2": lambda: _random_8x16(2),
}


def _models(nrows, ncols, costs, rows, name="m"):
    kw = dict(nrows=nrows, ncols=ncols, name=name)
    return (
        jproblem.ScpModel(costs=costs.copy(), rows=[r.copy() for r in rows], **kw),
        tproblem.ScpModel(costs=costs.copy(), rows=[r.copy() for r in rows], **kw),
    )


def _milp_optimum(model):
    res = scipy.optimize.milp(
        c=model.costs,
        constraints=scipy.optimize.LinearConstraint(model.dense_matrix(), lb=1.0),
        integrality=np.ones(model.ncols),
        bounds=scipy.optimize.Bounds(0, 1),
    )
    assert res.status == 0, res.message
    return res.fun


def _configs(**bnb):
    out = []
    for cfgmod in (jconfig, tconfig):
        cfg = cfgmod.SolverConfig(verbosity=0)
        out.append(cfg.replace(bnb=cfg.bnb.replace(**bnb)))
    return out


def _check_optimal(r, model, expected):
    assert r.status == MilpStatus.OPTIMAL, r
    assert abs(r.objective - expected) < 1e-9, (r.objective, expected)
    assert tbm.BaseModel(model).is_cover(r.solution)
    assert abs(float(model.costs @ r.solution) - r.objective) < 1e-9


@pytest.mark.parametrize("operator", ["dense", "ell"])
def test_node_solver_windows_match_jax(operator):
    """The same base and nodes through both packages' _NodeLpSolver, with no
    deadline: the root, fixings to 0 and 1, and a node infeasible by its
    fixings (every column of row 0 fixed to 0)."""
    nrows, ncols, costs, rows = _from_text(GAP_TEXT)
    jm, tm = _models(nrows, ncols, costs, rows)
    jcfg, tcfg = _configs(node_operator=operator, node_batch=8)
    jsolver = JNodeLpSolver(jbm.BaseModel(jm), jcfg, JLogger(verbosity=0))
    tsolver = TNodeLpSolver(tbm.BaseModel(tm), tcfg, TLogger(verbosity=0), device="cpu")

    def nodes(bm):
        root = bm.BranchNode()
        infeasible = root
        for j in rows[0]:
            infeasible = infeasible.child(int(j), 0)
        return [root, root.child(3, 1), root.child(3, 0).child(7, 1), infeasible]

    ipm_j = jcfg.ipm.replace(newton_max_steps=48)
    ipm_t = tcfg.ipm.replace(newton_max_steps=48)
    jres = jsolver.solve_nodes(nodes(jbm), ipm_j)
    before = dict(TNodeLpSolver.window_stats)
    tres = tsolver.solve_nodes(nodes(tbm), ipm_t)
    assert tsolver._use_ell == jsolver._use_ell == (operator == "ell")
    assert TNodeLpSolver.window_stats[operator] == before.get(operator, 0) + 1
    assert TNodeLpSolver.window_stats["failed"] == before.get("failed", 0)
    assert [r["status"] for r in tres] == [r["status"] for r in jres]
    assert tres[0]["status"] == IpmStatus.CONVERGED
    assert tres[-1]["status"] != IpmStatus.CONVERGED
    for t, j in zip(tres, jres):
        assert t["x"].shape == j["x"].shape and t["y"].shape == j["y"].shape
        if t["status"] == IpmStatus.CONVERGED:
            np.testing.assert_allclose(t["pobj"], j["pobj"], rtol=1e-8)
            np.testing.assert_allclose(t["dobj"], j["dobj"], rtol=1e-8)
            np.testing.assert_allclose(t["x"], j["x"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_bnb_matches_jax_and_scipy(name):
    jm, tm = _models(*INSTANCES[name](), name=name)
    expected = _milp_optimum(tm)
    jcfg, tcfg = _configs()
    _check_optimal(tbnb(tm, tcfg, device="cpu"), tm, expected)
    _check_optimal(jbnb(jm, jcfg), tm, expected)


def test_bnb_branches_on_a_root_gap():
    """exact_closure and cuts off, as the JAX package's multichip dry run
    does to force a tree: both packages process nodes and prove the same
    optimum."""
    jm, tm = _models(*_from_text(GAP_TEXT))
    expected = _milp_optimum(tm)
    jcfg, tcfg = _configs(exact_closure=False, cuts_enabled=False)
    failed = TNodeLpSolver.window_stats["failed"]
    for bnb, cfg in ((tbnb, tcfg), (jbnb, jcfg)):
        r = bnb(jm, cfg) if bnb is jbnb else bnb(tm, cfg, device="cpu")
        _check_optimal(r, tm, expected)
        assert r.nodes_processed > 0, r
        assert r.total_lp_iterations > 0, r
        assert r.dual_bound <= r.objective + 1e-9
    assert TNodeLpSolver.window_stats["failed"] == failed


def test_mesh_raises_not_implemented():
    """The mesh is ported (the name dates from before): mesh_devices=2 and an
    explicit 2-shard mesh both lane-shard every window and prove the optimum;
    a mesh asking for more cards than exist raises."""
    from sypha_tpu_torch.parallel.mesh import make_mesh

    _, tm = _models(*_from_text(TINY))
    expected = _milp_optimum(tm)
    _, tcfg = _configs(mesh_devices=2)
    _check_optimal(tbnb(tm, tcfg, device="cpu"), tm, expected)
    mesh = make_mesh(devices=["cpu", "cpu"])
    _check_optimal(tbnb(tm, tconfig.SolverConfig(verbosity=0), mesh=mesh, device="cpu"), tm, expected)
    solver = TNodeLpSolver(tbm.BaseModel(tm), tconfig.SolverConfig(verbosity=0), TLogger(verbosity=0),
                           mesh=mesh, device="cpu")
    assert len(solver.solve_nodes([tbm.BranchNode()], tconfig.IpmOptions())) == 1
    with pytest.raises((ValueError, RuntimeError)):
        make_mesh(10**6, device="cuda")


def test_device_loss_degrades_windows(monkeypatch):
    """A sticky CUDA error in a window latches device_lost and degrades this
    and every later window to INFEASIBLE_OR_NUMERICAL lanes; any other error
    propagates."""
    _, tm = _models(*_from_text(TINY))
    _, tcfg = _configs()
    solver = TNodeLpSolver(tbm.BaseModel(tm), tcfg, TLogger(verbosity=0), device="cpu")
    nodes = [tbm.BranchNode(), tbm.BranchNode().child(0, 1)]

    def fail(msg):
        def impl(*args, **kwargs):
            raise RuntimeError(msg)
        return impl

    monkeypatch.setattr(solver, "_solve_nodes_impl", fail("CUDA error: invalid argument"))
    with pytest.raises(RuntimeError, match="invalid argument"):
        solver.solve_nodes(nodes, tcfg.ipm)
    assert not solver.device_lost
    failed = TNodeLpSolver.window_stats["failed"]
    monkeypatch.setattr(solver, "_solve_nodes_impl", fail("CUDA error: an illegal memory access was encountered"))
    for _ in range(2):
        out = solver.solve_nodes(nodes, tcfg.ipm)
        assert solver.device_lost
        assert [r["status"] for r in out] == [IpmStatus.INFEASIBLE_OR_NUMERICAL] * 2
        assert all(r["pobj"] == np.inf and r["dobj"] == -np.inf for r in out)
    assert TNodeLpSolver.window_stats["failed"] == failed + 2


@pytest.mark.parametrize(
    "msg,lost",
    [
        ("CUDA error: an illegal memory access was encountered", True),
        ("CUDA error: unspecified launch failure", True),
        ("CUDA error: misaligned address", True),
        ("CUDA error: device-side assert triggered", True),
        ("CUDA error: uncorrectable ECC error encountered", True),
        ("gram kernel launch failed with CUDA error 700", True),
        ("gram kernel launch failed with CUDA error 719", True),
        ("CUDA out of memory. Tried to allocate 2.00 GiB", False),
        ("CUDA error: invalid argument", False),
        ("gram kernel launch failed with CUDA error 7000", False),
        ("gram takes float32 tensors, got torch.float64 and torch.float64", False),
        ("worker process crashed", False),
    ],
)
def test_is_device_loss_classifies_cuda_errors(msg, lost):
    assert tbnb_mod._is_device_loss(RuntimeError(msg)) is lost
