"""Lane sharding in the PyTorch port against the JAX package: the same
seeded inputs through each package's sharded solves at the same mesh size.
JAX shards over its 8 virtual CPU devices (tests/conftest.py); the port over
CPU shards of ``make_mesh(k, device="cpu")``, each on a host thread.

A sharded solve equals its shards solved alone (a group's PCG runs until
every lane in it converges), so the port's sharded result is held to the
JAX package's sharded result at the same mesh size, and bit for bit to its
own shards solved one after another."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sypha_tpu.config as jconfig
import sypha_tpu.core.problem as jproblem
import sypha_tpu.io.scp_reader as jreader
import sypha_tpu.io.standard_form as jsf
import sypha_tpu.ipm.shared as jshared
import sypha_tpu.milp.base_model as jbm
import sypha_tpu.ops.ell as jell
import sypha_tpu.parallel.mesh as jmesh
from sypha_tpu.milp.bnb import _NodeLpSolver as JNodeLpSolver
from sypha_tpu.milp.bnb import branch_and_bound as jbnb
from sypha_tpu.utils.logging import Logger as JLogger
import sypha_tpu_torch.config as tconfig
import sypha_tpu_torch.core.problem as tproblem
import sypha_tpu_torch.io.scp_reader as treader
import sypha_tpu_torch.io.standard_form as tsf
import sypha_tpu_torch.ipm.shared as tshared
import sypha_tpu_torch.milp.base_model as tbm
import sypha_tpu_torch.ops.ell as tell
import sypha_tpu_torch.parallel.mesh as tmesh
from sypha_tpu_torch.core.status import IpmStatus, MilpStatus
from sypha_tpu_torch.milp.bnb import _NodeLpSolver as TNodeLpSolver
from sypha_tpu_torch.milp.bnb import branch_and_bound as tbnb
from sypha_tpu_torch.testing import synthetic_scp
from sypha_tpu_torch.utils.logging import Logger as TLogger

CPU = "cpu"
LANES = 8
TEXT = synthetic_scp(40, 200, 0.1, seed=1)
# root LP 377.5, MILP optimum 385: the tree has to close a gap
GAP_TEXT = synthetic_scp(40, 80, 0.08, 9)


@pytest.fixture(autouse=True)
def _two_intra_op_threads():
    """Each shard thread opens an intra-op team of its own: cap the teams so
    that these sharded solves do not oversubscribe the cores that the other
    test workers share (the results hold at any thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fixings(lanes, n_pad):
    """Lane i fixes column i % 7 to 1 (odd lanes) or to 0 (even lanes)."""
    fix0 = np.zeros((lanes, n_pad))
    fix1 = np.zeros((lanes, n_pad))
    for i in range(lanes):
        (fix1 if i % 2 else fix0)[i, i % 7] = 1.0
    return fix0, fix1


def _lps():
    return (
        jsf.pad_lp(jreader.parse_scp_text(TEXT)),
        tsf.pad_lp(treader.parse_scp_text(TEXT), device=CPU),
    )


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_states_match(tst, jst, c_t, c_j, rtol=1e-8):
    """Statuses and iterations equal, primal objectives within rtol."""
    np.testing.assert_array_equal(_np(tst.status), _np(jst.status))
    np.testing.assert_array_equal(_np(tst.iterations), _np(jst.iterations))
    tobj = np.einsum("bn,bn->b", _np(c_t), _np(tst.x))
    jobj = np.einsum("bn,bn->b", np.broadcast_to(_np(c_j), _np(jst.x).shape), _np(jst.x))
    np.testing.assert_allclose(tobj, jobj, rtol=rtol)


@pytest.mark.parametrize("k", [2, 4])
def test_solve_shared_batch_sharded_matches_jax(k):
    jlp, tlp = _lps()
    fix0, fix1 = _fixings(LANES, tlp.n_pad)
    jb = jshared.fix_columns(jshared.make_shared_batch(jlp, LANES), jnp.asarray(fix0), jnp.asarray(fix1))
    tb = tshared.fix_columns(tshared.make_shared_batch(tlp, LANES), fix0, fix1)
    jm = jmesh.make_mesh(k)
    jst, jstats = jmesh.solve_shared_batch_sharded(jmesh.shard_shared_batch(jb, jm), jconfig.IpmOptions(), jm)
    mesh = tmesh.make_mesh(k, device=CPU)
    tst, tstats = tmesh.solve_shared_batch_sharded(tb, tconfig.IpmOptions(), mesh)
    assert mesh.devices == (torch.device(CPU),) * k
    _assert_states_match(tst, jst, tb.c, jb.c)
    # (worst_gap, max_iters, n_converged, min_dual)
    assert int(tstats[1]) == int(jstats[1]) and int(tstats[2]) == int(jstats[2])
    # the worst gap is a rounding-level residual (~1e-9): held in absolute terms
    np.testing.assert_allclose(float(tstats[0]), float(jstats[0]), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(tstats[3]), float(jstats[3]), rtol=1e-8)
    gathered = tmesh.pooled_stats([tst])
    assert [float(v) for v in gathered] == [float(v) for v in tstats[:3]]


@pytest.mark.parametrize("k", [2, 4])
def test_solve_node_batch_sharded_matches_jax(k):
    jlp, tlp = _lps()
    fix0, fix1 = _fixings(LANES, tlp.n_pad)
    jopts = jconfig.IpmOptions(gap_stall_window=5, gap_stall_min_improv=0.01)
    topts = tconfig.IpmOptions(gap_stall_window=5, gap_stall_min_improv=0.01)
    jst, jx, jp, jd = jmesh.solve_node_batch_sharded(
        jlp, jnp.asarray(fix0), jnp.asarray(fix1), jopts, jmesh.make_mesh(k)
    )
    tst, tx, tp, td = tmesh.solve_node_batch_sharded(
        tlp, fix0, fix1, topts, tmesh.make_mesh(k, device=CPU)
    )
    np.testing.assert_array_equal(_np(tst.status), _np(jst.status))
    np.testing.assert_array_equal(_np(tst.iterations), _np(jst.iterations))
    conv = _np(tst.status) == IpmStatus.CONVERGED
    assert conv.any()
    np.testing.assert_allclose(_np(tp)[conv], _np(jp)[conv], rtol=1e-8)
    np.testing.assert_allclose(_np(td)[conv], _np(jd)[conv], rtol=1e-8)
    np.testing.assert_allclose(_np(tx), _np(jx), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [2, 4])
def test_solve_lp_batch_sharded_matches_jax(k):
    """Distinct instances per lane: the JAX package vmaps its dense per-lane
    IPM here, the port solves each group of equal A (here one lane each) on
    its one engine, the shared-matrix IPM.  Statuses and objectives are held
    to JAX's sharded call, iterations to JAX's shared engine lane by lane:
    on seed 6 the JAX package's own two engines differ by one iteration
    (dense 11, shared 12)."""
    texts = [synthetic_scp(40, 200, 0.1, seed=s) for s in range(LANES)]
    jlp = jsf.stack_lps([jsf.pad_lp(jreader.parse_scp_text(t), m_pad=40, n_pad=256) for t in texts])
    tlp = tsf.stack_lps(
        [tsf.pad_lp(treader.parse_scp_text(t), m_pad=40, n_pad=256, device=CPU) for t in texts]
    )
    jm = jmesh.make_mesh(k)
    jst, jstats = jmesh.solve_lp_batch_sharded(jmesh.shard_batch(jlp, jm), jconfig.IpmOptions(), jm)
    tst, tstats = tmesh.solve_lp_batch_sharded(tlp, tconfig.IpmOptions(), tmesh.make_mesh(k, device=CPU))
    assert (_np(tst.status) == IpmStatus.CONVERGED).all()
    np.testing.assert_array_equal(_np(tst.status), _np(jst.status))
    tobj = np.einsum("bn,bn->b", _np(tlp.c), _np(tst.x))
    np.testing.assert_allclose(tobj, np.einsum("bn,bn->b", np.asarray(jlp.c), np.asarray(jst.x)), rtol=1e-8)
    shared_iters = [
        int(jshared.mehrotra_solve_shared(
            jshared.make_shared_batch(jsf.pad_lp(jreader.parse_scp_text(t), m_pad=40, n_pad=256), 1),
            jconfig.IpmOptions(),
        ).iterations[0])
        for t in texts
    ]
    assert _np(tst.iterations).tolist() == shared_iters
    assert np.abs(_np(tst.iterations) - np.asarray(jst.iterations)).max() <= 1
    assert int(tstats[2]) == int(jstats[2]) == LANES
    assert int(tstats[1]) == max(shared_iters)


def test_sharded_result_is_its_shards_solved_in_turn():
    """The shard threads change nothing: bit for bit the shards solved one
    after another, on lanes whose iteration counts differ."""
    _, tlp = _lps()
    fix0, fix1 = _fixings(LANES, tlp.n_pad)
    batch = tshared.fix_columns(tshared.make_shared_batch(tlp, LANES), fix0, fix1)
    mesh = tmesh.make_mesh(2, device=CPU)
    st, _ = tmesh.solve_shared_batch_sharded(batch, tconfig.IpmOptions(), mesh)
    alone = [tshared.mehrotra_solve_shared(s, tconfig.IpmOptions()) for s in tmesh.shard_shared_batch(batch, mesh)]
    assert len(set(_np(st.iterations).tolist())) > 1
    for name in ("x", "y", "s", "mu", "gap", "iterations", "status"):
        assert torch.equal(getattr(st, name), torch.cat([getattr(a, name) for a in alone])), name
    # the JAX-style call on pre-made shards gives the same result
    st2, _ = tmesh.solve_shared_batch_sharded(tmesh.shard_shared_batch(batch, mesh), mesh=mesh)
    assert torch.equal(st2.x, st.x)


def test_lanes_must_divide_over_the_mesh():
    _, tlp = _lps()
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.solve_shared_batch_sharded(tshared.make_shared_batch(tlp, 3), mesh=tmesh.make_mesh(2, device=CPU))
    with pytest.raises(ValueError, match="n_devices"):
        tmesh.make_mesh(3, devices=[CPU, CPU])


def test_mesh_chunked_resume_matches_jax():
    """Chunked (iter_limit + resume) windows through the mesh dispatch of
    _NodeLpSolver, as JAX's test_mesh_chunked_resume, against JAX's mesh."""
    nrows, ncols = 40, 200
    tm = treader.parse_scp_text(TEXT)
    jm = jproblem.ScpModel(nrows=nrows, ncols=ncols, costs=tm.costs.copy(), rows=[r.copy() for r in tm.rows])
    results = []
    for cfgmod, bm, solver_cls, logger, mesh in (
        (jconfig, jbm, JNodeLpSolver, JLogger, jmesh.make_mesh(2)),
        (tconfig, tbm, TNodeLpSolver, TLogger, tmesh.make_mesh(2, device=CPU)),
    ):
        cfg = cfgmod.SolverConfig(verbosity=0)
        cfg = cfg.replace(bnb=cfg.bnb.replace(iter_chunk=4, node_batch=8))
        model = jm if cfgmod is jconfig else tm
        kw = {} if cfgmod is jconfig else {"device": CPU}
        solver = solver_cls(bm.BaseModel(model), cfg, logger(verbosity=0), mesh=mesh, **kw)
        nodes = [bm.BranchNode().child(j, j % 2) for j in range(16)]
        results.append(solver.solve_nodes(nodes, cfg.ipm.replace(newton_max_steps=48), time.monotonic() + 3600))
    jres, tres = results
    assert len(tres) == 16
    assert [r["status"] for r in tres] == [r["status"] for r in jres]
    assert [r["iterations"] for r in tres] == [r["iterations"] for r in jres]
    assert all(r["status"] in (IpmStatus.CONVERGED, IpmStatus.GAP_STALLED) for r in tres)
    for j, (t, r) in enumerate(zip(tres, jres)):
        np.testing.assert_allclose(t["pobj"], r["pobj"], rtol=1e-8)
        if j % 2 == 1:  # fixed-to-1 lanes report the fixing in their solution
            assert t["x"][j] > 0.99


@pytest.mark.parametrize("k,lane_multiple", [(2, 8), (4, 16)])
def test_ell_column_slabs_match_jax(k, lane_multiple):
    model = treader.parse_scp_text(TEXT)
    rows = [(np.asarray(r, np.int32), np.ones(len(r))) for r in model.rows]
    args = dict(n_struct=model.ncols, m_pad=40, n_pad=256)
    jslabs = jell.ell_column_slabs(jell.ell_from_rows(rows, **args), k, lane_multiple)
    tslabs = tell.ell_column_slabs(tell.ell_from_rows(rows, device=CPU, **args), k, lane_multiple)
    for name in ("row_idx", "row_val", "col_idx", "col_val"):
        t, j = _np(getattr(tslabs, name)), np.asarray(getattr(jslabs, name))
        assert t.dtype == j.dtype and t.shape == j.shape, name
        np.testing.assert_array_equal(t, j, err_msg=name)
    with pytest.raises(ValueError, match="not divisible"):
        tell.ell_column_slabs(tell.ell_from_rows(rows, device=CPU, **args), 3)


def test_mesh_bnb_matches_jax():
    """Branch and bound with every node window on a 2-shard mesh, closure
    and cuts off so that the tree branches, in both packages."""
    tm = treader.parse_scp_text(GAP_TEXT)
    jm = jproblem.ScpModel(nrows=tm.nrows, ncols=tm.ncols, costs=tm.costs.copy(), rows=[r.copy() for r in tm.rows])
    out = []
    for cfgmod in (jconfig, tconfig):
        cfg = cfgmod.SolverConfig(verbosity=0)
        out.append(cfg.replace(bnb=cfg.bnb.replace(
            mesh_devices=2, exact_closure=False, cuts_enabled=False, precompile=False,
        )))
    jr = jbnb(jm, out[0])
    tr = tbnb(tm, out[1], device=CPU)
    assert tr.status == MilpStatus.OPTIMAL and int(jr.status) == int(tr.status)
    assert tr.objective == jr.objective == 385.0
    assert tr.nodes_processed > 0 and jr.nodes_processed > 0
    assert tbm.BaseModel(tm).is_cover(tr.solution)
