"""Two processes of the PyTorch port over ``torch.distributed`` (gloo, CPU):
the JAX package's three 2-process cases on the port's BoundPool, and the
tensor-parallel IPM on two ranks against the JAX package's on a 2-device
mesh.

Ranks meet through a ``file://`` rendezvous in the test's temporary
directory (no TCP port to race for under parallel test workers), each
worker runs with one intra-op thread (two ranks of eight threads each
oversubscribe the CPU twentyfold), and every subprocess has its own
timeout."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import sypha_tpu.config as jconfig
import sypha_tpu.io.scp_reader as jreader
import sypha_tpu.io.standard_form as jsf
import sypha_tpu.ipm.shared as jshared
import sypha_tpu.parallel.mesh as jmesh
from sypha_tpu_torch.core.status import IpmStatus
from sypha_tpu_torch.testing import synthetic_scp

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PREAMBLE = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from sypha_tpu_torch.parallel.distributed import BoundPool, initialize_distributed
init, pid = sys.argv[1], int(sys.argv[2])
n = initialize_distributed(init, num_processes=2, process_id=pid, backend="gloo", device="cpu")
assert n == 2, n
"""


def _run_pair(tmp_path, body, timeout, extra=()):
    """Start both ranks of ``body`` and wait for them; returns [(rc, out)]."""
    init = (tmp_path / "rendezvous").as_uri()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _PREAMBLE + body, init, str(pid), *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


_POOL = r"""
pool = BoundPool()
assert pool.n_processes == 2 and pool.pid == pid
# process 0 has the better incumbent (published as np.float64, with its
# cover bits); process 1 has the lower dual bound and requests a stop
inc = np.float64(429.0) if pid == 0 else np.float64(434.0)
dual = np.float64(420.0) if pid == 0 else np.float64(417.5)
cover = np.zeros(10); cover[[1, 4, 7]] = 1.0
out = pool.sync(inc, dual, pid == 1, wait=True, solution=cover if pid == 0 else None)
assert out.incumbent == 429.0 and out.dual_bound == 417.5 and out.stop, out
assert out.incumbent_solution is not None, out
np.testing.assert_array_equal(out.incumbent_solution[:10], cover)
# second cadence round: values move, pool again
out = pool.sync(428.0 if pid == 1 else 430.0, 425.0, False, wait=True)
assert out.incumbent == 428.0 and not out.stop, out
# a second pool in the same process pair reads none of the first one's keys
fresh = BoundPool().sync(500.0 + pid, 400.0, False, wait=True)
assert fresh.incumbent == 500.0 and not fresh.stop, fresh
# departure protocol: both processes drain and agree on the final view
out = pool.finalize(np.float64(out.incumbent), np.float64(425.0), stop_peers=False)
assert out.all_departed and out.incumbent == 428.0, out
print(f"proc {pid} ok")
"""


def test_bound_pool_two_processes(tmp_path):
    for pid, (rc, out) in enumerate(_run_pair(tmp_path, _POOL, timeout=120)):
        assert rc == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} ok" in out


_CRASH = r"""
import time
pool = BoundPool()
out = pool.sync(100.0 if pid == 0 else 101.0, 90.0, False, wait=True)
assert out.incumbent == 100.0, out
if pid == 1:
    # a crash: publish once more WITHOUT departing, then die abruptly (no
    # finalize, no clean shutdown)
    pool.sync(101.0, 90.0, False)
    os._exit(17)
# the survivor: the peer never departs; the bounded drain must return with
# all_departed=False and the last pooled view intact
t0 = time.monotonic()
out = pool.finalize(99.0, 92.0, stop_peers=False, drain_timeout_sec=5.0)
took = time.monotonic() - t0
assert not out.all_departed and out.incumbent == 99.0, out
assert took < 60.0, took
print(f"proc {pid} drain-timeout ok", flush=True)
os._exit(0)
"""


def test_finalize_drain_timeout_on_crashed_peer(tmp_path):
    (rc0, out0), (rc1, out1) = _run_pair(tmp_path, _CRASH, timeout=120)
    assert rc1 == 17, out1
    assert rc0 == 0, f"survivor failed:\n{out0}"
    assert "proc 0 drain-timeout ok" in out0


_BNB = r"""
from sypha_tpu_torch.config import BnbOptions, SolverConfig
from sypha_tpu_torch.core.problem import ScpModel
from sypha_tpu_torch.milp.bnb import branch_and_bound
from sypha_tpu_torch.utils.logging import Logger

# Planted instance (that of the JAX package's 2-process test): the optimum
# {col0, col1} (two disjoint 30-row halves, 50.5 each -> 101.0) is
# unreachable by ratio-greedy moves, and non-integral costs keep the exact
# closure and the ceil tightening out of play, so worker 1 can only reach
# 101 through the pooled incumbent.
m = 60
cover_of_col = [set(range(0, m, 2)), set(range(1, m, 2))]
costs = [50.5, 50.5]
for s in range(0, m, 4):
    cover_of_col.append({(s + i) % m for i in range(15)})
    costs.append(21.7)
rows = [np.asarray([j for j, cov in enumerate(cover_of_col) if i in cov], dtype=np.int32)
        for i in range(m)]
model = ScpModel(nrows=m, ncols=len(costs), costs=np.asarray(costs, dtype=np.float64),
                 rows=rows, name="planted2proc")
if pid == 0:
    # the optimal warm incumbent: proves 101 at the root, departs stopping peers
    cfg = SolverConfig(verbosity=3, bnb=BnbOptions(hard_time_limit_sec=30.0, node_batch=8))
    x = np.zeros(len(costs)); x[0] = x[1] = 1.0
    warm = (x, 101.0)
else:
    # crippled root phases: worker 1 cannot close the planted gap itself
    cfg = SolverConfig(verbosity=3, bnb=BnbOptions(
        hard_time_limit_sec=30.0, node_batch=8, int_heuristics="none", lagrangian_samples=0,
        cut_rounds_root=0, compact_resolve=False, core_time_frac=0.0))
    warm = None
res = branch_and_bound(model, cfg, Logger(verbosity=3), warm_incumbent=warm, device=sys.argv[3])
print(f"proc {pid} PRIMAL {res.objective:.6f} STATUS {res.status.name} SRC {res.incumbent_source}",
      flush=True)
"""


def test_branch_and_bound_two_processes_pooled_incumbent(tmp_path):
    """Both workers run branch_and_bound on the same instance; worker 0 is
    seeded with the optimal incumbent, worker 1 adopts it through the
    BoundPool mid-search, and both report the same objective with no
    deadlock on either exit path."""
    outs = _run_pair(tmp_path, _BNB, timeout=300, extra=("cpu",))
    for pid, (rc, out) in enumerate(outs):
        assert rc == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} PRIMAL 101.000000" in out, out
    assert "Pooled remote incumbent: 101" in outs[1][1], outs[1][1]


# ---- tensor parallelism: two ranks against JAX on a 2-device mesh ----

TP_TEXT = synthetic_scp(40, 200, 0.1, seed=1)
# name -> (ELL operator, IpmOptions keywords)
TP_CASES = {
    "dense": (False, {}),
    "ell": (True, {}),
    "ell_cg": (True, {"linear_solver": "cg"}),
    "dense_correctors": (False, {"max_correctors": 1}),
}

_TP = r"""
import json
from sypha_tpu_torch.config import IpmOptions
from sypha_tpu_torch.io.scp_reader import parse_scp_text
from sypha_tpu_torch.io.standard_form import pad_lp
from sypha_tpu_torch.ipm.shared import make_shared_batch, make_shared_batch_sparse
from sypha_tpu_torch.parallel.mesh import solve_shared_batch_tensor_parallel

out_dir = sys.argv[3]
with open(f"{out_dir}/instance.txt") as f:
    model = parse_scp_text(f.read())
lp = pad_lp(model, device="cpu")
for name, (ell, kw) in json.loads(sys.argv[4]).items():
    if ell:
        batch = make_shared_batch_sparse(model, 2, m_pad=lp.m_pad, n_pad=lp.n_pad, device="cpu")
    else:
        batch = make_shared_batch(lp, 2)
    st = solve_shared_batch_tensor_parallel(batch, IpmOptions(**kw))
    np.savez(f"{out_dir}/{name}_{pid}.npz", x=st.x.numpy(), y=st.y.numpy(), s=st.s.numpy(),
             status=st.status.numpy(), iterations=st.iterations.numpy(), gap=st.gap.numpy(),
             c=batch.c.numpy(), b=batch.b.numpy())
print(f"proc {pid} tp ok", flush=True)
"""


@pytest.fixture(scope="module")
def tp_results(tmp_path_factory):
    """Every TP case solved once by a pair of port ranks: {case: [rank 0
    arrays, rank 1 arrays]}."""
    import json

    tmp = tmp_path_factory.mktemp("tp")
    (tmp / "instance.txt").write_text(TP_TEXT)
    outs = _run_pair(tmp, _TP, timeout=300, extra=(str(tmp), json.dumps(TP_CASES)))
    for pid, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {pid} failed:\n{out}"
    return {
        name: [dict(np.load(tmp / f"{name}_{pid}.npz")) for pid in (0, 1)] for name in TP_CASES
    }


def _jax_tp(name):
    ell, kw = TP_CASES[name]
    model = jreader.parse_scp_text(TP_TEXT)
    lp = jsf.pad_lp(model)
    if ell:
        batch = jshared.make_shared_batch_sparse(model, 2, m_pad=lp.m_pad, n_pad=lp.n_pad)
    else:
        batch = jshared.make_shared_batch(lp, 2)
    st = jmesh.solve_shared_batch_tensor_parallel(
        batch, jconfig.IpmOptions(**kw), jmesh.make_mesh(2, axis=jmesh.TP_AXIS)
    )
    return {k: np.asarray(getattr(st, k)) for k in ("x", "y", "s", "status", "iterations", "gap")}


def _objectives(r):
    return np.einsum("bn,bn->b", r["c"], r["x"]), np.einsum("bm,bm->b", r["b"], r["y"])


@pytest.mark.parametrize("name", ["dense", "ell"])
def test_tensor_parallel_matches_jax(tp_results, name):
    """Primal objective within 1e-8 relative of JAX's TP, dual objective
    within 1e-7 (the JAX package's own tolerances for TP against one chip);
    statuses and iterations equal, and the ranks agree."""
    r0, r1 = tp_results[name]
    j = _jax_tp(name)
    for r in (r0, r1):
        assert (r["status"] == IpmStatus.CONVERGED).all(), r["status"]
        np.testing.assert_array_equal(r["status"], j["status"])
        np.testing.assert_array_equal(r["iterations"], j["iterations"])
        pobj, dobj = _objectives(r)
        np.testing.assert_allclose(pobj, np.einsum("bn,bn->b", r["c"], j["x"]), rtol=1e-8)
        np.testing.assert_allclose(dobj, np.einsum("bm,bm->b", r["b"], j["y"]), rtol=1e-7)
    np.testing.assert_array_equal(r0["x"], r1["x"])
    np.testing.assert_array_equal(r0["y"], r1["y"])


def test_tensor_parallel_cg_strategy(tp_results):
    """The matrix-free CG strategy on the ELL slabs: no Gram factor, every
    product all-reduced; CONVERGED or GAP_STALLED at a small gap, within
    5e-3 absolute of JAX's TP (the JAX package's tolerance for this case)."""
    r0, _ = tp_results["ell_cg"]
    j = _jax_tp("ell_cg")
    assert np.all(
        (r0["status"] == IpmStatus.CONVERGED)
        | ((r0["status"] == IpmStatus.GAP_STALLED) & (r0["gap"] < 1e-4))
    ), (r0["status"], r0["gap"])
    np.testing.assert_allclose(
        _objectives(r0)[0], np.einsum("bn,bn->b", r0["c"], j["x"]), rtol=0, atol=5e-3
    )


def test_tensor_parallel_correctors_finish(tp_results):
    """Gondzio correctors keep their step lengths rank-local, as in the JAX
    package: both packages finish with the same statuses, iterations and
    objectives, and the ranks hold the same y."""
    r0, r1 = tp_results["dense_correctors"]
    j = _jax_tp("dense_correctors")
    for r in (r0, r1):
        assert (r["status"] != IpmStatus.RUNNING).all()
        np.testing.assert_array_equal(r["status"], j["status"])
        np.testing.assert_array_equal(r["iterations"], j["iterations"])
        np.testing.assert_allclose(
            _objectives(r)[0], np.einsum("bn,bn->b", r["c"], j["x"]), rtol=1e-8
        )
    np.testing.assert_array_equal(r0["y"], r1["y"])
