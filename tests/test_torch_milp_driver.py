"""The branch and bound's mechanisms in the PyTorch port against the JAX
package: the padded-ELL operator cache, run_benchmark's per-family node
operator, checkpoint/resume, core search, the compact re-solve, the async
closure's ladder, the root-time guard, bucket rungs and their stability
under cut growth, the objective-cover cuts, the CG strategy, the operator
choice and the memory sampler.

Each test runs the JAX function and the port's (``device="cpu"``) on the
same numpy-made input and holds the port to what the JAX package's own test
asserts (tests/test_milp.py, test_krylov_path.py, test_ell.py,
test_checkpoint.py).  Where the JAX test reads the OR-Library files, both
packages run a ``synthetic_scp`` instance of the same class instead.  The
port runs on one intra-op thread: beside the other test workers a full
team of threads per worker runs many times slower.
"""

import contextlib
import functools
import io
import itertools
import pathlib
import pickle
import sys
import time
import types

import numpy as np
import pytest
import scipy.optimize
import torch

import sypha_tpu.config as jconfig
import sypha_tpu.io.scp_reader as jreader
import sypha_tpu.io.standard_form as jsf
import sypha_tpu.ipm.driver as jdriver
import sypha_tpu.ipm.shared as jshared
import sypha_tpu.milp.base_model as jbm
import sypha_tpu.milp.bnb as jbnb
import sypha_tpu.milp.cuts as jcuts
import sypha_tpu.milp.presolve as jpresolve
import sypha_tpu.utils.logging as jlogging
import sypha_tpu.utils.telemetry as jtelemetry
import sypha_tpu_torch.benchmark as tbench
import sypha_tpu_torch.benchmark.run_benchmark as trb
import sypha_tpu_torch.config as tconfig
import sypha_tpu_torch.io.scp_reader as treader
import sypha_tpu_torch.io.standard_form as tsf
import sypha_tpu_torch.ipm.driver as tdriver
import sypha_tpu_torch.ipm.shared as tshared
import sypha_tpu_torch.milp.base_model as tbm
import sypha_tpu_torch.milp.bnb as tbnb
import sypha_tpu_torch.milp.cuts as tcuts
import sypha_tpu_torch.milp.presolve as tpresolve
import sypha_tpu_torch.utils.logging as tlogging
import sypha_tpu_torch.utils.telemetry as ttelemetry
from sypha_tpu.core.status import MilpStatus as JMilpStatus
from sypha_tpu_torch.core.status import IpmStatus, MilpStatus
from sypha_tpu_torch.testing import synthetic_scp

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = "3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n"
# root LP 377.5, MILP optimum 385: the tree has to close a gap
GAP_TEXT = synthetic_scp(40, 80, 0.08, 9)
# the OR-Library classes of scp41, scpnre1 and scpnrg1 (rows, cols, density)
SCP4_CLASS = (200, 1000, 0.02)
SCPNRE_CLASS = (500, 5000, 0.10)
SCPNRG_CLASS = (1000, 10000, 0.02)

PKGS = {
    "jax": types.SimpleNamespace(
        config=jconfig, reader=jreader, sf=jsf, driver=jdriver,
        shared=jshared, bm=jbm, bnb=jbnb, cuts=jcuts, presolve=jpresolve,
        Logger=jlogging.Logger, telemetry=jtelemetry, kw={},
    ),
    "torch": types.SimpleNamespace(
        config=tconfig, reader=treader, sf=tsf, driver=tdriver,
        shared=tshared, bm=tbm, bnb=tbnb, cuts=tcuts, presolve=tpresolve,
        Logger=tlogging.Logger, telemetry=ttelemetry, kw={"device": "cpu"},
    ),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fresh_caches(monkeypatch):
    """Both packages' operator caches emptied for the test and restored
    after it."""
    monkeypatch.setattr(jsf, "_ELL_DEVICE_CACHE", {})
    monkeypatch.setattr(tsf, "_ELL_DEVICE_CACHE", {})


def _scipy_milp(model):
    res = scipy.optimize.milp(
        c=model.costs,
        constraints=scipy.optimize.LinearConstraint(model.dense_matrix(), lb=1.0),
        integrality=np.ones(model.ncols),
        bounds=scipy.optimize.Bounds(0, 1),
    )
    assert res.status == 0, res.message
    return res.fun


def _cfg(p, **bnb):
    """The B&B configuration with ``bnb`` set.  JAX's warm-up, which compiles
    every window variant before the clock starts (seconds per run on the
    CPU) and changes no result, is off."""
    cfg = p.config.SolverConfig(verbosity=0)
    if p is PKGS["jax"]:
        bnb = {"precompile": False, **bnb}
    return cfg.replace(bnb=cfg.bnb.replace(**bnb))


def _bnb(p, model_text, cfg, **kw):
    model = p.reader.parse_scp_text(model_text, name="m")
    return model, p.bnb.branch_and_bound(model, cfg, **kw, **p.kw)


def _random_text(seed, m, n, density, cost_hi):
    """The seeded instances of tests/test_milp.py, as SCP text."""
    rng = np.random.RandomState(seed)
    A = (rng.rand(m, n) < density).astype(float)
    A[np.arange(m), rng.randint(0, n, m)] = 1.0
    costs = rng.randint(1, cost_hi, n).astype(float)
    lines = [f"{m} {n}", " ".join(str(int(c)) for c in costs)]
    for i in range(m):
        cols = np.flatnonzero(A[i])
        lines.append(f"{len(cols)} " + " ".join(str(j + 1) for j in cols))
    return "\n".join(lines)


@functools.lru_cache(maxsize=None)
def _synthetic(cls, seed):
    return synthetic_scp(*cls, seed)


def _ell_rows(seed, m=6, n=12):
    rng = np.random.default_rng(seed)
    return [
        (np.sort(rng.choice(n, size=3, replace=False)).astype(np.int32), np.ones(3))
        for _ in range(m)
    ]


def _ell_tensors(ell):
    return (ell.row_idx, ell.row_val, ell.col_idx, ell.col_val)


# ---- the padded-ELL operator cache (io/standard_form) ----


def test_ell_cache_shares_equal_content_and_drops_the_oldest(fresh_caches):
    """Equal rows and padding give the same EllMatrix object (``is``) in both
    packages; four other keys later the first is dropped and built anew.
    ``builds``/``hits`` count each call once; b, c and row_pad are built per
    call and never shared."""
    rows = _ell_rows(0)
    args = (np.ones(6), np.arange(1.0, 13.0), 12, 8, 128)
    b0, h0 = tsf.pad_standard_form_ell.builds, tsf.pad_standard_form_ell.hits
    for p in PKGS.values():
        first = p.sf.pad_standard_form_ell(rows, *args, **p.kw)
        again = p.sf.pad_standard_form_ell([(i.copy(), v.copy()) for i, v in rows], *args, **p.kw)
        assert again.A is first.A
        assert again.b is not first.b and again.c is not first.c
        assert again.row_pad is not first.row_pad
        for seed in range(1, 5):
            assert p.sf.pad_standard_form_ell(_ell_rows(seed), *args, **p.kw).A is not first.A
        assert len(p.sf._ELL_DEVICE_CACHE) == 4
        rebuilt = p.sf.pad_standard_form_ell(rows, *args, **p.kw)
        assert rebuilt.A is not first.A
        for a, b in zip(_ell_tensors(rebuilt.A), _ell_tensors(first.A)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the port: 1 build, 1 hit, 4 builds, then a build of the dropped key
    assert tsf.pad_standard_form_ell.builds - b0 == 6
    assert tsf.pad_standard_form_ell.hits - h0 == 1
    # a different padding or value is a different key
    other_pad = tsf.pad_standard_form_ell(rows, *args[:3], 16, 128, device="cpu")
    other_val = tsf.pad_standard_form_ell(
        [(i, 2.0 * v) for i, v in rows], *args, device="cpu"
    )
    assert other_pad.A is not rebuilt.A and other_val.A is not rebuilt.A
    assert tsf.pad_standard_form_ell.builds - b0 == 8
    # the port's b and c equal JAX's
    jl = jsf.pad_standard_form_ell(rows, *args)
    tl = tsf.pad_standard_form_ell(rows, *args, device="cpu")
    for name in ("b", "c", "row_pad"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)))
    tl.c.mul_(0.0)
    assert float(tsf.pad_standard_form_ell(rows, *args, device="cpu").c.sum()) > 0.0


def test_ell_cache_key_includes_the_device(fresh_caches):
    """Equal rows on another device are another operator: the CPU's is never
    handed to the other device, and each lives where it was asked for.  A
    CUDA device with no index is keyed by the current card's index."""
    rows = _ell_rows(0)
    args = (np.ones(6), np.arange(1.0, 13.0), 12, 8, 128)
    b0 = tsf.pad_standard_form_ell.builds
    cpu = tsf.pad_standard_form_ell(rows, *args, device="cpu")
    meta = tsf.pad_standard_form_ell(rows, *args, device="meta")
    assert meta.A is not cpu.A
    assert cpu.A.device.type == "cpu" and meta.A.device.type == "meta"
    assert tsf.pad_standard_form_ell(rows, *args, device="meta").A is meta.A
    assert tsf.pad_standard_form_ell.builds - b0 == 2
    keys = {
        tsf._ell_key(rows, 12, 8, 128, torch.device(d))
        for d in ("cpu", "meta", "cuda:0", "cuda:1")
    }
    assert len(keys) == 4 and len({digest for digest, _ in keys}) == 1


def test_bnb_on_the_ell_operator_leaves_cached_operators_as_built(fresh_caches, monkeypatch):
    """A B&B on the ELL operator reuses a cached operator (hits > 0), writes
    into none (every cached tensor equal bit for bit to a fresh build of its
    rows after the run) and ends at JAX's objective and scipy's optimum."""
    built = []
    real = tsf.ell_from_rows

    def recording(rows, **kw):
        ell = real(rows, **kw)
        built.append(([(i.copy(), v.copy()) for i, v in rows], kw, ell))
        return ell

    monkeypatch.setattr(tsf, "ell_from_rows", recording)
    h0 = tsf.pad_standard_form_ell.hits
    tmodel, tr = _bnb(PKGS["torch"], GAP_TEXT, _cfg(PKGS["torch"], node_operator="ell"))
    _, jr = _bnb(PKGS["jax"], GAP_TEXT, _cfg(PKGS["jax"], node_operator="ell"))
    assert tr.status == jr.status == MilpStatus.OPTIMAL
    assert abs(tr.objective - jr.objective) < 1e-9
    assert abs(tr.objective - _scipy_milp(tmodel)) < 1e-9
    assert tsf.pad_standard_form_ell.hits - h0 > 0 and built
    cached = {id(a) for a in tsf._ELL_DEVICE_CACHE.values()}
    assert cached <= {id(ell) for _, _, ell in built}
    for rows, kw, ell in built:
        fresh = real(rows, **kw)
        for a, b in zip(_ell_tensors(ell), _ell_tensors(fresh)):
            assert torch.equal(a, b)


# ---- run_benchmark's per-family node operator ----


def _stub_bnb(calls, status):
    def stub(model, cfg, **kw):
        calls.append((cfg.bnb.hard_time_limit_sec, cfg.bnb.node_operator))
        return types.SimpleNamespace(
            status=status, objective=1.0, dual_bound=1.0, mip_gap=0.0,
            total_lp_iterations=1, compile_time_sec=0.0,
        )
    return stub


def test_run_benchmark_family_overrides_match_jax(tmp_path, monkeypatch):
    """Both tools give scpnrg's warm-up and timed B&B the dense node operator
    and scp4's ``auto``; the port's dict is the JAX tool's.  B&B is a stub
    that records the configuration, so nothing is solved.  The port's
    instances are its --synthetic stand-ins, at a small size: the override
    goes by family, not by size."""
    data = tmp_path / "orlib"
    data.mkdir()
    for name, seed in (("scp41", 5), ("scpnrg1", 3)):
        (data / f"{name}.txt").write_text(synthetic_scp(36, 180, 0.06, seed))
    monkeypatch.syspath_prepend(str(ROOT))
    import benchmark.run_benchmark as jrb

    assert trb.FAMILY_BNB_OVERRIDES == jrb.FAMILY_BNB_OVERRIDES
    argv = ["--families", "scp4,scpnrg", "--instances", "scp41,scpnrg1", "--time-limit", "60"]
    expected = [(30.0, "auto"), (60.0, "auto"), (30.0, "dense"), (60.0, "dense")]

    jcalls = []
    monkeypatch.setattr(jrb, "DATA_DIR", str(data))
    monkeypatch.setattr(jbnb, "branch_and_bound", _stub_bnb(jcalls, JMilpStatus.OPTIMAL))
    monkeypatch.setattr(sys, "argv", ["run_benchmark.py"] + argv + ["--out", str(tmp_path / "jax")])
    with contextlib.redirect_stdout(io.StringIO()):
        jrb.main()
    assert jcalls == expected

    tcalls = []
    monkeypatch.setattr(tbnb, "branch_and_bound", _stub_bnb(tcalls, MilpStatus.OPTIMAL))
    monkeypatch.setitem(tbench.SYNTHETIC_CLASSES, "scp4", (36, 180, 0.06))
    monkeypatch.setitem(tbench.SYNTHETIC_CLASSES, "scpnrg", (36, 180, 0.06))
    empty = tmp_path / "none"
    empty.mkdir()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = trb.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu",
                              "--synthetic", "--data-dir", str(empty)])
    assert rc == 0 and tcalls == expected
    assert "synthetic scpnrg1" in out.getvalue()


# ---- checkpoint/resume and the memory sampler (tests/test_checkpoint.py) ----


def test_checkpoint_resume_matches_jax(tmp_path):
    """GAP_TEXT with the closure and cuts off, cut by ``max_nodes=1`` with a
    checkpoint saved at every loop head: FEASIBLE, the file written.
    Resumed from it: OPTIMAL at scipy's optimum and at JAX's resumed
    objective, its processed count going on from the checkpoint's."""
    expected = _scipy_milp(treader.parse_scp_text(GAP_TEXT))
    out = {}
    for name, p in PKGS.items():
        ckpt = tmp_path / f"{name}.ckpt"
        cut = _cfg(p, exact_closure=False, cuts_enabled=False, max_nodes=1,
                   checkpoint_path=str(ckpt), checkpoint_interval_sec=0.0)
        _, r1 = _bnb(p, GAP_TEXT, cut)
        assert r1.status.name == "FEASIBLE", r1
        assert ckpt.exists()
        with open(ckpt, "rb") as f:
            saved = pickle.load(f)["processed"]
        assert saved == r1.nodes_processed >= 1
        resume = _cfg(p, exact_closure=False, cuts_enabled=False,
                      checkpoint_path=str(ckpt), checkpoint_interval_sec=30.0)
        _, r2 = _bnb(p, GAP_TEXT, resume)
        assert r2.status.name == "OPTIMAL", r2
        assert abs(r2.objective - expected) < 1e-9
        assert r2.nodes_processed > saved
        out[name] = (r1, r2)
    assert abs(out["torch"][0].objective - out["jax"][0].objective) < 1e-9
    assert abs(out["torch"][1].objective - out["jax"][1].objective) < 1e-9


def test_memory_stats_graceful():
    """No device memory stats on the CPU: None, not an error, and a sampler
    that still reports, in both packages."""
    for p in PKGS.values():
        stats = p.telemetry.device_memory_stats()
        with p.telemetry.MemorySampler(enabled=True) as ms:
            pass
        assert isinstance(ms.report(), str)
        if stats is not None:
            assert stats.bytes_limit >= 0
    assert ttelemetry.device_memory_stats("cpu") is None
    with ttelemetry.MemorySampler(enabled=True, device="cpu") as ms:
        pass
    assert ms.report() == "memory sampling unavailable"


# ---- tests/test_milp.py ----


def test_objective_cover_cuts_valid_for_improving_covers():
    """Both packages separate the same objective-budget cover cuts at the
    same points, and each holds for every cover strictly better than the
    incumbent."""
    rng = np.random.RandomState(5)
    jbase = jbm.BaseModel(jreader.parse_scp_text(TINY))
    tbase = tbm.BaseModel(treader.parse_scp_text(TINY))
    n_cuts = 0
    for U in (5.0, 7.0, 9.0, 12.0):
        for _ in range(50):
            x = rng.uniform(0, 1, size=tbase.ncols)
            tc = tcuts.objective_cover_cuts(tbase, x, U, 1e-6)
            jc = jcuts.objective_cover_cuts(jbase, x, U, 1e-6)
            assert [(list(c.indices), list(c.values), c.rhs) for c in tc] == [
                (list(c.indices), list(c.values), c.rhs) for c in jc
            ]
            n_cuts += len(tc)
            for cut in tc:
                assert cut.rhs <= 0 and np.all(cut.values == -1.0)
                for bits in itertools.product([0, 1], repeat=tbase.ncols):
                    xx = np.asarray(bits, dtype=np.float64)
                    if tbase.is_cover(xx) and tbase.costs @ xx <= U - 1 + 1e-9:
                        assert cut.values @ xx[cut.indices] + 1e-9 >= cut.rhs, (U, bits)
    assert n_cuts > 0


def _core_search_cfg(p):
    return _cfg(p, core_min_active=10, core_mult=3, core_time_cap_sec=5.0,
                lagrangian_min_gap=0.0, hard_time_limit_sec=60.0)


def _root_time_cfg(p):
    return _cfg(p, hard_time_limit_sec=60.0, root_time_frac=1e-9, precompile=False)


@pytest.mark.parametrize(
    "text,make_cfg",
    [
        # core search forced on a 25 x 80 instance: the restricted run's
        # incumbents are global covers and its OPTIMAL claims do not leak
        (_random_text(11, 25, 80, 0.2, 30), _core_search_cfg),
        # the root-time guard clips the root phases, the tree still proves
        (TINY, _root_time_cfg),
    ],
    ids=["core_search", "root_time_frac_guard"],
)
def test_bnb_mechanism_solves_as_jax(text, make_cfg):
    expected = _scipy_milp(treader.parse_scp_text(text))
    objs = []
    for p in PKGS.values():
        model, r = _bnb(p, text, make_cfg(p))
        assert r.status.name == "OPTIMAL", r
        assert abs(r.objective - expected) < 1e-9
        assert p.bm.BaseModel(model).is_cover(r.solution)
        objs.append(r.objective)
    assert objs[0] == objs[1]


def test_warm_incumbent_and_restrict_active():
    """restrict_active without column 1 (part of the optimum {0, 1}): a cover
    no worse than the best within the restriction (6); with a better warm
    incumbent (5) that incumbent survives.  Both packages."""
    mask = np.array([True, False, True, True])
    warm = np.array([1.0, 1.0, 0.0, 0.0])
    out = []
    for p in PKGS.values():
        model, r = _bnb(p, TINY, _cfg(p), restrict_active=mask)
        assert r.objective <= 6.0 + 1e-9
        A, rhs = p.bm.BaseModel(model).rel_csr()
        assert np.all(A @ r.solution + 1e-9 >= rhs)
        _, r2 = _bnb(p, TINY, _cfg(p), restrict_active=mask, warm_incumbent=(warm, 5.0))
        assert abs(r2.objective - 5.0) < 1e-9
        out.append((r.objective, r2.objective))
    assert out[0] == out[1]


def test_warm_duals_arm_the_early_closure_ladder():
    """warm_duals with a proven warm_lower start the refutation ladder before
    the root LP: the ladder proves the warm incumbent optimal, in both
    packages."""
    m = treader.parse_scp_text(TINY)
    expected = _scipy_milp(m)
    A = np.zeros((m.nrows, m.ncols))
    for i, cols in enumerate(m.rows):
        A[i, cols] = 1.0
    lp = scipy.optimize.linprog(m.costs, A_ub=-A, b_ub=-np.ones(m.nrows), bounds=(0, 1), method="highs")
    duals = -lp.ineqlin.marginals
    best = None
    for k in range(1, m.ncols + 1):
        for comb in itertools.combinations(range(m.ncols), k):
            sel = np.zeros(m.ncols)
            sel[list(comb)] = 1.0
            if np.all(A @ sel >= 1.0) and (best is None or m.costs @ sel < best[0]):
                best = (float(m.costs @ sel), sel)
    for p in PKGS.values():
        _, r = _bnb(p, TINY, _cfg(p), warm_incumbent=(best[1], best[0]),
                    warm_lower=float(np.ceil(lp.fun - 1e-9)), warm_duals=duals)
        assert r.status.name == "OPTIMAL", r
        assert abs(r.objective - expected) < 1e-9


@pytest.mark.parametrize("operator", ["dense", "ell"])
def test_node_lp_bucket_stable_under_cut_growth(operator, fresh_caches):
    """Cuts appended within room_for_cuts() never grow the padded bucket, on
    either operator; the port's bucket and room equal JAX's at each step."""
    out = {}
    for name, p in PKGS.items():
        base = p.bm.BaseModel(p.reader.parse_scp_text(TINY))
        solver = p.bnb._NodeLpSolver(base, _cfg(p, node_operator=operator), p.Logger(verbosity=0), **p.kw)
        solver._rebuild_device_base()
        bucket0, room = solver._bucket, solver.room_for_cuts()
        assert room > 0
        cut = p.bm.Cut(indices=np.array([0, 1], dtype=np.int32), values=np.array([1.0, 1.0]), rhs=1.0)
        base.add_cuts([cut] * room)
        solver.refresh()
        solver._rebuild_device_base()
        assert solver._bucket == bucket0, (solver._bucket, bucket0)
        assert solver.room_for_cuts() == 0
        assert solver._use_ell == (operator == "ell")
        out[name] = (bucket0, room, solver._device_base.A.shape)
    assert out["torch"] == out["jax"]


def test_compact_scp_mapping():
    """_compact_scp keeps exactly the kept columns and remaps the rows, in
    both packages; a compact cover maps back to a cover of the original."""
    keep = np.array([True, False, True, True])
    for p in PKGS.values():
        m = p.reader.parse_scp_text(TINY, name="tiny")
        base = p.bm.BaseModel(m)
        cm, cols = p.bnb._compact_scp(base, keep, "tiny@c")
        assert cm.ncols == 3 and list(cols) == [0, 2, 3]
        np.testing.assert_allclose(cm.costs, m.costs[[0, 2, 3]])
        assert [list(r) for r in cm.rows] == [[0], [1], [0, 1, 2]]
        x = np.zeros(m.ncols)
        x[cols[np.flatnonzero(np.array([1.0, 1.0, 0.0]) > 0.5)]] = 1.0
        assert base.is_cover(x)


def _cycles_text():
    """Two disjoint odd 7-cycles (LP 7, IP 8) and 600 fillers at cost 50,
    which reduced-cost fixing masks (tests/test_milp.py's instance)."""
    rng = np.random.default_rng(3)
    rows, costs, col = [], [], 0
    for _ in range(2):
        for i in range(7):
            rows.append([col + i, col + (i + 1) % 7])
        col += 7
        costs += [1.0] * 7
    for _ in range(600):
        rows[rng.integers(0, len(rows))].append(col)
        costs.append(50.0)
        col += 1
    lines = [f"{len(rows)} {col}", " ".join(str(int(c)) for c in costs)]
    lines += [f"{len(r)} " + " ".join(str(j + 1) for j in sorted(r)) for r in rows]
    return "\n".join(lines)


def test_compact_resolve_end_to_end(monkeypatch):
    """With the exact closure made useless in the outer run, the B&B
    rebases to a compact model and the delegated search carries an OPTIMAL
    proof back, in both packages (cuts off: the zero-half separator would
    close the odd cycles at the root)."""
    text = _cycles_text()
    expected = _scipy_milp(treader.parse_scp_text(text))
    objs = []
    for p in PKGS.values():
        real = p.presolve.exact_small_cover
        orig_bnb = p.bnb.branch_and_bound
        state = {"depth": 0}

        def fake_exact(*a, _real=real, _state=state, **k):
            return (None, None) if _state["depth"] == 0 else _real(*a, **k)

        def wrapped_bnb(*a, _orig=orig_bnb, _state=state, **k):
            _state["depth"] = max(_state["depth"], k.get("_compact_depth", 0))
            return _orig(*a, **k)

        monkeypatch.setattr(p.presolve, "exact_small_cover", fake_exact)
        monkeypatch.setattr(p.bnb, "branch_and_bound", wrapped_bnb)
        model = p.reader.parse_scp_text(text, name="cyc2x7")
        r = orig_bnb(model, _cfg(p, cuts_enabled=False), **p.kw)
        assert state["depth"] >= 1, "compact re-solve did not trigger"
        assert r.status.name == "OPTIMAL", r
        assert abs(r.objective - expected) < 1e-9
        assert p.bm.BaseModel(model).is_cover(r.solution)
        objs.append(r.objective)
    assert objs[0] == objs[1]


def test_async_closure_worker_self_chains_the_ladder():
    """Started two below the optimum, one ladder refutes each level below it
    in order and then finds an optimal cover, on its own thread, in both
    packages."""
    opt = _scipy_milp(treader.parse_scp_text(TINY))
    for p in PKGS.values():
        base = p.bm.BaseModel(p.reader.parse_scp_text(TINY))
        w = p.bnb._AsyncClosure(base, 1e-6, p.Logger(verbosity=0))
        w.start_ladder(
            probe0=opt - 2.0, best_obj=opt + 3.0, seed_fn=lambda: (None, None),
            deadline_mono=time.monotonic() + 30.0, last_refute_sec=0.0, attempts={},
        )
        results = []
        deadline = time.monotonic() + 30.0
        while w.busy() or not results:
            results.extend(w.poll_all())
            if results and results[-1]["verdict"] is True:
                break
            assert time.monotonic() < deadline, "ladder never finished"
            time.sleep(0.01)
        results.extend(w.poll_all())
        w.join(5.0)
        assert [r["level"] for r in results if r["verdict"] is False] == [opt - 2.0, opt - 1.0]
        found = [r for r in results if r["verdict"] is True]
        assert len(found) == 1
        assert float(base.costs @ (found[0]["x"] > 0.5)) == opt
        assert not w.busy()


def test_std_bucket_rungs():
    """Compact and core children snap their widths to the same rung ladder
    in both packages."""
    assert tbnb._STD_RUNGS == jbnb._STD_RUNGS
    assert list(tbnb._STD_RUNGS) == sorted(tbnb._STD_RUNGS)
    for n, want in ((1, 128), (128, 128), (129, 256), (1012, 1024), (2084, 3072), (20000, 20480)):
        assert tbnb._std_bucket_cols(n) == want
    for n in list(range(1, 4200, 37)) + [20000, 20481, 50000]:
        assert tbnb._std_bucket_cols(n) == jbnb._std_bucket_cols(n), n


# ---- tests/test_krylov_path.py ----


def test_cg_path_tiny():
    """TINY on the Jacobi-CG strategy: CONVERGED at 4.5 in both packages."""
    out = []
    for p in PKGS.values():
        model = p.reader.parse_scp_text(TINY, name="tiny")
        lp = p.sf.pad_lp(model, m_pad=8, n_pad=128, **p.kw)
        res = p.driver.solve_lp(lp, p.config.IpmOptions(linear_solver="cg"))
        assert res.status == IpmStatus.CONVERGED
        assert abs(res.primal_objective - 4.5) < 1e-7
        out.append((res.iterations, res.primal_objective))
    assert out[0][0] == out[1][0]
    assert abs(out[0][1] - out[1][1]) < 1e-9


def test_cg_path_failure_keeps_best_iterate():
    """Jacobi-CG at the default 1e-8 target on an scp41-class instance (two
    lanes): every lane stops CONVERGED or GAP_STALLED, on the solve-quality
    gate, with an iterate within 1e-3 of HiGHS's LP optimum, in both
    packages."""
    text = _synthetic(SCP4_CLASS, 0)
    tmodel = treader.parse_scp_text(text)
    A = tmodel.dense_matrix()
    lp_opt = scipy.optimize.linprog(tmodel.costs, A_ub=-A, b_ub=-np.ones(tmodel.nrows),
                                    bounds=(0, None), method="highs").fun
    objs = []
    for p in PKGS.values():
        model = p.reader.parse_scp_text(text)
        batch = p.shared.make_shared_batch(p.sf.pad_lp(model, **p.kw), 2)
        opts = p.config.IpmOptions(linear_solver="cg", cg_max_iter=500)
        st = p.shared.mehrotra_solve_shared(batch, opts)
        status = np.asarray(st.status)
        assert np.all((status == IpmStatus.CONVERGED) | (status == IpmStatus.GAP_STALLED)), status
        obj = np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st.x))
        np.testing.assert_allclose(obj, lp_opt, rtol=1e-3)
        objs.append(obj)
    np.testing.assert_allclose(objs[1], objs[0], rtol=1e-3)


@pytest.mark.parametrize("solver,m_pad,cg", [
    ("auto", 512, False), ("auto", 2048, False), ("auto", 2056, True), ("auto", 4096, True),
    ("cg", 8, True), ("dense", 4096, False),
])
def test_auto_strategy_resolution(solver, m_pad, cg):
    for p in PKGS.values():
        assert p.shared.use_cg_strategy(p.config.IpmOptions(linear_solver=solver), m_pad) is cg


# ---- tests/test_ell.py ----


def test_auto_operator_selection():
    """Dense for an scpnre-class instance (about 9% dense in standard form),
    padded ELL for an scpnrg-class one (about 1.8%), in both packages."""
    for cls, sparse in ((SCPNRE_CLASS, False), (SCPNRG_CLASS, True)):
        text = _synthetic(cls, 1)
        for p in PKGS.values():
            b = p.shared.make_shared_batch_auto(p.reader.parse_scp_text(text), 1, **p.kw)
            assert b.is_sparse is sparse, (cls, b.is_sparse)


def test_sparse_memory_footprint():
    """On an scpnre-class instance the ELL operator stays more than 3.5x under
    the dense f64 matrix and under 1.5x its two orientations' raw nnz bytes;
    the port's four arrays have JAX's shapes and dtypes."""
    text = _synthetic(SCPNRE_CLASS, 1)
    model = treader.parse_scp_text(text)
    sizes = []
    for p in PKGS.values():
        ell = p.shared.make_shared_batch_sparse(p.reader.parse_scp_text(text), 1, **p.kw).A
        arrays = [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a) for a in _ell_tensors(ell)]
        ell_bytes = sum(a.nbytes for a in arrays)
        assert ell_bytes * 3.5 < ell.m_pad * ell.n_pad * 8, ell_bytes
        nnz = sum(len(r) for r in model.rows) + model.nrows
        assert ell_bytes < 1.5 * (2 * nnz * 8), (ell_bytes, nnz)
        sizes.append([(a.shape, a.dtype) for a in arrays])
    assert sizes[0] == sizes[1]
