"""The port's solve drivers (ipm.driver) against the JAX package on the CPU.

``solve_lp`` and ``solve_lp_batch`` run the per-lane dense IPM
(ipm.dense.mehrotra_solve), as the JAX package's drivers do: against JAX's
``solve_lp`` and ``solve_lp_batch``, equal statuses and iterations,
objectives within 1e-10 relative.  The port's shared-matrix engine on a
one-lane batch is held to JAX's on the same batch.  ``solve_lp_batch`` is
one engine call for the whole stack, whatever its lanes' matrices."""

import pathlib

import numpy as np
import pytest

import sypha_tpu.config as jconfig
import sypha_tpu.io.scp_reader as jreader
import sypha_tpu.io.standard_form as jsf
from sypha_tpu.api import Solver as JSolver
from sypha_tpu.ipm import driver as jdriver
from sypha_tpu.ipm import shared as jshared
import sypha_tpu_torch.config as tconfig
import sypha_tpu_torch.io.scp_reader as treader
import sypha_tpu_torch.io.standard_form as tsf
from sypha_tpu_torch.api import Solver as TSolver
from sypha_tpu_torch.core.status import IpmStatus
from sypha_tpu_torch.ipm import driver as tdriver
from sypha_tpu_torch.ipm import shared as tshared
from sypha_tpu_torch.ipm.shared import IpmState
from sypha_tpu_torch.ops import gram as tgram
from sypha_tpu_torch.ops import spd as tspd
from sypha_tpu_torch.testing import synthetic_scp

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
TINY = "3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n"


def _general_lp(seed=11, n=30, m_eq=6, m_ge=6):
    """Seeded general LP in standard form: m_eq equality rows and m_ge >=
    rows (with surplus columns), feasible at a positive point, with positive
    costs so it is bounded."""
    rng = np.random.default_rng(seed)
    m = m_eq + m_ge
    A0 = rng.uniform(-1.0, 1.0, (m, n))
    x0 = rng.uniform(0.5, 2.0, n)
    b = A0 @ x0
    b[m_eq:] -= 0.5
    A = np.zeros((m, n + m_ge))
    A[:, :n] = A0
    A[m_eq:, n:] = -np.eye(m_ge)
    c = np.concatenate([rng.uniform(1.0, 5.0, n), np.zeros(m_ge)])
    return A, b, c, n


def _scp(text):
    return lambda pkg: (jsf if pkg == "jax" else tsf).pad_lp(
        (jreader if pkg == "jax" else treader).parse_scp_text(text),
        **({} if pkg == "jax" else {"device": "cpu"}),
    )


def _std(A, b, c, n):
    return lambda pkg: (
        jsf.pad_standard_form(A, b, c, n_struct=n)
        if pkg == "jax"
        else tsf.pad_standard_form(A, b, c, n_struct=n, device="cpu")
    )


CASES = {
    "tiny": _scp(TINY),
    "demo_small": _scp((DATA / "demo_small.txt").read_text()),
    "syn40x200": _scp(synthetic_scp(40, 200, 0.1, 4)),
    "general_eq": _std(*_general_lp()),
}


def _jax_shared_one_lane(jlp, opts):
    jb = jshared.make_shared_batch(jlp, 1)
    st = jshared.mehrotra_solve_shared(jb, opts)
    n, m = int(jlp.n_real), int(jlp.m_real)
    x, y = np.asarray(st.x)[0], np.asarray(st.y)[0]
    c, b = np.asarray(jb.c)[0], np.asarray(jb.b)[0]
    return (
        int(np.asarray(st.status)[0]),
        int(np.asarray(st.iterations)[0]),
        float(c[:n] @ x[:n]),
        float(b[:m] @ y[:m]),
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_lp_matches_jax_shared_engine(name):
    tlp = CASES[name]("torch")
    tb = tshared.make_shared_batch(tlp, 1)
    st = tshared.mehrotra_solve_shared(tb, tconfig.IpmOptions())
    n, m = int(tlp.n_real), int(tlp.m_real)
    pobj = float(tb.c[0, :n] @ st.x[0, :n])
    dobj = float(tb.b[0, :m] @ st.y[0, :m])
    status, iters, jpobj, jdobj = _jax_shared_one_lane(CASES[name]("jax"), jconfig.IpmOptions())
    assert int(st.status[0]) == status == IpmStatus.CONVERGED
    assert int(st.iterations[0]) == iters
    np.testing.assert_allclose(pobj, jpobj, rtol=1e-10)
    np.testing.assert_allclose(dobj, jdobj, rtol=1e-10)


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_lp_matches_jax_dense_driver(name):
    tlp, jlp = CASES[name]("torch"), CASES[name]("jax")
    res = tdriver.solve_lp(tlp)
    ref = jdriver.solve_lp(jlp)
    assert res.status == IpmStatus.CONVERGED and res.converged
    assert (int(res.status), res.iterations) == (int(ref.status), ref.iterations)
    np.testing.assert_allclose(res.primal_objective, ref.primal_objective, rtol=1e-10)
    np.testing.assert_allclose(res.dual_objective, ref.dual_objective, rtol=1e-10)
    assert res.x.shape == ref.x.shape and res.y.shape == ref.y.shape
    assert isinstance(res.x, np.ndarray) and res.x.dtype == np.float64
    for f in ("mu", "gap", "res_primal", "res_dual"):
        assert isinstance(getattr(res, f), float), f


def _infeasible_standard_form(solver_cls, **kw):
    """The model of test_api.py:test_infeasible_lp (x >= 2, x <= 1)."""
    s = solver_cls("infeas", **kw)
    x = s.MakeNumVar(0.0, s.infinity(), "x")
    c1 = s.MakeRowConstraint(2.0, s.infinity())
    c1.SetCoefficient(x, 1.0)
    c2 = s.MakeRowConstraint(-s.infinity(), 1.0)
    c2.SetCoefficient(x, 1.0)
    s.MutableObjective().SetCoefficient(x, 1.0)
    return s._build_standard_form()


def test_infeasible_lp_never_converges():
    A, b, c, n, _ = _infeasible_standard_form(TSolver, device="cpu")
    jA, jb, jc, jn, _ = _infeasible_standard_form(JSolver)
    np.testing.assert_array_equal(A, jA)
    res = tdriver.solve_lp(tsf.pad_standard_form(A, b, c, n_struct=n, device="cpu"))
    ref = jdriver.solve_lp(jsf.pad_standard_form(jA, jb, jc, n_struct=jn))
    assert res.status != IpmStatus.CONVERGED, res.status
    assert int(ref.status) != int(IpmStatus.CONVERGED), ref.status


# lanes 0..5 carry the instances A, B, A, C, B, A
LANE_TEXTS = [synthetic_scp(24, 120, 0.1, s) for s in (3, 5, 3, 7, 5, 3)]


def _stacked(pkg):
    if pkg == "jax":
        return jsf.stack_lps([jsf.pad_lp(jreader.parse_scp_text(t), m_pad=32, n_pad=256) for t in LANE_TEXTS])
    return tsf.stack_lps(
        [tsf.pad_lp(treader.parse_scp_text(t), m_pad=32, n_pad=256, device="cpu") for t in LANE_TEXTS]
    )


def test_solve_lp_batch_groups_lanes_by_matrix(monkeypatch):
    """Lanes with repeated and with distinct matrices: one engine call for
    the whole stack, each lane's Gram formed from its own matrix; per-lane
    statuses and iterations equal JAX's solve_lp_batch, objectives within
    1e-10, and each lane equals solve_lp of its instance."""
    lp = _stacked("torch")
    grams = []

    def counted(A32, w, **kw):
        grams.append(tuple(A32.shape))
        return tgram.gram_reference(A32, w, **kw)

    monkeypatch.setattr(tspd, "gram", counted)
    calls = []
    engine = tdriver.mehrotra_solve

    def counted_engine(lp, *a, **kw):
        calls.append(lp.A.shape[0])
        return engine(lp, *a, **kw)

    monkeypatch.setattr(tdriver, "mehrotra_solve", counted_engine)
    results = tdriver.solve_lp_batch(lp)
    assert calls == [len(LANE_TEXTS)]
    assert grams and set(grams) == {(len(LANE_TEXTS), 32, 256)}, grams
    assert len(results) == len(LANE_TEXTS)

    ref = jdriver.solve_lp_batch(_stacked("jax"))
    for res, j in zip(results, ref):
        assert res.status == IpmStatus.CONVERGED
        assert (int(res.status), res.iterations) == (int(j.status), j.iterations)
        np.testing.assert_allclose(res.primal_objective, j.primal_objective, rtol=1e-10)
        np.testing.assert_allclose(res.dual_objective, j.dual_objective, rtol=1e-10)

    for text, res in zip(LANE_TEXTS, results):
        single = tdriver.solve_lp(tsf.pad_lp(treader.parse_scp_text(text), m_pad=32, n_pad=256, device="cpu"))
        assert (single.status, single.iterations) == (res.status, res.iterations)
        np.testing.assert_allclose(res.primal_objective, single.primal_objective, rtol=1e-10)
        np.testing.assert_allclose(res.x, single.x, rtol=0, atol=1e-8)


def test_solve_lp_batch_warm_start_and_state():
    lp = _stacked("torch")
    opts = tconfig.IpmOptions()
    cold = tdriver.solve_lp_batch(lp, opts, as_results=False)
    assert isinstance(cold, IpmState)
    assert cold.x.shape == (len(LANE_TEXTS), lp.n_pad) and cold.status.shape == (len(LANE_TEXTS),)
    results = tdriver.solve_lp_batch(lp, opts)
    np.testing.assert_array_equal(cold.status.numpy(), [int(r.status) for r in results])
    np.testing.assert_array_equal(cold.iterations.numpy(), [r.iterations for r in results])
    for lane, r in enumerate(results):
        n = int(lp.n_real[lane])
        np.testing.assert_array_equal(cold.x[lane, :n].numpy(), r.x)

    # a warm start from the cold optimum, pulled back into the interior
    x0 = cold.x + 0.1
    s0 = cold.s + 0.1
    warm = tdriver.solve_lp_batch(lp, opts, warm_start=(x0, cold.y, s0))
    for c, w in zip(results, warm):
        assert w.status == IpmStatus.CONVERGED
        assert w.iterations < c.iterations, (w.iterations, c.iterations)
        np.testing.assert_allclose(w.primal_objective, c.primal_objective, rtol=1e-7)


def test_solve_lp_batch_rejects_an_unbatched_lp():
    with pytest.raises(ValueError):
        tdriver.solve_lp_batch(tsf.pad_lp(treader.parse_scp_text(TINY), device="cpu"))


def test_solve_lp_on_the_ell_operator():
    """solve_lp takes an ELL PaddedLp too (the JAX driver's dense IPM does
    not): same answer as the dense operator on the same bucket."""
    model = treader.parse_scp_text(synthetic_scp(40, 200, 0.02, 5))
    rows = [(np.asarray(r, np.int32), np.ones(len(r))) for r in model.rows]
    dense = tsf.pad_lp(model, device="cpu")
    ell = tsf.pad_standard_form_ell(
        rows, np.ones(model.nrows), model.costs, n_struct=model.ncols,
        m_pad=dense.m_pad, n_pad=dense.n_pad, device="cpu",
    )
    rd, re = tdriver.solve_lp(dense), tdriver.solve_lp(ell)
    assert rd.status == re.status == IpmStatus.CONVERGED
    np.testing.assert_allclose(re.primal_objective, rd.primal_objective, rtol=1e-8)
    assert re.x.shape == rd.x.shape
