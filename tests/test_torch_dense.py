"""The port's per-lane dense IPM (ipm.dense) against ``jax.vmap`` of the
JAX package's ``sypha_tpu.ipm.dense`` on the CPU, lane by lane: equal
statuses and iterations, objectives within 1e-10 relative, x within 1e-8.

Stacks: instances with a matrix of their own in each lane (TINY, demo_small
and seeded 24 x 120 and 40 x 200 instances); one matrix with shifted costs,
where the port's former shared-matrix route differed from JAX by an
iteration; and an infeasible lane beside feasible ones.  Both linear-solver
strategies, cold and warm."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sypha_tpu.config as jconfig
import sypha_tpu.io.scp_reader as jreader
import sypha_tpu.io.standard_form as jsf
from sypha_tpu.api import Solver as JSolver
from sypha_tpu.ipm import dense as jdense
from sypha_tpu.ipm import driver as jdriver
import sypha_tpu_torch as st
import sypha_tpu_torch.config as tconfig
import sypha_tpu_torch.io.scp_reader as treader
import sypha_tpu_torch.io.standard_form as tsf
from sypha_tpu_torch.api import Solver as TSolver
from sypha_tpu_torch.core.problem import PaddedLp
from sypha_tpu_torch.core.status import IpmStatus
from sypha_tpu_torch.ipm import dense as tdense
from sypha_tpu_torch.ops import spd as tspd
from sypha_tpu_torch.testing import synthetic_scp

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
TINY = "3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n"


def _scp_stack(texts, m_pad, n_pad, cost_shift=None):
    """The same SCP texts stacked in both packages, in one bucket; lane i's
    costs are raised by cost_shift[i] when given."""
    out = []
    for reader, sf, kw in ((jreader, jsf, {}), (treader, tsf, {"device": "cpu"})):
        lps = []
        for i, t in enumerate(texts):
            model = reader.parse_scp_text(t)
            if cost_shift is not None:
                model.costs = model.costs + cost_shift[i]
            lps.append(sf.pad_lp(model, m_pad=m_pad, n_pad=n_pad, **kw))
        out.append(sf.stack_lps(lps))
    return tuple(out)


def _infeasible_model(solver_cls, **kw):
    """tests/test_torch_driver.py's infeasible LP: x >= 2 and x <= 1."""
    s = solver_cls("infeas", **kw)
    x = s.MakeNumVar(0.0, s.infinity(), "x")
    c1 = s.MakeRowConstraint(2.0, s.infinity())
    c1.SetCoefficient(x, 1.0)
    c2 = s.MakeRowConstraint(-s.infinity(), 1.0)
    c2.SetCoefficient(x, 1.0)
    s.MutableObjective().SetCoefficient(x, 1.0)
    return s._build_standard_form()


def _with_infeasible():
    """An infeasible lane between two feasible SCP lanes, bucket 8 x 128."""
    out = []
    for reader, sf, solver_cls, kw in (
        (jreader, jsf, JSolver, {}),
        (treader, tsf, TSolver, {"device": "cpu"}),
    ):
        A, b, c, n, _ = _infeasible_model(solver_cls, **kw)
        lps = [
            sf.pad_lp(reader.parse_scp_text(TINY), m_pad=8, n_pad=128, **kw),
            sf.pad_standard_form(A, b, c, n_struct=n, m_pad=8, n_pad=128, **kw),
            sf.pad_lp(reader.parse_scp_text(synthetic_scp(6, 20, 0.4, 2)), m_pad=8, n_pad=128, **kw),
        ]
        out.append(sf.stack_lps(lps))
    return tuple(out)


STACKS = {
    "mixed": lambda: _scp_stack(
        [TINY, (DATA / "demo_small.txt").read_text(), synthetic_scp(24, 120, 0.1, 3), synthetic_scp(40, 200, 0.1, 4)],
        40, 256,
    ),
    "syn24x120": lambda: _scp_stack([synthetic_scp(24, 120, 0.1, s) for s in (3, 5, 7, 9)], 24, 256),
    "syn40x200": lambda: _scp_stack([synthetic_scp(40, 200, 0.1, s) for s in range(4)], 40, 256),
    "shared_A_shifted_costs": lambda: _scp_stack(
        [synthetic_scp(40, 200, 0.1, 4)] * 4, 40, 256,
        cost_shift=np.concatenate([[0.0], np.random.default_rng(0).uniform(0.0, 5.0, 3)]),
    ),
}


# The CG strategy with a tight per-lane tolerance schedule (1e-8 halving to
# 1e-11 with each lane's iterations).  Under the default schedule (1e-2 down
# to 1e-8) Jacobi-CG stops far from the solution, where a CG iterate is so
# sensitive to rounding that the two packages' lanes part by 1e-12 -> 1e-9
# -> 1e-6 over successive IPM iterations, and endgame lanes end GAP_STALLED
# on the solve-quality gate at rounding-dependent iterations (as
# tests/test_torch_ipm_shared.py finds on the shared-matrix engine).
OPTIONS = {
    "dense": {},
    "cg": {"linear_solver": "cg", "cg_tol_initial": 1e-8, "cg_tol_final": 1e-11, "cg_max_iter": 2000},
}


def _jax_vmapped(jlp, jopts, warm=None):
    if warm is None:
        return jdriver._solve_batch(jlp, jopts)
    return jdriver._solve_batch_warm(jlp, *(jnp.asarray(v) for v in warm), jopts)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _objectives(lp, stt):
    c, x = _np(lp.c), _np(stt.x)
    return np.einsum("bn,bn->b", c, x)


def _assert_lanes_match(tst, jst, tlp, jlp, jopts, warm=None, lanes=None):
    """Equal statuses and iterations per lane (of ``lanes``, default all),
    objectives within 1e-10, x within 1e-8.  A lane may differ by one
    iteration only where JAX's own batched and single-lane solves of it
    differ too (a rounding knife edge); the assertion names that lane."""
    lanes = np.arange(tlp.A.shape[0]) if lanes is None else np.asarray(lanes)
    t_it, j_it = _np(tst.iterations), _np(jst.iterations)
    np.testing.assert_array_equal(_np(tst.status)[lanes], _np(jst.status)[lanes])
    for lane in lanes[t_it[lanes] != j_it[lanes]]:
        one = jax.tree_util.tree_map(lambda a: a[lane], jlp)
        args = () if warm is None else tuple(jnp.asarray(v)[lane] for v in warm)
        alone = jax.jit(lambda p, *a: jdense.mehrotra_solve(p, jopts, *a))(one, *args)
        assert abs(int(t_it[lane]) - int(j_it[lane])) == 1, (lane, t_it, j_it)
        assert int(alone.iterations) != int(j_it[lane]), (
            f"lane {lane}: port {t_it[lane]} vs JAX batched {j_it[lane]}, and JAX alone agrees "
            f"with JAX batched ({int(alone.iterations)}): not a knife edge"
        )
    conv = lanes[_np(tst.status)[lanes] == IpmStatus.CONVERGED]
    np.testing.assert_allclose(_objectives(tlp, tst)[conv], _objectives(jlp, jst)[conv], rtol=1e-10)
    np.testing.assert_allclose(_np(tst.x)[conv], _np(jst.x)[conv], rtol=0, atol=1e-8)


@pytest.mark.parametrize("solver", sorted(OPTIONS))
@pytest.mark.parametrize("name", sorted(set(STACKS) - {"infeasible_lane"}))
def test_mehrotra_solve_matches_vmapped_jax(name, solver):
    jlp, tlp = STACKS[name]()
    jopts = jconfig.IpmOptions(**OPTIONS[solver])
    jst = _jax_vmapped(jlp, jopts)
    launches = tspd.gram.launches
    tst = tdense.mehrotra_solve(tlp, tconfig.IpmOptions(**OPTIONS[solver]))
    assert tspd.gram.launches == launches, "no kernel launch on CPU tensors"
    _assert_lanes_match(tst, jst, tlp, jlp, jopts)
    assert (_np(tst.status) == IpmStatus.CONVERGED).all(), _np(tst.status)


@pytest.mark.parametrize("mu_max", [1e32, 1e3])
@pytest.mark.parametrize("solver", sorted(OPTIONS))
def test_infeasible_lane_leaves_the_others_alone(solver, mu_max):
    """tests/test_torch_driver.py's infeasible LP between two feasible lanes.
    The feasible lanes match JAX lane by lane.  Under the default mu_max
    (1e32) the infeasible lane diverges chaotically: mu passes 1e9 by
    iteration 5, where the packages' iterates part in the third digit, and
    JAX's own batched and single-lane solves end it differently (MAX_ITER
    after 60 iterations, GAP_STALLED after 6 in the dense strategy).  So
    that lane is held only to never converging, in the port, in JAX
    batched and in JAX alone.  With mu_max = 1e3 the divergence test stops
    it while the iterates still agree, and every lane matches, its verdict
    INFEASIBLE_OR_NUMERICAL included."""
    jlp, tlp = _with_infeasible()
    kw = dict(OPTIONS[solver], mu_max=mu_max)
    jopts = jconfig.IpmOptions(**kw)
    jst = _jax_vmapped(jlp, jopts)
    tst = tdense.mehrotra_solve(tlp, tconfig.IpmOptions(**kw))
    status = _np(tst.status)
    assert (status[[0, 2]] == IpmStatus.CONVERGED).all() and status[1] != IpmStatus.CONVERGED
    if mu_max < 1e32:
        assert status[1] == IpmStatus.INFEASIBLE_OR_NUMERICAL
        _assert_lanes_match(tst, jst, tlp, jlp, jopts)
    else:
        _assert_lanes_match(tst, jst, tlp, jlp, jopts, lanes=[0, 2])
        one = jax.tree_util.tree_map(lambda a: a[1], jlp)
        alone = jax.jit(lambda p: jdense.mehrotra_solve(p, jopts))(one)
        assert int(_np(jst.status)[1]) != IpmStatus.CONVERGED
        assert int(alone.status) != IpmStatus.CONVERGED


@pytest.mark.parametrize("solver", sorted(OPTIONS))
@pytest.mark.parametrize("name", ["mixed", "shared_A_shifted_costs"])
def test_warm_mehrotra_solve_matches_vmapped_jax(name, solver):
    """Warm-started from the cold optimum pulled back into the interior."""
    jlp, tlp = STACKS[name]()
    topts = tconfig.IpmOptions(**OPTIONS[solver])
    cold = tdense.mehrotra_solve(tlp, topts)
    warm = (cold.x.numpy() + 0.1, cold.y.numpy(), cold.s.numpy() + 0.1)
    jopts = jconfig.IpmOptions(**OPTIONS[solver])
    jst = _jax_vmapped(jlp, jopts, warm)
    tst = tdense.mehrotra_solve(tlp, topts, *(torch.from_numpy(v) for v in warm))
    _assert_lanes_match(tst, jst, tlp, jlp, jopts, warm)
    assert (_np(tst.status) == IpmStatus.CONVERGED).all()
    assert (_np(tst.iterations) < _np(cold.iterations)).all()


@pytest.mark.parametrize("name", ["mixed", "infeasible_lane"])
def test_initial_point_matches_vmapped_jax(name):
    jlp, tlp = _with_infeasible() if name == "infeasible_lane" else STACKS[name]()
    jopts = jconfig.IpmOptions()
    want = jax.vmap(lambda p: jdense.initial_point(p, jopts))(jlp)
    got = st.initial_point(tlp, tconfig.IpmOptions())
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-10 * max(1.0, np.abs(w).max()))


def test_shared_matrix_lanes_run_on_their_own():
    """The shifted-cost stack shares one A, as lanes of the shared-matrix
    engine would; per lane each stops at its own iteration, which is where
    that engine's batch-wide PCG differed from JAX's per-lane loop.  Each
    lane solved alone takes the same iterations to the same point (the
    batched library calls round differently at another batch size)."""
    jlp, tlp = STACKS["shared_A_shifted_costs"]()
    tst = tdense.mehrotra_solve(tlp, tconfig.IpmOptions())
    for lane in range(tlp.A.shape[0]):
        one = tsf.stack_lps([PaddedLp(**{f: getattr(tlp, f)[lane] for f in tlp.__dataclass_fields__})])
        alone = tdense.mehrotra_solve(one, tconfig.IpmOptions())
        assert int(alone.iterations[0]) == int(tst.iterations[lane])
        np.testing.assert_allclose(alone.x[0].numpy(), tst.x[lane].numpy(), rtol=0, atol=1e-10)


def test_mehrotra_solve_rejects_a_shared_or_sparse_operator():
    lp = tsf.pad_lp(treader.parse_scp_text(TINY), device="cpu")
    with pytest.raises(ValueError, match="stacked dense"):
        tdense.mehrotra_solve(lp, tconfig.IpmOptions())
