"""B&B node windows on the dense operator, the one the B&B picks above
``node_ell_density``: the operator pick, an 8-lane window against the
benchmark's plain float64 reference, the ``dense.*`` spans and the shared
IPM's solves counted by operator, and answers unmoved by tracing.  No JAX."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sypha_tpu_torch.config import SolverConfig
from sypha_tpu_torch.io.scp_reader import parse_scp_text
from sypha_tpu_torch.ipm.node_batch import solve_node_batch
from sypha_tpu_torch.milp.base_model import BaseModel
from sypha_tpu_torch.milp.bnb import _NodeLpSolver
from sypha_tpu_torch.utils import telemetry
from sypha_tpu_torch.utils.logging import Logger

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.kinds import status_names  # noqa: E402
from portbench.reference import judge, lp  # noqa: E402
from portbench.traffic.generate import beasley_instance, rng_for, seeded_fixings  # noqa: E402

LANES = 8
# the limit of the scpnre.window64 cell: a converged lane's objectives lie
# within the port's 1e-8 relative gap and residuals of its optimum and the
# reference reaches 1e-10, so a sound answer errs by about 1e-8; the limit
# sits above every sound reading on the card and below the float32
# reference's (PERF.md, section 4)
ANSWER_ERR = harness.load_json(harness.PKG / "limits" / "scpnre.window64.json")["answer_err"]["max"]


@pytest.fixture(scope="module")
def window():
    """A seeded 40 x 400 instance at 10% density, its base built by the
    B&B's ``_NodeLpSolver``, and one window of seeded fixings with its last
    lane made infeasible (every column covering row 0 fixed to 0)."""
    inst = beasley_instance(40, 400, 0.10, seed=3)
    cfg = SolverConfig()
    solver = _NodeLpSolver(BaseModel(parse_scp_text(inst.text(), "d")), cfg, Logger(verbosity=0),
                           device="cpu")
    solver._rebuild_device_base()
    base = solver._device_base
    fix0, fix1 = seeded_fixings(rng_for(5, 2), LANES, inst.ncols, base.n_pad)
    fix0[-1, inst.rows[0]] = 1.0
    fix1[-1, inst.rows[0]] = 0.0
    fix0 = np.maximum(fix0, solver._inactive)
    opts = cfg.ipm.replace(
        newton_max_steps=max(cfg.ipm.newton_max_steps, 48),
        gap_stall_window=cfg.bnb.gap_stall_branch_iters,
        gap_stall_min_improv=cfg.bnb.gap_stall_min_improv_pct / 100.0,
    )
    return inst, solver, base, torch.as_tensor(fix0), torch.as_tensor(fix1), opts


def _solve(window, **opts):
    _, _, base, fix0, fix1, o = window
    return solve_node_batch(base, fix0, fix1, o.replace(**opts) if opts else o)


def test_the_node_solver_picks_the_dense_operator(window):
    _, solver, base, *_ = window
    assert solver._use_ell is False
    assert isinstance(base.A, torch.Tensor) and base.A.dtype == torch.float64
    assert tuple(base.A.shape) == (base.m_pad, base.n_pad)


def test_window_agrees_lane_by_lane_with_the_reference(window):
    inst, _, _, fix0, fix1, _ = window
    st, _, pobj, dobj = _solve(window)
    f0 = fix0[:, : inst.ncols].numpy() > 0.5
    f1 = fix1[:, : inst.ncols].numpy() > 0.5
    ref = lp.solve(inst.dense, inst.costs, f0, f1)
    names = status_names(st.status)
    # every feasible lane claims its optimum; the infeasible one claims none
    # (the judge reads its stalled answer as no bound, as the B&B prunes it)
    assert names[:-1] == ["converged"] * (LANES - 1) and names[-1] != "converged"
    assert list(ref["feasible"]) == [True] * (LANES - 1) + [False]
    for k in range(LANES):
        one = judge.lp_numbers([names[k]], [float(pobj[k])], [float(dobj[k])], [float(st.res_d[k])],
                               [ref["z"][k]], [ref["feasible"][k]])
        assert one["answer_err"] <= ANSWER_ERR, (k, one)


def _counted(fn):
    telemetry.reset_spans()
    c0 = telemetry.counters()
    with telemetry.tracing():
        out = fn()
    c1 = telemetry.counters()
    log = telemetry.spans()
    telemetry.reset_spans()
    return out, log, {k: c1[k] - c0[k] for k in c1}


def test_dense_spans_and_one_dense_solve_per_call(window):
    _, log, d = _counted(lambda: _solve(window))
    names = {s.name for s in log}
    assert {"dense.Av", "dense.ATu"} <= names and not any(n.startswith("ell.") for n in names)
    assert (d["mehrotra_solve_shared.solves_dense"], d["mehrotra_solve_shared.solves_ell"],
            d["mehrotra_solve_shared.solves_grouped"]) == (1, 0, 0)
    # the Jacobi-diagonal product runs in the matrix-free CG strategy
    _, log, d = _counted(lambda: _solve(window, linear_solver="cg", max_iter=2))
    assert "dense.sqAv" in {s.name for s in log}
    assert d["mehrotra_solve_shared.solves_dense"] == 1
    # off tracing nothing is recorded, and the counters still count
    telemetry.reset_spans()
    c0 = telemetry.counters()["mehrotra_solve_shared.solves_dense"]
    _solve(window, max_iter=2)
    assert telemetry.spans() == []
    assert telemetry.counters()["mehrotra_solve_shared.solves_dense"] == c0 + 1


def test_tracing_moves_no_answer(window):
    off = _solve(window)
    on, _, _ = _counted(lambda: _solve(window))
    st_off, *rest_off = off
    st_on, *rest_on = on
    for f in st_off.__dataclass_fields__:
        assert torch.equal(getattr(st_off, f), getattr(st_on, f)), f
    for a, b in zip(rest_off, rest_on):
        assert torch.equal(a, b)
