"""The configuration ``scpnre`` and its cell ``scpnre.window64``: its files
load by name, a small CPU run of the cell's own files (the class cut to a
test size, its density kept, so that the B&B still picks the dense operator)
is correct and reports the dense operator's metric, the float32 control and
each ``node_window`` fault are not correct, and ``dense.host_ms_per_iter``
reads hand-built span logs."""

import time

import pytest

from portbench import faults, harness

CELL = "scpnre.window64"
MS = 1_000_000


def cell():
    sp = harness.spec()
    return sp, harness.workload(sp, CELL)


@pytest.fixture
def small_scpnre():
    """The cell's own configuration, traffic and limits, the class cut to
    40 x 400 at its 10%, 2 instances of 2 fixing sets of 8 lanes."""
    _, w = cell()
    config, traffic, limits = harness.cell_files(w)
    config = dict(config, rows=40, cols=400)
    traffic = dict(traffic, instances=2, lanes=8, fixing_sets=2, check_windows=4, trace_calls=1)
    return w, (config, traffic, limits)


def run(small, seed, traced=False):
    w, files = small
    res, _ = harness.run_cell(CELL, seed, 0.2, traced, "cpu", t_start=time.perf_counter(),
                              files=files, entry=w, log=lambda m: None)
    return res


def test_configuration_and_cell_load_by_name():
    sp, w = cell()
    config, traffic, limits = harness.cell_files(w)
    assert (w["config"], w["traffic"], w["chips"]) == ("scpnre", "window64", 1)
    assert (config["rows"], config["cols"], config["density"]) == (500, 5000, 0.1)
    assert config["instances"] == [f"scpnre{i}" for i in range(1, 6)]
    assert next(c for c in sp["configs"] if c["name"] == "scpnre")["reduced"] == []
    assert traffic["kind"] == "node_window"
    assert set(limits) == {"answer_err", "converged_pct"}
    per_layer = {m["name"] for m in harness.metrics_for(sp, w, traced=True)}
    assert "dense.host_ms_per_iter" in per_layer and "ell.device_ms_per_iter" not in per_layer


def test_small_run_is_correct_on_the_dense_operator(small_scpnre):
    from sypha_tpu_torch.utils import telemetry

    c0 = telemetry.counters()
    res = run(small_scpnre, 3000000019, traced=True)
    c1 = telemetry.counters()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert c1["mehrotra_solve_shared.solves_dense"] > c0["mehrotra_solve_shared.solves_dense"]
    assert c1["mehrotra_solve_shared.solves_ell"] == c0["mehrotra_solve_shared.solves_ell"]
    assert res["metrics"]["dense.host_ms_per_iter"]["value"] > 0
    assert harness.foreign_modules() == []


@pytest.mark.parametrize("rule", ["claims", "program"])
def test_float32_control_is_not_correct(rule, small_scpnre):
    """The float32 reference in the program's place, every feasible lane
    claiming its optimum or under the port's own rule, at 100 x 1000 and 32
    lanes: at 40 x 400 the float32 reference still reaches about 1e-7,
    where the claims of a class cut that far are too easy to be a control."""
    _, (config, traffic, limits) = small_scpnre
    config = dict(config, rows=100, cols=1000)
    traffic = dict(traffic, instances=1, lanes=32, fixing_sets=1)
    c = harness.kind("node_window").setup(config, traffic, 3000000023, "cpu")
    c.answers = [(0, 0, None, None, None, None)]
    assert not harness.judge.verdict(c.control(rule), limits)[1]


@pytest.mark.parametrize("fault", faults.FAULTS["node_window"])
def test_planted_fault_is_not_correct(fault, small_scpnre):
    undo = faults.plant(fault, "node_window")
    try:
        res = run(small_scpnre, 3000000029)
    finally:
        undo()
    assert not res["correct"], res["checks"]


def span(name, start_ms, end_ms, parent=-1, thread=1):
    return (name, thread, start_ms * MS, end_ms * MS, parent)


def test_dense_host_ms_per_iter_on_hand_built_logs():
    value = harness.reader("dense.host_ms_per_iter").__globals__["value"]
    log = [
        span("ipm.node_batch", 0, 100),      # 0
        span("dense.Av", 0, 1, 0),           # 1: fix_columns, outside ipm.solve
        span("ipm.solve", 1, 91, 0),         # 2
        span("ipm.initial_point", 2, 10, 2),  # 3
        span("dense.ATu", 3, 5, 3),          # 4
        span("ipm.iteration", 12, 50, 2),    # 5
        span("dense.Av", 13, 14, 5),         # 6
        span("pcg.solve", 20, 40, 5),        # 7
        span("dense.ATu", 21, 24, 7),        # 8
        span("ipm.iteration", 50, 88, 2),    # 9
        span("dense.sqAv", 51, 52, 9),       # 10
        span("dense.Av", 200, 210),          # 11: a product of its own
    ]
    # 2 + 1 + 3 + 1 ms inside ipm.solve over its two iterations
    assert value(log) == pytest.approx(7 / 2)
    assert value([]) is None
    assert value([("other",) + s[1:] if s[0].startswith("dense.") else s for s in log]) is None
    assert value([("ipm.solve", 1, 0, None, -1), span("dense.Av", 1, 2, 0)]) is None
