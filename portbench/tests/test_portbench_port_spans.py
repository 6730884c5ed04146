"""The readers of the port's own spans (``ipm.syncs_per_iter``,
``ipm.sync_wait_pct``, ``bnb.precompile_s_per_solve``) on hand-built span
logs, on an empty log, on a port without spans, and on the log of a small
solve against the port's counters."""

import numpy as np
import pytest

from portbench import harness

MS = 1_000_000


def span(name, start_ms, end_ms, parent=-1, thread=1):
    return (name, thread, start_ms * MS, end_ms * MS, parent)


def renamed(log, name):
    """The log with every span called ``name`` renamed (indices kept)."""
    return [("other",) + s[1:] if s[0] == name else s for s in log]


# one IPM call of two iterations: 5 syncs inside ipm.solve, 2 outside
IPM_LOG = [
    span("ipm.node_batch", 0, 100),                # 0
    span("ipm.solve", 1, 91, 0),                   # 1
    span("k1.sync", 2, 3, 1),                      # 2
    span("ipm.initial_point", 3, 10, 1),           # 3
    span("pcg.solve", 4, 9, 3),                    # 4
    span("pcg.sync", 5, 6, 4),                     # 5
    span("ipm.sync", 10, 12, 1),                   # 6
    span("ipm.iteration", 12, 50, 1),              # 7
    span("pcg.sync", 20, 21, 7),                   # 8
    span("ipm.iteration", 50, 88, 1),              # 9
    span("ipm.sync", 88, 90, 1),                   # 10
    span("bnb.host_copy", 92, 99, 0),              # 11: outside ipm.solve
    span("pcg.sync", 200, 210),                    # 12: a PCG call of its own
]

# two solves, the second with a nested (compact) solve that warms up again
BNB_LOG = [
    span("bnb.solve", 0, 1000),                    # 0
    span("bnb.precompile", 10, 310, 0),            # 1
    span("bnb.window", 320, 400, 0),               # 2
    span("bnb.solve", 1000, 3000),                 # 3
    span("bnb.precompile", 1010, 1210, 3),         # 4
    span("bnb.compact", 1300, 2900, 3),            # 5
    span("bnb.solve", 1310, 2890, 5),              # 6: nested, part of solve 3
    span("bnb.precompile", 1320, 1420, 6),         # 7
    span("bnb.closure", 1000, 1500, -1, thread=2),  # 8: the closure's worker
]


def test_syncs_per_iter():
    value = harness.reader("ipm.syncs_per_iter").__globals__["value"]
    assert value(IPM_LOG) == pytest.approx(5 / 2)
    assert value([]) is None
    assert value(renamed(IPM_LOG, "ipm.iteration")) is None


def test_sync_wait_pct():
    value = harness.reader("ipm.sync_wait_pct").__globals__["value"]
    # syncs inside ipm.solve: 1 + 1 + 2 + 1 + 2 ms of a 90 ms solve
    assert value(IPM_LOG) == pytest.approx(100.0 * 7 / 90)
    assert value([]) is None
    open_solve = [("ipm.solve", 1, 0, None, -1), span("ipm.sync", 1, 2, 0)]
    assert value(open_solve) is None


def test_precompile_s_per_solve():
    value = harness.reader("bnb.precompile_s_per_solve").__globals__["value"]
    # 300 + 200 + 100 ms over the two outermost solves
    assert value(BNB_LOG) == pytest.approx(0.6 / 2)
    assert value([]) is None
    assert value(renamed(BNB_LOG, "bnb.solve")) is None


@pytest.mark.parametrize("name", ["ipm.syncs_per_iter", "ipm.sync_wait_pct", "bnb.precompile_s_per_solve"])
def test_readers_find_nothing_without_the_port_s_spans(name, monkeypatch):
    from sypha_tpu_torch.utils import telemetry

    read = harness.reader(name)
    monkeypatch.setattr(telemetry, "spans", lambda: [])
    assert read({}) is None
    # a port that records no spans at all (before it had them)
    monkeypatch.delattr(telemetry, "spans")
    assert read({}) is None


def test_syncs_per_iter_of_a_solve_matches_the_port_s_counters():
    """On the log of a small node window under ``telemetry.tracing()``, the
    reader's syncs per iteration are the port's sync counters over its
    iteration counter, and the wait share lies in (0, 100)."""
    from sypha_tpu_torch.config import IpmOptions
    from sypha_tpu_torch.io.scp_reader import parse_scp_text
    from sypha_tpu_torch.io.standard_form import pad_lp
    from sypha_tpu_torch.ipm.node_batch import solve_node_batch
    from sypha_tpu_torch.testing import synthetic_scp
    from sypha_tpu_torch.utils import telemetry

    base = pad_lp(parse_scp_text(synthetic_scp(20, 60, 0.15, 7), "t"), device="cpu")
    fix0 = np.zeros((4, base.n_pad))
    fix0[np.arange(4), np.arange(4)] = 1.0
    telemetry.reset_spans()
    c0 = telemetry.counters()
    with telemetry.tracing():
        solve_node_batch(base, fix0, np.zeros_like(fix0), IpmOptions())
    c1 = telemetry.counters()
    log = telemetry.spans()
    telemetry.reset_spans()
    d = {k: c1[k] - c0[k] for k in c1}
    syncs = d["pcg_solve.syncs"] + d["mehrotra_solve_shared.syncs"]
    read = harness.reader("ipm.syncs_per_iter").__globals__["value"]
    assert read(log) == pytest.approx(syncs / d["mehrotra_solve_shared.iterations"])
    wait = harness.reader("ipm.sync_wait_pct").__globals__["value"](log)
    assert 0.0 < wait < 100.0
