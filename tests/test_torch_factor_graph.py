"""The shared IPM's factor as one CUDA graph per key (ops.spd.factor_gram
with ``graph``): off a card the eager chain runs and the graph counters stay
0; the counters are listed by ``telemetry.counters()``; the benchmark's
``ipm.factor_graph_pct`` reads synthetic span logs.  The tests marked
``cuda`` hold the replayed factor against the eager chain on the card, bit
for bit: (Linv, dinv), a non-PD lane's NaNs, two threads on two keys, the
cache's LRU, and whole node windows.  Nothing here imports JAX:

    python -m pytest --noconftest tests/test_torch_factor_graph.py -q
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from sypha_tpu_torch.config import IpmOptions
from sypha_tpu_torch.io.scp_reader import parse_scp_text
from sypha_tpu_torch.io.standard_form import bucket_dims, pad_lp, pad_standard_form_ell
from sypha_tpu_torch.ipm import node_batch as tnode
from sypha_tpu_torch.ipm import shared as tshared
from sypha_tpu_torch.ops import spd as tspd
from sypha_tpu_torch.testing import synthetic_scp
from sypha_tpu_torch.utils import telemetry

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

COUNTERS = ("calls", "graph_captures", "graph_replays")
RIDGE, LEAF = 2e-6, 64


def _counts():
    return {k: getattr(tspd.factor_gram, k) for k in COUNTERS}


def _delta(c0):
    return {k: getattr(tspd.factor_gram, k) - c0[k] for k in COUNTERS}


def _gram(shape, device, seed=0):
    """An f32 Gram matrix of ``shape`` [..., m, m] with the spread of scales
    an IPM's late iterations give, and row_reg [..., m] in f64."""
    g = torch.Generator().manual_seed(seed)
    m = shape[-1]
    A = (torch.rand(shape[:-1] + (2 * m,), generator=g) < 0.1).double()
    w = 10.0 ** (8 * torch.rand(shape[:-2] + (1, 2 * m), generator=g, dtype=torch.float64) - 4)
    M = (A * w) @ A.mT
    row_reg = (torch.rand(shape[:-1], generator=g, dtype=torch.float64) < 0.05) * 1.0
    return M.float().to(device), row_reg.to(device)


def _same(a, b):
    """Bit for bit, NaNs where NaNs are."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


def test_shared_factor_runs_the_eager_chain_off_a_card():
    """``_shared_factor`` asks for the graph (no process group) and gets the
    eager chain on the CPU: exactly ``factor_gram``'s answer without the
    graph, every call counted, nothing captured or replayed."""
    model = parse_scp_text(synthetic_scp(20, 60, 0.15, 3), "t3")
    batch = tshared.make_shared_batch(pad_lp(model, device="cpu"), 3)
    d = torch.from_numpy(10.0 ** np.random.default_rng(3).uniform(-4, 4, batch.c.shape)) * batch.col_mask
    A32 = batch.A.float().contiguous()
    row_reg = batch.row_pad.unsqueeze(-2).expand(batch.b.shape)
    c0 = _counts()
    Linv, dinv = tshared._shared_factor(A32, d, row_reg, torch.float32, RIDGE, LEAF)
    M = tshared.gram(A32, torch.sqrt(d).float().contiguous())
    want = tspd.factor_gram(M, row_reg, RIDGE, LEAF)
    assert _delta(c0) == dict(calls=2, graph_captures=0, graph_replays=0)
    assert torch.equal(Linv, want[0]) and torch.equal(dinv, want[1])


def test_factor_counters_are_listed():
    c = telemetry.counters()
    assert all(c[f"factor_gram.{k}"] == getattr(tspd.factor_gram, k) for k in COUNTERS)


def _log(*factors):
    """A span log: an outermost ``ipm.solve``, and per entry of ``factors``
    an ``ipm.factor`` inside it holding a ``factor.replay`` (True), a
    ``factor.capture`` alone (False) or no child (None); then an
    ``ipm.factor`` outside any ``ipm.solve``, which is not counted."""
    log = [("ipm.solve", 1, 0, 100, -1), ("ipm.iteration", 1, 1, 90, 0)]
    for replayed in factors:
        log.append(("ipm.factor", 1, 2, 3, 1))
        if replayed is not None:
            log.append(("factor.replay" if replayed else "factor.capture", 1, 2, 3, len(log) - 1))
    log.append(("ipm.factor", 1, 200, 300, -1))
    return log


@pytest.mark.parametrize("factors,want", [
    ((True, True, True), 100.0),
    ((True, False, True, None), 50.0),
    ((None, None), None),
], ids=["replayed", "half", "eager"])
def test_factor_graph_pct_reads_the_span_log(factors, want):
    value = harness.reader("ipm.factor_graph_pct").__globals__["value"]
    assert value(_log(*factors)) == want


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 288, 288), (64, 576, 576), (2, 8, 288, 288)],
                         ids=["scp4x", "scpnre", "grouped"])
def test_replayed_factor_is_the_eager_chain_on_card(cuda_device, shape):
    """The first call captures and replays, later calls of the key replay
    alone; each answer is the eager chain's bit for bit, a lane made non-PD
    included, whose lower triangle comes back NaN."""
    tspd._factor_graphs.clear()
    c0 = _counts()
    for seed in (0, 1, 2):
        M, row_reg = _gram(shape, cuda_device, seed)
        if seed == 2:
            bad = M[(0,) * (len(shape) - 2)]
            bad.copy_(torch.eye(shape[-1], device=cuda_device))
            bad[0, 1] = bad[1, 0] = 2.0
        want = tspd.factor_gram(M, row_reg, RIDGE, LEAF)
        got = tspd.factor_gram(M, row_reg, RIDGE, LEAF, graph=True)
        assert _same(got[0], want[0]) and _same(got[1], want[1])
        nan = torch.isnan(got[0]).flatten(0, -3).flatten(1)
        lower = torch.ones(shape[-1], shape[-1], dtype=torch.bool, device=cuda_device).tril()
        assert bool(nan.any(dim=1)[0]) == (seed == 2) and not bool(nan[1:].any())
        if seed == 2:
            assert bool(torch.isnan(got[0].flatten(0, -3)[0][lower]).all())
    assert _delta(c0) == dict(calls=6, graph_captures=1, graph_replays=3)


@pytest.mark.cuda
def test_replayed_factor_from_two_threads_on_card(cuda_device):
    """Two threads factoring on two keys at once (the mesh's shard threads
    on one card) each get the eager answer, captures included."""
    tspd._factor_graphs.clear()
    inputs = [_gram(shape, cuda_device, i) for i, shape in enumerate([(64, 288, 288), (32, 288, 288)])]
    wants = [tspd.factor_gram(M, r, RIDGE, LEAF) for M, r in inputs]
    got, errors = {}, []

    def work(i):
        try:
            M, r = inputs[i]
            got[i] = [tspd.factor_gram(M, r, RIDGE, LEAF, graph=True) for _ in range(6)]
        except Exception as e:  # reported below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    for i in (0, 1):
        for Linv, dinv in got[i]:
            assert _same(Linv, wants[i][0]) and _same(dinv, wants[i][1])


@pytest.mark.cuda
def test_factor_graph_cache_drops_the_least_recently_used_key_on_card(cuda_device, monkeypatch):
    monkeypatch.setattr(tspd, "GRAPH_KEYS", 2)
    tspd._factor_graphs.clear()
    inputs = [_gram((lanes, 96, 96), cuda_device) for lanes in (8, 16, 32)]
    for M, r in inputs + inputs[:1]:
        c0 = _counts()
        tspd.factor_gram(M, r, RIDGE, LEAF, graph=True)
        assert _delta(c0)["graph_captures"] == 1  # the first key was dropped
        assert len(tspd._factor_graphs) <= 2


def _scp4x_window(device, sparse, lanes=64, seed=0):
    """A 64-lane node window of a scp4x-class instance (200 x 1000 at 2%):
    its base LP on the padded-ELL or the dense operator, and seeded fixings
    to 0."""
    model = parse_scp_text(synthetic_scp(200, 1000, 0.02, seed), f"scp4x-{seed}")
    if sparse:
        m_pad, n_pad = bucket_dims(model.nrows, model.ncols + model.nrows)
        rows = [(np.asarray(cols, dtype=np.int32), np.ones(len(cols))) for cols in model.rows]
        lp = pad_standard_form_ell(rows, np.ones(model.nrows), model.costs, model.ncols,
                                   m_pad, n_pad, device=device)
    else:
        lp = pad_lp(model, device=device)
    fix0 = (np.random.default_rng(seed).random((lanes, lp.n_pad)) < 0.03).astype(np.float64)
    fix0[:, model.ncols:] = 0.0
    fix0 = torch.from_numpy(fix0).to(device)
    return lp, fix0, torch.zeros_like(fix0)


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [True, False], ids=["ell", "dense"])
def test_graphed_factor_node_window_matches_eager_on_card(cuda_device, sparse, monkeypatch):
    """A whole ``solve_node_batch`` window with the replayed factor against
    the same window with the eager chain: statuses, iterations and
    objectives equal, and the same PCG steps and syncs; every
    ``ipm.factor`` of the traced window replays."""
    lp, fix0, fix1 = _scp4x_window(cuda_device, sparse)
    opts = IpmOptions().replace(newton_max_steps=48)
    work = ("pcg_solve.steps", "pcg_solve.syncs", "mehrotra_solve_shared.syncs")
    c0, w0 = _counts(), telemetry.counters()
    telemetry.reset_spans()
    with telemetry.tracing():
        graphed = tnode.solve_node_batch(lp, fix0, fix1, opts)
    log = telemetry.spans()
    telemetry.reset_spans()
    graphed_work = [telemetry.counters()[k] - w0[k] for k in work]
    assert _delta(c0)["graph_replays"] == _delta(c0)["calls"] > 0
    assert harness.reader("ipm.factor_graph_pct").__globals__["value"](log) == 100.0

    def eager(M, row_reg, ridge, leaf_size, graph=False):
        return tspd._factor_chain(M, row_reg, ridge, leaf_size)

    monkeypatch.setattr(tshared, "factor_gram", eager)
    c0, w0 = _counts(), telemetry.counters()
    plain = tnode.solve_node_batch(lp, fix0, fix1, opts)
    assert _delta(c0)["graph_replays"] == 0
    assert [telemetry.counters()[k] - w0[k] for k in work] == graphed_work
    assert torch.equal(graphed[0].status, plain[0].status)
    assert torch.equal(graphed[0].iterations, plain[0].iterations)
    for a, b in zip(graphed[2:], plain[2:]):
        assert torch.equal(a, b)
