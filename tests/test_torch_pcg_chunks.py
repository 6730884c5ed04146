"""The PCG in chunks (ops.spd.pcg_chunked, normal_pcg): gated steps with one
read of a device flag per chunk give the eager ``pcg_solve``'s x and rel bit
for bit after the same number of real steps, in the batch-wide and the
per-group loop, at chunk sizes 1, 3 and 8, wherever the loop stops: inside a
chunk, on a chunk's last step, at entry, or cut by ``max_steps``; the
counters of real and masked steps and of reads are exact.  The CUDA graphs
of ``normal_pcg`` carry the ``cuda`` marker and skip without a card.  Nothing
here imports JAX, so the file also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_pcg_chunks.py -q
"""

import numpy as np
import pytest
import torch

from sypha_tpu_torch.config import IpmOptions
from sypha_tpu_torch.io.scp_reader import parse_scp_text
from sypha_tpu_torch.io.standard_form import bucket_dims, pad_lp, pad_standard_form_ell
from sypha_tpu_torch.ipm import node_batch as tnode
from sypha_tpu_torch.ipm import shared as tshared
from sypha_tpu_torch.ops import spd as tspd
from sypha_tpu_torch.ops.ell import products
from sypha_tpu_torch.testing import synthetic_scp

COUNTERS = ("steps", "syncs", "masked_steps", "graph_captures", "graph_replays")


def _counts():
    return {k: getattr(tspd.pcg_solve, k) for k in COUNTERS}


def _delta(c0):
    return {k: getattr(tspd.pcg_solve, k) - c0[k] for k in COUNTERS}


def _system(per_group):
    """A Jacobi-preconditioned SPD system: 6 lanes, or 3 groups of 2."""
    rng = np.random.default_rng(7)
    B, m = 6, 48  # PCG's residual falls at every one of its first 20 steps
    G = rng.standard_normal((B, m, 2 * m))
    scale = 10.0 ** rng.uniform(-2, 2, (B, m))
    M = scale[:, :, None] * (G @ G.transpose(0, 2, 1) + m * np.eye(m)) * scale[:, None, :]
    f = rng.standard_normal((B, m))
    M, f = torch.from_numpy(M), torch.from_numpy(f)
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    if per_group:
        M, f, diag = M.reshape(3, 2, m, m), f.reshape(3, 2, m), diag.reshape(3, 2, m)
    return (lambda r: r / diag), (lambda v: torch.einsum("...ij,...j->...i", M, v)), f


def _tol_for(precond, matvec, f, K, per_group):
    """The tolerance at which the loop stops after exactly K steps (per
    group, group g after K - g steps): the residual norms of K gated steps
    with every lane stepping, the threshold just above the largest norm at
    step K, and a check that some lane (of the group) is above it before."""
    s = tspd._PcgState(f, False)
    s.kmax.fill_(K)
    tspd._chunked_setup(precond, matvec, f, 0.0, s)
    norm_f = torch.linalg.vector_norm(f, dim=-1)
    rels = [torch.linalg.vector_norm(s.r, dim=-1) / norm_f]
    for _ in range(K):
        tspd._chunk(precond, matvec, s, 1)
        rels.append(torch.linalg.vector_norm(s.r, dim=-1) / norm_f)
    rels = torch.stack(rels)  # [K + 1, lanes...]
    if not per_group:
        worst = rels.reshape(K + 1, -1).amax(dim=1)
        tol = float(worst[K]) * (1 + 1e-9)
        assert bool((worst[:K] > tol * (1 + 1e-6)).all())
        return tol
    worst = rels.amax(dim=-1)  # [K + 1, G]
    ks = [max(K - g, 0) for g in range(worst.shape[1])]
    tol = torch.tensor([float(worst[k, g]) * (1 + 1e-9) for g, k in enumerate(ks)], dtype=f.dtype)
    for g, k in enumerate(ks):
        assert bool((worst[:k, g] > tol[g] * (1 + 1e-6)).all())
    return tol[:, None, None].expand(f.shape[:-1] + (1,)).contiguous()


@pytest.mark.parametrize("per_group", [False, True], ids=["batch", "group"])
@pytest.mark.parametrize("size", [1, 3, 8])
@pytest.mark.parametrize("stop", ["mid_chunk", "chunk_end", "at_entry", "max_steps"])
def test_chunked_loop_is_the_eager_loop_bit_for_bit(per_group, size, stop):
    precond, matvec, f = _system(per_group)
    max_steps = 40
    if stop == "mid_chunk":
        K = 2 * size + 1
    elif stop == "chunk_end":
        K = 2 * size
    elif stop == "at_entry":
        K = 0
    else:
        K = max_steps = 2 * size + 1
    tol = 0.0 if stop == "max_steps" else (1e3 if K == 0 else _tol_for(precond, matvec, f, K, per_group))

    c0 = _counts()
    ex, erel = tspd.pcg_solve(precond, matvec, f, tol, max_steps, per_group=per_group)
    eager = _delta(c0)
    assert eager["steps"] == K

    # one chunk a read (the plan off a card), then a first batch that runs
    # past the stop, as on a card after a longer call
    for last in (0, K + 2 * size):
        plan = tspd.PcgChunks()
        plan.SIZE = size
        plan.last = last
        first = max(1, last // size)
        plan.first = lambda device: first
        c0 = _counts()
        x, rel = tspd.pcg_chunked(precond, matvec, f, tol, max_steps, plan, per_group)
        got = _delta(c0)
        assert torch.equal(x, ex) and torch.equal(rel, erel)
        cap = -(-max_steps // size)
        need = max(1, -(-K // size))  # chunks until the flag is down after step K
        chunks = min(max(first, need), cap)
        reads = 1 + max(0, chunks - first)
        assert got == dict(steps=K, syncs=reads, masked_steps=chunks * size - K,
                           graph_captures=0, graph_replays=0)
        assert plan.last == K


def test_normal_pcg_is_the_shared_ipms_eager_pcg_on_the_cpu():
    """``normal_pcg`` on both operators against ``pcg_solve`` with the shared
    IPM's preconditioner and matvec, bit for bit: it runs the chunked loop
    eagerly off a card."""
    model = parse_scp_text(synthetic_scp(30, 120, 0.08, 4), "t4")
    rng = np.random.default_rng(4)
    for batch in (tshared.make_shared_batch_sparse(model, 5, device="cpu"),
                  tshared.make_shared_batch_auto(model, 5, density_threshold=0.0, device="cpu")):
        d = torch.from_numpy(10.0 ** rng.uniform(-4, 4, (5, batch.n_pad))) * batch.col_mask
        Linv, dinv, f, row_pad = _factored(batch, d, rng)
        c0 = _counts()
        want = _eager(Linv, dinv, batch.A, d, row_pad, f, 48)
        k = _delta(c0)["steps"]
        plan = tspd.PcgChunks()
        got = tspd.normal_pcg(Linv, dinv, batch.A, d, row_pad, f, 1e-10, 48, plan)
        assert k > 0 and plan.last == k
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _factored(batch, d, rng):
    row_pad = batch.row_pad.unsqueeze(-2)
    A32 = batch.A.todense(torch.float32) if batch.is_sparse else batch.A.float()
    Linv, dinv = tshared._shared_factor(A32, d, row_pad.expand(batch.b.shape), torch.float32, 2e-6, 64)
    f = torch.from_numpy(rng.standard_normal(batch.b.shape)).to(batch.b.device)
    return Linv, dinv, f, row_pad


def _eager(Linv, dinv, A, d, row_pad, f, max_steps, tol=1e-10, per_group=False):
    fac = tspd.NormalEqFactor(Linv=Linv, dinv=dinv)
    Av, ATu, _ = products(A)
    return tspd.pcg_solve(
        lambda r: tspd._apply_normal_precond(fac, r),
        lambda v: Av(d * ATu(v)) + row_pad * v, f, tol, max_steps, per_group=per_group,
    )


# ---------------------------------------------------------------------------
# on the card: the CUDA graphs of normal_pcg
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _scp4x_lp(device, sparse, seed=0):
    """A scp4x-class instance (200 x 1000 at 2%) as a base LP on the
    padded-ELL or the dense operator."""
    model = parse_scp_text(synthetic_scp(200, 1000, 0.02, seed), f"scp4x-{seed}")
    if not sparse:
        return model, pad_lp(model, device=device)
    m_pad, n_pad = bucket_dims(model.nrows, model.ncols + model.nrows)
    rows = [(np.asarray(cols, dtype=np.int32), np.ones(len(cols))) for cols in model.rows]
    return model, pad_standard_form_ell(rows, np.ones(model.nrows), model.costs, model.ncols,
                                        m_pad, n_pad, device=device)


def _scp4x_window(device, sparse, lanes=64, seed=0):
    """A 64-lane node window of a scp4x-class instance: its base LP, seeded
    fixings to 0, and the window's batch."""
    model, lp = _scp4x_lp(device, sparse, seed)
    rng = np.random.default_rng(seed)
    fix0 = (rng.random((lanes, lp.n_pad)) < 0.03).astype(np.float64)
    fix0[:, model.ncols:] = 0.0
    fix0 = torch.from_numpy(fix0).to(device)
    fix1 = torch.zeros_like(fix0)
    batch = tshared.fix_columns(tshared.make_shared_batch(lp, lanes), fix0, fix1)
    return lp, fix0, fix1, batch, rng


def _newton_system(device, kind, seed=0, lanes=64):
    """(A, d, row_pad, Linv, dinv, f, per_group) of a Newton system of a
    scp4x-class window: 64 lanes on the ELL or the dense operator, or 3
    instance groups of 16 lanes (the grouped solve's layout)."""
    if kind == "grouped":
        batch = tshared.stack_shared_batches(
            [tshared.make_shared_batch(_scp4x_lp(device, False, s)[1], lanes // 4) for s in range(3)]
        )
        rng = np.random.default_rng(seed)
    else:
        batch, rng = _scp4x_window(device, kind == "ell", lanes, seed)[3:]
    d = torch.from_numpy(10.0 ** rng.uniform(-6, 6, batch.c.shape)).to(device) * batch.col_mask
    Linv, dinv, f, row_pad = _factored(batch, d, rng)
    return batch.A, d, row_pad, Linv, dinv, f, kind == "grouped"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ell", "dense", "grouped"])
def test_graphed_pcg_matches_eager_on_card(cuda_device, kind):
    """Graphed against eager on a scp4x-class window: the same real steps,
    x and rel bit for bit; a second call of the key replays without a
    capture; a changed d is copied in and gives the eager answer."""
    A, d, row_pad, Linv, dinv, f, grouped = _newton_system(cuda_device, kind)
    c0 = _counts()
    want = _eager(Linv, dinv, A, d, row_pad, f, 48, per_group=grouped)
    k = _delta(c0)["steps"]
    plan = tspd.PcgChunks()
    c0 = _counts()
    got = tspd.normal_pcg(Linv, dinv, A, d, row_pad, f, 1e-10, 48, plan, grouped)
    first = _delta(c0)
    assert plan.last == k > 0 and first["steps"] == k
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert first["graph_replays"] >= 2

    c0 = _counts()
    again = tspd.normal_pcg(Linv, dinv, A, d, row_pad, f, 1e-10, 48, plan, grouped)
    second = _delta(c0)
    assert second["graph_captures"] == 0 and second["graph_replays"] >= 2
    assert torch.equal(again[0], want[0])

    _, d2, _, Linv2, dinv2, f2, _ = _newton_system(cuda_device, kind, seed=1)
    want2 = _eager(Linv2, dinv2, A, d2, row_pad, f2, 48, per_group=grouped)
    c0 = _counts()
    got2 = tspd.normal_pcg(Linv2, dinv2, A, d2, row_pad, f2, 1e-10, 48, plan, grouped)
    assert _delta(c0)["graph_captures"] == 0
    assert torch.equal(got2[0], want2[0]) and torch.equal(got2[1], want2[1])


@pytest.mark.cuda
def test_graphed_pcg_from_two_threads_on_card(cuda_device):
    """Two threads solving systems of one key at once (the mesh's shard
    threads on one card) each get the eager answer: a key's calls hold its
    lock from the copy of the inputs to the copy of x."""
    import sys
    import threading

    systems = [_newton_system(cuda_device, "ell", seed=s) for s in (0, 1)]
    wants = [_eager(L, di, A, d, rp, f, 48) for A, d, rp, L, di, f, _ in systems]
    got, errors = {}, []

    def work(i):
        try:
            A, d, rp, L, di, f, _ = systems[i]
            plan = tspd.PcgChunks()
            got[i] = [tspd.normal_pcg(L, di, A, d, rp, f, 1e-10, 48, plan) for _ in range(6)]
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
        for x, rel in got[i]:
            assert torch.equal(x, wants[i][0]) and torch.equal(rel, wants[i][1])


@pytest.mark.cuda
def test_graph_cache_drops_the_least_recently_used_key_on_card(cuda_device, monkeypatch):
    monkeypatch.setattr(tspd, "GRAPH_KEYS", 2)
    tspd._graphs.clear()
    systems = [_newton_system(cuda_device, "ell", lanes=lanes) for lanes in (8, 16, 32)]
    for A, d, rp, L, di, f, _ in systems + systems[:1]:
        c0 = _counts()
        tspd.normal_pcg(L, di, A, d, rp, f, 1e-10, 48, tspd.PcgChunks())
        assert _delta(c0)["graph_captures"] == 2  # the first key was dropped
        assert len(tspd._graphs) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [True, False], ids=["ell", "dense"])
def test_graphed_node_window_matches_eager_on_card(cuda_device, sparse, monkeypatch):
    """A whole ``solve_node_batch`` window with the graphed PCG against the
    same window with the eager ``pcg_solve``: statuses, iterations and
    objectives equal."""
    lp, fix0, fix1, _, _ = _scp4x_window(cuda_device, sparse)
    opts = IpmOptions().replace(newton_max_steps=48)
    c0 = _counts()
    graphed = tnode.solve_node_batch(lp, fix0, fix1, opts)
    assert _delta(c0)["graph_replays"] > 0

    def eager(Linv, dinv, A, d, row_pad, f, tol, max_steps, plan, per_group=False):
        return _eager(Linv, dinv, A, d, row_pad, f, max_steps, tol, per_group)

    monkeypatch.setattr(tshared, "normal_pcg", eager)
    c0 = _counts()
    plain = tnode.solve_node_batch(lp, fix0, fix1, opts)
    assert _delta(c0)["graph_replays"] == 0
    assert torch.equal(graphed[0].status, plain[0].status)
    assert torch.equal(graphed[0].iterations, plain[0].iterations)
    for a, b in zip(graphed[2:], plain[2:]):
        assert torch.equal(a, b)
