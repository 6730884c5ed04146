"""The PCG's one loop (ops.spd.pcg_solve, normal_pcg): its test is a flag
that stays on the device, read by the host before every step or, with a
``PcgChunks`` plan that gates the steps on it, after a first batch of
steps.  On the CPU each loop
semantics (batch-wide, per lane, a subset of lanes, per group) is held to
the JAX package's ``pcg_solve`` (through ``jax.vmap`` per lane and per
group) wherever the loop stops: inside, at entry, or cut by ``max_steps``;
a plan gives the answer without one bit for bit, and the counters of real
and masked steps and of reads are exact.  An ``agree`` that overrules a
rank's flag steps the rank as the ranks decided.  The CUDA graphs of
``normal_pcg`` carry the ``cuda`` marker, skip without a card, and need no
JAX:

    python -m pytest tests/test_torch_pcg_chunks.py -q
    python -m pytest --noconftest -m cuda tests/test_torch_pcg_chunks.py -q   # on a card
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
K, CAP = 5, 7  # the loop's steps when it stops inside, and the cut's max_steps
SUBSET = torch.tensor([True, False, True, True, False, True])  # the lanes to solve


def _counts():
    return {k: getattr(tspd.pcg_solve, k) for k in COUNTERS}


def _delta(c0):
    return {k: getattr(tspd.pcg_solve, k) - c0[k] for k in COUNTERS}


def _system(per_group):
    """A Jacobi-preconditioned SPD system as numpy (M, diag, f): 6 lanes of
    48 rows, or 3 groups of 2."""
    rng = np.random.default_rng(7)
    B, m = 6, 48  # PCG's residual falls at every one of its first 20 steps
    G = rng.standard_normal((B, m, 2 * m))
    scale = 10.0 ** rng.uniform(-2, 2, (B, m))
    M = scale[:, :, None] * (G @ G.transpose(0, 2, 1) + m * np.eye(m)) * scale[:, None, :]
    f = rng.standard_normal((B, m))
    diag = np.diagonal(M, axis1=1, axis2=2).copy()
    if per_group:
        M, f, diag = M.reshape(3, 2, m, m), f.reshape(3, 2, m), diag.reshape(3, 2, m)
    return M, diag, f


def _ops(M, diag):
    tM, tdiag = torch.from_numpy(M), torch.from_numpy(diag)
    return (lambda r: r / tdiag), (lambda v: torch.einsum("...ij,...j->...i", tM, v))


def _stops(kind):
    """Each lane's (per group, each group's) steps when the loop stops
    inside: K for the first, one fewer for each next, none for the last
    lanes."""
    n = 3 if kind == "group" else 6
    return [max(K - i, 0) for i in range(n)]


def _tol_inside(kind, precond, matvec, f):
    """The tolerance at which the loop stops inside after K steps, each lane
    (group) after its own ``_stops`` where it stops on its own: the residual
    norms of k steps of every lane at tol 0, each threshold just above the
    largest norm of the lane (group, batch) at its stop, and a check that it
    is below every norm before."""
    per_group = kind == "group"
    rels = torch.stack([tspd.pcg_solve(precond, matvec, f, 0.0, k, per_group=per_group)[1]
                        for k in range(K + 1)])  # [K + 1, lanes...]
    if kind == "batch":
        worst = rels.reshape(K + 1, -1).amax(dim=1)
        assert bool((worst[:K] > worst[K] * (1 + 1e-6)).all())
        return float(worst[K]) * (1 + 1e-9)
    worst = rels.amax(dim=-1) if per_group else rels  # [K + 1, groups or lanes]
    tol = torch.empty(worst.shape[1], dtype=f.dtype)
    for i, k in enumerate(_stops(kind)):
        assert bool((worst[:k, i] > worst[k, i] * (1 + 1e-6)).all())
        tol[i] = worst[k, i] * (1 + 1e-9)
    if per_group:
        return tol[:, None, None].expand(f.shape[:-1] + (1,)).contiguous()
    return tol[:, None]


def _jax_pcg(kind, M, diag, f, tol, max_steps):
    """The JAX package's loop on the same system: batched, or through
    ``jax.vmap`` over lanes (lanes outside the subset at an infinite
    tolerance, so that they never step) or over groups."""
    import jax
    import jax.numpy as jnp

    from sypha_tpu.ops import spd as jspd

    def one(Mi, di, fi, ti):
        matvec = lambda v: jnp.einsum("...ij,...j->...i", Mi, v)  # noqa: E731
        return jspd.pcg_solve(lambda r: r / di, matvec, fi, ti, max_steps)

    tol = np.asarray(tol, dtype=np.float64)
    if kind == "batch":
        out = one(jnp.asarray(M), jnp.asarray(diag), jnp.asarray(f), float(tol))
    else:
        if kind != "group":
            tol = np.broadcast_to(tol, f.shape[:-1] + (1,))[..., 0].copy()
            if kind == "subset":
                tol[~SUBSET.numpy()] = np.inf
        else:
            tol = np.broadcast_to(tol, f.shape[:-1] + (1,)).copy()
        out = jax.vmap(one)(jnp.asarray(M), jnp.asarray(diag), jnp.asarray(f), jnp.asarray(tol))
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("kind", ["batch", "lane", "subset", "group"])
@pytest.mark.parametrize("stop", ["inside", "at_entry", "max_steps"])
@pytest.mark.parametrize("plan", ["every_step", "first_batch"])
def test_pcg_loop_matches_jax(kind, stop, plan):
    M, diag, f_np = _system(kind == "group")
    precond, matvec = _ops(M, diag)
    f = torch.from_numpy(f_np)
    per_lane = {"lane": True, "subset": SUBSET}.get(kind, False)
    kw = dict(per_lane=per_lane, per_group=kind == "group")
    max_steps, steps = 40, K
    if stop == "inside":
        tol = _tol_inside(kind, precond, matvec, f)
    elif stop == "at_entry":
        tol, steps = 1e3, 0
    else:
        tol, max_steps = 0.0, CAP
        steps = CAP

    c0 = _counts()
    x, rel = tspd.pcg_solve(precond, matvec, f, tol, max_steps, **kw)
    # one read before every step below max_steps, as the JAX loop tests
    reads = steps if stop == "max_steps" else steps + 1
    assert _delta(c0) == dict(steps=steps, syncs=reads, masked_steps=0,
                              graph_captures=0, graph_replays=0)
    if plan == "first_batch":
        # a first batch that runs past the stop, as on a card after a
        # longer call, then a read a step: the same answer bit for bit
        chunks = tspd.PcgChunks()
        chunks.last = steps + 3
        chunks.first = lambda device: chunks.last
        first = min(steps + 3, max_steps)
        c0 = _counts()
        px, prel = tspd.pcg_solve(precond, matvec, f, tol, max_steps, plan=chunks, **kw)
        assert torch.equal(px, x) and torch.equal(prel, rel)
        assert _delta(c0) == dict(steps=steps, syncs=1, masked_steps=first - steps,
                                  graph_captures=0, graph_replays=0)
        assert chunks.last == steps

    jx, jrel = _jax_pcg(kind, M, diag, f_np, tol, max_steps)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-12 * np.abs(jx).max())
    np.testing.assert_allclose(rel.numpy(), jrel, rtol=1e-6, atol=1e-15)
    if kind == "subset":  # a lane outside the subset never steps
        assert torch.equal(x[~SUBSET], precond(f)[~SUBSET])


def test_agree_that_overrules_the_flag_steps_as_the_ranks_decided():
    """Tensor parallelism: where ``agree`` decides to step while the rank's
    own flag is down (here at every test), the rank steps, exactly as at
    tol 0, deciding before each of the steps and stopping at ``max_steps``
    without asking."""
    M, diag, f_np = _system(False)
    precond, matvec = _ops(M, diag)
    f = torch.from_numpy(f_np)
    want = tspd.pcg_solve(precond, matvec, f, 0.0, CAP)
    asked = []

    def agree(flag):
        asked.append(flag)
        return True

    c0 = _counts()
    x, rel = tspd.pcg_solve(precond, matvec, f, 1e3, CAP, agree)
    assert torch.equal(x, want[0]) and torch.equal(rel, want[1])
    assert [bool(flag) for flag in asked] == [False] * CAP
    assert _delta(c0) == dict(steps=CAP, syncs=CAP, masked_steps=0, graph_captures=0, graph_replays=0)


def test_normal_pcg_is_the_shared_ipms_eager_pcg_on_the_cpu():
    """``normal_pcg`` with the shared IPM's plan on both operators: bit for
    bit ``pcg_solve`` without a plan on the same preconditioner and matvec,
    and the JAX package's loop on the same factor and the dense A."""
    import jax.numpy as jnp

    from sypha_tpu.ipm import shared as jshared
    from sypha_tpu.ops import spd as jspd

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

        A = jnp.asarray((batch.A.todense(torch.float64) if batch.is_sparse else batch.A).numpy())
        jd, jrp = jnp.asarray(d.numpy()), jnp.asarray(row_pad.numpy())
        jx, jrel = jspd.pcg_solve(
            lambda r: jshared._precond(jnp.asarray(Linv.numpy()), jnp.asarray(dinv.numpy()), r),
            lambda v: jnp.einsum("ij,bj->bi", A, jd * jnp.einsum("ij,bi->bj", A, v)) + jrp * v,
            jnp.asarray(f.numpy()), 1e-10, 48,
        )
        jx = np.asarray(jx)
        assert np.abs(got[0].numpy() - jx).max() <= 1e-9 * np.abs(jx).max()
        assert np.all(got[1].numpy() <= 1e-10) and np.all(np.asarray(jrel) <= 1e-10)


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
    tspd._pcg_graphs.clear()
    systems = [_newton_system(cuda_device, "ell", lanes=lanes) for lanes in (8, 16, 32)]
    for A, d, rp, L, di, f, _ in systems + systems[:1]:
        c0 = _counts()
        tspd.normal_pcg(L, di, A, d, rp, f, 1e-10, 48, tspd.PcgChunks())
        assert _delta(c0)["graph_captures"] == 2  # the first key was dropped
        assert len(tspd._pcg_graphs) <= 2


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

    def eager(Linv, dinv, A, d, row_pad, f, tol, max_steps, plan, per_group, psum, agree):
        return _eager(Linv, dinv, A, d, row_pad, f, max_steps, tol, per_group)

    monkeypatch.setattr(tshared, "normal_pcg", eager)
    c0 = _counts()
    plain = tnode.solve_node_batch(lp, fix0, fix1, opts)
    assert _delta(c0)["graph_replays"] == 0
    assert torch.equal(graphed[0].status, plain[0].status)
    assert torch.equal(graphed[0].iterations, plain[0].iterations)
    for a, b in zip(graphed[2:], plain[2:]):
        assert torch.equal(a, b)
