"""The grouped shared-matrix solve (bench.py's layout): G instance groups,
each with its own A, stacked by ``stack_shared_batches`` and solved by one
``mehrotra_solve_shared`` call, against ``jax.jit(jax.vmap(...))`` of the
JAX package's solve over the same stacked groups, and against the port's
own groups solved alone.  Also the grouped pieces underneath:
``fix_columns``, ``pcg_solve``'s group mode, the grouped ``gram_reference``,
and ``python -m sypha_tpu_torch.bench`` at a small size.

The groups are three scp-style instances (synthetic_scp(40, 200, 0.1, seed),
seeds 1, 4 and 6) in one 40 x 256 bucket, 4 lanes each; alone they take 10,
11 and 12 iterations, so the early groups sit frozen while the last steps.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sypha_tpu.config as jconfig
import sypha_tpu.io.scp_reader as jreader
import sypha_tpu.io.standard_form as jsf
from sypha_tpu.ipm import shared as jshared
from sypha_tpu.ops import spd as jspd
import sypha_tpu_torch as st
import sypha_tpu_torch.config as tconfig
from sypha_tpu_torch.core.status import IpmStatus
from sypha_tpu_torch.ipm import shared as tshared
from sypha_tpu_torch.ops import gram as tgram
from sypha_tpu_torch.ops import spd as tspd
from sypha_tpu_torch.testing import synthetic_scp

SEEDS = (1, 4, 6)
LANES = 4
M_PAD, N_PAD = 40, 256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.cache
def _texts():
    return tuple(synthetic_scp(40, 200, 0.1, s) for s in SEEDS)


def _torch_batches(lanes=LANES):
    return [
        tshared.make_shared_batch(
            st.pad_lp(st.parse_scp_text(t), m_pad=M_PAD, n_pad=N_PAD, device="cpu"), lanes
        )
        for t in _texts()
    ]


def _grouped():
    jbs = [
        jshared.make_shared_batch(jsf.pad_lp(jreader.parse_scp_text(t), m_pad=M_PAD, n_pad=N_PAD), LANES)
        for t in _texts()
    ]
    jg = jax.tree.map(lambda *xs: jnp.stack(xs), *jbs)
    return jg, tshared.stack_shared_batches(_torch_batches())


def _objectives(c, b, x, y):
    return (
        np.einsum("gln,gln->gl", np.asarray(c), np.asarray(x)),
        np.einsum("glm,glm->gl", np.asarray(b), np.asarray(y)),
    )


def _assert_grouped_parity(jg, js, tg, ts):
    """test_torch_ipm_shared.py's tolerances: statuses equal and iterations
    within 1 on every lane; objectives within 1e-8 relative and x within
    1e-6 on lanes that CONVERGED, whose stall monitor must agree too (a
    group that stopped keeps it while the others step).  A lane that ends
    GAP_STALLED stops at an iterate that rounding decides: JAX's own
    vmapped and single-group solves of seed 6 under factor_refresh_every=2
    part by 1.5e-5 in x."""
    status = ts.status.numpy()
    np.testing.assert_array_equal(status, np.asarray(js.status))
    assert np.abs(ts.iterations.numpy() - np.asarray(js.iterations)).max() <= 1
    conv = status == IpmStatus.CONVERGED
    jp, jd = _objectives(jg.c, jg.b, js.x, js.y)
    tp, td = _objectives(tg.c, tg.b, ts.x, ts.y)
    np.testing.assert_allclose(tp[conv], jp[conv], rtol=1e-8)
    np.testing.assert_allclose(td[conv], jd[conv], rtol=1e-8)
    np.testing.assert_allclose(ts.x.numpy()[conv], np.asarray(js.x)[conv], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ts.stall_count.numpy()[conv], np.asarray(js.stall_count)[conv])
    # the best gap seen, to a tenth of the 1e-8 gap tolerance
    np.testing.assert_allclose(ts.best_gap.numpy()[conv], np.asarray(js.best_gap)[conv], rtol=0, atol=1e-9)


def test_stack_shared_batches_matches_jax():
    jg, tg = _grouped()
    assert tg.is_grouped and not tg.is_sparse
    assert (tg.m_pad, tg.n_pad, tg.n_lanes) == (jg.m_pad, jg.n_pad, jg.n_lanes) == (M_PAD, N_PAD, LANES)
    for f in ("A", "b", "c", "col_mask", "row_pad", "obj_offset"):
        t, j = getattr(tg, f), np.asarray(getattr(jg, f))
        assert t.dtype == torch.float64, f
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f)
    assert tuple(tg.A.shape) == (3, M_PAD, N_PAD) and tuple(tg.row_pad.shape) == (3, M_PAD)
    batches = _torch_batches()
    with pytest.raises(ValueError):  # another lane count
        tshared.stack_shared_batches(batches[:2] + _torch_batches(lanes=2)[:1])
    with pytest.raises(ValueError):  # another bucket
        other = st.pad_lp(st.parse_scp_text(_texts()[0]), m_pad=48, n_pad=N_PAD, device="cpu")
        tshared.stack_shared_batches(batches[:1] + [tshared.make_shared_batch(other, LANES)])
    with pytest.raises(ValueError):  # the padded-ELL operator
        tshared.stack_shared_batches([st.make_shared_batch_sparse(st.parse_scp_text(_texts()[0]), 2, device="cpu")])
    with pytest.raises(ValueError):  # already grouped
        tshared.stack_shared_batches([tg, tg])
    with pytest.raises(ValueError):
        tshared.stack_shared_batches([])
    # instance groups do not combine with tensor parallelism's process group
    with pytest.raises(ValueError, match="grouped"):
        tshared.mehrotra_solve_shared(tg, tconfig.IpmOptions(), group=object())


GROUPED_OPTIONS = [
    {},
    {"max_correctors": 1},
    {"factor_refresh_every": 2},
    {"gap_stall_window": 5, "adaptive_eta": False},
    # every lane ends GAP_STALLED in both packages (the default schedule is
    # rounding-chaotic, ROADMAP queue 3), so statuses and iterations carry it
    {"linear_solver": "cg"},
    # the parity tests' tight schedule: every lane converges
    {"linear_solver": "cg", "cg_tol_initial": 1e-8, "cg_tol_final": 1e-11},
]


@pytest.mark.parametrize("opts", GROUPED_OPTIONS, ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()) or "default")
def test_grouped_solve_matches_jax_vmap(opts):
    jg, tg = _grouped()
    jo = jconfig.IpmOptions(**opts)
    js = jax.jit(jax.vmap(lambda g: jshared.mehrotra_solve_shared(g, jo)))(jg)
    ts = tshared.mehrotra_solve_shared(tg, tconfig.IpmOptions(**opts))
    assert tuple(ts.x.shape) == (3, LANES, N_PAD) and tuple(ts.status.shape) == (3, LANES)
    _assert_grouped_parity(jg, js, tg, ts)
    if not opts:
        assert np.all(ts.status.numpy() == IpmStatus.CONVERGED)
        assert ts.iterations[:, 0].tolist() == [10, 11, 12]


def _fixings(rng, shape, n_real):
    fix0 = np.zeros(shape)
    fix1 = np.zeros(shape)
    for idx in np.ndindex(shape[:-1]):
        cols = rng.permutation(n_real)
        k0, k1 = rng.integers(0, 3, size=2)
        fix0[idx + (cols[:k0],)] = 1.0
        fix1[idx + (cols[k0 : k0 + k1],)] = 1.0
    return fix0, fix1


@pytest.mark.parametrize(
    "opts",
    [{}, {"gap_stall_window": 5, "adaptive_eta": False}, {"factor_refresh_every": 2}],
    ids=["default", "stall_window", "refresh2"],
)
def test_grouped_solve_matches_groups_alone(opts):
    """Each group of the grouped solve is the group solved alone by the
    ungrouped engine: statuses, iterations, the stall monitor, and x within
    1e-10 (the broadcast products round like one call per group here).
    Node-style fixings make the lanes of a group differ."""
    batches = _torch_batches()
    fix0, fix1 = _fixings(np.random.default_rng(4), (3, LANES, N_PAD), 200)
    fixed = [tshared.fix_columns(b, fix0[g], fix1[g]) for g, b in enumerate(batches)]
    to = tconfig.IpmOptions(**opts)
    ts = tshared.mehrotra_solve_shared(tshared.stack_shared_batches(fixed), to)
    alone = [tshared.mehrotra_solve_shared(b, to) for b in fixed]
    for f in ("status", "iterations", "stall_count"):
        np.testing.assert_array_equal(
            getattr(ts, f).numpy(), np.stack([getattr(a, f).numpy() for a in alone]), err_msg=f
        )
    for f in ("x", "y", "s", "best_gap", "gap", "mu"):
        want = torch.stack([getattr(a, f) for a in alone])
        torch.testing.assert_close(getattr(ts, f), want, rtol=0, atol=1e-10, equal_nan=True, msg=f)
    # the groups stop at different iterations (a factor refresh's steps
    # apart), so freezing is exercised
    last = ts.iterations.max(dim=-1).values
    assert int(last.max() - last.min()) >= to.factor_refresh_every


def test_grouped_resume_matches_jax_and_one_shot():
    """iter_limit=3, then state0 with the full limit: against JAX's vmapped
    resume, and the port's one-shot grouped solve."""
    jg, tg = _grouped()
    opts = {"gap_stall_window": 5, "adaptive_eta": False}
    jo, to = jconfig.IpmOptions(**opts), tconfig.IpmOptions(**opts)
    one_shot = tshared.mehrotra_solve_shared(tg, to)
    first = tshared.mehrotra_solve_shared(tg, to, iter_limit=3)
    assert np.all(first.status.numpy() == IpmStatus.MAX_ITER)
    assert np.all(first.iterations.numpy() == 3)
    resumed = tshared.mehrotra_solve_shared(tg, to, state0=first, iter_limit=to.max_iter)
    np.testing.assert_array_equal(resumed.status.numpy(), one_shot.status.numpy())
    np.testing.assert_array_equal(resumed.iterations.numpy(), one_shot.iterations.numpy())
    torch.testing.assert_close(resumed.x, one_shot.x, rtol=0, atol=1e-12)

    jfirst = jax.jit(jax.vmap(lambda g: jshared.mehrotra_solve_shared(g, jo, iter_limit=3)))(jg)
    jres = jax.jit(
        jax.vmap(lambda g, s: jshared.mehrotra_solve_shared(g, jo, state0=s, iter_limit=jo.max_iter))
    )(jg, jfirst)
    _assert_grouped_parity(jg, jres, tg, resumed)


def test_fix_columns_grouped_matches_jax():
    jg, tg = _grouped()
    fix0, fix1 = _fixings(np.random.default_rng(2), (3, LANES, N_PAD), 200)
    jf = jax.vmap(jshared.fix_columns)(jg, jnp.asarray(fix0), jnp.asarray(fix1))
    tf = tshared.fix_columns(tg, fix0, fix1)
    assert tf.is_grouped and tf.A is tg.A
    for f in ("b", "c", "col_mask", "obj_offset"):
        np.testing.assert_allclose(getattr(tf, f).numpy(), np.asarray(getattr(jf, f)), rtol=1e-15, atol=0, err_msg=f)


def test_pcg_solve_per_group_matches_vmap():
    """Group mode against jax.vmap over groups of the JAX loop: a group
    steps while any of its lanes is above its threshold, every lane of it
    stepping; groups stop at their own step."""
    rng = np.random.default_rng(11)
    G, L, m = 3, 4, 40
    Gm = rng.standard_normal((G, L, m, 3 * m))
    scale = 30.0 ** rng.uniform(-1, 1, (G, L, m))
    M = scale[..., :, None] * (Gm @ np.swapaxes(Gm, -1, -2) + m * np.eye(m)) * scale[..., None, :]
    f = rng.standard_normal((G, L, m))
    diag = np.diagonal(M, axis1=-2, axis2=-1).copy()
    tol = np.array([1e-4, 1e-8, 1e-12])[:, None, None] * np.ones((G, L, 1))

    def one(Mg, dg, fg, tg):
        return jspd.pcg_solve(lambda r: r / dg, lambda v: jnp.einsum("lij,lj->li", Mg, v), fg, tg, 60)

    jx, jrel = jax.vmap(one)(jnp.asarray(M), jnp.asarray(diag), jnp.asarray(f), jnp.asarray(tol))
    tM, tdiag = torch.from_numpy(M), torch.from_numpy(diag)
    steps = tspd.pcg_solve.steps
    tx, trel = tspd.pcg_solve(
        lambda r: r / tdiag, lambda v: torch.einsum("glij,glj->gli", tM, v),
        torch.from_numpy(f), torch.from_numpy(tol), 60, per_group=True,
    )
    assert tspd.pcg_solve.steps > steps
    jx, jrel = np.asarray(jx), np.asarray(jrel)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-12 * np.abs(jx).max())
    np.testing.assert_allclose(trel.numpy(), jrel, rtol=1e-6, atol=1e-15)
    # the first group stopped at its own tolerance, the last ran to its own
    assert trel[0].max() <= 1e-4 and trel[0].max() > 1e-8 and trel[2].max() <= 1e-12
    with pytest.raises(ValueError):
        tspd.pcg_solve(lambda r: r, lambda v: v, torch.from_numpy(f), 1e-8, 5, per_lane=True, per_group=True)


@pytest.mark.parametrize("G,L,m,n", [(3, 5, 37, 301), (2, 4, 40, 256)])
def test_gram_reference_grouped_matches_shared_form(G, L, m, n):
    rng = np.random.default_rng(G + m + n)
    A32 = torch.from_numpy(rng.integers(-1, 2, size=(G, m, n)).astype(np.float32))
    w = torch.from_numpy((10.0 ** rng.uniform(-6, 3, size=(G, L, n))).astype(np.float32))
    got = tgram.gram_reference(A32, w)
    assert got.dtype == torch.float32 and tuple(got.shape) == (G, L, m, m)
    for g in range(G):
        shared = tgram.gram_reference(A32[g], w[g])
        torch.testing.assert_close(got[g], shared, rtol=0, atol=1e-6 * float(shared.abs().max()))
    # the wrapper takes the grouped form on the CPU without a launch
    before = (tgram.gram.launches, tgram.gram.launches_grouped)
    assert torch.equal(tgram.gram(A32, w), got)
    assert (tgram.gram.launches, tgram.gram.launches_grouped) == before
    with pytest.raises(ValueError):  # one A per group, not per lane
        tgram.gram(A32, w[:, :, :-1].contiguous())
    with pytest.raises(ValueError):
        tgram.gram(A32[:-1].contiguous(), w)


def test_bench_prints_one_json_line():
    out = subprocess.run(
        [sys.executable, "-m", "sypha_tpu_torch.bench", "--device", "cpu", "--groups", "2", "--lanes", "3",
         "--rows", "40", "--cols", "200", "--density", "0.1"],
        capture_output=True, text=True, cwd=REPO, timeout=300, check=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    res = json.loads(lines[0])
    for key in (
        "metric", "value", "unit", "vs_baseline", "single_lp_latency_s", "single_lp_latency_min_s",
        "single_lp_vs_ref_1p70s", "achieved_tflops", "ipm_iters_total", "flop_model", "methodology",
        "device",
    ):
        assert key in res, key
    for key in ("f32_equiv_tflops", "mfu_vs_197tflops_nominal", "frac_of_measured_tunnel_ceiling"):
        assert key not in res, key
    assert res["value"] > 0 and res["single_lp_latency_min_s"] <= res["single_lp_latency_s"]
    assert res["lanes"] == res["lanes_converged"] == 6
    hist = {int(k): v for k, v in res["iterations_histogram"].items()}
    assert sum(hist.values()) == 6 and sum(k * v for k, v in hist.items()) == res["ipm_iters_total"]
    assert res["device"].startswith("cpu") and "synthetic_scp(40, 200, 0.1" in res["methodology"]
    assert out.stderr.count("WARNING") == 0
