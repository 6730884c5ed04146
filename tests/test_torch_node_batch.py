"""B&B node windows: solve_node_batch of the PyTorch port against the JAX
package with seeded fixings, one lane made infeasible by its fixings, warm
starts and chunked resume.  Statuses equal; objectives within 1e-8 relative."""

import numpy as np
import pytest

import sypha_tpu.config as jconfig
import sypha_tpu.io.scp_reader as jreader
import sypha_tpu.io.standard_form as jsf
from sypha_tpu.ipm.node_batch import solve_node_batch as jsolve
import sypha_tpu_torch.config as tconfig
import sypha_tpu_torch.io.scp_reader as treader
import sypha_tpu_torch.io.standard_form as tsf
from sypha_tpu_torch.core.status import IpmStatus
from sypha_tpu_torch.ipm.node_batch import solve_node_batch as tsolve
from sypha_tpu_torch.testing import synthetic_scp

TEXT = synthetic_scp(24, 120, 0.1, 3)


def _fixings(model, n_pad, B=4, seed=0):
    """Lane 0 free, lanes 1..B-2 seeded fixings, the last lane infeasible:
    every column covering row 0 fixed to 0."""
    rng = np.random.default_rng(seed)
    fix0 = np.zeros((B, n_pad))
    fix1 = np.zeros((B, n_pad))
    for lane in range(1, B - 1):
        cols = rng.permutation(model.ncols)
        fix0[lane, cols[: rng.integers(1, 6)]] = 1.0
        fix1[lane, cols[5 : 5 + rng.integers(1, 6)]] = 1.0
    fix0[B - 1, model.rows[0]] = 1.0
    return fix0, fix1


def _setup():
    tm = treader.parse_scp_text(TEXT)
    tlp = tsf.pad_lp(tm)
    jlp = jsf.pad_lp(jreader.parse_scp_text(TEXT))
    fix0, fix1 = _fixings(tm, tlp.n_pad)
    return tm, tlp, jlp, fix0, fix1


def _assert_window_parity(jout, tout):
    jst, jx, jp, jd = jout
    jx, jp, jd = np.asarray(jx), np.asarray(jp), np.asarray(jd)
    tst, tx, tp, td = tout
    np.testing.assert_array_equal(tst.status.numpy(), np.asarray(jst.status))
    # a lane that ends GAP_STALLED or infeasible stops where a gate trips,
    # which rounding can move: iterations and iterates compare on converged lanes
    conv = tst.status.numpy() == IpmStatus.CONVERGED
    assert np.abs(tst.iterations.numpy() - np.asarray(jst.iterations))[conv].max() <= 1
    np.testing.assert_allclose(tp.numpy()[conv], jp[conv], rtol=1e-8)
    np.testing.assert_allclose(td.numpy()[conv], jd[conv], rtol=1e-8)
    np.testing.assert_allclose(tx.numpy()[conv], jx[conv], rtol=0, atol=1e-6)


def test_node_window_matches_jax_and_highs():
    from scipy.optimize import linprog

    tm, tlp, jlp, fix0, fix1 = _setup()
    tout = tsolve(tlp, fix0, fix1, tconfig.IpmOptions())
    jout = jsolve(jlp, fix0, fix1, jconfig.IpmOptions())
    _assert_window_parity(jout, tout)

    status = tout[0].status.numpy()
    assert np.all(status[:-1] == IpmStatus.CONVERGED)
    assert status[-1] != IpmStatus.CONVERGED, "the infeasible lane must not converge"
    A = tm.dense_matrix()
    for lane in range(3):
        bounds = [
            (1, 1) if fix1[lane, j] else (0, 0) if fix0[lane, j] else (0, None)
            for j in range(tm.ncols)
        ]
        res = linprog(tm.costs, A_ub=-A, b_ub=-np.ones(tm.nrows), bounds=bounds, method="highs")
        assert res.status == 0
        np.testing.assert_allclose(tout[2].numpy()[lane], res.fun, rtol=1e-6)
    x_full = tout[1].numpy()
    assert np.all(x_full[fix1 > 0] == pytest.approx(1.0))
    assert np.all(x_full[:-1][fix0[:-1] > 0] == 0.0)


def test_node_window_warm_start_matches_jax():
    _, tlp, jlp, fix0, fix1 = _setup()
    # the B&B runs node windows with the gap-stall monitor on
    opts_t = tconfig.IpmOptions(gap_stall_window=5)
    opts_j = jconfig.IpmOptions(gap_stall_window=5)
    parent_t = tsolve(tlp, fix0 * 0, fix1 * 0, opts_t)[0]
    parent_j = jsolve(jlp, fix0 * 0, fix1 * 0, opts_j)[0]
    tout = tsolve(tlp, fix0, fix1, opts_t, warm=(parent_t.x, parent_t.y, parent_t.s))
    jout = jsolve(jlp, fix0, fix1, opts_j, warm=(parent_j.x, parent_j.y, parent_j.s))
    _assert_window_parity(jout, tout)


def test_node_window_chunked_resume_matches_jax():
    _, tlp, jlp, fix0, fix1 = _setup()
    opts_t = tconfig.IpmOptions(gap_stall_window=5)
    opts_j = jconfig.IpmOptions(gap_stall_window=5)
    one_shot = tsolve(tlp, fix0, fix1, opts_t)
    st = tsolve(tlp, fix0, fix1, opts_t, iter_limit=3)[0]
    assert np.all(st.status.numpy() == IpmStatus.MAX_ITER)
    limit = 3
    while np.any(st.status.numpy() == IpmStatus.MAX_ITER):
        limit += 4
        assert limit <= opts_t.max_iter
        out = tsolve(tlp, fix0, fix1, opts_t, resume=st, iter_limit=limit)
        st = out[0]
    np.testing.assert_array_equal(st.status.numpy(), one_shot[0].status.numpy())
    conv = st.status.numpy() == IpmStatus.CONVERGED
    np.testing.assert_array_equal(st.iterations.numpy()[conv], one_shot[0].iterations.numpy()[conv])
    np.testing.assert_allclose(out[2].numpy()[conv], one_shot[2].numpy()[conv], rtol=1e-12)

    # the same chunks in the JAX package; a chunk boundary counts one more
    # stalled iteration there too (the step that hits the limit updates
    # stall_count), so the stalled lane ends one iteration earlier in both
    jst = jsolve(jlp, fix0, fix1, opts_j, iter_limit=3)[0]
    for lim in range(7, limit + 1, 4):
        jout = jsolve(jlp, fix0, fix1, opts_j, resume=jst, iter_limit=lim)
        jst = jout[0]
    np.testing.assert_array_equal(st.iterations.numpy(), np.asarray(jst.iterations))
    _assert_window_parity(jout, out)
