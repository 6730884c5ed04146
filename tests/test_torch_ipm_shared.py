"""The slice: SCP text -> reader -> pad_lp -> make_shared_batch ->
mehrotra_solve_shared, in the PyTorch port and in the JAX package on the
same inputs.  Statuses equal, iteration counts within 1, objectives within
1e-8 relative, x within 1e-6 absolute; one case also against HiGHS."""

import pathlib

import numpy as np
import pytest
import torch

import sypha_tpu.config as jconfig
import sypha_tpu.io.scp_reader as jreader
import sypha_tpu.io.standard_form as jsf
from sypha_tpu.ipm import shared as jshared
import sypha_tpu_torch.config as tconfig
import sypha_tpu_torch.io.scp_reader as treader
import sypha_tpu_torch.io.standard_form as tsf
from sypha_tpu_torch.core.status import IpmStatus
from sypha_tpu_torch.ipm import shared as tshared
from sypha_tpu_torch.ops import gram as tgram
from sypha_tpu_torch.testing import synthetic_scp

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
TINY = "3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n"
TEXTS = {
    "tiny": lambda: TINY,
    "demo_small": lambda: (DATA / "demo_small.txt").read_text(),
    "syn24x120": lambda: synthetic_scp(24, 120, 0.1, 3),
    "syn40x200": lambda: synthetic_scp(40, 200, 0.1, 4),
}


def _batches(name, B=4):
    text = TEXTS[name]()
    jb = jshared.make_shared_batch(jsf.pad_lp(jreader.parse_scp_text(text)), B)
    tb = tshared.make_shared_batch(tsf.pad_lp(treader.parse_scp_text(text), device="cpu"), B)
    return jb, tb


def _objectives(batch_c, batch_b, x, y):
    x, y = np.asarray(x), np.asarray(y)
    return np.einsum("bn,bn->b", np.asarray(batch_c), x), np.einsum(
        "bm,bm->b", np.asarray(batch_b), y
    )


def _assert_slice_parity(jb, js, tb, ts):
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    assert np.abs(ts.iterations.numpy() - np.asarray(js.iterations)).max() <= 1
    jp, jd = _objectives(jb.c, jb.b, js.x, js.y)
    tp, td = _objectives(tb.c, tb.b, ts.x, ts.y)
    np.testing.assert_allclose(tp, jp, rtol=1e-8)
    np.testing.assert_allclose(td, jd, rtol=1e-8)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=1e-6)


def test_make_shared_batch_matches_jax():
    jb, tb = _batches("syn24x120", 3)
    for f in ("A", "b", "c", "col_mask", "row_pad", "obj_offset"):
        t, j = getattr(tb, f), np.asarray(getattr(jb, f))
        assert t.dtype == torch.float64, f
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f)
    assert (tb.m_pad, tb.n_pad, tb.n_lanes) == (jb.m_pad, jb.n_pad, jb.n_lanes)


def test_fix_columns_matches_jax():
    jb, tb = _batches("syn24x120", 3)
    rng = np.random.default_rng(2)
    fix0 = (rng.random((3, tb.n_pad)) < 0.05).astype(np.float64)
    fix1 = (rng.random((3, tb.n_pad)) < 0.05).astype(np.float64) * (1 - fix0)
    jf = jshared.fix_columns(jb, fix0, fix1)
    tf = tshared.fix_columns(tb, fix0, fix1)
    for f in ("b", "c", "col_mask", "obj_offset"):
        np.testing.assert_allclose(getattr(tf, f).numpy(), np.asarray(getattr(jf, f)), rtol=1e-15, atol=0)


def test_sparse_batch_matches_jax():
    """``make_shared_batch_sparse`` builds the JAX package's padded-ELL
    batch, field for field, and ``make_shared_batch_auto`` picks the
    operator by density as JAX does (TINY's standard form is 7/21 = 33%
    dense: dense by default, ELL under a 0.5 threshold)."""
    model = treader.parse_scp_text(TINY)
    jmodel = jreader.parse_scp_text(TINY)
    tb = tshared.make_shared_batch_sparse(model, 2, device="cpu")
    jb = jshared.make_shared_batch_sparse(jmodel, 2)
    assert tb.is_sparse and jb.is_sparse
    np.testing.assert_array_equal(tb.A.todense().numpy(), np.asarray(jb.A.todense()))
    for f in ("b", "c", "col_mask", "row_pad", "obj_offset"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), err_msg=f)
    assert not tshared.make_shared_batch_auto(model, 2, device="cpu").is_sparse
    assert tshared.make_shared_batch_auto(model, 2, density_threshold=0.5, device="cpu").is_sparse


def test_initial_point_matches_jax():
    jb, tb = _batches("syn40x200")
    jo, to = jconfig.IpmOptions(), tconfig.IpmOptions()
    jx, jy, js = jshared.shared_initial_point(jb, jo, jb.A.astype(np.float32), False)
    before = tgram.gram.launches
    tx, ty, ts = tshared.shared_initial_point(tb, to, tb.A.float(), False)
    assert tgram.gram.launches == before  # CPU tensors take the plain version
    for t, j in ((tx, jx), (ty, jy), (ts, js)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-9 * np.abs(j).max())


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_slice_matches_jax(name):
    jb, tb = _batches(name)
    js = jshared.mehrotra_solve_shared(jb, jconfig.IpmOptions())
    ts = tshared.mehrotra_solve_shared(tb, tconfig.IpmOptions())
    assert np.all(ts.status.numpy() == IpmStatus.CONVERGED)
    for f in ("x", "y", "s", "mu", "gap", "res_p", "res_d", "best_gap"):
        assert getattr(ts, f).dtype == torch.float64, f
    for f in ("iterations", "status", "stall_count"):
        assert getattr(ts, f).dtype == torch.int32, f
    _assert_slice_parity(jb, js, tb, ts)


@pytest.mark.parametrize(
    "name,opts",
    [
        ("syn40x200", {"max_correctors": 1}),
        ("syn24x120", {"linear_solver": "cg"}),
        ("syn40x200", {"factor_refresh_every": 2}),
        ("syn40x200", {"gap_stall_window": 5, "adaptive_eta": False}),
    ],
)
def test_slice_options_match_jax(name, opts):
    jb, tb = _batches(name)
    js = jshared.mehrotra_solve_shared(jb, jconfig.IpmOptions(**opts))
    ts = tshared.mehrotra_solve_shared(tb, tconfig.IpmOptions(**opts))
    _assert_slice_parity(jb, js, tb, ts)


def test_slice_matches_highs():
    from scipy.optimize import linprog

    text = TEXTS["syn40x200"]()
    model = treader.parse_scp_text(text)
    tb = tshared.make_shared_batch(tsf.pad_lp(model, device="cpu"), 3)
    ts = tshared.mehrotra_solve_shared(tb, tconfig.IpmOptions())
    assert np.all(ts.status.numpy() == IpmStatus.CONVERGED)
    res = linprog(
        model.costs, A_ub=-model.dense_matrix(), b_ub=-np.ones(model.nrows),
        bounds=[(0, None)] * model.ncols, method="highs",
    )
    obj = torch.sum(tb.c * ts.x, dim=-1).numpy()
    # pad columns cost 1 each but converge to ~0; tolerance absorbs them
    np.testing.assert_allclose(obj, res.fun, rtol=1e-6)


def test_resumed_solve_matches_one_shot_and_jax():
    jb, tb = _batches("syn40x200")
    opts_t, opts_j = tconfig.IpmOptions(), jconfig.IpmOptions()
    one_shot = tshared.mehrotra_solve_shared(tb, opts_t)

    first = tshared.mehrotra_solve_shared(tb, opts_t, iter_limit=3)
    assert np.all(first.status.numpy() == IpmStatus.MAX_ITER)
    assert np.all(first.iterations.numpy() == 3)
    resumed = tshared.mehrotra_solve_shared(tb, opts_t, state0=first, iter_limit=opts_t.max_iter)
    np.testing.assert_array_equal(resumed.status.numpy(), one_shot.status.numpy())
    np.testing.assert_array_equal(resumed.iterations.numpy(), one_shot.iterations.numpy())
    np.testing.assert_allclose(resumed.x.numpy(), one_shot.x.numpy(), rtol=0, atol=1e-12)

    jfirst = jshared.mehrotra_solve_shared(jb, opts_j, iter_limit=3)
    jres = jshared.mehrotra_solve_shared(jb, opts_j, state0=jfirst, iter_limit=opts_j.max_iter)
    _assert_slice_parity(jb, jres, tb, resumed)
