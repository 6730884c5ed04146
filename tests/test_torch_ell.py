"""The padded-ELL operator of the PyTorch port against the JAX package's, on
the same seeded numpy inputs: the products (rtol 1e-13), the builders
(arrays equal exactly), LP solves on an ELL batch (statuses and iterations
equal, objectives within 1e-8 relative), the port's ELL solve against its
dense solve, and a node window on an ELL base."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sypha_tpu.config as jconfig
import sypha_tpu.io.scp_reader as jreader
import sypha_tpu.io.standard_form as jsf
import sypha_tpu.ops.ell as jell
from sypha_tpu.ipm import shared as jshared
from sypha_tpu.ipm.node_batch import solve_node_batch as jsolve
import sypha_tpu_torch.config as tconfig
import sypha_tpu_torch.io.scp_reader as treader
import sypha_tpu_torch.io.standard_form as tsf
import sypha_tpu_torch.ops.ell as tell
from sypha_tpu_torch.core.status import IpmStatus
from sypha_tpu_torch.ipm import shared as tshared
from sypha_tpu_torch.ipm.node_batch import solve_node_batch as tsolve
from sypha_tpu_torch.ops import gram as tgram
from sypha_tpu_torch.testing import synthetic_scp

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
TINY = "3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n"
TEXTS = {
    "tiny": lambda: TINY,
    "demo_small": lambda: (DATA / "demo_small.txt").read_text(),
    "syn40x200_2pct": lambda: synthetic_scp(40, 200, 0.02, 5),
}
FIELDS = ("row_idx", "row_val", "col_idx", "col_val")


def _rows_with_cuts(seed=0, n_struct=30, n_cover=12, n_cuts=3):
    """Covering rows of ragged width (values 1) and cut rows with small
    integer coefficients, as the B&B hands them to the ELL builder."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_cover):
        idx = np.sort(rng.choice(n_struct, size=int(rng.integers(1, 7)), replace=False))
        rows.append((idx.astype(np.int32), np.ones(len(idx))))
    for _ in range(n_cuts):
        idx = np.sort(rng.choice(n_struct, size=int(rng.integers(3, 9)), replace=False))
        rows.append((idx.astype(np.int32), rng.integers(1, 4, len(idx)).astype(np.float64)))
    return rows


def _assert_ell_equal(t, j):
    for f in FIELDS:
        tv, jv = getattr(t, f), np.asarray(getattr(j, f))
        assert tv.numpy().dtype == jv.dtype, f
        np.testing.assert_array_equal(tv.numpy(), jv, err_msg=f)


def _ell_pair(kind):
    if kind == "rows_with_cuts":
        rows = _rows_with_cuts()
        args = dict(n_struct=30, m_pad=24, n_pad=128)
        return tell.ell_from_rows(rows, **args, device="cpu"), jell.ell_from_rows(rows, **args)
    rng = np.random.default_rng(3)
    A = rng.integers(-3, 4, (20, 50)).astype(np.float64)
    A[rng.random(A.shape) < 0.7] = 0.0
    args = dict(m_pad=24, n_pad=64)
    return tell.ell_from_dense(A, **args, device="cpu"), jell.ell_from_dense(A, **args)


@pytest.mark.parametrize("kind", ["rows_with_cuts", "dense_signed"])
def test_ell_products_match_jax(kind):
    t, j = _ell_pair(kind)
    rng = np.random.default_rng(1)
    for shape in ((3,), ()):  # a batched [3, n] vector and a single one
        v = rng.standard_normal(shape + (t.n_pad,))
        u = rng.standard_normal(shape + (t.m_pad,))
        for name, arg in (("Av", v), ("ATu", u), ("sqAv", np.abs(v))):
            tr = getattr(t, name)(torch.from_numpy(arg))
            jr = np.asarray(getattr(j, name)(jnp.asarray(arg)))
            assert tr.dtype == torch.float64 and tr.shape == jr.shape, name
            np.testing.assert_allclose(tr.numpy(), jr, rtol=1e-13, atol=1e-13 * np.abs(jr).max())
    for dtype, jdtype in ((torch.float32, jnp.float32), (None, None)):
        td = t.todense(dtype).numpy()
        jd = np.asarray(j.todense(jdtype))
        assert td.dtype == jd.dtype
        np.testing.assert_array_equal(td, jd)


def test_ell_builders_match_jax():
    for kind in ("rows_with_cuts", "dense_signed"):
        _assert_ell_equal(*_ell_pair(kind))
    rows = _rows_with_cuts(seed=2)
    rhs = np.arange(1.0, len(rows) + 1)
    costs = np.arange(30.0) + 1.0
    tlp = tsf.pad_standard_form_ell(rows, rhs, costs, n_struct=30, m_pad=24, n_pad=128, device="cpu")
    jlp = jsf.pad_standard_form_ell(rows, rhs, costs, n_struct=30, m_pad=24, n_pad=128)
    _assert_ell_equal(tlp.A, jlp.A)
    for f in ("b", "c", "row_pad", "m_real", "n_real", "n_struct"):
        tv, jv = getattr(tlp, f).numpy(), np.asarray(getattr(jlp, f))
        assert tv.dtype == jv.dtype, f
        np.testing.assert_array_equal(tv, jv, err_msg=f)
    assert (tlp.m_pad, tlp.n_pad) == (jlp.m_pad, jlp.n_pad) == (24, 128)


def _objectives(c, b, x, y):
    return (np.einsum("bn,bn->b", np.asarray(c), np.asarray(x)),
            np.einsum("bm,bm->b", np.asarray(b), np.asarray(y)))


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_ell_slice_matches_jax_and_dense(name):
    text = TEXTS[name]()
    tmodel = treader.parse_scp_text(text)
    jb = jshared.make_shared_batch_sparse(jreader.parse_scp_text(text), 3)
    tb = tshared.make_shared_batch_sparse(tmodel, 3, device="cpu")
    assert tb.is_sparse and jb.is_sparse
    _assert_ell_equal(tb.A, jb.A)
    js = jshared.mehrotra_solve_shared(jb, jconfig.IpmOptions())
    before = tgram.gram.launches
    ts = tshared.mehrotra_solve_shared(tb, tconfig.IpmOptions())
    assert tgram.gram.launches == before  # CPU tensors take the plain Gram
    assert np.all(ts.status.numpy() == IpmStatus.CONVERGED)
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_array_equal(ts.iterations.numpy(), np.asarray(js.iterations))
    tp, td = _objectives(tb.c, tb.b, ts.x, ts.y)
    jp, jd = _objectives(jb.c, jb.b, js.x, js.y)
    np.testing.assert_allclose(tp, jp, rtol=1e-8)
    np.testing.assert_allclose(td, jd, rtol=1e-8)

    # the port's dense operator on the same bucket
    db = tshared.make_shared_batch(tsf.pad_lp(tmodel, m_pad=tb.m_pad, n_pad=tb.n_pad, device="cpu"), 3)
    ds = tshared.mehrotra_solve_shared(db, tconfig.IpmOptions())
    np.testing.assert_array_equal(ds.status.numpy(), ts.status.numpy())
    assert np.abs(ds.iterations.numpy() - ts.iterations.numpy()).max() <= 1
    dp, _ = _objectives(db.c, db.b, ds.x, ds.y)
    np.testing.assert_allclose(tp, dp, rtol=1e-8)


def test_make_shared_batch_auto_picks_like_jax():
    for text, sparse in ((synthetic_scp(40, 200, 0.02, 5), True), (synthetic_scp(24, 120, 0.1, 3), False)):
        tb = tshared.make_shared_batch_auto(treader.parse_scp_text(text), 2, device="cpu")
        jb = jshared.make_shared_batch_auto(jreader.parse_scp_text(text), 2)
        assert tb.is_sparse == jb.is_sparse == sparse
        for f in ("b", "c", "col_mask", "row_pad", "obj_offset"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), err_msg=f)


def test_ell_node_window_matches_jax():
    """fix_columns + solve_node_batch on an ELL base in both packages: lane 0
    free, lanes 1-2 seeded fixings, lane 3 infeasible by its fixings."""
    text = synthetic_scp(40, 200, 0.02, 5)
    model = treader.parse_scp_text(text)
    rows = [(np.asarray(r, np.int32), np.ones(len(r))) for r in model.rows]
    args = dict(n_struct=model.ncols, m_pad=48, n_pad=256)
    rhs = np.ones(model.nrows)
    tlp = tsf.pad_standard_form_ell(rows, rhs, model.costs, **args, device="cpu")
    jlp = jsf.pad_standard_form_ell(rows, rhs, model.costs, **args)
    rng = np.random.default_rng(0)
    B = 4
    fix0 = np.zeros((B, 256))
    fix1 = np.zeros((B, 256))
    for lane in (1, 2):
        cols = rng.permutation(model.ncols)
        fix0[lane, cols[:4]] = 1.0
        fix1[lane, cols[4:7]] = 1.0
    fix0[3, model.rows[0]] = 1.0
    opts_t = tconfig.IpmOptions(gap_stall_window=5)
    opts_j = jconfig.IpmOptions(gap_stall_window=5)
    tst, tx, tp, td = tsolve(tlp, fix0, fix1, opts_t)
    jst, jx, jp, jd = jsolve(jlp, fix0, fix1, opts_j)
    status = tst.status.numpy()
    np.testing.assert_array_equal(status, np.asarray(jst.status))
    assert status[3] != IpmStatus.CONVERGED
    conv = status == IpmStatus.CONVERGED
    assert conv[:3].all()
    np.testing.assert_array_equal(tst.iterations.numpy()[conv], np.asarray(jst.iterations)[conv])
    np.testing.assert_allclose(tp.numpy()[conv], np.asarray(jp)[conv], rtol=1e-8)
    np.testing.assert_allclose(td.numpy()[conv], np.asarray(jd)[conv], rtol=1e-8)
    np.testing.assert_allclose(tx.numpy()[conv], np.asarray(jx)[conv], rtol=0, atol=1e-6)
