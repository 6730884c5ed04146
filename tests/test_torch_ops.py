"""Device operations of the PyTorch port against the JAX package: the Gram
product (plain version here; the CUDA kernel on the card), the block
Cholesky inverse in f64 and f32, the NaN lane, and the f64 PCG."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sypha_tpu.ops import linalg as jlinalg
from sypha_tpu.ops import spd as jspd
from sypha_tpu.ops.pallas_gram import batched_gram
from sypha_tpu.ipm import shared as jshared
from sypha_tpu_torch.ops import gram as tgram
from sypha_tpu_torch.ops.linalg import block_chol_inverse
from sypha_tpu_torch.ops.spd import NormalEqFactor, _apply_normal_precond, pcg_solve
from sypha_tpu_torch.io.scp_reader import parse_scp_text
from sypha_tpu_torch.io.standard_form import pad_lp
from sypha_tpu_torch.testing import synthetic_scp


def _gram_inputs(rng, B, m, n):
    A32 = rng.integers(-1, 2, size=(m, n)).astype(np.float32)
    w = (10.0 ** rng.uniform(-6, 3, size=(B, n))).astype(np.float32)
    return A32, w


@pytest.mark.parametrize("B,m,n", [(3, 37, 301), (2, 64, 128), (4, 200, 1280), (1, 1, 5)])
def test_gram_reference_matches_jax(B, m, n):
    rng = np.random.default_rng(m * 7 + n)
    A32, w = _gram_inputs(rng, B, m, n)
    Aw = A32[None] * w[:, None]
    want = np.asarray(batched_gram(jnp.asarray(Aw), backend="einsum"))
    got = tgram.gram_reference(torch.from_numpy(A32), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (B, m, m)
    # f32 sums taken in another order: 1e-5 of the largest entry
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_gram_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(1)
    A32, w = (torch.from_numpy(a) for a in _gram_inputs(rng, 3, 37, 301))
    before = tgram.gram.launches
    torch.testing.assert_close(tgram.gram(A32, w), tgram.gram_reference(A32, w), rtol=0, atol=0)
    assert tgram.gram.launches == before, "no kernel launch for CPU tensors"


def test_gram_wrapper_rejects_bad_operands():
    A32 = torch.ones(8, 16)
    w = torch.ones(2, 16)
    with pytest.raises(TypeError):
        tgram.gram(A32.double(), w)
    with pytest.raises(ValueError):
        tgram.gram(A32, torch.ones(2, 15))
    with pytest.raises(ValueError):
        tgram.gram(A32[None], w)
    with pytest.raises(ValueError):
        tgram.gram(torch.ones(16, 8).T, w)  # not contiguous
    with pytest.raises(ValueError):
        tgram.gram(A32.to("meta"), w.to("meta"))


def _random_spd(rng, B, m, cond_scale=1.0):
    # the inputs of tests/test_linalg.py
    G = rng.standard_normal((B, m, 3 * m))
    M = G @ np.swapaxes(G, -1, -2) + m * np.eye(m)
    d = cond_scale ** rng.uniform(-1, 1, (B, m))
    return d[:, :, None] * M * d[:, None, :]


@pytest.mark.parametrize("m", [8, 40, 200])
def test_block_chol_inverse_f64_matches_jax(m):
    rng = np.random.default_rng(m)
    M = _random_spd(rng, 3, m)
    got = block_chol_inverse(torch.from_numpy(M)).numpy()
    want = np.asarray(jlinalg.block_chol_inverse(jnp.asarray(M)))
    L = np.linalg.cholesky(M)
    assert np.max(np.abs(got @ L - np.eye(m))) < 1e-10
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def _ipm_like_f32(rng, nrows, spread):
    """Equilibrated f32 normal matrices of an SCP standard form with a
    spread column scaling and the 2e-6 ridge, as _shared_factor builds them."""
    lp = pad_lp(parse_scp_text(synthetic_scp(nrows, 5 * nrows, 0.1, 7)), device="cpu")
    A = lp.A.numpy().astype(np.float32)
    m, n = A.shape
    w = np.sqrt(10.0 ** rng.uniform(-spread, spread, (3, n))).astype(np.float32)
    Aw = A[None] * w[:, None]
    M = np.einsum("bik,bjk->bij", Aw, Aw) + np.diag(lp.row_pad.numpy()).astype(np.float32)
    dinv = 1.0 / np.sqrt(np.diagonal(M, axis1=1, axis2=2))
    return (M * dinv[:, None, :] * dinv[:, :, None] + 2e-6 * np.eye(m)).astype(np.float32)


@pytest.mark.parametrize("nrows,spread", [(40, 2), (100, 4), (150, 6)])
def test_block_chol_inverse_f32_matches_jax(nrows, spread):
    Ms = _ipm_like_f32(np.random.default_rng(nrows), nrows, spread)
    got = block_chol_inverse(torch.from_numpy(Ms)).numpy()
    want = np.asarray(jlinalg.block_chol_inverse(jnp.asarray(Ms)))
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    L = got.astype(np.float64)
    res = np.einsum("bij,bjk,blk->bil", L, Ms.astype(np.float64), L) - np.eye(Ms.shape[-1])
    assert np.abs(res).max() <= 1e-3


@pytest.mark.parametrize("m", [8, 80])
def test_block_chol_inverse_nan_lane(m):
    """A lane that is not positive definite yields NaN (as jax's cholesky
    does) and leaves the other lanes untouched."""
    rng = np.random.default_rng(m)
    M = _random_spd(rng, 3, m)
    M[1] = -M[1]
    got = block_chol_inverse(torch.from_numpy(M)).numpy()
    want = np.asarray(jlinalg.block_chol_inverse(jnp.asarray(M)))
    assert np.isnan(want[1]).any() and np.isnan(got[1]).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isfinite(got[[0, 2]]).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=0, atol=1e-10)


def test_pcg_solve_f64_with_f32_preconditioner_matches_jax():
    rng = np.random.default_rng(5)
    Ms32 = _ipm_like_f32(rng, 40, 3)
    M = Ms32.astype(np.float64) + 1e-3 * np.eye(Ms32.shape[-1])
    f = rng.standard_normal(M.shape[:2])
    Linv = np.array(jlinalg.block_chol_inverse(jnp.asarray(Ms32)))
    dinv = np.ones(M.shape[:2], np.float32)

    jx, jrel = jspd.pcg_solve(
        lambda r: jshared._precond(jnp.asarray(Linv), jnp.asarray(dinv), r),
        lambda v: jnp.einsum("bij,bj->bi", jnp.asarray(M), v),
        jnp.asarray(f), 1e-12, 16,
    )
    Lt, dt, Mt = torch.from_numpy(Linv), torch.from_numpy(dinv), torch.from_numpy(M)
    steps = pcg_solve.steps
    tx, trel = pcg_solve(
        lambda r: _apply_normal_precond(NormalEqFactor(Linv=Lt, dinv=dt), r),
        lambda v: torch.einsum("bij,bj->bi", Mt, v),
        torch.from_numpy(f), 1e-12, 16,
    )
    assert pcg_solve.steps > steps
    assert tx.dtype == torch.float64
    jx = np.asarray(jx)
    assert np.abs(tx.numpy() - jx).max() <= 1e-9 * np.abs(jx).max()
    assert np.all(trel.numpy() < 1e-11) and np.all(np.asarray(jrel) < 1e-11)
