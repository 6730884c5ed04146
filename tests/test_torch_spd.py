"""The port's SPD helpers (ops.linalg, ops.spd) and the per-lane form of the
Gram product against the JAX package on the CPU, on the inputs of
tests/test_linalg.py and tests/test_spd.py: ``chol_inverse`` and
``spd_solve_with_inv``, ``spd_factor``/``spd_solve`` (f32 and f64 factors),
``normal_eq_factor``/``normal_eq_solve``, ``pcg_solve`` in its per-lane mode
against ``jax.vmap`` of the JAX loop, and ``gram_reference`` with a matrix
per lane against ``batched_gram``'s CPU route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sypha_tpu.ops import linalg as jlinalg
from sypha_tpu.ops import spd as jspd
from sypha_tpu.ops.pallas_gram import batched_gram
from sypha_tpu_torch.ops import gram as tgram
from sypha_tpu_torch.ops import linalg as tlinalg
from sypha_tpu_torch.ops import spd as tspd


def _random_spd(rng, B, m, cond_scale=1.0):
    # tests/test_linalg.py's inputs
    G = rng.standard_normal((B, m, 3 * m))
    M = G @ np.swapaxes(G, -1, -2) + m * np.eye(m)
    d = cond_scale ** rng.uniform(-1, 1, (B, m))
    return d[:, :, None] * M * d[:, None, :]


def _ipm_like_system(rng, B, m, n, spread):
    # tests/test_spd.py's inputs: A D^2 A^T with diagonal spread
    A = (rng.random((B, m, n)) < 0.05).astype(np.float64)
    A[..., -m:] = -np.eye(m)
    d2 = 10.0 ** rng.uniform(-spread, spread, (B, n))
    return (A * d2[:, None, :]) @ np.swapaxes(A, -1, -2)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("m", [8, 40, 200])
def test_chol_inverse_matches_jax(m):
    M = _random_spd(np.random.default_rng(m), 3, m)
    got = tlinalg.chol_inverse(torch.from_numpy(M)).numpy()
    assert _rel(got, jlinalg.chol_inverse(jnp.asarray(M))) <= 1e-12


@pytest.mark.parametrize("m,cond_scale", [(200, 1e3), (64, 1e5)])
def test_spd_solve_with_inv_matches_jax(m, cond_scale):
    rng = np.random.default_rng(m)
    M = _random_spd(rng, 4, m, cond_scale)
    f = rng.standard_normal((4, m))
    got = tlinalg.spd_solve_with_inv(tlinalg.chol_inverse(torch.from_numpy(M)), torch.from_numpy(f))
    want = jlinalg.spd_solve_with_inv(jlinalg.chol_inverse(jnp.asarray(M)), jnp.asarray(f))
    assert _rel(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize(
    "seed,B,m,n,spread,dtype,tol,max_steps",
    [
        (0, 4, 64, 400, 1.0, "float32", 1e-12, 50),
        (1, 4, 64, 400, 6.0, "float32", 1e-11, 100),
        (2, 2, 40, 200, 3.0, "float64", 1e-13, 50),
    ],
)
def test_spd_factor_and_solve_match_jax(seed, B, m, n, spread, dtype, tol, max_steps):
    rng = np.random.default_rng(seed)
    M = _ipm_like_system(rng, B, m, n, spread)
    f = rng.standard_normal((B, m))
    ridge = 2e-6 if dtype == "float32" else 1e-12
    jfac = jspd.spd_factor(jnp.asarray(M), getattr(jnp, dtype), ridge)
    tfac = tspd.spd_factor(torch.from_numpy(M), getattr(torch, dtype), ridge)
    assert tfac.Linv.dtype == getattr(torch, dtype)
    assert _rel(tfac.Ms.numpy(), jfac.Ms) <= 1e-12
    assert _rel(tfac.dinv.numpy(), jfac.dinv) <= 1e-12
    # the f32 factor within tests/test_torch_ops.py's f32 tolerance, f64 at 1e-12
    assert _rel(tfac.Linv.numpy(), jfac.Linv) <= (1e-4 if dtype == "float32" else 1e-12)
    want = np.asarray(jspd.spd_solve(jfac, jnp.asarray(f), tol, max_steps))
    for per_lane in (False, True):
        got = tspd.spd_solve(tfac, torch.from_numpy(f), tol, max_steps, per_lane=per_lane).numpy()
        # both converge to the f64 solution, to their tolerance on its scale
        assert _rel(got, want) <= 1e-9, per_lane
    got = tspd.spd_solve(tfac, torch.from_numpy(f), tol, max_steps, per_lane=True).numpy()
    vmapped = jax.vmap(lambda fa, fi: jspd.spd_solve(fa, fi, tol, max_steps))(jfac, jnp.asarray(f))
    assert _rel(got, vmapped) <= 1e-9


def _normal_eq_inputs(rng, B, m, n):
    A = (rng.random((B, m, n)) < 0.1).astype(np.float64)
    A[..., -m:] = -np.eye(m)
    d2 = 10.0 ** rng.uniform(-3, 3, (B, n))
    row_reg = np.zeros((B, m))
    row_reg[:, -3:] = 1.0
    f = rng.standard_normal((B, m))
    return A, d2, row_reg, f


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_normal_eq_factor_and_solve_match_jax(dtype):
    rng = np.random.default_rng(7)
    A, d2, row_reg, f = _normal_eq_inputs(rng, 3, 48, 160)
    ridge = 2e-6 if dtype == "float32" else 1e-12
    jA, jd2, jr = jnp.asarray(A), jnp.asarray(d2), jnp.asarray(row_reg)
    tA, td2, tr = (torch.from_numpy(a) for a in (A, d2, row_reg))
    # the JAX factor forms diag(row_reg) for one lane: vmapped over the lanes
    jfac = jax.vmap(lambda a, d, r: jspd.normal_eq_factor(a, d, r, getattr(jnp, dtype), ridge))(jA, jd2, jr)
    tfac = tspd.normal_eq_factor(tA, td2, tr, getattr(torch, dtype), ridge)
    assert tfac.Linv.dtype == tfac.dinv.dtype == getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 1e-12
    assert _rel(tfac.dinv.numpy(), jfac.dinv) <= tol
    assert _rel(tfac.Linv.numpy(), jfac.Linv) <= tol

    def jmatvec(v):
        return jnp.einsum("bij,bj->bi", jA, jd2 * jnp.einsum("bij,bi->bj", jA, v)) + jr * v

    def tmatvec(v):
        return torch.einsum("bij,bj->bi", tA, td2 * torch.einsum("bij,bi->bj", tA, v)) + tr * v

    want = np.asarray(jspd.normal_eq_solve(jfac, jmatvec, jnp.asarray(f), 1e-12, 40))
    for per_lane in (False, True):
        got = tspd.normal_eq_solve(tfac, tmatvec, torch.from_numpy(f), 1e-12, 40, per_lane=per_lane)
        assert _rel(got.numpy(), want) <= 1e-10, per_lane
    # the shared form: one A for every lane, as the shared-matrix IPM factors
    shared = tspd.normal_eq_factor(tA[0], td2, tr, getattr(torch, dtype), ridge)
    lane = jax.vmap(lambda d, r: jspd.normal_eq_factor(jA[0], d, r, getattr(jnp, dtype), ridge))(jd2, jr)
    assert _rel(shared.Linv.numpy(), lane.Linv) <= tol


def test_pcg_solve_per_lane_matches_vmap():
    """Per-lane loop semantics against jax.vmap of the JAX loop, on
    tests/test_linalg.py's scaled SPD inputs: lanes with per-lane
    tolerances stop at their own step; x within 1e-12, rel lane by lane
    (below each lane's tolerance; the last lane's sits at the rounding
    floor, where the two packages' sums differ in their last digits)."""
    rng = np.random.default_rng(3)
    B, m = 4, 48
    M = _random_spd(rng, B, m, 100.0)
    f = rng.standard_normal((B, m))
    diag = np.diagonal(M, axis1=1, axis2=2).copy()
    tol = np.array([1e-4, 1e-8, 1e-10, 1e-12])
    jM, jdiag = jnp.asarray(M), jnp.asarray(diag)

    def one(Mi, di, fi, ti):
        return jspd.pcg_solve(lambda r: r / di, lambda v: Mi @ v, fi, ti, 60)

    jx, jrel = jax.vmap(one)(jM, jdiag, jnp.asarray(f), jnp.asarray(tol))
    tM, tdiag = torch.from_numpy(M), torch.from_numpy(diag)
    steps = tspd.pcg_solve.steps
    tx, trel = tspd.pcg_solve(
        lambda r: r / tdiag, lambda v: torch.einsum("bij,bj->bi", tM, v),
        torch.from_numpy(f), torch.from_numpy(tol)[:, None], 60, per_lane=True,
    )
    assert tspd.pcg_solve.steps > steps
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-12 * np.abs(np.asarray(jx)).max())
    assert np.all(trel.numpy() <= tol) and np.all(np.asarray(jrel) <= tol)
    np.testing.assert_allclose(trel.numpy(), np.asarray(jrel), rtol=1e-3)
    # lanes stopped at their own tolerance, not the tightest one
    assert trel[0] > 1e-6 and trel[3] <= 1e-12
    # the batch-wide mode steps every lane to the tightest tolerance instead
    bx, brel = tspd.pcg_solve(
        lambda r: r / tdiag, lambda v: torch.einsum("bij,bj->bi", tM, v),
        torch.from_numpy(f), torch.from_numpy(tol)[:, None], 60,
    )
    assert brel[0] < trel[0]
    # a lane outside the mask never steps: x stays at the preconditioned rhs
    mask = torch.tensor([True, False, True, True])
    mx, _ = tspd.pcg_solve(
        lambda r: r / tdiag, lambda v: torch.einsum("bij,bj->bi", tM, v),
        torch.from_numpy(f), torch.from_numpy(tol)[:, None], 60, per_lane=mask,
    )
    assert torch.equal(mx[1], torch.from_numpy(f[1] / diag[1]))
    assert torch.equal(mx[[0, 2, 3]], tx[[0, 2, 3]])


@pytest.mark.parametrize("B,m,n", [(3, 37, 301), (2, 64, 128), (4, 40, 256)])
def test_gram_reference_per_lane_matches_jax(B, m, n):
    rng = np.random.default_rng(m + n)
    A32 = rng.integers(-1, 2, size=(B, m, n)).astype(np.float32)
    w = (10.0 ** rng.uniform(-6, 3, size=(B, n))).astype(np.float32)
    want = np.asarray(batched_gram(jnp.asarray(A32 * w[:, None, :]), backend="einsum"))
    got = tgram.gram_reference(torch.from_numpy(A32), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (B, m, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # the wrapper takes the per-lane form on the CPU without a launch
    before = (tgram.gram.launches, tgram.gram.launches_per_lane)
    assert torch.equal(tgram.gram(torch.from_numpy(A32), torch.from_numpy(w)), got)
    assert (tgram.gram.launches, tgram.gram.launches_per_lane) == before
    # lane b of the per-lane form is the shared form of A32[b]
    for b in range(B):
        shared = tgram.gram_reference(torch.from_numpy(A32[b]), torch.from_numpy(w[b : b + 1]))
        torch.testing.assert_close(got[b], shared[0], rtol=0, atol=1e-6 * float(shared.abs().max()))


def test_gram_rejects_mismatched_lanes():
    with pytest.raises(ValueError):
        tgram.gram(torch.ones(3, 8, 16), torch.ones(2, 16))
    with pytest.raises(ValueError):
        tgram.gram(torch.ones(2, 8, 16), torch.ones(2, 15))
