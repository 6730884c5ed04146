"""The numerics of the Gram kernel's bf16x6 split, emulated on the CPU.

The kernel (``sypha_tpu_torch/csrc/gram.cu``) splits each f32 operand
x = A[i, k] * w[b, k] into three bf16 pieces hi + mid + lo and keeps six of
the nine products on the tensor cores.  The kernel itself runs only on the
card; here the same split is made with ``.to(torch.bfloat16)`` and the six
products are summed by f32 einsums (each product of two bf16 values is exact
in f32), to show on the CPU that the split is exact, that the kept products
carry f32 precision, and that the IPM slice solved with this Gram matches
the JAX package.
"""

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
from sypha_tpu_torch.ipm import shared as tshared
from sypha_tpu_torch.ops.gram import gram_reference
from sypha_tpu_torch.testing import synthetic_scp

# (left piece, right piece) of each kept product, in the kernel's order:
# lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi
KEPT = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def split3(x: torch.Tensor):
    """f32 -> (hi, mid, lo) bf16 with hi + mid + lo == x, as the kernel splits."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def gram_bf16x6(A32: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Emulation of the kernel: the six kept products, each summed in f32."""
    pieces = [p.float() for p in split3(A32[None, :, :] * w[:, None, :])]
    M = torch.zeros((w.shape[0], A32.shape[0], A32.shape[0]), dtype=torch.float32)
    for a, b in KEPT:
        M += torch.einsum("bik,bjk->bij", pieces[a], pieces[b])
    return M


def _inputs(B, m, n, log10_d2, seed):
    rng = np.random.default_rng(seed)
    A32 = torch.from_numpy(rng.integers(-1, 2, size=(m, n)).astype(np.float32))
    w = torch.from_numpy(np.sqrt(10.0 ** rng.uniform(*log10_d2, size=(B, n))).astype(np.float32))
    return A32, w


def _entry_rel_err(M, G64, bound):
    """max_ij |M - G64|_ij / (|Aw| |Aw|^T)_ij; entries with a zero bound must be exact."""
    err = (M.double() - G64).abs()
    pos = bound > 0
    assert bool((err[~pos] == 0).all())
    return (err[pos] / bound[pos]).max().item()


def test_split_is_exact_over_the_ipm_range():
    rng = np.random.default_rng(0)
    mag = 10.0 ** rng.uniform(-15, 15, size=200_000)
    x = torch.from_numpy((mag * rng.choice([-1.0, 1.0], size=mag.size)).astype(np.float32))
    hi, mid, lo = split3(x)
    np.testing.assert_array_equal((hi.float() + mid.float() + lo.float()).numpy(), x.numpy())
    # each piece is at most about 2^-8 of the one before it
    assert bool((mid.float().abs() <= hi.float().abs() * 2.0**-8).all())
    assert bool((lo.float().abs() <= mid.float().abs() * 2.0**-8).all())


@pytest.mark.parametrize(
    "B,m,n,log10_d2",
    [(3, 37, 301, (-12, 6)), (4, 64, 256, (-12, 6)), (4, 64, 256, (-30, 30))],
)
def test_bf16x6_gram_holds_f32_precision(B, m, n, log10_d2):
    A32, w = _inputs(B, m, n, log10_d2, seed=m + n)
    Aw = A32.double()[None] * w.double()[:, None]
    G64 = Aw @ Aw.mT
    bound = Aw.abs() @ Aw.abs().mT
    emulated = gram_bf16x6(A32, w)
    plain = _entry_rel_err(gram_reference(A32, w), G64, bound)
    # the chip_smoke bound: no worse than 4x the plain f32 version
    assert _entry_rel_err(emulated, G64, bound) <= 4 * plain
    assert torch.isfinite(emulated).all()
    # the three dropped products are each at most about 2^-24 of their
    # term: summed exactly (f64), the kept ones are that close per entry
    pieces = [p.double() for p in split3(A32[None] * w[:, None])]
    kept = sum(torch.einsum("bik,bjk->bij", pieces[a], pieces[b]) for a, b in KEPT)
    assert _entry_rel_err(kept, G64, bound) <= 2.0**-24


TINY = "3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n"
_DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
TEXTS = {
    "tiny": lambda: TINY,
    "demo_small": lambda: (_DATA / "demo_small.txt").read_text(),
    "syn40x200": lambda: synthetic_scp(40, 200, 0.1, 4),
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_slice_with_bf16x6_gram_matches_jax(name, monkeypatch):
    text = TEXTS[name]()
    jb = jshared.make_shared_batch(jsf.pad_lp(jreader.parse_scp_text(text)), 4)
    tb = tshared.make_shared_batch(tsf.pad_lp(treader.parse_scp_text(text)), 4)
    calls = []

    def counted(A32, w):
        calls.append(w.shape[0])
        return gram_bf16x6(A32, w)

    monkeypatch.setattr(tshared, "gram", counted)
    js = jshared.mehrotra_solve_shared(jb, jconfig.IpmOptions())
    ts = tshared.mehrotra_solve_shared(tb, tconfig.IpmOptions())
    assert len(calls) >= int(ts.iterations.max()) + 1
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    assert np.abs(ts.iterations.numpy() - np.asarray(js.iterations)).max() <= 1
    jobj = np.einsum("bn,bn->b", np.asarray(jb.c), np.asarray(js.x))
    tobj = torch.sum(tb.c * ts.x, dim=-1).numpy()
    np.testing.assert_allclose(tobj, jobj, rtol=1e-8)
