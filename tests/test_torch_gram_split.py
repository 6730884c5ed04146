"""The numerics of the Gram kernel's paths, emulated on the CPU.

The kernel (``sypha_tpu_torch/csrc/gram.cu``) has two product paths.
bf16x6 splits each f32 operand x = A[i, k] * w[b, k] into three bf16 pieces
hi + mid + lo and keeps six of the nine products on the tensor cores.
bf16x3, for an A whose every entry is exact in bf16, multiplies A itself by
u = A * fl(w * w) split in three: three products, none dropped.  Split-k
cuts the k range into slices whose partial sums a second pass adds in a
fixed order.  The kernel itself runs only on the card; here the same splits
are made with ``.to(torch.bfloat16)`` and the products are summed by f32
einsums (each product of two bf16 values is exact in f32), to show on the
CPU that the splits are exact, that the kept products carry f32 precision,
that the IPM slice solved with either Gram matches the JAX package, how
``_plan`` cuts k, and that the IPMs decide bf16 exactness once per solve
and hand it to ``gram``.
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
import sypha_tpu_torch as st
from sypha_tpu_torch.ipm import driver as tdriver
from sypha_tpu_torch.milp.base_model import BaseModel, Cut
from sypha_tpu_torch.ops import gram as tgram
from sypha_tpu_torch.ops import spd as tspd
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
    tb = tshared.make_shared_batch(tsf.pad_lp(treader.parse_scp_text(text), device="cpu"), 4)
    calls = []

    def counted(A32, w, **kw):
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


# -- bf16x3: A exact in bf16, u = A * fl(w * w) split in three ----------------


def gram_bf16x3(A32: torch.Tensor, w: torch.Tensor, splits: int = 1) -> torch.Tensor:
    """Emulation of the kernel's three-product path on an A exact in bf16
    ([m, n] shared or [B, m, n] per lane): per 16-wide k block a fresh f32
    sum of A.lo, A.mid, A.hi, added to the running sum of its k slice; with
    ``splits`` slices (split-k) the slices' partial sums added in the order
    0 .. splits - 1; the lower triangle mirrored, as the kernel's tiles are."""
    A = A32 if A32.ndim == 3 else A32[None].expand(w.shape[0], -1, -1)
    n = A.shape[-1]
    pieces = [p.float() for p in split3(A * (w * w)[:, None, :])]
    chunks = -(-n // 16)
    parts = []
    for z in range(splits):
        acc = torch.zeros(A.shape[:-1] + (A.shape[-2],))
        for c in range(z * chunks // splits, (z + 1) * chunks // splits):
            k = slice(16 * c, 16 * (c + 1))
            d = torch.zeros_like(acc)
            for p in (2, 1, 0):  # lo, mid, hi: smallest first
                d = d + torch.einsum("bik,bjk->bij", A[..., k], pieces[p][..., k])
            acc = acc + d
        parts.append(acc)
    M = parts[0]
    for P in parts[1:]:
        M = M + P
    return torch.tril(M) + torch.tril(M, -1).mT


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize(
    "B,m,n,log10_d2,values",
    [
        (3, 37, 301, (-12, 6), (-1, 2)),
        (4, 64, 256, (-12, 6), (-1, 2)),
        (4, 64, 256, (-30, 30), (-1, 2)),
        # small-integer cut rows: A fl(w^2) rounds once more
        (2, 40, 200, (-12, 6), (-3, 4)),
    ],
)
def test_bf16x3_gram_holds_f32_precision(B, m, n, log10_d2, values, splits):
    rng = np.random.default_rng(m + n + splits)
    A32 = torch.from_numpy(rng.integers(*values, size=(m, n)).astype(np.float32))
    w = torch.from_numpy(np.sqrt(10.0 ** rng.uniform(*log10_d2, size=(B, n))).astype(np.float32))
    assert tgram.bf16_exact(A32)
    Aw = A32.double()[None] * w.double()[:, None]
    G64 = Aw @ Aw.mT
    bound = Aw.abs() @ Aw.abs().mT
    emulated = gram_bf16x3(A32, w, splits)
    assert torch.isfinite(emulated).all()
    assert torch.equal(emulated, emulated.mT)
    plain = _entry_rel_err(gram_reference(A32, w), G64, bound)
    # the chip_smoke bound: no worse than 4x the plain f32 version
    assert _entry_rel_err(emulated, G64, bound) <= 4 * plain
    # no product is dropped: summed exactly (f64), the pieces are off only
    # by fl(w w) and, for |A| > 1, by A fl(w^2), each at most 2^-24
    pieces = [p.double() for p in split3(A32[None] * (w * w)[:, None])]
    kept = sum(torch.einsum("ik,bjk->bij", A32.double(), p) for p in pieces)
    assert _entry_rel_err(kept, G64, bound) <= 2.0**-23


def test_bf16x3_pieces_stay_normal_over_the_clamp_range():
    """u = A fl(w^2) with d2 = w^2 over the IPM's clamp [1e-30, 1e30], as
    d2_eff reaches the kernel (w = sqrt(d2) rounded to f32, 0 on fixed
    columns): the split is exact and every nonzero piece, hence every kept
    product with an integer A, is a normal f32 number that the tensor cores
    do not flush."""
    rng = np.random.default_rng(3)
    d2 = np.concatenate([[1e-30, 1e30, 0.0], 10.0 ** rng.uniform(-30, 30, size=20_000)])
    w = torch.from_numpy(np.sqrt(np.where(d2 > 0, np.clip(d2, 1e-30, 1e30), 0.0))).float()
    A = torch.from_numpy(rng.integers(-3, 4, size=(4, d2.size)).astype(np.float32))
    u = A * (w * w)
    hi, mid, lo = split3(u)
    np.testing.assert_array_equal((hi.float() + mid.float() + lo.float()).numpy(), u.numpy())
    tiny = torch.finfo(torch.float32).tiny
    for p in (hi, mid, lo):
        nz = p.float()[p.float() != 0]
        assert bool((nz.abs() >= tiny).all())


# -- split-k: the plan and its fixed order of summation ----------------------

SMS = 132  # an H100 SXM's SMs


@pytest.mark.parametrize(
    "B,m,n",
    [
        (128, 200, 1280),  # cell A; per lane, phase 9 (a)
        (64, 504, 5504),  # cell B; per lane
        (1280, 200, 1280),  # grouped, bench.py's layout
        (16, 504, 5504),  # per lane over the clamp range
        (64, 1000, 11008),  # ell_vs_dense's 64 lanes at scpnrg class
        (64, 288, 1280),  # a B&B window with cut rows
    ],
)
def test_plan_keeps_one_pass_where_the_grid_fills_the_card(B, m, n):
    assert tgram._plan(B, m, n, SMS) == 1


@pytest.mark.parametrize(
    "B,m,n",
    [
        (1, 200, 1280),
        (2, 200, 1280),
        (1, 504, 5504),
        (2, 504, 5504),
        (1, 576, 5632),  # root_cut_study's root with cut rows
        (2, 504, 2752),  # tensor-parallel slab, scpnre class
        (1, 1024, 5632),  # tensor-parallel slab, scpnrg class
        (1, 1024, 11264),  # scpnrg class whole
    ],
)
def test_plan_splits_k_for_one_or_two_lanes(B, m, n):
    s = tgram._plan(B, m, n, SMS)
    t = -(-m // 64)
    ctas = B * t * (t + 1) // 2
    chunks = -(-n // 16)
    target = tgram._CTAS_PER_SM * SMS
    assert s > 1
    assert chunks // s >= tgram._MIN_CHUNKS
    # two CTAs a SM unless the chunks ran out, and no slice past 64 chunks
    # where another slice would not make one shorter than 8
    assert ctas * s >= target or chunks // (s + 1) < tgram._MIN_CHUNKS
    assert -(-chunks // s) <= tgram._MAX_CHUNKS or chunks // (s + 1) < tgram._MIN_CHUNKS


def test_plan_never_cuts_more_slices_than_chunks():
    rng = np.random.default_rng(0)
    for B, m, n in zip(rng.integers(1, 9, 2000), rng.integers(1, 1200, 2000), rng.integers(0, 20000, 2000)):
        s = tgram._plan(int(B), int(m), int(n), SMS)
        chunks = -(-int(n) // 16)
        assert 1 <= s <= max(1, chunks)
        assert s == 1 or chunks // s >= tgram._MIN_CHUNKS
    assert tgram._plan(0, 200, 1280, SMS) == 1 and tgram._plan(1, 0, 1280, SMS) == 1


def test_split_k_sums_in_a_fixed_order():
    """Cutting k changes the order of the f32 sums, not their precision,
    and the same cut gives the same bits."""
    rng = np.random.default_rng(7)
    A32 = torch.from_numpy(rng.integers(-1, 2, size=(50, 700)).astype(np.float32))
    w = torch.from_numpy(np.sqrt(10.0 ** rng.uniform(-12, 6, size=(2, 700))).astype(np.float32))
    Aw = A32.double()[None] * w.double()[:, None]
    G64, bound = Aw @ Aw.mT, Aw.abs() @ Aw.abs().mT
    plain = _entry_rel_err(gram_reference(A32, w), G64, bound)
    one = gram_bf16x3(A32, w, 1)
    for s in (2, 5, 11):
        got = gram_bf16x3(A32, w, s)
        assert torch.equal(got, gram_bf16x3(A32, w, s))
        assert _entry_rel_err(got, G64, bound) <= 4 * plain
        assert (got - one).abs().max().item() <= 1e-5 * G64.abs().max().item()


# -- the exactness decision: once per solve, handed to gram ------------------


def _general_lp():
    """A 3 x 4 covering LP with a 0.3 coefficient, in standard form."""
    A = np.array([[1.0, 0.3, 0.0, 1.0], [0.0, 1.0, 1.0, 0.0], [1.0, 0.0, 1.0, 1.0]])
    A_std = np.hstack([A, -np.eye(3)])
    return tsf.pad_standard_form(A_std, np.ones(3), np.concatenate([[2.0, 1.0, 3.0, 2.5], np.zeros(3)]),
                                 n_struct=4, device="cpu")


def _window_with_cuts():
    """A B&B node window's base: the SCP rows with two integer cut rows."""
    base = BaseModel(treader.parse_scp_text(synthetic_scp(40, 200, 0.1, 4)))
    base.add_cuts([
        Cut(indices=np.array([0, 3, 7], dtype=np.int32), values=np.array([1.0, 2.0, 1.0]), rhs=2.0),
        Cut(indices=np.array([1, 2, 5, 9], dtype=np.int32), values=np.array([1.0, 1.0, 3.0, 1.0]), rhs=2.0),
    ])
    A, b, c, n0 = base.standard_form(None)
    return tsf.pad_standard_form(A, b, c, n_struct=n0, device="cpu")


def _scp():
    return tsf.pad_lp(treader.parse_scp_text(synthetic_scp(40, 200, 0.1, 4)), device="cpu")


CASES = {
    "scp shared": (lambda: tshared.mehrotra_solve_shared(tshared.make_shared_batch(_scp(), 3), tconfig.IpmOptions()), True),
    "scp ell": (lambda: tshared.mehrotra_solve_shared(
        tshared.make_shared_batch_sparse(treader.parse_scp_text(synthetic_scp(40, 200, 0.1, 4)), 3, device="cpu"),
        tconfig.IpmOptions()), True),
    "scp solve_lp": (lambda: tdriver.solve_lp(_scp()), True),
    "window with cuts": (lambda: st.solve_node_batch(
        _window_with_cuts(), np.zeros((4, _window_with_cuts().n_pad)), np.zeros((4, _window_with_cuts().n_pad)),
        tconfig.IpmOptions()), True),
    "general shared": (lambda: tshared.mehrotra_solve_shared(tshared.make_shared_batch(_general_lp(), 2), tconfig.IpmOptions()), False),
    "general solve_lp": (lambda: tdriver.solve_lp(_general_lp()), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_exactness_is_decided_once_per_solve(case, monkeypatch):
    """True for SCP standard forms (dense, ELL, per lane) and for a window
    with integer cut rows appended; False for an LP with a 0.3 coefficient.
    Decided once per solve and handed to every Gram call as a keyword."""
    from sypha_tpu_torch.ipm import dense as tdense

    solve, want = CASES[case]
    seen, decided = [], []

    def recording(real):
        def gram(A32, w, *, a_bf16_exact=None):
            seen.append(a_bf16_exact)
            return real(A32, w, a_bf16_exact=a_bf16_exact)
        return gram

    def counting(real):
        def bf16_exact(A32):
            decided.append(A32.shape)
            return real(A32)
        return bf16_exact

    monkeypatch.setattr(tshared, "gram", recording(tshared.gram))
    monkeypatch.setattr(tspd, "gram", recording(tspd.gram))
    monkeypatch.setattr(tshared, "bf16_exact", counting(tshared.bf16_exact))
    monkeypatch.setattr(tdense, "bf16_exact", counting(tdense.bf16_exact))
    solve()
    assert len(seen) >= 2 and set(seen) == {want}, seen
    assert len(decided) == 1, decided


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_slice_with_bf16x3_gram_matches_jax(name, monkeypatch):
    text = TEXTS[name]()
    jb = jshared.make_shared_batch(jsf.pad_lp(jreader.parse_scp_text(text)), 4)
    tb = tshared.make_shared_batch(tsf.pad_lp(treader.parse_scp_text(text), device="cpu"), 4)
    calls = []

    def counted(A32, w, *, a_bf16_exact=None):
        assert a_bf16_exact is True, "an SCP standard form is exact in bf16"
        calls.append(w.shape[0])
        return gram_bf16x3(A32, w)

    monkeypatch.setattr(tshared, "gram", counted)
    js = jshared.mehrotra_solve_shared(jb, jconfig.IpmOptions())
    ts = tshared.mehrotra_solve_shared(tb, tconfig.IpmOptions())
    assert len(calls) >= int(ts.iterations.max()) + 1
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    assert np.abs(ts.iterations.numpy() - np.asarray(js.iterations)).max() <= 1
    jobj = np.einsum("bn,bn->b", np.asarray(jb.c), np.asarray(js.x))
    tobj = torch.sum(tb.c * ts.x, dim=-1).numpy()
    np.testing.assert_allclose(tobj, jobj, rtol=1e-8)
