"""The Gram kernel on the card, and the slice on the card against the same
slice on the CPU.  The kernel is CUDA C++ and has no CPU mode, so these
tests carry the ``cuda`` marker and skip without a card.  Nothing here
imports JAX, so the file also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_gram_kernel.py -q
"""

import numpy as np
import pytest
import torch

import sypha_tpu_torch as st
from sypha_tpu_torch.ops import _build
from sypha_tpu_torch.ops import gram as tgram
from sypha_tpu_torch.testing import synthetic_scp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Gram kernel is CUDA C++ and has no CPU mode")
    return torch.device("cuda")


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _entry_rel_err(M, G64, bound):
    """max_ij |M - G64|_ij / (|Aw| |Aw|^T)_ij; entries with a zero bound must be exact."""
    err = (M.double() - G64).abs()
    pos = bound > 0
    assert bool((err[~pos] == 0).all())
    return (err[pos] / bound[pos]).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,m,n,log10_d2",
    [
        (3, 37, 301, (-12, 6)),
        (2, 64, 128, (-12, 6)),
        (128, 200, 1280, (-12, 6)),
        # w = sqrt(d2) over the IPM's whole clamp range [1e-30, 1e30]
        (64, 504, 5504, (-30, 30)),
    ],
)
def test_gram_kernel_matches_plain_version_on_card(cuda_device, B, m, n, log10_d2):
    rng = np.random.default_rng(m + n)
    A32 = torch.from_numpy(rng.integers(-1, 2, size=(m, n)).astype(np.float32)).to(cuda_device)
    w = np.sqrt(10.0 ** rng.uniform(*log10_d2, size=(B, n)))
    w = torch.from_numpy(w.astype(np.float32)).to(cuda_device)
    before = tgram.gram.launches
    got = tgram.gram(A32, w)
    torch.cuda.synchronize()
    assert tgram.gram.launches == before + 1
    plain = tgram.gram_reference(A32, w)
    Aw = A32.double()[None] * w.double()[:, None]
    want = Aw @ Aw.mT
    bound = Aw.abs() @ Aw.abs().mT
    scale = want.abs().max().item()
    # f32 sums against the f64 Gram: 1e-5 of the largest entry
    assert (got.double() - want).abs().max().item() <= 1e-5 * scale
    assert (got - plain).abs().max().item() <= 1e-5 * scale
    # per entry, no worse than 4x the plain f32 version (a single bf16 pass
    # reads about 4e-3 here)
    assert _entry_rel_err(got, want, bound) <= 4 * _entry_rel_err(plain, want, bound)
    assert torch.equal(got, got.mT), "lower tiles mirrored: symmetric bit for bit"


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,m,n,log10_d2",
    [
        (3, 37, 301, (-12, 6)),
        (4, 40, 256, (-12, 6)),
        (16, 504, 5504, (-30, 30)),
    ],
)
def test_gram_kernel_per_lane_matches_plain_version_on_card(cuda_device, B, m, n, log10_d2):
    """The per-lane form: a distinct A for every lane."""
    rng = np.random.default_rng(B + m + n)
    A32 = torch.from_numpy(rng.integers(-1, 2, size=(B, m, n)).astype(np.float32)).to(cuda_device)
    w = np.sqrt(10.0 ** rng.uniform(*log10_d2, size=(B, n)))
    w = torch.from_numpy(w.astype(np.float32)).to(cuda_device)
    before = (tgram.gram.launches, tgram.gram.launches_per_lane)
    got = tgram.gram(A32, w)
    torch.cuda.synchronize()
    assert (tgram.gram.launches, tgram.gram.launches_per_lane) == (before[0] + 1, before[1] + 1)
    plain = tgram.gram_reference(A32, w)
    Aw = A32.double() * w.double()[:, None]
    want = Aw @ Aw.mT
    bound = Aw.abs() @ Aw.abs().mT
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    assert ((got.double() - want).abs() <= 1e-5 * scale).all()
    assert _entry_rel_err(got, want, bound) <= 4 * _entry_rel_err(plain, want, bound)
    assert torch.equal(got, got.mT)
    # lane b is the shared form of A32[b] on the same path with k cut as
    # in the batch (a lone lane cuts k finer, and sums in another order)
    splits = tgram._plan(B, m, n, _sms(cuda_device))
    for b in (0, B - 1):
        one = tgram._launch(A32[b].contiguous(), w[b : b + 1].contiguous(), tgram.bf16_exact(A32), splits)
        assert torch.equal(got[b], one[0])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "G,L,m,n,log10_d2",
    [
        (3, 5, 37, 301, (-12, 6)),
        (4, 3, 40, 256, (-12, 6)),
        (10, 128, 200, 1280, (-12, 6)),
        (2, 8, 504, 5504, (-30, 30)),
    ],
)
def test_gram_kernel_grouped_matches_plain_version_on_card(cuda_device, G, L, m, n, log10_d2):
    """The grouped form: one A per group of L lanes, all G L lanes in one
    launch."""
    rng = np.random.default_rng(G + L + m + n)
    A32 = torch.from_numpy(rng.integers(-1, 2, size=(G, m, n)).astype(np.float32)).to(cuda_device)
    w = np.sqrt(10.0 ** rng.uniform(*log10_d2, size=(G, L, n)))
    w = torch.from_numpy(w.astype(np.float32)).to(cuda_device)
    counts = (tgram.gram.launches, tgram.gram.launches_per_lane, tgram.gram.launches_grouped)
    got = tgram.gram(A32, w)
    torch.cuda.synchronize()
    assert (tgram.gram.launches, tgram.gram.launches_per_lane, tgram.gram.launches_grouped) == (
        counts[0] + 1, counts[1], counts[2] + 1
    )
    assert got.shape == (G, L, m, m)
    plain = tgram.gram_reference(A32, w)
    Aw = A32.double()[:, None] * w.double()[..., None, :]
    want = Aw @ Aw.mT
    bound = Aw.abs() @ Aw.abs().mT
    del Aw
    scale = want.abs().amax(dim=(-2, -1), keepdim=True)
    assert ((got.double() - want).abs() <= 1e-5 * scale).all()
    assert _entry_rel_err(got, want, bound) <= 4 * _entry_rel_err(plain, want, bound)
    assert torch.equal(got, got.mT)
    # lane (g, l) is the shared form of A32[g] with w[g, l], bit for bit, on
    # the same path with k cut as in the batch
    splits = tgram._plan(G * L, m, n, _sms(cuda_device))
    for g, lane in ((0, 0), (G // 2, L // 2), (G - 1, L - 1)):
        one = tgram._launch(A32[g].contiguous(), w[g, lane : lane + 1].contiguous(), tgram.bf16_exact(A32), splits)
        assert torch.equal(got[g, lane], one[0])


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,n", [(1, 200, 1280), (2, 200, 1280), (1, 504, 5504), (2, 504, 5504)])
@pytest.mark.parametrize("exact", [True, False], ids=["bf16x3", "bf16x6"])
@pytest.mark.parametrize("form", ["shared", "per_lane"])
def test_gram_kernel_small_b_on_card(cuda_device, form, exact, B, m, n):
    """One or two lanes: split-k, on an A exact in bf16 (0/+-1, the
    three-product path) and on a general f32 A (uniform in [-1, 1], the
    six-product path); a repeated call gives the same bits."""
    rng = np.random.default_rng(B + m + n + exact)
    a_shape = (B, m, n) if form == "per_lane" else (m, n)
    A = rng.integers(-1, 2, size=a_shape) if exact else rng.uniform(-1.0, 1.0, size=a_shape)
    A32 = torch.from_numpy(A.astype(np.float32)).to(cuda_device)
    w = np.sqrt(10.0 ** rng.uniform(-12, 6, size=(B, n)))
    w = torch.from_numpy(w.astype(np.float32)).to(cuda_device)
    assert tgram.bf16_exact(A32) == exact
    assert tgram._plan(B, m, n, _sms(cuda_device)) > 1
    counters = ("launches", "launches_bf16x3", "launches_split_k", "launches_per_lane")
    before = [getattr(tgram.gram, c) for c in counters]
    got = tgram.gram(A32, w)
    torch.cuda.synchronize()
    after = [getattr(tgram.gram, c) for c in counters]
    assert [a - b for a, b in zip(after, before)] == [1, int(exact), 1, int(form == "per_lane")]
    plain = tgram.gram_reference(A32, w)
    Aw = (A32.double() if form == "per_lane" else A32.double()[None]) * w.double()[:, None]
    want = Aw @ Aw.mT
    bound = Aw.abs() @ Aw.abs().mT
    scale = want.abs().max().item()
    assert (got.double() - want).abs().max().item() <= 1e-5 * scale
    assert (got - plain).abs().max().item() <= 1e-5 * scale
    assert _entry_rel_err(got, want, bound) <= 4 * _entry_rel_err(plain, want, bound)
    assert torch.equal(got, got.mT)
    assert torch.equal(got, tgram.gram(A32, w)), "split-k sums in a fixed order"
    # the same path in one pass (no split) is held to the same gates
    one = tgram._launch(A32, w, exact, 1)
    assert (one - plain).abs().max().item() <= 1e-5 * scale
    assert _entry_rel_err(one, want, bound) <= 4 * _entry_rel_err(plain, want, bound)


@pytest.mark.cuda
def test_grouped_engine_on_card_matches_cpu(cuda_device):
    """Three instance groups of 4 lanes in one grouped solve, on the card
    (one grouped K1 launch per factor) and on the CPU."""
    texts = [synthetic_scp(40, 200, 0.1, s) for s in (1, 4, 6)]
    results = []
    for device in ("cpu", cuda_device):
        batch = st.stack_shared_batches([
            st.make_shared_batch(st.pad_lp(st.parse_scp_text(t), m_pad=40, n_pad=256, device=device), 4)
            for t in texts
        ])
        before = (tgram.gram.launches, tgram.gram.launches_grouped)
        state = st.mehrotra_solve_shared(batch, st.IpmOptions())
        launches = (tgram.gram.launches - before[0], tgram.gram.launches_grouped - before[1])
        obj = torch.sum(batch.c * state.x, dim=-1).cpu().numpy()
        results.append((state.status.cpu().numpy(), state.iterations.cpu().numpy(), obj, launches))
    (cpu_status, cpu_iters, cpu_obj, cpu_launches), (status, iters, obj, launches) = results
    assert cpu_launches == (0, 0)
    assert launches[0] == launches[1] >= int(iters.max()) + 1
    np.testing.assert_array_equal(status, cpu_status)
    assert np.abs(iters - cpu_iters).max() <= 1
    np.testing.assert_allclose(obj, cpu_obj, rtol=1e-8)


@pytest.mark.cuda
def test_per_lane_engine_on_card_matches_cpu(cuda_device):
    texts = [synthetic_scp(40, 200, 0.1, s) for s in range(4)]
    results = []
    for device in ("cpu", cuda_device):
        lp = st.stack_lps([st.pad_lp(st.parse_scp_text(t), m_pad=40, n_pad=256, device=device) for t in texts])
        before = tgram.gram.launches_per_lane
        state = st.mehrotra_solve(lp, st.IpmOptions())
        launches = tgram.gram.launches_per_lane - before
        obj = torch.sum(lp.c * state.x, dim=-1).cpu().numpy()
        results.append((state.status.cpu().numpy(), state.iterations.cpu().numpy(), obj, launches))
    (cpu_status, cpu_iters, cpu_obj, cpu_launches), (status, iters, obj, launches) = results
    assert cpu_launches == 0
    assert launches >= int(iters.max()) + 1
    np.testing.assert_array_equal(status, cpu_status)
    assert np.abs(iters - cpu_iters).max() <= 1
    np.testing.assert_allclose(obj, cpu_obj, rtol=1e-8)


@pytest.mark.cuda
def test_slice_on_card_matches_cpu(cuda_device):
    model = st.parse_scp_text(synthetic_scp(40, 200, 0.1, 4))
    results = []
    for device in ("cpu", cuda_device):
        batch = st.make_shared_batch(st.pad_lp(model, device=device), 4)
        before = tgram.gram.launches
        state = st.mehrotra_solve_shared(batch, st.IpmOptions())
        launches = tgram.gram.launches - before
        obj = torch.sum(batch.c * state.x, dim=-1).cpu().numpy()
        results.append((state.status.cpu().numpy(), state.iterations.cpu().numpy(), obj, launches))
    (cpu_status, cpu_iters, cpu_obj, cpu_launches), (status, iters, obj, launches) = results
    assert cpu_launches == 0
    assert launches >= int(iters.max()) + 1
    np.testing.assert_array_equal(status, cpu_status)
    assert np.abs(iters - cpu_iters).max() <= 1
    np.testing.assert_allclose(obj, cpu_obj, rtol=1e-8)


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_is_keyed_by_source_and_flags():
    path = _build.library_path("gram")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libgram_") and path.suffix == ".so"
    assert path == _build.library_path("gram")
