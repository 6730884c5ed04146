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
