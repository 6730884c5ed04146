"""Batched column-scaled Gram matrices  M_b = (A_b * w_b) (A_b * w_b)^T.

The per-iteration normal-matrix formation is the IPM's largest FLOP block
(O(B m^2 n) f32).  ``gram`` is the port of the Pallas TPU kernel
``sypha_tpu/ops/pallas_gram.py:pallas_gram``: on a CUDA tensor it launches
the hand-written Hopper kernel in ``sypha_tpu_torch/csrc/gram.cu`` (see the
note there), a SYRK on the bf16 tensor cores that carries f32 precision by
one of two exact splits:

- bf16x6, any f32 A: each operand A w is split into three bf16 pieces and
  the six products that carry f32 precision are kept;
- bf16x3, when every entry of A equals its bf16 rounding (``bf16_exact``:
  the 0/+-1 rows of an SCP standard form, small-integer cut rows): A is one
  bf16 operand and only u = A w^2 is split, three products, none dropped.
  Half the MMAs and about half the split work of bf16x6.

Where the lanes' lower 64 x 64 tiles would not fill a wave of the card (one
or two lanes at the main path's widths), ``_plan`` cuts the k range into
slices (split-k): each slice's CTAs write partial tiles to a workspace taken
here from torch's caching allocator on the caller's stream, and a second
kernel sums them in a fixed order, so the bits do not change from call to
call.  Elsewhere one pass writes M, as before split-k existed.

It applies the column scale while staging tiles of A, so the [B, m, n]
``Aw`` temporary that the JAX path built never exists.  ``A`` is one matrix
shared by every lane ([m, n], the shared-matrix IPM), one per lane
([B, m, n], the per-lane IPM, the Pallas kernel's own contract), or one per
instance group of L lanes (A [G, m, n] with w [G, L, n], the grouped
shared-matrix IPM: the Pallas kernel under ``jax.vmap`` over groups).  On a
CPU tensor it computes the same product with ``gram_reference``, the plain
PyTorch version.  There is no fallback from the kernel to the plain version
on the card.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from sypha_tpu_torch.ops._build import load_library

# the kernel's lane axis is gridDim.y (G L lanes in the grouped form)
_MAX_LANES = 65535
# gram.cu's output tile edge and k values staged per pipeline step
_TILE = 64
_CHUNK = 16
# split-k: below two CTAs a SM the k range is cut, into slices of at least
# _MIN_CHUNKS chunks (the cp.async pipeline runs two chunks ahead) and, where
# n allows, at most _MAX_CHUNKS (no CTA walks a long serial chain)
_CTAS_PER_SM = 2
_MIN_CHUNKS = 8
_MAX_CHUNKS = 64


def gram_reference(A32: torch.Tensor, w: torch.Tensor, *, a_bf16_exact: bool | None = None) -> torch.Tensor:
    """Plain version: [m, n] or [B, m, n] f32, [B, n] f32 -> [B, m, m] f32;
    grouped, [G, m, n] and [G, L, n] -> [G, L, m, m] (f32 sums).  Takes
    ``gram``'s arguments, so it can stand in for it; ``a_bf16_exact`` does
    not change what it computes."""
    if w.ndim == 3:
        Aw = A32[:, None] * w[..., None, :]
        return torch.einsum("glik,gljk->glij", Aw, Aw)
    Aw = A32 * w[:, None, :]
    return torch.einsum("bik,bjk->bij", Aw, Aw)


def bf16_exact(A32: torch.Tensor) -> bool:
    """Whether every entry of A32 equals its bf16 rounding, so that K1 may
    take its three-product path: one device reduction and one host read.
    The IPMs decide it once per solve, where they make A in the factor
    dtype."""
    return bool(torch.equal(A32, A32.to(torch.bfloat16).to(A32.dtype)))


def _plan(B: int, m: int, n: int, sms: int) -> int:
    """Slices of the k range (split-k) for one launch over B lanes of an
    m x m Gram over n columns on a card with ``sms`` SMs.

    1 where the lanes' lower tiles (B T(T+1)/2 CTAs, T = ceil(m / 64))
    already give every SM ``_CTAS_PER_SM`` of them, or n is too short to
    cut.  Otherwise enough slices for that (about one or two waves of the
    card), or more where a slice would keep over ``_MAX_CHUNKS`` of the
    ceil(n / 16) chunks, and never so many that one keeps fewer than
    ``_MIN_CHUNKS``."""
    t = -(-m // _TILE)
    ctas = B * t * (t + 1) // 2
    target = _CTAS_PER_SM * sms
    if ctas == 0 or ctas >= target:
        return 1
    chunks = -(-n // _CHUNK)
    splits = max(-(-target // ctas), -(-chunks // _MAX_CHUNKS))
    return max(1, min(splits, chunks // _MIN_CHUNKS))


_load_lock = threading.Lock()
_count_lock = threading.Lock()


@functools.cache
def _bind():
    fn = load_library("gram").sypha_gram_f32
    # A, w, M, workspace; B, m, n; A's matrix stride in floats; lanes per
    # matrix; splits; bf16x3; device; stream
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 3
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def load_kernel():
    """Build the kernel (nvcc, on the first use in a checkout) and bind it.

    Under a lock, so host threads that launch on several devices at once
    (parallel.mesh) build and bind it once."""
    with _load_lock:
        return _bind()


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(A32: torch.Tensor, w: torch.Tensor):
    if A32.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"gram takes float32 tensors, got {A32.dtype} and {w.dtype}")
    shared = A32.ndim == 2 and w.ndim == 2 and A32.shape[1] == w.shape[1]
    per_lane = A32.ndim == 3 and w.ndim == 2 and A32.shape[::2] == w.shape
    grouped = A32.ndim == 3 and w.ndim == 3 and A32.shape[::2] == w.shape[::2]
    if not (shared or per_lane or grouped):
        raise ValueError(
            f"gram takes A32 [m, n] or [B, m, n] with w [B, n], or A32 [G, m, n] with w "
            f"[G, L, n], got {tuple(A32.shape)} and {tuple(w.shape)}"
        )
    if A32.device != w.device:
        raise ValueError(f"gram operands on different devices: {A32.device}, {w.device}")
    if not (A32.is_contiguous() and w.is_contiguous()):
        raise ValueError("gram takes contiguous tensors")


def gram(A32: torch.Tensor, w: torch.Tensor, *, a_bf16_exact: bool | None = None) -> torch.Tensor:
    """M[b, i, j] = sum_k (A[i, k] w[b, k]) (A[j, k] w[b, k]), f32, where A
    is A32 (shared) or A32[b] (per lane); grouped, M[g, l] is the shared
    form of A32[g] with w[g, l].

    A32: [m, n] or [B, m, n] f32 contiguous with w: [B, n] f32 contiguous,
    or A32 [G, m, n] with w [G, L, n] (M [G, L, m, m]); same device.
    ``a_bf16_exact``: ``bf16_exact(A32)``, which the caller may have
    decided once for many calls; None decides it here.  CUDA tensors go
    through the hand-written kernel in one launch over every lane (two with
    split-k): ``gram.launches`` counts its launches, ``launches_per_lane``
    and ``launches_grouped`` those in the per-lane and grouped forms,
    ``launches_bf16x3`` those on the three-product path and
    ``launches_split_k`` those with the k range cut, exactly under host
    threads.  CPU tensors go through ``gram_reference``.
    """
    _check(A32, w)
    if A32.device.type == "cpu":
        return gram_reference(A32, w)
    if A32.device.type != "cuda":
        raise ValueError(f"gram runs on cuda or cpu tensors, not {A32.device}")
    B = w.shape[:-1].numel()
    if B > _MAX_LANES:
        raise ValueError(f"gram takes at most {_MAX_LANES} lanes, got {B}")
    if a_bf16_exact is None:
        a_bf16_exact = bf16_exact(A32)
    device = A32.device.index if A32.device.index is not None else torch.cuda.current_device()
    m, n = A32.shape[-2:]
    return _launch(A32, w, bool(a_bf16_exact), _plan(B, m, n, _sm_count(device)))


def _launch(A32: torch.Tensor, w: torch.Tensor, exact: bool, splits: int) -> torch.Tensor:
    """One kernel call on checked CUDA operands: the bf16x3 path if
    ``exact``, k cut into ``splits`` slices.  ``gram`` picks both; a caller
    that times one path against another passes them itself."""
    m, n = A32.shape[-2:]
    lanes = w.shape[:-1]  # (B,) or (G, L)
    B = lanes.numel()
    a_stride = m * n if A32.ndim == 3 else 0
    lanes_per_matrix = lanes[-1] if w.ndim == 3 else 1
    M = torch.empty(lanes + (m, m), dtype=torch.float32, device=A32.device)
    if B == 0 or m == 0:
        return M
    device = A32.device.index if A32.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    partial = None
    if splits > 1:
        # on the current stream of A32's device, as M: a lane-shard thread
        # (parallel.mesh) gets its own block
        t = -(-m // _TILE)
        partial = torch.empty(
            (splits, B, t * (t + 1) // 2, _TILE, _TILE), dtype=torch.float32, device=A32.device
        )
    err = load_kernel()(
        A32.data_ptr(), w.data_ptr(), M.data_ptr(), 0 if partial is None else partial.data_ptr(),
        B, m, n, a_stride, lanes_per_matrix, splits, int(exact), device, stream,
    )
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed with CUDA error {err}")
    with _count_lock:
        gram.launches += 1
        gram.launches_per_lane += int(A32.ndim == 3 and w.ndim == 2)
        gram.launches_grouped += int(w.ndim == 3)
        gram.launches_bf16x3 += int(exact)
        gram.launches_split_k += int(splits > 1)
    return M


gram.launches = 0
gram.launches_per_lane = 0
gram.launches_grouped = 0
gram.launches_bf16x3 = 0
gram.launches_split_k = 0
