"""Batched column-scaled Gram matrices  M_b = (A_b * w_b) (A_b * w_b)^T.

The per-iteration normal-matrix formation is the IPM's largest FLOP block
(O(B m^2 n) f32).  ``gram`` is the port of the Pallas TPU kernel
``sypha_tpu/ops/pallas_gram.py:pallas_gram``: on a CUDA tensor it launches
the hand-written Hopper kernel in ``sypha_tpu_torch/csrc/gram.cu`` (see the
note there): a SYRK on the bf16 tensor cores that splits each f32 operand
into three bf16 pieces and keeps the six products that carry f32 precision.
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


def gram_reference(A32: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: [m, n] or [B, m, n] f32, [B, n] f32 -> [B, m, m] f32;
    grouped, [G, m, n] and [G, L, n] -> [G, L, m, m] (f32 sums)."""
    if w.ndim == 3:
        Aw = A32[:, None] * w[..., None, :]
        return torch.einsum("glik,gljk->glij", Aw, Aw)
    Aw = A32 * w[:, None, :]
    return torch.einsum("bik,bjk->bij", Aw, Aw)


_load_lock = threading.Lock()
_count_lock = threading.Lock()


@functools.cache
def _bind():
    fn = load_library("gram").sypha_gram_f32
    # A, w, M; B, m, n; A's matrix stride in floats; lanes per matrix;
    # device; stream
    fn.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 3
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def load_kernel():
    """Build the kernel (nvcc, on the first use in a checkout) and bind it.

    Under a lock, so host threads that launch on several devices at once
    (parallel.mesh) build and bind it once."""
    with _load_lock:
        return _bind()


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


def gram(A32: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """M[b, i, j] = sum_k (A[i, k] w[b, k]) (A[j, k] w[b, k]), f32, where A
    is A32 (shared) or A32[b] (per lane); grouped, M[g, l] is the shared
    form of A32[g] with w[g, l].

    A32: [m, n] or [B, m, n] f32 contiguous with w: [B, n] f32 contiguous,
    or A32 [G, m, n] with w [G, L, n] (M [G, L, m, m]); same device.  CUDA
    tensors go through the hand-written kernel in one launch over every
    lane: ``gram.launches`` counts its launches, ``gram.launches_per_lane``
    and ``gram.launches_grouped`` those of them in the per-lane and grouped
    forms, exactly under host threads.  CPU tensors go through
    ``gram_reference``.
    """
    _check(A32, w)
    if A32.device.type == "cpu":
        return gram_reference(A32, w)
    if A32.device.type != "cuda":
        raise ValueError(f"gram runs on cuda or cpu tensors, not {A32.device}")
    m, n = A32.shape[-2:]
    lanes = w.shape[:-1]  # (B,) or (G, L)
    B = lanes.numel()
    a_stride = m * n if A32.ndim == 3 else 0
    lanes_per_matrix = lanes[-1] if w.ndim == 3 else 1
    if B > _MAX_LANES:
        raise ValueError(f"gram takes at most {_MAX_LANES} lanes, got {B}")
    M = torch.empty(lanes + (m, m), dtype=torch.float32, device=A32.device)
    if B == 0 or m == 0:
        return M
    device = A32.device.index if A32.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = load_kernel()(
        A32.data_ptr(), w.data_ptr(), M.data_ptr(), B, m, n, a_stride, lanes_per_matrix,
        device, stream,
    )
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed with CUDA error {err}")
    with _count_lock:
        gram.launches += 1
        gram.launches_per_lane += int(A32.ndim == 3 and w.ndim == 2)
        gram.launches_grouped += int(w.ndim == 3)
    return M


gram.launches = 0
gram.launches_per_lane = 0
gram.launches_grouped = 0
