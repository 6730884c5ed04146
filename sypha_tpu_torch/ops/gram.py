"""Batched column-scaled Gram matrices  M_b = (A * w_b) (A * w_b)^T.

The per-iteration normal-matrix formation is the IPM's largest FLOP block
(O(B m^2 n) f32).  ``gram`` is the port of the Pallas TPU kernel
``sypha_tpu/ops/pallas_gram.py:pallas_gram``: on a CUDA tensor it launches
the hand-written Hopper kernel in ``sypha_tpu_torch/csrc/gram.cu`` (see the
note there): a SYRK on the bf16 tensor cores that splits each f32 operand
into three bf16 pieces and keeps the six products that carry f32 precision.
It applies the column scale while staging tiles of A, so the [B, m, n]
``Aw`` temporary that the JAX path built never exists.  On a CPU
tensor it computes the same product with ``gram_reference``, the plain
PyTorch version.  There is no fallback from the kernel to the plain version
on the card.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from sypha_tpu_torch.ops._build import load_library

# the kernel's lane axis is gridDim.y
_MAX_LANES = 65535


def gram_reference(A32: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: [m, n] f32, [B, n] f32 -> [B, m, m] f32 (f32 sums)."""
    Aw = A32[None, :, :] * w[:, None, :]
    return torch.einsum("bik,bjk->bij", Aw, Aw)


_load_lock = threading.Lock()
_count_lock = threading.Lock()


@functools.cache
def _bind():
    fn = load_library("gram").sypha_gram_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
    if A32.ndim != 2 or w.ndim != 2 or A32.shape[1] != w.shape[1]:
        raise ValueError(
            f"gram takes A32 [m, n] and w [B, n], got {tuple(A32.shape)} and {tuple(w.shape)}"
        )
    if A32.device != w.device:
        raise ValueError(f"gram operands on different devices: {A32.device}, {w.device}")
    if not (A32.is_contiguous() and w.is_contiguous()):
        raise ValueError("gram takes contiguous tensors")


def gram(A32: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """M[b, i, j] = sum_k (A32[i, k] w[b, k]) (A32[j, k] w[b, k]), f32.

    A32: [m, n] f32 contiguous; w: [B, n] f32 contiguous, same device.
    CUDA tensors go through the hand-written kernel (``gram.launches`` counts
    its launches, exactly under host threads); CPU tensors through
    ``gram_reference``.
    """
    _check(A32, w)
    if A32.device.type == "cpu":
        return gram_reference(A32, w)
    if A32.device.type != "cuda":
        raise ValueError(f"gram runs on cuda or cpu tensors, not {A32.device}")
    B, n = w.shape
    m = A32.shape[0]
    if B > _MAX_LANES:
        raise ValueError(f"gram takes at most {_MAX_LANES} lanes, got {B}")
    M = torch.empty((B, m, m), dtype=torch.float32, device=A32.device)
    if B == 0 or m == 0:
        return M
    device = A32.device.index if A32.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = load_kernel()(A32.data_ptr(), w.data_ptr(), M.data_ptr(), B, m, n, device, stream)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed with CUDA error {err}")
    with _count_lock:
        gram.launches += 1
    return M


gram.launches = 0
