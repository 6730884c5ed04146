"""Device telemetry and profiler hooks: the port of sypha_tpu/utils/telemetry.py.

``device_memory_stats`` reads the CUDA caching allocator
(``torch.cuda.memory_stats``) and the driver's view of the card
(``torch.cuda.mem_get_info``); it returns None for a CPU device, as the JAX
package does.  ``profile_trace`` records a ``torch.profiler`` trace
(viewable in TensorBoard or Perfetto).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, Optional

import torch


@dataclass
class DeviceMemoryStats:
    bytes_in_use: int = 0
    peak_bytes_in_use: int = 0
    bytes_limit: int = 0

    @property
    def free_bytes(self) -> int:
        return max(0, self.bytes_limit - self.bytes_in_use)

    def __str__(self) -> str:
        gb = 1 << 30
        return (
            f"in_use={self.bytes_in_use / gb:.3f}GiB "
            f"peak={self.peak_bytes_in_use / gb:.3f}GiB "
            f"limit={self.bytes_limit / gb:.3f}GiB"
        )


def device_memory_stats(device=None) -> Optional[DeviceMemoryStats]:
    """Memory stats of a CUDA device (default: the current one); None on a
    CPU device or when no CUDA device is available.  ``bytes_limit`` is the
    card's total memory."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return DeviceMemoryStats(
        bytes_in_use=int(stats.get("allocated_bytes.all.current", 0)),
        peak_bytes_in_use=int(stats.get("allocated_bytes.all.peak", 0)),
        bytes_limit=int(total),
    )


class MemorySampler:
    """Before/after sampling of device memory around a solver phase."""

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = device
        self.before: Optional[DeviceMemoryStats] = None
        self.after: Optional[DeviceMemoryStats] = None

    def __enter__(self) -> "MemorySampler":
        if self.enabled:
            self.before = device_memory_stats(self.device)
        return self

    def __exit__(self, *exc) -> None:
        if self.enabled:
            self.after = device_memory_stats(self.device)

    def report(self) -> str:
        if not self.enabled or self.before is None or self.after is None:
            return "memory sampling unavailable"
        return f"before: {self.before} | after: {self.after}"


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """torch.profiler trace of the host and, where there is one, the CUDA
    device, written into ``log_dir`` when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield
