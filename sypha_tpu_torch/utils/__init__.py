"""Host utilities."""

from sypha_tpu_torch.utils.logging import Logger
from sypha_tpu_torch.utils.timers import PhaseTimers

__all__ = ["Logger", "PhaseTimers"]
