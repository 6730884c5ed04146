"""Phase timers (host wall clock, in milliseconds)."""

from __future__ import annotations

import time
from typing import Dict


class PhaseTimers:
    def __init__(self):
        self._start: Dict[str, float] = {}
        self.elapsed_ms: Dict[str, float] = {}

    def start(self, phase: str):
        self._start[phase] = time.monotonic()

    def stop(self, phase: str):
        if phase in self._start:
            self.elapsed_ms[phase] = (
                self.elapsed_ms.get(phase, 0.0)
                + (time.monotonic() - self._start.pop(phase)) * 1e3
            )

    def report(self) -> str:
        return "\n".join(
            f"TIME {name.upper()}: {ms:.3f}" for name, ms in self.elapsed_ms.items()
        )
