"""Leveled, colored, elapsed-stamped logging + wall-clock watchdog.

Counterpart of the reference's SyphaLogger (src/sypha_logger.cpp): colored
``[elapsed] [LEVEL] msg`` lines, verbosity->level mapping
(src/sypha_environment.cpp:25-34), and the hard-time-limit watchdog the
logger thread doubles as (src/sypha_logger.cpp:139-146).  Python logging is
synchronous (host logging is never on the device hot path here, so the
reference's async queue buys nothing).
"""

from __future__ import annotations

import sys
import time


_LEVELS = {"TRACE": 5, "DEBUG": 4, "INFO": 3, "WARN": 2, "ERROR": 1}
_COLORS = {
    "TRACE": "\033[90m",
    "DEBUG": "\033[36m",
    "INFO": "\033[0m",
    "WARN": "\033[33m",
    "ERROR": "\033[31m",
}
_RESET = "\033[0m"


class Logger:
    """verbosity: 0 silent .. 5 trace (reference mapping)."""

    def __init__(self, verbosity: int = 3, stream=None, color: bool = True,
                 hard_time_limit_sec: float = 0.0):
        self.verbosity = verbosity
        self.stream = stream or sys.stderr
        self.color = color and hasattr(self.stream, "isatty") and self.stream.isatty()
        self.t0 = time.monotonic()
        self.hard_time_limit_sec = hard_time_limit_sec
        self._stop = False

    def request_stop(self) -> None:
        """Asynchronously request termination (the reference's atomic
        stopRequested_ flag, settable from any thread / signal handler);
        the B&B driver honors it between node windows and — via chunked
        dispatches — between iteration chunks of a running solve."""
        self._stop = True

    def is_stop_requested(self) -> bool:
        """Watchdog: true once the hard wall-clock limit has elapsed or a
        stop was requested (reference SyphaLogger::isStopRequested)."""
        return self._stop or (
            self.hard_time_limit_sec > 0
            and (time.monotonic() - self.t0) >= self.hard_time_limit_sec
        )

    def log(self, level: str, msg: str):
        if _LEVELS.get(level, 3) > self.verbosity:
            return
        elapsed = time.monotonic() - self.t0
        line = f"[{elapsed:9.3f}] [{level:5s}] {msg}"
        if self.color:
            line = _COLORS.get(level, "") + line + _RESET
        print(line, file=self.stream)

    def trace(self, msg: str):
        self.log("TRACE", msg)

    def debug(self, msg: str):
        self.log("DEBUG", msg)

    def info(self, msg: str):
        self.log("INFO", msg)

    def warn(self, msg: str):
        self.log("WARN", msg)

    def error(self, msg: str):
        self.log("ERROR", msg)
