"""Termination statuses, with the integer values of sypha_tpu/core/status.py."""

import enum


class IpmStatus(enum.IntEnum):
    RUNNING = 0
    CONVERGED = 1
    MAX_ITER = 2
    GAP_STALLED = 3
    INFEASIBLE_OR_NUMERICAL = 4
    TIME_LIMIT = 5


class MilpStatus(enum.IntEnum):
    OPTIMAL = 0
    FEASIBLE = 1
    INFEASIBLE = 2
    NOT_SOLVED = 3
    ABNORMAL = 4
