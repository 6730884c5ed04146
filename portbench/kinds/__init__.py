"""Cell kinds: one module per kind of timed call, named by a traffic file's
``kind``.  Each has ``setup(config, traffic, seed, device) -> Cell``; a Cell
has ``warm()``, ``call() -> dict`` (one timed call: ``lanes``, ``ipm_iters``,
``instance``), ``release()`` (frees the program's state once the window has
closed), ``check(limits) -> (numbers, attempted, failed)`` and
``control(rule) -> numbers`` (the plain reference in a lower precision, or
with its guarantee broken, put in the program's place on the same inputs;
``rule`` as in ``control_status``)."""

from __future__ import annotations

STATUS_NAMES = {
    "RUNNING": "running",
    "CONVERGED": "converged",
    "MAX_ITER": "max_iter",
    "GAP_STALLED": "stalled",
    "INFEASIBLE_OR_NUMERICAL": "infeasible",
    "TIME_LIMIT": "max_iter",
}


def status_names(codes):
    """The judge's names for the port's IpmStatus codes."""
    from sypha_tpu_torch.core.status import IpmStatus

    return [STATUS_NAMES[IpmStatus(int(c)).name] for c in codes]


def control_status(ref: dict, rule: str):
    """The statuses of the reference's lanes put in the program's place:
    ``claims`` has every feasible lane claim its optimum; ``program`` applies
    the port's own rule, converged only where the relative gap and both
    residuals are under 1e-8 (``IpmOptions`` tol_gap, tol_feas), else
    stalled."""
    import numpy as np

    if rule == "claims":
        ok = ref["feasible"]
    else:
        ok = ref["feasible"] & (ref["gap"] < 1e-8) & (ref["res_p"] < 1e-8) & (ref["res_d"] < 1e-8)
    return np.where(ok, "converged", np.where(ref["feasible"], "stalled", "infeasible"))
