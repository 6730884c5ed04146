"""Faults planted underneath the timed path, to show that ``correct`` comes
out false for each fault a cell can have.  The benchmark's runs never plant
one; ``calibrate.py --fault`` reads them on the card and the tests at a small
size on the CPU.

``plant(fault, kind)`` patches the port and returns a function that undoes
it.  For ``node_window``: ``state_unchanged`` (every IPM step has length 0,
so the iterate never moves), ``half_batch`` (half the lanes left out of the
solve, their answers those of the other half), ``answer_altered`` (one
lane's dual objective moved where it is produced).  For ``bnb``:
``state_unchanged`` (every node window returns its nodes unsolved, the B&B's
own failed-window answer) and ``answer_altered`` (the objective reported one
less than the cover's cost).
"""

from __future__ import annotations

import torch

FAULTS = {
    "node_window": ("state_unchanged", "half_batch", "answer_altered"),
    "bnb": ("state_unchanged", "answer_altered"),
}


def _patch(obj, attr, new):
    old = getattr(obj, attr)
    setattr(obj, attr, new)
    return lambda: setattr(obj, attr, old)


def plant(fault: str, kind: str):
    if fault not in FAULTS.get(kind, ()):
        raise ValueError(f"no fault {fault!r} for kind {kind!r}")
    from sypha_tpu_torch.ipm import node_batch, shared
    from sypha_tpu_torch.milp import bnb

    if kind == "bnb":
        if fault == "state_unchanged":
            return _patch(bnb._NodeLpSolver, "solve_nodes",
                          lambda self, nodes, *a, **k: self._failed_window(nodes))
        orig_bnb = bnb.branch_and_bound

        def altered_bnb(*a, **k):
            res = orig_bnb(*a, **k)
            res.objective -= 1.0
            return res

        return _patch(bnb, "branch_and_bound", altered_bnb)
    if fault == "state_unchanged":
        return _patch(shared, "_alpha_max_batch",
                      lambda v, dv: torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device))
    orig = node_batch.solve_node_batch

    def wrong(base, fix0, fix1, opts, *a):
        if fault == "half_batch":
            h = fix0.shape[0] // 2
            st, x, p, d = orig(base, fix0[:h], fix1[:h], opts, *a)
            cat = lambda t: torch.cat([t, t], dim=0)  # noqa: E731
            st = type(st)(**{f: cat(getattr(st, f)) for f in st.__dataclass_fields__})
            return st, cat(x), cat(p), cat(d)
        st, x, p, d = orig(base, fix0, fix1, opts, *a)
        d = d.clone()
        d[0] += 1e-3 * (1.0 + d[0].abs())
        return st, x, p, d

    return _patch(node_batch, "solve_node_batch", wrong)
