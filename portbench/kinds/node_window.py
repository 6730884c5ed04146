"""The branch and bound's node window: ``solve_node_batch`` over a base built
as the B&B builds it, with the B&B's options.

Set-up builds each instance's base with the B&B's own ``_NodeLpSolver`` (its
bucket, and the operator that its ``node_operator`` and ``node_ell_density``
pick: padded ELL at scp4x density, dense at scpnre's), and uploads a pool of
``fixing_sets`` fixing sets of ``lanes`` lanes per instance.  The pool is
drawn once from a fixed stream, the same for every seed; the seed orders the
instances and each instance's pool, so that every run carries the same work
in another order.  A timed call is one window: ``solve_node_batch`` with the
options the B&B's main loop passes (``newton_max_steps`` at least 48, its
gap-stall window) and ``max_iter`` as the cap, as the B&B runs a window
without a deadline, then one copy of the B&B's results (per-lane scalars and
iterates) to the host.  Windows go round robin over the instances, and over
each instance's pool in turn, closed loop.

The check solves a sample of the distinct windows that ran (``check_windows``
of them, drawn from the seed) with the plain LP reference and judges every
answer those windows gave, each time they ran.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.kinds import control_status, status_names
from portbench.reference import judge, lp
from portbench.traffic.generate import class_instances, rng_for, seeded_fixings

PURPOSE_ORDER, PURPOSE_FIX, PURPOSE_CHECK = 1, 2, 3


class NodeWindows:
    def __init__(self, config, traffic, seed, device):
        from sypha_tpu_torch.config import SolverConfig
        from sypha_tpu_torch.io.scp_reader import parse_scp_text
        from sypha_tpu_torch.milp.base_model import BaseModel
        from sypha_tpu_torch.milp.bnb import _NodeLpSolver
        from sypha_tpu_torch.utils.logging import Logger

        self.device = torch.device(device)
        self.seed = seed
        names = config["instances"][: traffic["instances"]]
        self.instances = insts = class_instances(config, names)
        order = rng_for(seed, PURPOSE_ORDER)
        self.order = order.permutation(len(insts))
        cfg = SolverConfig()
        bnb = cfg.bnb
        # the options of the B&B's node windows (milp/bnb.py: ipm_opts, full_opts)
        self.opts = cfg.ipm.replace(
            newton_max_steps=max(cfg.ipm.newton_max_steps, 48),
            gap_stall_window=bnb.gap_stall_branch_iters,
            gap_stall_min_improv=bnb.gap_stall_min_improv_pct / 100.0,
        )
        self.lanes = int(traffic["lanes"])
        self.sets = int(traffic["fixing_sets"])
        self.check_windows = int(traffic["check_windows"])
        rng = rng_for(0, PURPOSE_FIX)  # the pool: the same for every seed
        self.set_order = order.permutation(self.sets)
        self.bases, self.pool, self.drawn = [], [], {}
        for i, inst in enumerate(insts):
            solver = _NodeLpSolver(BaseModel(parse_scp_text(inst.text(), inst.name)), cfg,
                                   Logger(verbosity=0), device=self.device)
            solver._rebuild_device_base()
            base = solver._device_base
            f0, f1 = [], []
            for s in range(self.sets):
                a, b = seeded_fixings(rng, self.lanes, inst.ncols, base.n_pad)
                a = np.maximum(a, solver._inactive)  # presolve-masked columns, as the B&B
                f0.append(a)
                f1.append(b)
                self.drawn[(i, s)] = (a[:, : inst.ncols] > 0.5, b[:, : inst.ncols] > 0.5)
            self.pool.append((torch.as_tensor(np.stack(f0), device=self.device),
                              torch.as_tensor(np.stack(f1), device=self.device)))
            self.bases.append(base)
        self.k = 0
        self.answers = []  # (instance, set, status names, pobj, dobj, res_d)

    def _window(self, i, s, iter_limit):
        from sypha_tpu_torch.ipm.node_batch import solve_node_batch

        fix0, fix1 = self.pool[i]
        st, x_full, pobj, dobj = solve_node_batch(
            self.bases[i], fix0[s], fix1[s], self.opts, None, None, iter_limit
        )
        # the B&B's one copy to the host (milp/bnb.py: _to_host)
        lanes = [st.status, st.iterations, st.gap, st.res_d, pobj, dobj]
        packed = torch.cat(
            [torch.stack([v.to(torch.float64) for v in lanes], dim=1), x_full, st.y, st.x, st.s],
            dim=1,
        ).cpu().numpy()
        return packed[:, :6]

    def warm(self):
        for i in range(len(self.instances)):
            self._window(i, 0, 2)

    def call(self) -> dict:
        n = len(self.instances)
        i, s = self.order[self.k % n], self.set_order[(self.k // n) % self.sets]
        self.k += 1
        h = self._window(i, s, self.opts.max_iter)
        self.answers.append((i, s, status_names(h[:, 0]), h[:, 4], h[:, 5], h[:, 3]))
        return {"lanes": self.lanes, "ipm_iters": int(h[:, 1].max()), "instance": int(i)}

    def release(self):
        self.bases = self.pool = None

    def _sample(self):
        keys = sorted({(int(i), int(s)) for i, s, *_ in self.answers})
        pick = rng_for(self.seed, PURPOSE_CHECK).permutation(len(keys))[: self.check_windows]
        return [keys[p] for p in sorted(pick)]

    def _reference(self, keys, dtype=torch.float64):
        out = {}
        for i, s in keys:
            inst = self.instances[i]
            f0, f1 = self.drawn[(i, s)]
            out[(i, s)] = lp.solve(inst.dense, inst.costs, f0, f1, dtype=dtype, device=self.device)
        return out

    def check(self, limits):
        """(numbers, attempted, failed): every answer of the sampled windows
        judged; a window fails where one of its answers is wrong."""
        ref = self._reference(self._sample())
        cols = [[] for _ in range(6)]
        failed = 0
        for i, s, st, pobj, dobj, res_d in self.answers:
            r = ref.get((int(i), int(s)))
            if r is None:
                continue
            for c, v in zip(cols, (st, pobj, dobj, res_d, r["z"], r["feasible"])):
                c.extend(v)
            one = judge.lp_numbers(st, pobj, dobj, res_d, r["z"], r["feasible"])
            failed += int(not one["answer_err"] <= limits["answer_err"]["max"])
        return judge.lp_numbers(*[np.asarray(c) for c in cols]), len(self.answers), failed

    def control(self, rule="claims", dtype=torch.float32):
        """The numbers of the reference in ``dtype``, put in the program's
        place on the sampled windows, its statuses by ``rule``
        (``kinds.control_status``)."""
        keys = self._sample()
        ref = self._reference(keys)
        low = self._reference(keys, dtype=dtype)
        cols = [[] for _ in range(6)]
        for key in keys:
            a, r = low[key], ref[key]
            st = control_status(a, rule)
            for c, v in zip(cols, (st, a["z"], a["dobj"], a["res_d"], r["z"], r["feasible"])):
                c.extend(v)
        return judge.lp_numbers(*[np.asarray(c) for c in cols])

    def statuses(self):
        """Answers by status, over the window."""
        from collections import Counter

        return Counter(x for a in self.answers for x in a[2])


def setup(config, traffic, seed, device):
    return NodeWindows(config, traffic, seed, device)
