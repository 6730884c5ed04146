"""Branch and bound to a proven optimum, one instance after another.

Set-up parses ``instances`` instances of the class and orders them by the
seed.  A timed call is one whole ``branch_and_bound`` with default options
but a hard time limit of ``hard_time_limit_sec`` and the given
``verbosity``: its own presolve, heuristics, warm-up, root, cuts, closure and
tree, as a user of the API pays for it.  Calls go round the instances in that
order, closed loop.  Set-up warms up with one solve of the class's first
instance, whatever the seed, so that every seed's set-up does the same work.

The check holds every solve's cover to the instance (every row covered, the
cost equal to the objective) and its objective to the optimum of the plain
MILP reference, solved once per instance from the reference's own first
cover, never from the program's; a solve that ends without status OPTIMAL
fails.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import judge, milp
from portbench.traffic.generate import class_instances, rng_for

PURPOSE_ORDER = 1


class Bnb:
    def __init__(self, config, traffic, seed, device):
        from sypha_tpu_torch.config import SolverConfig
        from sypha_tpu_torch.io.scp_reader import parse_scp_text

        self.device = torch.device(device)
        insts = class_instances(config, config["instances"][: traffic["instances"]])
        self.instances = [insts[i] for i in rng_for(seed, PURPOSE_ORDER).permutation(len(insts))]
        self.models = [parse_scp_text(inst.text(), inst.name) for inst in self.instances]
        self.warm_model = parse_scp_text(insts[0].text(), insts[0].name)
        cfg = SolverConfig(verbosity=int(traffic["verbosity"]))
        self.cfg = cfg.replace(bnb=cfg.bnb.replace(hard_time_limit_sec=float(traffic["hard_time_limit_sec"])))
        self.k = 0
        self.solves = []

    def _solve(self, model):
        from sypha_tpu_torch.milp.bnb import branch_and_bound

        return branch_and_bound(model, self.cfg, device=self.device)

    def warm(self):
        self._solve(self.warm_model)

    def call(self) -> dict:
        i = self.k % len(self.instances)
        self.k += 1
        res = self._solve(self.models[i])
        self.solves.append({
            "instance": i,
            "status": res.status.name.lower(),
            "objective": float(res.objective),
            "cover": np.asarray(res.solution, dtype=np.float64),
        })
        return {"lanes": 0, "ipm_iters": None, "instance": i}

    def release(self):
        self.models = self.warm_model = None

    def _judged(self, solves):
        out = []
        for s in solves:
            inst = self.instances[s["instance"]]
            out.append(dict(s, A=inst.dense, costs=inst.costs.astype(np.float64)))
        return out

    def _optima(self, solves):
        """The reference optimum of every instance solved, found from the
        reference's own first cover: nothing the program answered goes in."""
        optima = {}
        for i in sorted({s["instance"] for s in solves}):
            inst = self.instances[i]
            A, c = inst.dense, inst.costs.astype(np.float64)
            start = milp.first_cover(A, c, device=self.device)[0]
            opt, _, proven, _ = milp.optimum(A, c, start, device=self.device)
            optima[i] = (opt, proven)
        return optima

    def check(self, limits):
        """(numbers, attempted, failed): every solve judged; a solve fails
        where one of its numbers is over its limit."""
        judged = self._judged(self.solves)
        optima = self._optima(self.solves)
        failed = sum(not judge.verdict(judge.milp_numbers([s], optima), limits)[1] for s in judged)
        return judge.milp_numbers(judged, optima), len(self.solves), int(failed)

    def control(self, rule="claims"):
        """The reference's root cover put in the program's place, claimed
        optimal: the B&B's guarantee of a proven optimum broken."""
        fake = []
        for i, inst in enumerate(self.instances):
            x, cost = milp.first_cover(inst.dense, inst.costs.astype(np.float64), device=self.device)
            fake.append({"instance": i, "status": "optimal", "objective": cost, "cover": x.astype(np.float64)})
        return judge.milp_numbers(self._judged(fake), self._optima(fake))


def setup(config, traffic, seed, device):
    return Bnb(config, traffic, seed, device)
