"""Entry points of the port: the main path as one function of tensors, and
a multi-device dry run.  The port of __graft_entry__.py."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from sypha_tpu_torch.config import IpmOptions, SolverConfig
from sypha_tpu_torch.core.status import IpmStatus, MilpStatus
from sypha_tpu_torch.io.scp_reader import parse_scp_text
from sypha_tpu_torch.io.standard_form import pad_lp, stack_lps
from sypha_tpu_torch.ipm.driver import solve_lp_batch
from sypha_tpu_torch.ipm.shared import fix_columns, make_shared_batch, make_shared_batch_sparse
from sypha_tpu_torch.milp.bnb import branch_and_bound
from sypha_tpu_torch.parallel.distributed import run_spmd
from sypha_tpu_torch.parallel.mesh import (
    make_mesh,
    solve_lp_batch_sharded,
    solve_shared_batch_sharded,
    solve_shared_batch_tensor_parallel,
)
from sypha_tpu_torch.testing import synthetic_scp

TINY = "3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n"


def _tiny_batch(B: int, device):
    """A stacked batch of B padded (8 x 128) tiny SCP LPs whose costs vary
    by lane."""
    lps = []
    for i in range(B):
        model = parse_scp_text(TINY, name=f"tiny{i}")
        model.costs = model.costs + (i % 3)
        lps.append(pad_lp(model, m_pad=8, n_pad=128, device=device))
    return stack_lps(lps)


def entry(device: torch.device | str | None = None):
    """(fn, example_args): the batched IPM solve of the main path, tensors in
    and out, on ``device`` (``cuda`` by default; raises without a card).

    One call of ``fn`` is a whole batched Mehrotra solve of four tiny LPs
    with ``max_iter=8``, returning (x, status, gap)."""
    opts = IpmOptions(max_iter=8)
    lp = _tiny_batch(4, device)

    def fn(lp):
        st = solve_lp_batch(lp, opts, as_results=False)
        return st.x, st.status, st.gap

    return fn, (lp,)


def _tp_legs(max_iter: int, devices):
    """Legs 3 and 3b on one rank, on ``devices[rank]``: the tiny LP's column
    axis split over the ranks, on the dense and on the ELL operator.
    Returns each leg's statuses and worst gap."""
    dev = torch.device(devices[dist.get_rank()])
    base = parse_scp_text(TINY, name="tiny")
    opts = IpmOptions(max_iter=max_iter)
    out = {}
    for leg, batch in (
        ("dense", make_shared_batch(pad_lp(base, m_pad=8, n_pad=128, device=dev), 2)),
        ("ell", make_shared_batch_sparse(base, 2, m_pad=8, n_pad=128, device=dev)),
    ):
        st = solve_shared_batch_tensor_parallel(batch, opts)
        out[leg] = (st.status.cpu().tolist(), float(st.gap.max()))
    return out


def dryrun_multichip(
    n_devices: int,
    devices=None,
    device: torch.device | str | None = None,
) -> None:
    """Run the port's multi-device paths over a mesh of ``n_devices``:

    1. the shared-matrix B&B node window, lane-sharded: A copied to every
       device, per-lane branch fixings, pooled scalar statistics;
    2. the batch of independent LPs (per-lane A), lane-sharded;
    3. tensor parallelism: one LP's column axis split over ``n_devices``
       ranks of a process group (spawned here), on the dense operator and
       (3b) on the padded-ELL one;
    4. the B&B driver with every node window lane-sharded over the mesh, on
       a seeded scp4x-class instance whose LP optimum (458.5) lies below its
       integer optimum (460), exact closure and cuts off, so that it
       branches.

    ``devices`` lists the mesh's devices (they may repeat: two shards on one
    card); else ``device`` (``cuda`` by default) gives ``make_mesh``'s.
    The ranks of leg 3 use ``nccl`` when every device is a card of its own,
    else ``gloo``.  Any failed check raises.
    """
    mesh = make_mesh(n_devices, device=device, devices=devices)
    dev0 = mesh.devices[0]
    opts = IpmOptions(max_iter=6)
    lanes = 2 * n_devices

    # --- 1. shared-matrix node window (the B&B hot path), lane-sharded ---
    base = parse_scp_text(TINY, name="tiny")
    lp1 = pad_lp(base, m_pad=8, n_pad=128, device=dev0)
    fix0 = np.zeros((lanes, 128))
    fix1 = np.zeros((lanes, 128))
    for i in range(lanes):  # lane i fixes variable i % 4 to i % 2
        (fix1 if i % 2 else fix0)[i, i % 4] = 1.0
    batch = fix_columns(make_shared_batch(lp1, lanes), fix0, fix1)
    st, (worst_gap, max_iters, n_conv, min_dual) = solve_shared_batch_sharded(batch, opts, mesh)
    if tuple(st.gap.shape) != (lanes,) or not np.isfinite(float(min_dual)):
        raise RuntimeError(f"dryrun leg 1: gap shape {tuple(st.gap.shape)}, min dual {float(min_dual)}")
    print(
        f"dryrun_multichip({n_devices}) shared-A node window: {int(n_conv)}/{lanes} lanes "
        f"converged, pooled dual bound {float(min_dual):.3f}, worst gap {float(worst_gap):.2e}"
    )

    # --- 2. per-lane-A batched instances, lane-sharded ---
    st, (worst_gap, max_iters, n_conv) = solve_lp_batch_sharded(_tiny_batch(lanes, dev0), opts, mesh)
    if tuple(st.gap.shape) != (lanes,) or not np.isfinite(float(worst_gap)) or int(max_iters) > 6:
        raise RuntimeError(f"dryrun leg 2: worst gap {float(worst_gap)}, max iters {int(max_iters)}")
    print(
        f"dryrun_multichip({n_devices}) per-lane batch: {int(n_conv)}/{lanes} lanes converged, "
        f"worst gap {float(worst_gap):.2e}, max iters {int(max_iters)}"
    )

    # --- 3, 3b. tensor parallelism over n_devices ranks ---
    own_cards = all(d.type == "cuda" for d in mesh.devices) and len(set(mesh.devices)) == n_devices
    names = [str(d) for d in mesh.devices]
    ranks = run_spmd(_tp_legs, names, "nccl" if own_cards else "gloo", args=(6, names))
    for leg in ("dense", "ell"):
        status, gap = ranks[0][leg]
        if any(r[leg] != ranks[0][leg] for r in ranks) or status != [IpmStatus.CONVERGED] * 2:
            raise RuntimeError(f"dryrun leg 3 ({leg}): {[r[leg] for r in ranks]}")
        print(
            f"dryrun_multichip({n_devices}) tensor-parallel ({leg}): 2/2 lanes converged with "
            f"the column axis {n_devices}-way split, worst gap {gap:.2e}"
        )

    # --- 4. the B&B driver with mesh-sharded node windows ---
    model = parse_scp_text(synthetic_scp(200, 1000, 0.02, seed=0), name="syn_scp4x_0")
    cfg = SolverConfig(verbosity=1)
    cfg = cfg.replace(bnb=cfg.bnb.replace(
        max_nodes=192, precompile=False, hard_time_limit_sec=600.0,
        exact_closure=False, cuts_enabled=False,
    ))
    res = branch_and_bound(model, cfg, mesh=mesh, device=dev0)
    # 460 is the instance's integer optimum (scipy's MILP): below it would be unsound
    if (
        res.status not in (MilpStatus.OPTIMAL, MilpStatus.FEASIBLE)
        or not 460.0 - 1e-6 <= res.objective <= 475.0
        or res.nodes_processed <= 0
        or res.total_lp_iterations <= 0
    ):
        raise RuntimeError(f"dryrun leg 4: {res}")
    print(
        f"dryrun_multichip({n_devices}) mesh B&B syn_scp4x_0: {res.status.name} "
        f"obj={res.objective:g} nodes={res.nodes_processed} lp_iters={res.total_lp_iterations}"
    )

