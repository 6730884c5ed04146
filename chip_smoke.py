#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sypha_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and nvcc; run from the root of a
checkout.  Phases, each printed as it runs:

  1. device: card name and power limit, precision flags, build of the Gram
     kernel from sypha_tpu_torch/csrc/gram.cu;
  2. kernel: the Gram kernel against its plain PyTorch version and an f64
     Gram at seven shapes (one with w over the IPM's full clamp range; the
     last three are the column slabs of phase 8's tensor-parallel ranks and
     the whole scpnrg-class matrix), per entry against |Aw| |Aw|^T, for bit
     symmetry, with CUDA-event times;
  3. slice A: 128 lanes of a seeded scp4x-class LP (200 x 1000, 2%) through
     the reader, pad_lp, make_shared_batch and mehrotra_solve_shared, checked
     against HiGHS, then again with the plain Gram for comparison;
  4. slice B: a 64-lane B&B node window with seeded fixings on a seeded
     scpnre-class LP (500 x 5000, 10%) through solve_node_batch, four lanes
     checked against HiGHS, then again with the plain Gram;
  5. slice C: slice A's instance on the padded-ELL operator, which
     make_shared_batch_auto must pick: 128 lanes against HiGHS and against
     the dense operator, then a 64-lane node window on an ELL base against
     the same window on the dense base, with warm times of both operators;
  6. MILP: branch_and_bound on a seeded scp4x-class instance whose LP
     optimum lies below its integer optimum (found on the CPU with HiGHS):
     (a) the default configuration against scipy's MILP optimum, (b) with
     exact closure and cuts off, so that the tree branches, checked for
     sound bounds; both on the ELL node operator with the Gram kernel;
  7. interfaces, every run on the default device and counted: (a) the CLI
     in process on the scpnre-class LP against HiGHS, the single-LP latency
     of solve_lp at scpnre and scp4x class, K1 at one lane; (b) ``python3 -m
     sypha_tpu_torch`` as a subprocess on phase 6's MILP, with no --device;
     (c) the Solver on each route: the scp4x-class model as an LP and as a
     MILP, a general LP with every row type, maximisation and an offset
     (objective and duals against HiGHS), a knapsack (generic binary) and
     bounded general integers (binarized), against scipy; (d)
     solve_lp_batch over four instances in one 64-lane bucket, one shared
     call per instance, then warm-started from the cold iterates;
  8. multi-device, on the one card: (a) slice B's window through
     solve_node_batch_sharded on a mesh of two shards of cuda:0, bit for bit
     its two halves solved alone, four lanes against HiGHS, K1 launched in
     both shard threads; slice A through solve_shared_batch_sharded, its
     pooled statistics against the gathered state; (c) phase 6's B&B with
     closure and cuts off over that mesh, OPTIMAL at the optimum after
     branching; then two spawned processes sharing the card in one gloo
     group: (b) the tensor-parallel IPM on the scpnre-class LP (2 lanes,
     5504 = 2 x 2752 columns) and the scpnrg-class LP (1000 x 10000, 2%,
     padded 1024 x 11264) on the dense and the ELL operator, against the
     unsharded solve on the card and HiGHS, K1 launched on each rank; (d)
     branch_and_bound in both processes on a planted instance, pooling
     through the BoundPool: both end at 101, rank 1 by the pooled incumbent.

Any failed check raises, and the script exits non-zero; without a CUDA card
it exits non-zero before doing anything.  The last line is the JSON status
object and the line before it the card's name and power limit; the line
before that lists each kernel with its launch count in the slices (slice A
as ``launches``, then slices B and C, the B&B, the API, the in-process
CLI run, the lane-sharded legs and the tensor-parallel ranks), its error
against the plain version, its times against the plain version and the
one-call library einsum, and its bound (the larger of the f32 SYRK's FLOPs
over the f32 peak and its bytes over HBM bandwidth), at the batched shapes
and at the slab shapes.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event-timed calls, after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def entry_rel_err(M, G64, bound) -> float:
    """max_ij |M - G64|_ij / bound_ij; entries with a zero bound must be exact."""
    err = (M.double() - G64).abs()
    pos = bound > 0
    check(bool((err[~pos] == 0).all()), "gram entries with a zero bound are exact")
    return (err[pos] / bound[pos]).max().item()


def highs_objective(model, fix0=None, fix1=None):
    """LP optimum of the SCP relaxation with optional fixings (None if infeasible)."""
    import numpy as np
    from scipy.optimize import linprog

    bounds = [(0, None)] * model.ncols
    if fix0 is not None:
        bounds = [
            (1, 1) if fix1[j] else (0, 0) if fix0[j] else (0, None)
            for j in range(model.ncols)
        ]
    res = linprog(
        model.costs, A_ub=-model.dense_matrix(), b_ub=-np.ones(model.nrows),
        bounds=bounds, method="highs",
    )
    if res.status == 2:
        return None
    check(res.status == 0, f"HiGHS status {res.status}: {res.message}")
    return float(res.fun)


def kernel_phase(torch, gram_mod, dev, card):
    """Phase 2: the Gram kernel against its plain version and an f64 Gram.

    Returns ({label: (kernel ms, plain ms, library ms)}, max abs error vs plain at the
    first three shapes, max per-entry relative error of kernel and plain).
    """
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel_err = entry_err = plain_entry_err = 0.0
    times = {}
    shapes = (
        (128, 200, 1280, "cell A"),
        (64, 504, 5504, "cell B"),
        (3, 37, 301, "ragged"),
        (64, 504, 5504, "full range"),
        (2, 504, 2752, "slab scpnre"),
        (1, 1024, 5632, "slab scpnrg"),
        (1, 1024, 11264, "scpnrg"),
    )
    for B, m, n, label in shapes:
        A32 = torch.randint(-1, 2, (m, n), generator=gen, device=dev).float()
        if label == "full range":
            # w = sqrt(d2), d2 log-uniform over the IPM's clamp [1e-30, 1e30]
            log_d2 = torch.rand((B, n), generator=gen, device=dev, dtype=torch.float64) * 60.0 - 30.0
            w = torch.sqrt(10.0**log_d2).float()
        else:
            w = 10.0 ** (torch.rand((B, n), generator=gen, device=dev) * 9.0 - 6.0)
        M = gram_mod.gram(A32, w)
        plain = gram_mod.gram_reference(A32, w)
        torch.cuda.synchronize()
        Aw = A32.double()[None] * w.double()[:, None]
        G64 = Aw @ Aw.mT
        bound = Aw.abs() @ Aw.abs().mT  # per entry: sum_k |Aw_ik| |Aw_jk|
        del Aw
        scale = G64.abs().max().item()
        err64 = (M.double() - G64).abs().max().item()
        err_plain = (M - plain).abs().max().item()
        check(err64 <= 1e-5 * scale, f"gram vs f64 at {(B, m, n)}: {err64} > 1e-5 * {scale}")
        check(err_plain <= 1e-5 * scale, f"gram vs plain at {(B, m, n)}: {err_plain}")
        check(torch.isfinite(M).all().item(), "gram output finite")
        check(torch.equal(M, M.mT), f"gram output symmetric bit for bit at {(B, m, n)}")
        rel_k = entry_rel_err(M, G64, bound)
        rel_p = entry_rel_err(plain, G64, bound)
        check(rel_k <= 4 * rel_p, f"gram per-entry error at {(B, m, n)}: {rel_k} > 4 x plain {rel_p}")
        del G64, bound
        if label != "full range":  # there the absolute error scales with w^2 ~ 1e30
            kernel_err = max(kernel_err, err_plain)
        entry_err = max(entry_err, rel_k)
        plain_entry_err = max(plain_entry_err, rel_p)
        ms = time_ms(torch, lambda: gram_mod.gram(A32, w))
        plain_ms = time_ms(torch, lambda: gram_mod.gram_reference(A32, w))
        library_ms = time_ms(torch, lambda: gram_library_call(torch, A32, w))
        times[label] = (ms, plain_ms, library_ms)
        print(
            f"[kernel] gram B={B} m={m} n={n} ({label}): max_abs_err vs f64 {err64:.3e} "
            f"(limit {1e-5 * scale:.3e}), vs plain {err_plain:.3e}; per-entry rel err "
            f"{rel_k:.3e} vs plain {rel_p:.3e} (limit 4x); symmetric; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library einsum {library_ms:.4f} ms "
            f"(median of 20) on {card}"
        )
    return times, kernel_err, entry_err, plain_entry_err


def seeded_fixings(rng, lanes, ncols, n_pad):
    """Slice B's style of node fixings: 0..5 columns fixed to 0 and 0..5 to 1."""
    import numpy as np

    fix0 = np.zeros((lanes, n_pad))
    fix1 = np.zeros((lanes, n_pad))
    for lane in range(lanes):
        cols = rng.permutation(ncols)
        k0, k1 = rng.integers(0, 6, size=2)
        fix0[lane, cols[:k0]] = 1.0
        fix1[lane, cols[k0 : k0 + k1]] = 1.0
    return fix0, fix1


def slice_c_phase(torch, st, gram_mod, dev, card, model, highs_obj):
    """Phase 5: the padded-ELL operator on slice A's instance.

    Returns the K1 launches of the ELL solve and the ELL window."""
    import numpy as np

    from sypha_tpu_torch.config import BnbOptions
    from sypha_tpu_torch.io.standard_form import pad_standard_form_ell
    from sypha_tpu_torch.ipm.shared import make_shared_batch_auto

    lanes = 128
    ell = make_shared_batch_auto(model, lanes, device=dev)
    check(ell.is_sparse, "make_shared_batch_auto picks the ELL operator at scp4x density")
    dense = st.make_shared_batch(st.pad_lp(model, m_pad=ell.m_pad, n_pad=ell.n_pad, device=dev), lanes)
    opts = st.IpmOptions()
    n_real = model.ncols + model.nrows

    def solve(batch):
        t0 = time.perf_counter()
        out = st.mehrotra_solve_shared(batch, opts)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    solve(ell)  # warm-up of the ELL products
    torch.cuda.reset_peak_memory_stats()
    gram_mod.gram.launches = 0
    state, _ = solve(ell)
    launches = gram_mod.gram.launches
    status = state.status.cpu().numpy()
    obj = torch.sum(ell.c[:, :n_real] * state.x[:, :n_real], dim=-1).cpu().numpy()
    check(np.all(status == st.IpmStatus.CONVERGED), f"slice C statuses {np.unique(status)}")
    rel = np.max(np.abs(obj - highs_obj)) / abs(highs_obj)
    check(rel <= 1e-6, f"slice C objective vs HiGHS: rel {rel}")
    check(launches > 0, "gram launched on the ELL path")
    dstate, _ = solve(dense)
    dobj = torch.sum(dense.c[:, :n_real] * dstate.x[:, :n_real], dim=-1).cpu().numpy()
    check(np.array_equal(dstate.status.cpu().numpy(), status), "slice C statuses, ELL vs dense")
    rel_d = np.max(np.abs(obj - dobj) / np.abs(dobj))
    check(rel_d <= 1e-8, f"slice C objectives, ELL vs dense: rel {rel_d}")
    ell_s = statistics.median(solve(ell)[1] for _ in range(3))
    dense_s = statistics.median(solve(dense)[1] for _ in range(3))
    print(
        f"[slice C] {lanes} lanes of {model.nrows}x{model.ncols} on the ELL operator (padded "
        f"{ell.m_pad}x{ell.n_pad}, row slots {ell.A.row_idx.shape[1]}, column slots "
        f"{ell.A.col_idx.shape[1]}): all CONVERGED, objective {obj[0]:.10f} vs HiGHS "
        f"{highs_obj:.10f} (max rel {rel:.2e}); vs dense: max rel {rel_d:.2e}, iterations "
        f"ELL {int(state.iterations.max())} / dense {int(dstate.iterations.max())}"
    )
    print(
        f"[slice C] gram.launches={launches} in the ELL solve; warm solve (median of 3) "
        f"ELL {ell_s:.4f} s, dense {dense_s:.4f} s on {card}"
    )

    # a node window on an ELL base and on the dense base
    lanes = 64
    rows = [(np.asarray(r, np.int32), np.ones(len(r))) for r in model.rows]
    ell_lp = pad_standard_form_ell(
        rows, np.ones(model.nrows), model.costs, n_struct=model.ncols,
        m_pad=ell.m_pad, n_pad=ell.n_pad, device=dev,
    )
    dense_lp = st.pad_lp(model, m_pad=ell.m_pad, n_pad=ell.n_pad, device=dev)
    fix0, fix1 = seeded_fixings(np.random.default_rng(2), lanes, model.ncols, ell.n_pad)
    bnb = BnbOptions()
    node_opts = st.IpmOptions(
        gap_stall_window=bnb.gap_stall_branch_iters,
        gap_stall_min_improv=bnb.gap_stall_min_improv_pct / 100.0,
    )

    def window(lp):
        t0 = time.perf_counter()
        out = st.solve_node_batch(lp, fix0, fix1, node_opts)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    window(ell_lp)  # warm-up
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = gram_mod.gram.launches
    (st_e, _, pobj_e, _), _ = window(ell_lp)
    window_launches = gram_mod.gram.launches - before
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    # the f64 gathers of one product on this window, from the shapes
    av_mib = lanes * ell_lp.A.row_idx.numel() * 8 / 2**20
    atu_mib = lanes * ell_lp.A.col_idx.numel() * 8 / 2**20
    (st_d, _, pobj_d, _), _ = window(dense_lp)
    # Lanes that end the endgame one step short of convergence (GAP_STALLED
    # at a gap near 1e-8) flip between CONVERGED and GAP_STALLED under any
    # change of rounding, and the operators sum A-products in different
    # orders: the JAX package flips such lanes between its own ELL and dense
    # operators too.  So every other status must be equal, the flips few,
    # and a flipped lane's objective within 1e-6 of the converged one.
    status_e, status_d = st_e.status.cpu().numpy(), st_d.status.cpu().numpy()
    conv_e = status_e == st.IpmStatus.CONVERGED
    conv_d = status_d == st.IpmStatus.CONVERGED
    endgame = (st.IpmStatus.CONVERGED, st.IpmStatus.GAP_STALLED)
    flips = (status_e != status_d) & np.isin(status_e, endgame) & np.isin(status_d, endgame)
    check(np.array_equal(status_e[~flips], status_d[~flips]), "slice C window statuses, ELL vs dense")
    check(flips.sum() <= lanes // 8, f"slice C window: {flips.sum()} endgame flips, ELL vs dense")
    pe, pd = pobj_e.cpu().numpy(), pobj_d.cpu().numpy()
    both = conv_e & conv_d
    rel_w = np.max(np.abs(pe - pd)[both] / np.abs(pd[both]), initial=0.0)
    check(rel_w <= 1e-8, f"slice C window objectives, ELL vs dense: rel {rel_w}")
    rel_f = np.max(np.abs(pe - pd)[flips] / np.abs(pd[flips]), initial=0.0)
    check(rel_f <= 1e-6, f"slice C window objectives of flipped lanes: rel {rel_f}")
    check(window_launches > 0, "gram launched in the ELL node window")
    ell_w = statistics.median(window(ell_lp)[1] for _ in range(3))
    dense_w = statistics.median(window(dense_lp)[1] for _ in range(3))
    def counts(status):
        return {st.IpmStatus(v).name: int((status == v).sum()) for v in np.unique(status)}

    print(
        f"[slice C] {lanes}-lane node window on an ELL base vs the dense base: statuses "
        f"ELL {counts(status_e)}, dense {counts(status_d)}, endgame flips at lanes "
        f"{np.flatnonzero(flips).tolist()} (objectives max rel {rel_f:.2e}), objectives of "
        f"lanes converged in both max rel {rel_w:.2e}, iterations ELL "
        f"{int(st_e.iterations.max())} / dense {int(st_d.iterations.max())}, "
        f"gram.launches={window_launches}"
    )
    print(
        f"[slice C] warm window (median of 3) ELL {ell_w:.4f} s, dense {dense_w:.4f} s; "
        f"ELL window peak device memory {peak:.1f} MiB above its inputs (one Av gather "
        f"{av_mib:.1f} MiB, one ATu gather {atu_mib:.1f} MiB) on {card}"
    )
    return launches + window_launches


def milp_phase(torch, st, gram_mod, card):
    """Phase 6: branch and bound on a seeded scp4x-class instance with a root
    gap, (a) default configuration, (b) exact closure and cuts off.

    Returns the K1 launches of both runs, the instance's seed and its MILP
    optimum."""
    import numpy as np
    from scipy.optimize import Bounds, LinearConstraint, linprog, milp

    from sypha_tpu_torch import native
    from sypha_tpu_torch.milp import branch_and_bound
    from sypha_tpu_torch.milp.base_model import BaseModel
    from sypha_tpu_torch.milp.bnb import _NodeLpSolver
    from sypha_tpu_torch.testing import synthetic_scp

    for seed in range(20):
        model = st.parse_scp_text(synthetic_scp(200, 1000, 0.02, seed=seed), name=f"syn_scp4x_{seed}")
        A = model.dense_matrix()
        lp = linprog(model.costs, A_ub=-A, b_ub=-np.ones(model.nrows), bounds=(0, None), method="highs")
        ip = milp(
            c=model.costs, constraints=LinearConstraint(A, lb=1.0),
            integrality=np.ones(model.ncols), bounds=Bounds(0, 1),
        )
        check(lp.status == 0 and ip.status == 0, f"HiGHS on seed {seed}: {lp.message} / {ip.message}")
        if lp.fun < ip.fun - 1e-6:
            break
    else:
        raise RuntimeError("chip_smoke check failed: no seed below 20 has a root gap")
    opt = float(ip.fun)
    print(
        f"[milp] instance synthetic_scp(200, 1000, 0.02, seed={seed}): HiGHS LP optimum "
        f"{lp.fun:.6f} < scipy MILP optimum {opt:.6f} (found on the CPU)"
    )
    check(native.available(), "the native host library builds and loads")
    launches = 0
    runs = {
        "a": {},
        "b": {"exact_closure": False, "cuts_enabled": False, "max_nodes": 192},
    }
    for name, extra in runs.items():
        cfg = st.SolverConfig(verbosity=3)
        cfg = cfg.replace(bnb=cfg.bnb.replace(hard_time_limit_sec=120.0, **extra))
        _NodeLpSolver.window_stats.clear()
        gram_mod.gram.launches = 0
        t0 = time.perf_counter()
        r = branch_and_bound(model, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = gram_mod.gram.launches
        windows = dict(_NodeLpSolver.window_stats)
        launches += k1
        print(
            f"[milp] run ({name}) {extra or 'default configuration'}: {r.status.name} "
            f"objective {r.objective:.6f} dual bound {r.dual_bound:.6f} nodes "
            f"{r.nodes_processed} lp_iterations {r.total_lp_iterations} windows {windows} "
            f"wall {wall:.3f} s (solver {r.wall_time_sec:.3f} s, of it node windows "
            f"{windows.get('seconds', 0.0):.3f} s; warm-up {r.compile_time_sec:.3f} s) "
            f"gram.launches={k1} on {card}"
        )
        check(windows.get("failed", 0) == 0, f"run ({name}): no window degraded to _failed_window")
        check(windows.get("ell", 0) > 0 and windows.get("dense", 0) == 0, f"run ({name}) node operator ELL")
        check(k1 > 0, f"run ({name}): gram launched in the B&B")
        sol = np.asarray(r.solution)
        check(
            sol.shape == (model.ncols,) and BaseModel(model).is_cover(sol),
            f"run ({name}): solution is a cover",
        )
        check(abs(float(model.costs @ sol) - r.objective) <= 1e-6, f"run ({name}): cover cost = objective")
        if name == "a":
            check(r.status == st.MilpStatus.OPTIMAL, f"run (a) status {r.status.name}")
            check(abs(r.objective - opt) <= 1e-6, f"run (a) objective {r.objective} vs {opt}")
        else:
            check(r.nodes_processed > 0, "run (b) branches")
            check(r.status in (st.MilpStatus.OPTIMAL, st.MilpStatus.FEASIBLE), f"run (b) status {r.status.name}")
            check(r.objective >= opt - 1e-6, f"run (b) incumbent {r.objective} below the optimum {opt}")
            check(r.dual_bound <= opt + 1e-6, f"run (b) dual bound {r.dual_bound} above the optimum {opt}")
    return launches, seed, opt


# H100 SXM published peaks (NVIDIA data sheet, dense): f32 outside the tensor
# cores, bf16 on them, HBM3 bandwidth
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12


def gram_bound(B: int, m: int, n: int):
    """Least time of one Gram call on the card: the lower-triangle SYRK's
    f32 FLOPs (2 B m(m+1)/2 n) over the f32 peak, against A, w read once and
    M written once over HBM bandwidth.  Returns (ms, bound_by, bf16x6 ms):
    the last is the kernel's own work, six bf16 products, over the bf16 peak."""
    flops = 2.0 * B * (m * (m + 1) / 2) * n
    bytes_ = 4.0 * (m * n + B * n + B * m * m)
    ops_ms, bytes_ms = flops / F32_FLOPS * 1e3, bytes_ / HBM_BYTES * 1e3
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), bound_by, 6.0 * flops / BF16_FLOPS * 1e3


def gram_library_call(torch, A32, w):
    """One PyTorch call computing the Gram function on the same inputs."""
    return torch.einsum("ik,bk,bk,jk->bij", A32, w, w, A32)


def cli_lines(out: str) -> dict:
    """The CLI's ``KEY: value`` result lines."""
    return {
        line.split(":", 1)[0]: line.split(":", 1)[1].strip()
        for line in out.splitlines()
        if ":" in line and line[:1].isupper()
    }


# Loaded by the CLI subprocess of phase 7 through PYTHONPATH: it reports the
# process's K1 launches at exit, then runs the interpreter's own
# sitecustomize, if there is one.
LAUNCH_HOOK = '''
import atexit, importlib.machinery, importlib.util, os, sys

def _report():
    gram = sys.modules.get("sypha_tpu_torch.ops.gram")
    print(f"GRAM_LAUNCHES {gram.gram.launches if gram else 0}", file=sys.stderr)

atexit.register(_report)
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or os.curdir) != _here]
)
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
'''


def general_lp(Solver, dev):
    """A seeded general LP on the Solver API (100 rows by 300 columns: 30 <=,
    30 >=, 20 equality and 20 range rows; maximisation with an offset) and
    HiGHS's optimum and constraint duals, d objective / d bound, for it."""
    import numpy as np
    from scipy.optimize import linprog

    rng = np.random.default_rng(5)
    n, offset = 300, 12.5
    x0 = rng.uniform(0.5, 2.0, n)
    cost = rng.uniform(0.0, 1.0, n)
    s = Solver("general_lp", device=dev)
    s.parameters().verbosity = 0
    xs = [s.MakeNumVar(0.0, s.infinity(), f"x{j}") for j in range(n)]
    A_ub, b_ub, A_eq, b_eq, rows = [], [], [], [], []
    for i, kind in enumerate(["le"] * 30 + ["ge"] * 30 + ["eq"] * 20 + ["range"] * 20):
        if i == 0:
            a = np.ones(n)  # a budget row keeps the maximisation bounded
        else:
            a = np.where(rng.random(n) < 0.1, rng.uniform(-1.0, 1.0, n), 0.0)
        act = float(a @ x0)
        lb, ub = {"le": (-s.infinity(), act + 1.0), "ge": (act - 1.0, s.infinity()),
                  "eq": (act, act), "range": (act - 1.0, act + 1.0)}[kind]
        ct = s.MakeRowConstraint(lb, ub)
        for j in np.flatnonzero(a):
            ct.SetCoefficient(xs[j], float(a[j]))
        # where the row's bounds sit in HiGHS's minimisation of -cost.x
        if kind == "eq":
            rows.append((("eq", len(A_eq), -1.0),))
            A_eq.append(a)
            b_eq.append(act)
            continue
        parts = []
        if kind in ("le", "range"):
            parts.append(("ub", len(A_ub), -1.0))
            A_ub.append(a)
            b_ub.append(ub)
        if kind in ("ge", "range"):
            parts.append(("ub", len(A_ub), 1.0))
            A_ub.append(-a)
            b_ub.append(-lb)
        rows.append(tuple(parts))
    obj = s.MutableObjective()
    for x, cj in zip(xs, cost):
        obj.SetCoefficient(x, float(cj))
    obj.SetOffset(offset)
    obj.SetMaximization()
    ref = linprog(-cost, A_ub=np.array(A_ub), b_ub=b_ub, A_eq=np.array(A_eq), b_eq=b_eq,
                  bounds=(0, None), method="highs")
    check(ref.status == 0, f"HiGHS on the general LP: {ref.message}")
    marg = {"ub": ref.ineqlin.marginals, "eq": ref.eqlin.marginals}
    duals = np.array([sum(sign * marg[k][i] for k, i, sign in parts) for parts in rows])
    return s, -ref.fun + offset, duals


def knapsack(Solver, dev):
    """A seeded 30-item knapsack (generic binary route) and scipy's optimum."""
    import numpy as np
    from scipy.optimize import Bounds, LinearConstraint, milp

    rng = np.random.default_rng(0)
    w = rng.integers(5, 40, 30).astype(float)
    v = rng.integers(5, 60, 30).astype(float)
    cap = float(w.sum() // 2)
    s = Solver("knapsack30", device=dev)
    s.parameters().verbosity = 0
    s.parameters().bnb_hard_time_limit_sec = 60.0
    xs = [s.MakeBoolVar(f"x{j}") for j in range(30)]
    ct = s.MakeRowConstraint(-s.infinity(), cap)
    for x, wj, vj in zip(xs, w, v):
        ct.SetCoefficient(x, float(wj))
        s.MutableObjective().SetCoefficient(x, float(vj))
    s.MutableObjective().SetMaximization()
    ref = milp(-v, constraints=LinearConstraint(w[None], ub=cap), integrality=np.ones(30),
               bounds=Bounds(0, 1))
    check(ref.status == 0, f"scipy milp on the knapsack: {ref.message}")
    return s, -ref.fun


def bounded_integers(Solver, dev):
    """A seeded model of bounded general integers (binarized route) and
    scipy's optimum: min c.x, A x >= r, x in [lb, ub] integer."""
    import numpy as np
    from scipy.optimize import Bounds, LinearConstraint, milp

    rng = np.random.default_rng(2)
    nv, nr = 5, 3
    lbs = rng.integers(0, 3, nv).astype(float)
    ubs = lbs + rng.integers(2, 6, nv)
    cost = rng.integers(1, 10, nv).astype(float)
    A = rng.integers(0, 6, (nr, nv)).astype(float)
    rhs = np.floor(0.6 * (A @ ubs))
    s = Solver("bounded_integers", device=dev)
    s.parameters().verbosity = 0
    s.parameters().bnb_hard_time_limit_sec = 60.0
    xs = [s.MakeIntVar(float(lo), float(hi), f"x{j}") for j, (lo, hi) in enumerate(zip(lbs, ubs))]
    for i in range(nr):
        ct = s.MakeRowConstraint(float(rhs[i]), s.infinity())
        for j in np.flatnonzero(A[i]):
            ct.SetCoefficient(xs[j], float(A[i, j]))
    for x, cj in zip(xs, cost):
        s.MutableObjective().SetCoefficient(x, float(cj))
    s.MutableObjective().SetMinimization()
    ref = milp(cost, constraints=LinearConstraint(A, lb=rhs), integrality=np.ones(nv),
               bounds=Bounds(lbs, ubs))
    check(ref.status == 0, f"scipy milp on the bounded integers: {ref.message}")
    return s, ref.fun


def scp_solver(Solver, dev, model, disable_bnb: bool):
    """The scp4x-class model built as the reference's acceptance demo does."""
    s = Solver("scp4x_" + ("lp" if disable_bnb else "milp"), device=dev)
    s.parameters().verbosity = 1
    s.parameters().disable_bnb = disable_bnb
    s.parameters().bnb_hard_time_limit_sec = 120.0
    xs = [s.MakeBoolVar(f"x{j}") for j in range(model.ncols)]
    for x, cj in zip(xs, model.costs):
        s.MutableObjective().SetCoefficient(x, float(cj))
    s.MutableObjective().SetMinimization()
    for row in model.rows:
        ct = s.MakeRowConstraint(1.0, s.infinity())
        for j in row:
            ct.SetCoefficient(xs[int(j)], 1.0)
    return s


def interfaces_phase(torch, st, gram_mod, dev, card, model_a, highs_a, model_b, milp_seed, milp_opt):
    """Phase 7: the user entry points on the card, each run counted.

    (a) the CLI in process on an scpnre-class LP, and the single-LP latency
    of solve_lp at scpnre and scp4x class; (b) the CLI as a subprocess on
    the MILP with no --device; (c) the Solver, one route per run; (d)
    solve_lp_batch over four instances in one bucket, cold and warm.
    Returns (K1 launches of the Solver and solve_lp_batch runs, K1 launches
    of the in-process CLI run, {label: (latency s, solve s, launches)},
    {shape: (kernel ms, plain ms, library ms)} at B = 1)."""
    import atexit
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    import numpy as np

    from sypha_tpu_torch import cli
    from sypha_tpu_torch.api import ResultStatus, Solver
    from sypha_tpu_torch.ipm import driver

    def counted(label, fn):
        gram_mod.gram.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gram_mod.gram.launches
        check(launches > 0, f"{label}: gram launched")
        return out, wall, launches

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)

    # (a) the CLI in process, LP at scpnre class; then single-LP latency
    highs_b = highs_objective(model_b)
    path_b = os.path.join(tmp, "scpnre_class.txt")
    with open(path_b, "w") as f:
        f.write(scpnre_text())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, wall, launches_cli = counted(
            "cli LP", lambda: cli.main(["--input-file", path_b, "--disable-bnb", "--verbosity", "1"])
        )
    out = cli_lines(buf.getvalue())
    check(rc == 0, f"cli LP return code {rc}")
    for key in ("PRIMAL", "DUAL"):
        rel = abs(float(out[key]) - highs_b) / abs(highs_b)
        check(rel <= 1e-6, f"cli LP {key} {out[key]} vs HiGHS {highs_b}: rel {rel}")
    print(
        f"[interfaces] (a) cli --disable-bnb on {model_b.nrows}x{model_b.ncols}: PRIMAL "
        f"{out['PRIMAL']} DUAL {out['DUAL']} vs HiGHS {highs_b:.10f}, ITERATIONS "
        f"{out['ITERATIONS']}, TIME SOLVER {out['TIME SOLVER']} ms, wall {wall:.3f} s, "
        f"gram.launches={launches_cli} on {card}"
    )
    latency = {}
    for label, model, ref in (("scpnre class", model_b, highs_b), ("scp4x class", model_a, highs_a)):
        lp = st.pad_lp(model, device=dev)
        res, _, launches = counted(f"solve_lp at {label}", lambda: st.solve_lp(lp))
        check(res.converged, f"solve_lp at {label}: {res.status.name}")
        rel = abs(res.primal_objective - ref) / abs(ref)
        check(rel <= 1e-6, f"solve_lp at {label}: {res.primal_objective} vs HiGHS {ref}")
        st.solve_lp(st.pad_lp(model, device=dev))  # warm-up
        full, solve = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            st.solve_lp(st.pad_lp(model, device=dev))
            full.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            st.solve_lp(lp)
            solve.append(time.perf_counter() - t0)
        latency[label] = (statistics.median(full), statistics.median(solve), launches)
        print(
            f"[interfaces] single-LP latency at {label} ({model.nrows}x{model.ncols}, padded "
            f"{lp.m_pad}x{lp.n_pad}): solve_lp(pad_lp(model)) {latency[label][0]:.4f} s, "
            f"solve_lp of a padded LP {latency[label][1]:.4f} s (medians of 5, warm); "
            f"{res.iterations} iterations, gram.launches={launches}, CONVERGED at "
            f"{res.primal_objective:.10f} (rel {rel:.2e}) on {card}"
        )
    k1_b1 = {}
    gen = torch.Generator(device=dev).manual_seed(1)
    for m, n in ((200, 1280), (504, 5504)):
        A32 = torch.randint(-1, 2, (m, n), generator=gen, device=dev).float()
        w = 10.0 ** (torch.rand((1, n), generator=gen, device=dev) * 9.0 - 6.0)
        M = gram_mod.gram(A32, w)
        err = (M - gram_mod.gram_reference(A32, w)).abs().max().item()
        scale = gram_mod.gram_reference(A32, w).abs().max().item()
        check(err <= 1e-5 * scale, f"gram at B=1 ({m}, {n}): {err}")
        k1_b1[(1, m, n)] = (
            time_ms(torch, lambda: gram_mod.gram(A32, w)),
            time_ms(torch, lambda: gram_mod.gram_reference(A32, w)),
            time_ms(torch, lambda: gram_library_call(torch, A32, w)),
        )
        bound, by, bf16 = gram_bound(1, m, n)
        print(
            f"[interfaces] gram B=1 m={m} n={n}: kernel {k1_b1[(1, m, n)][0]:.4f} ms, plain "
            f"{k1_b1[(1, m, n)][1]:.4f} ms, library einsum {k1_b1[(1, m, n)][2]:.4f} ms (medians "
            f"of 20); bound {bound:.4f} ms ({by}; bf16x6 work {bf16:.4f} ms); max_abs_err vs "
            f"plain {err:.3e} on {card}"
        )

    # (b) the CLI as a subprocess on the MILP, with the default device
    milp_model = st.parse_scp_text(synthetic_scp_text(milp_seed), name=f"syn_scp4x_{milp_seed}")
    path_a = os.path.join(tmp, "scp4x_class.txt")
    with open(path_a, "w") as f:
        f.write(synthetic_scp_text(milp_seed))
    hook_dir = os.path.join(tmp, "hook")
    os.mkdir(hook_dir)
    with open(os.path.join(hook_dir, "sitecustomize.py"), "w") as f:
        f.write(LAUNCH_HOOK)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (hook_dir, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sypha_tpu_torch", "--input-file", path_a, "--verbosity", "0",
         "--show-solution", "--bnb-hard-time-limit-sec", "120"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli MILP subprocess rc {proc.returncode}: {proc.stderr[-2000:]}")
    out = cli_lines(proc.stdout)
    primal = float(out["PRIMAL"])
    check(abs(primal - milp_opt) <= 1e-6, f"cli MILP PRIMAL {primal} vs scipy {milp_opt}")
    chosen = [k for k in out if k.startswith("SELECTED COLUMNS")]
    check(len(chosen) == 1, "cli MILP prints SELECTED COLUMNS")
    cols = np.asarray(json.loads(out[chosen[0]]), dtype=int)
    x = np.zeros(milp_model.ncols)
    x[cols] = 1.0
    check(bool(np.all(milp_model.dense_matrix() @ x >= 1.0)), "cli MILP selected columns cover every row")
    check(abs(float(milp_model.costs @ x) - primal) <= 1e-6, "cli MILP cover cost = PRIMAL")
    hook = [l for l in proc.stderr.splitlines() if l.startswith("GRAM_LAUNCHES ")]
    check(len(hook) == 1, "cli MILP subprocess reported its gram launches")
    sub_launches = int(hook[0].split()[1])
    check(sub_launches > 0, "cli MILP subprocess: gram launched")
    print(
        f"[interfaces] (b) python3 -m sypha_tpu_torch (default device) on the MILP: rc 0, PRIMAL "
        f"{primal} = scipy {milp_opt}, cover of {len(cols)} columns, ITERATIONS "
        f"{out['ITERATIONS']}, TIME SOLVER {out['TIME SOLVER']} ms, TIME COMPILE "
        f"{out['TIME COMPILE']} ms, process wall {wall:.3f} s, gram.launches={sub_launches} "
        f"on {card}"
    )

    # (c) the Solver, one route per run
    launches_api = 0

    def solve(label, s):
        nonlocal launches_api
        status, wall, launches = counted(label, s.Solve)
        launches_api += launches
        print(
            f"[interfaces] (c) Solver {label}: {status.name} objective {s.objective_value():.10f} "
            f"dual {s.dual_objective_value():.10f} nodes {s.nodes()} iterations "
            f"{s.iterations()} compile_time {s.compile_time():.3f} s wall_time "
            f"{s.wall_time():.3f} s, gram.launches={launches} on {card}"
        )
        return status

    s = scp_solver(Solver, dev, model_a, disable_bnb=True)
    check(solve("LP route, scp4x class", s) == ResultStatus.OPTIMAL, "Solver LP route OPTIMAL")
    rel = abs(s.objective_value() - highs_a) / abs(highs_a)
    check(rel <= 1e-6, f"Solver LP route {s.objective_value()} vs HiGHS {highs_a}")
    s = scp_solver(Solver, dev, milp_model, disable_bnb=False)
    check(solve("SCP MILP route, scp4x class", s) == ResultStatus.OPTIMAL, "Solver SCP MILP OPTIMAL")
    check(abs(s.objective_value() - milp_opt) <= 1e-6, f"Solver SCP MILP {s.objective_value()} vs {milp_opt}")
    s, ref, duals = general_lp(Solver, dev)
    check(solve("LP route, general rows, maximize + offset", s) == ResultStatus.OPTIMAL, "general LP OPTIMAL")
    rel = abs(s.objective_value() - ref) / abs(ref)
    check(rel <= 1e-6, f"general LP objective {s.objective_value()} vs HiGHS {ref}: rel {rel}")
    got = np.array([c.dual_value() for c in s._constraints])
    dual_err = float(np.max(np.abs(got - duals)))
    check(dual_err <= 1e-6, f"general LP constraint duals vs HiGHS: max abs err {dual_err}")
    print(f"[interfaces] (c) general LP: objective rel {rel:.2e} vs HiGHS, duals max abs err {dual_err:.2e}")
    for label, build in (("generic binary route, knapsack", knapsack),
                         ("binarized route, bounded integers", bounded_integers)):
        s, ref = build(Solver, dev)
        check(solve(label, s) == ResultStatus.OPTIMAL, f"Solver {label} OPTIMAL")
        check(abs(s.objective_value() - ref) <= 1e-6, f"Solver {label}: {s.objective_value()} vs scipy {ref}")

    # (d) solve_lp_batch: four instances, 16 lanes each, in one bucket
    models = [model_a] + [
        st.parse_scp_text(synthetic_scp_text(seed), name=f"syn_scp4x_{seed}") for seed in (1, 2, 3)
    ]
    refs = [highs_a] + [highs_objective(m) for m in models[1:]]
    lps = [st.pad_lp(m, device=dev) for m in models]
    stacked = st.stack_lps([lps[lane % 4] for lane in range(64)])
    engine = driver.mehrotra_solve_shared
    calls = []

    def counted_engine(batch, *a, **kw):
        calls.append(batch.n_lanes)
        return engine(batch, *a, **kw)

    driver.mehrotra_solve_shared = counted_engine
    try:
        cold, wall, launches = counted("solve_lp_batch", lambda: st.solve_lp_batch(stacked, as_results=False))
        results = st.solve_lp_batch(stacked)
        x0, s0 = cold.x + 0.1, cold.s + 0.1
        warm, warm_wall, warm_launches = counted(
            "solve_lp_batch warm", lambda: st.solve_lp_batch(stacked, warm_start=(x0, cold.y, s0))
        )
    finally:
        driver.mehrotra_solve_shared = engine
    launches_api += launches + warm_launches
    check(calls[:4] == [16] * 4 and len(calls) == 12, f"solve_lp_batch: one shared call per instance, got {calls}")
    for lane, (res, w) in enumerate(zip(results, warm)):
        ref = refs[lane % 4]
        check(res.converged and w.converged, f"solve_lp_batch lane {lane} CONVERGED")
        check(abs(res.primal_objective - ref) / abs(ref) <= 1e-6, f"lane {lane}: {res.primal_objective} vs {ref}")
        check(w.iterations < res.iterations, f"lane {lane}: warm {w.iterations} < cold {res.iterations}")
    cold_it = sorted({r.iterations for r in results})
    warm_it = sorted({r.iterations for r in warm})
    print(
        f"[interfaces] (d) solve_lp_batch of 64 lanes (4 instances x 16, interleaved, padded "
        f"{stacked.m_pad}x{stacked.n_pad}): 4 shared calls of 16 lanes, all CONVERGED at their "
        f"HiGHS optima {[round(r, 6) for r in refs]}; iterations cold {cold_it}, warm from the "
        f"cold iterates {warm_it}; cold {wall:.3f} s ({launches} gram launches), warm "
        f"{warm_wall:.3f} s ({warm_launches}) on {card}"
    )
    return launches_api, launches_cli, latency, k1_b1


def planted_model(st):
    """The planted instance of the JAX package's two-process B&B test: the
    optimum {col0, col1} (two disjoint 30-row halves, 50.5 each, 101.0) is
    unreachable by ratio-greedy moves, and non-integral costs keep the exact
    closure and the ceil tightening out of play."""
    import numpy as np

    m = 60
    cover_of_col = [set(range(0, m, 2)), set(range(1, m, 2))]
    costs = [50.5, 50.5]
    for s in range(0, m, 4):
        cover_of_col.append({(s + i) % m for i in range(15)})
        costs.append(21.7)
    rows = [
        np.asarray([j for j, cov in enumerate(cover_of_col) if i in cov], dtype=np.int32)
        for i in range(m)
    ]
    return st.ScpModel(
        nrows=m, ncols=len(costs), costs=np.asarray(costs, dtype=np.float64), rows=rows,
        name="planted2proc",
    )


def tp_lps(st, dev):
    """Phase 8 (b)'s LPs: (label, model, whole batch on ``dev``)."""
    nre = st.parse_scp_text(scpnre_text(), name="syn_scpnre")
    nrg = st.parse_scp_text(scpnrg_text(), name="syn_scpnrg")
    return [
        ("scpnre dense", nre, st.make_shared_batch(st.pad_lp(nre, device=dev), 2)),
        ("scpnrg dense", nrg, st.make_shared_batch(st.pad_lp(nrg, m_pad=1024, n_pad=11264, device=dev), 1)),
        ("scpnrg ell", nrg, st.make_shared_batch_sparse(nrg, 1, m_pad=1024, n_pad=11264, device=dev)),
    ]


def rank_legs():
    """Phase 8 (b) and (d) on one rank of a two-process gloo group whose
    ranks share the card (parallel.distributed.run_spmd spawns it).

    (b) the tensor-parallel solve of each of ``tp_lps`` (after a warm-up on a
    tiny LP); (d) branch_and_bound on the planted instance, rank 0 seeded
    with the optimal incumbent, rank 1 crippled so that it can reach 101 only
    through the pooled incumbent.  Returns picklable results."""
    import io

    import numpy as np
    import torch
    import torch.distributed as dist

    import sypha_tpu_torch as st
    from sypha_tpu_torch.config import BnbOptions
    from sypha_tpu_torch.ops import gram as gram_mod
    from sypha_tpu_torch.parallel import solve_shared_batch_tensor_parallel
    from sypha_tpu_torch.utils.logging import Logger

    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    tiny = st.parse_scp_text("3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n")
    solve_shared_batch_tensor_parallel(st.make_shared_batch(st.pad_lp(tiny, device=dev), 2))
    out = {"tp": []}
    for label, model, batch in tp_lps(st, dev):
        n_real = model.ncols + model.nrows
        gram_mod.gram.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = solve_shared_batch_tensor_parallel(batch, st.IpmOptions())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["tp"].append({
            "label": label,
            "wall": wall,
            "launches": gram_mod.gram.launches,
            "status": s.status.cpu().tolist(),
            "iterations": s.iterations.cpu().tolist(),
            "gap": s.gap.cpu().tolist(),
            "pobj": torch.sum(batch.c[:, :n_real] * s.x[:, :n_real], dim=-1).cpu().tolist(),
            "y": s.y.cpu().numpy(),
        })

    model = planted_model(st)
    if rank == 0:
        cfg = st.SolverConfig(verbosity=3, bnb=BnbOptions(hard_time_limit_sec=30.0, node_batch=8))
        x = np.zeros(model.ncols)
        x[0] = x[1] = 1.0
        warm = (x, 101.0)
    else:
        cfg = st.SolverConfig(verbosity=3, bnb=BnbOptions(
            hard_time_limit_sec=30.0, node_batch=8, int_heuristics="none", lagrangian_samples=0,
            cut_rounds_root=0, compact_resolve=False, core_time_frac=0.0,
        ))
        warm = None
    log = io.StringIO()
    gram_mod.gram.launches = 0
    t0 = time.perf_counter()
    res = st.branch_and_bound(model, cfg, Logger(verbosity=3, stream=log), warm_incumbent=warm)
    out["bnb"] = {
        "line": f"PRIMAL {res.objective:.6f} STATUS {res.status.name} SRC {res.incumbent_source}",
        "pooled": "Pooled remote incumbent: 101" in log.getvalue(),
        "wall": time.perf_counter() - t0,
        "launches": gram_mod.gram.launches,
    }
    return out


def multi_device_phase(torch, st, gram_mod, shared, card, batch_a, highs_a, n_real_a,
                       model_b, lp_b, fix0, fix1, node_opts, refs_b, milp_model, milp_opt):
    """Phase 8: the multi-device paths on the one card.

    Returns (K1 launches of the lane-sharded legs (a) and (c), K1 launches of
    the tensor-parallel ranks (b), {label: wall s} of every leg)."""
    import collections
    import threading

    import numpy as np

    from sypha_tpu_torch.parallel import (
        make_mesh,
        pooled_stats,
        run_spmd,
        solve_shared_batch_sharded,
    )
    from sypha_tpu_torch.parallel.mesh import solve_node_batch_sharded

    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    walls = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st.solve_node_batch(lp_b, fix0, fix1, node_opts)  # slice B's window, unsharded and warm
    torch.cuda.synchronize()
    walls["window unsharded"] = time.perf_counter() - t0

    # (a) slice B's window on two shards of the card, each on a host thread
    per_thread = collections.Counter()
    real_gram = shared.gram

    def counting_gram(A32, w):
        per_thread[threading.get_ident()] += 1
        return real_gram(A32, w)

    gram_mod.gram.launches = 0
    shared.gram = counting_gram
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_sh, x_sh, p_sh, d_sh = solve_node_batch_sharded(lp_b, fix0, fix1, node_opts, mesh)
        torch.cuda.synchronize()
        walls["window sharded"] = time.perf_counter() - t0
    finally:
        shared.gram = real_gram
    launches_window = gram_mod.gram.launches
    check(
        len(per_thread) == 2 and min(per_thread.values()) > 0
        and sum(per_thread.values()) == launches_window,
        f"K1 launched in both shard threads: {dict(per_thread)}, total {launches_window}",
    )
    t0 = time.perf_counter()
    halves = [st.solve_node_batch(lp_b, fix0[sl], fix1[sl], node_opts) for sl in (slice(0, 32), slice(32, 64))]
    torch.cuda.synchronize()
    walls["window halves in turn"] = time.perf_counter() - t0
    for name in ("x", "y", "s", "mu", "gap", "iterations", "status"):
        check(
            torch.equal(getattr(st_sh, name), torch.cat([getattr(h[0], name) for h in halves])),
            f"sharded window {name} equals its halves solved alone",
        )
    for i, got in enumerate((x_sh, p_sh, d_sh)):
        check(torch.equal(got, torch.cat([h[i + 1] for h in halves])), "sharded window x_full/pobj/dobj")
    status = st_sh.status.cpu().numpy()
    pobj = p_sh.cpu().numpy()
    for lane, ref in refs_b.items():
        conv = status[lane] == st.IpmStatus.CONVERGED
        if ref is None:
            check(not conv, f"sharded lane {lane}: HiGHS infeasible but CONVERGED")
        elif conv:
            check(abs(pobj[lane] - ref) <= 1e-6 * abs(ref), f"sharded lane {lane}: {pobj[lane]} vs HiGHS {ref}")
    counts = {st.IpmStatus(v).name: int((status == v).sum()) for v in np.unique(status)}
    print(
        f"[multi] (a) slice B window on 2 shards of cuda:0: statuses {counts}, bit for bit its "
        f"two 32-lane halves solved alone; lanes {sorted(refs_b)} agree with HiGHS; "
        f"gram.launches={launches_window} ({sorted(per_thread.values())} per shard thread); "
        f"sharded {walls['window sharded']:.4f} s, halves in turn "
        f"{walls['window halves in turn']:.4f} s, unsharded {walls['window unsharded']:.4f} s on {card}"
    )

    before = gram_mod.gram.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats = solve_shared_batch_sharded(batch_a, st.IpmOptions(), mesh)
    torch.cuda.synchronize()
    walls["slice A sharded"] = time.perf_counter() - t0
    launches_a = gram_mod.gram.launches - before
    gathered = pooled_stats([state])
    check(all(torch.equal(a, b) for a, b in zip(stats[:3], gathered)), "pooled stats = gathered state's")
    min_dual = torch.amin(torch.sum(batch_a.b * state.y, dim=-1) + batch_a.obj_offset)
    check(torch.equal(stats[3], min_dual), "pooled min dual = gathered state's")
    check(int(stats[2]) == 128, f"slice A sharded: {int(stats[2])} of 128 CONVERGED")
    obj = torch.sum(batch_a.c[:, :n_real_a] * state.x[:, :n_real_a], dim=-1).cpu().numpy()
    rel = np.max(np.abs(obj - highs_a)) / abs(highs_a)
    check(rel <= 1e-6, f"slice A sharded vs HiGHS: rel {rel}")
    check(launches_a > 0, "gram launched in sharded slice A")
    print(
        f"[multi] (a) slice A (128 lanes) on 2 shards: pooled (worst gap, max iterations, "
        f"converged, min dual) = ({float(stats[0]):.3e}, {int(stats[1])}, {int(stats[2])}, "
        f"{float(stats[3]):.10f}) = the gathered state's; objective max rel {rel:.2e} vs HiGHS; "
        f"gram.launches={launches_a}; {walls['slice A sharded']:.4f} s on {card}"
    )

    # (c) the B&B with every node window on the 2-shard mesh
    cfg = st.SolverConfig(verbosity=3)
    cfg = cfg.replace(bnb=cfg.bnb.replace(
        hard_time_limit_sec=120.0, exact_closure=False, cuts_enabled=False, max_nodes=192,
    ))
    before = gram_mod.gram.launches
    t0 = time.perf_counter()
    r = st.branch_and_bound(milp_model, cfg, mesh=mesh)
    torch.cuda.synchronize()
    walls["mesh B&B"] = time.perf_counter() - t0
    launches_bnb = gram_mod.gram.launches - before
    check(r.status == st.MilpStatus.OPTIMAL, f"mesh B&B status {r.status.name}")
    check(abs(r.objective - milp_opt) <= 1e-6, f"mesh B&B objective {r.objective} vs {milp_opt}")
    check(r.nodes_processed > 0, "mesh B&B branches")
    check(launches_bnb > 0, "gram launched in the mesh B&B")
    print(
        f"[multi] (c) B&B over 2 shards, closure and cuts off: {r.status.name} objective "
        f"{r.objective:.6f} = scipy {milp_opt:.6f}, nodes {r.nodes_processed}, lp_iterations "
        f"{r.total_lp_iterations}, gram.launches={launches_bnb}, wall {walls['mesh B&B']:.3f} s "
        f"(solver {r.wall_time_sec:.3f} s) on {card}"
    )

    # (b) and (d): two processes sharing the card in one gloo group; the
    # blocks this process's allocator still caches go back to the card first,
    # or the ranks find no memory for their CUDA contexts
    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    print(
        f"[multi] released {(reserved - torch.cuda.memory_reserved()) / 2**30:.2f} GiB cached "
        f"by this process's allocator before spawning the ranks"
    )
    t0 = time.perf_counter()
    ranks = run_spmd(rank_legs, ["cuda:0", "cuda:0"], "gloo")
    walls["two-process legs"] = time.perf_counter() - t0
    launches_tp = 0
    for i, (label, model, batch) in enumerate(tp_lps(st, torch.device("cuda"))):
        n_real = model.ncols + model.nrows
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = st.mehrotra_solve_shared(batch, st.IpmOptions())
        torch.cuda.synchronize()
        walls[f"unsharded {label}"] = ref_s = time.perf_counter() - t0
        ref_obj = torch.sum(batch.c[:, :n_real] * ref.x[:, :n_real], dim=-1).cpu().numpy()
        highs = highs_objective(model)
        legs = [rk["tp"][i] for rk in ranks]
        for rk, leg in enumerate(legs):
            ok = [
                s == st.IpmStatus.CONVERGED or (s == st.IpmStatus.GAP_STALLED and g < 1e-6)
                for s, g in zip(leg["status"], leg["gap"])
            ]
            check(all(ok), f"TP {label} rank {rk}: statuses {leg['status']} gaps {leg['gap']}")
            p = np.asarray(leg["pobj"])
            rel_ref = np.max(np.abs(p - ref_obj) / np.abs(ref_obj))
            rel_highs = np.max(np.abs(p - highs)) / abs(highs)
            check(rel_ref <= 1e-8, f"TP {label} rank {rk} vs unsharded: rel {rel_ref}")
            check(rel_highs <= 1e-6, f"TP {label} rank {rk} vs HiGHS: rel {rel_highs}")
            check(leg["launches"] > 0, f"TP {label}: gram launched on rank {rk}")
            launches_tp += leg["launches"]
        check(legs[0]["pobj"] == legs[1]["pobj"], f"TP {label}: the ranks gather the same x")
        walls[f"TP {label}"] = legs[0]["wall"]
        print(
            f"[multi] (b) TP {label} on 2 gloo ranks sharing the card: statuses {legs[0]['status']}, "
            f"iterations {legs[0]['iterations']} (unsharded {ref.iterations.cpu().tolist()}), "
            f"objective {legs[0]['pobj'][0]:.10f} vs unsharded {ref_obj[0]:.10f} (rel "
            f"{abs(legs[0]['pobj'][0] - ref_obj[0]) / abs(ref_obj[0]):.2e}) vs HiGHS {highs:.10f}; "
            f"y equal on both ranks: {bool(np.array_equal(legs[0]['y'], legs[1]['y']))}; "
            f"gram.launches {[leg['launches'] for leg in legs]}; TP wall "
            f"{[round(leg['wall'], 4) for leg in legs]} s, unsharded {ref_s:.4f} s on {card}"
        )
    for rk, leg in enumerate(rk["bnb"] for rk in ranks):
        print(
            f"[multi] (d) rank {rk} branch_and_bound on the card: {leg['line']}, pooled remote "
            f"incumbent logged: {leg['pooled']}, gram.launches={leg['launches']}, wall "
            f"{leg['wall']:.3f} s on {card}"
        )
        check(leg["line"].startswith("PRIMAL 101.000000"), f"rank {rk}: {leg['line']}")
    check(ranks[1]["bnb"]["pooled"], "rank 1 logs 'Pooled remote incumbent: 101'")
    print(f"[multi] two-process legs (b) + (d), spawn included: {walls['two-process legs']:.3f} s on {card}")
    return launches_window + launches_a + launches_bnb, launches_tp, walls


def scpnre_text() -> str:
    from sypha_tpu_torch.testing import synthetic_scp

    return synthetic_scp(500, 5000, 0.10, seed=1)


def scpnrg_text() -> str:
    from sypha_tpu_torch.testing import synthetic_scp

    return synthetic_scp(1000, 10000, 0.02, seed=0)


def synthetic_scp_text(seed: int) -> str:
    from sypha_tpu_torch.testing import synthetic_scp

    return synthetic_scp(200, 1000, 0.02, seed=seed)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one NVIDIA GPU", file=sys.stderr)
        return 1

    import numpy as np

    import sypha_tpu_torch as st
    from sypha_tpu_torch.config import BnbOptions
    from sypha_tpu_torch.ipm import shared
    from sypha_tpu_torch.ops import gram as gram_mod
    from sypha_tpu_torch.ops._build import library_path, load_library
    from sypha_tpu_torch.ops.spd import pcg_solve
    from sypha_tpu_torch.testing import synthetic_scp
    from sypha_tpu_torch.utils.timers import PhaseTimers

    dev = torch.device("cuda")
    card = card_line()
    timers = PhaseTimers()

    # -- phase 1: device --------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"[device] {card}")
    print(
        f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} python={sys.version.split()[0]}"
    )
    print(
        f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}"
    )
    check(torch.get_float32_matmul_precision() == "highest", "f32 matmul precision")
    fresh = not library_path("gram").exists()
    t0 = time.perf_counter()
    load_library("gram")
    print(
        f"[device] gram kernel {'built' if fresh else 'loaded'} in "
        f"{time.perf_counter() - t0:.3f} s: {library_path('gram')}"
    )

    # -- phase 2: the kernel against its plain version ---------------------
    times, kernel_err, entry_err, plain_entry_err = kernel_phase(torch, gram_mod, dev, card)

    # -- phase 3: slice A, batched LP relaxations --------------------------
    timers.start("slice_a_setup")
    model_a = st.parse_scp_text(synthetic_scp(200, 1000, 0.02, seed=0), name="syn_scp4x")
    lp_a = st.pad_lp(model_a, device=dev)
    batch_a = st.make_shared_batch(lp_a, 128)
    n_real = int(lp_a.n_real)
    timers.stop("slice_a_setup")
    opts = st.IpmOptions()
    highs_a = highs_objective(model_a)
    st.mehrotra_solve_shared(batch_a, opts)  # warm-up: library handles, caches
    torch.cuda.synchronize()

    gram_mod.gram.launches = 0
    pcg_solve.steps = 0
    timers.start("slice_a_solve")
    t0 = time.perf_counter()
    state_a = st.mehrotra_solve_shared(batch_a, opts)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    timers.stop("slice_a_solve")
    launches_a = gram_mod.gram.launches
    cg_steps_a = pcg_solve.steps

    status_a = state_a.status.cpu().numpy()
    iters_a = state_a.iterations.cpu().numpy()
    obj_a = torch.sum(batch_a.c[:, :n_real] * state_a.x[:, :n_real], dim=-1).cpu().numpy()
    check(state_a.x.shape == (128, lp_a.n_pad) and state_a.x.dtype == torch.float64, "x shape/dtype")
    check(bool(torch.isfinite(state_a.x).all()), "x finite")
    check(np.all(status_a == st.IpmStatus.CONVERGED), f"slice A statuses {np.unique(status_a)}")
    rel_a = np.max(np.abs(obj_a - highs_a)) / abs(highs_a)
    check(rel_a <= 1e-6, f"slice A objective vs HiGHS: rel {rel_a}")
    check(launches_a >= int(iters_a.max()) + 1, f"gram launches {launches_a} < iterations + 1")
    print(
        f"[slice A] 128 lanes of {model_a.nrows}x{model_a.ncols} (padded {lp_a.m_pad}x{lp_a.n_pad}): "
        f"all CONVERGED, objective {obj_a[0]:.10f} vs HiGHS {highs_a:.10f} (max rel {rel_a:.2e})"
    )
    print(
        f"[slice A] gram.launches={launches_a} ipm_iterations={int(iters_a.max())} "
        f"cg_steps={cg_steps_a} (host syncs: one per IPM iteration and per CG step)"
    )
    print(
        f"[slice A] warm solve {solve_s:.4f} s = {128 / solve_s:.2f} solves/s on {card}"
    )

    shared.gram = gram_mod.gram_reference
    try:
        t0 = time.perf_counter()
        plain_a = st.mehrotra_solve_shared(batch_a, opts)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        shared.gram = gram_mod.gram
    plain_status = plain_a.status.cpu().numpy()
    plain_obj = torch.sum(batch_a.c[:, :n_real] * plain_a.x[:, :n_real], dim=-1).cpu().numpy()
    check(np.array_equal(plain_status, status_a), "slice A statuses, kernel vs plain Gram")
    rel = np.max(np.abs(plain_obj - obj_a) / np.abs(plain_obj))
    check(rel <= 1e-8, f"slice A objectives, kernel vs plain Gram: rel {rel}")
    print(
        f"[slice A] plain Gram: iterations {int(plain_a.iterations.max())} vs kernel "
        f"{int(iters_a.max())}, objectives max rel diff {rel:.2e}, "
        f"solve {plain_s:.4f} s vs kernel {solve_s:.4f} s on {card}"
    )

    # -- phase 4: slice B, a B&B node window -------------------------------
    timers.start("slice_b_setup")
    model_b = st.parse_scp_text(synthetic_scp(500, 5000, 0.10, seed=1), name="syn_scpnre")
    lp_b = st.pad_lp(model_b, device=dev)
    lanes = 64
    fix0, fix1 = seeded_fixings(np.random.default_rng(1), lanes, model_b.ncols, lp_b.n_pad)
    timers.stop("slice_b_setup")
    bnb = BnbOptions()
    node_opts = st.IpmOptions(
        gap_stall_window=bnb.gap_stall_branch_iters,
        gap_stall_min_improv=bnb.gap_stall_min_improv_pct / 100.0,
    )

    torch.cuda.reset_peak_memory_stats()
    gram_mod.gram.launches = 0
    pcg_solve.steps = 0
    timers.start("slice_b_solve")
    t0 = time.perf_counter()
    state_b, x_full, pobj, dobj = st.solve_node_batch(lp_b, fix0, fix1, node_opts)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    timers.stop("slice_b_solve")
    launches_b = gram_mod.gram.launches
    cg_steps_b = pcg_solve.steps
    peak = torch.cuda.max_memory_allocated()

    status_b = state_b.status.cpu().numpy()
    iters_b = state_b.iterations.cpu().numpy()
    pobj_b = pobj.cpu().numpy()
    check(x_full.shape == (lanes, lp_b.n_pad) and bool(torch.isfinite(x_full).all()), "x_full")
    check(launches_b >= int(iters_b.max()) + 1, f"gram launches {launches_b} < iterations + 1")
    refs_b = {}
    for lane in range(4):
        ref = highs_objective(model_b, fix0[lane, : model_b.ncols], fix1[lane, : model_b.ncols])
        refs_b[lane] = ref
        conv = status_b[lane] == st.IpmStatus.CONVERGED
        if ref is None:
            check(not conv, f"lane {lane}: HiGHS infeasible but CONVERGED")
            print(f"[slice B] lane {lane}: HiGHS infeasible, status {st.IpmStatus(status_b[lane]).name}")
            continue
        if conv:
            rel = abs(pobj_b[lane] - ref) / abs(ref)
            check(rel <= 1e-6, f"lane {lane}: objective {pobj_b[lane]} vs HiGHS {ref}")
        print(
            f"[slice B] lane {lane}: {st.IpmStatus(status_b[lane]).name} objective "
            f"{pobj_b[lane]:.10f} vs HiGHS {ref:.10f}"
        )
    counts = {st.IpmStatus(s).name: int((status_b == s).sum()) for s in np.unique(status_b)}
    print(
        f"[slice B] {lanes} lanes of {model_b.nrows}x{model_b.ncols} (padded "
        f"{lp_b.m_pad}x{lp_b.n_pad}): statuses {counts}"
    )
    print(
        f"[slice B] gram.launches={launches_b} ipm_iterations={int(iters_b.max())} "
        f"cg_steps={cg_steps_b}; window {window_s:.4f} s; peak device memory "
        f"{peak / 2**20:.1f} MiB on {card}"
    )

    shared.gram = gram_mod.gram_reference
    try:
        plain_b = st.solve_node_batch(lp_b, fix0, fix1, node_opts)
        torch.cuda.synchronize()
    finally:
        shared.gram = gram_mod.gram
    plain_status_b = plain_b[0].status.cpu().numpy()
    check(np.array_equal(plain_status_b, status_b), "slice B statuses, kernel vs plain Gram")
    conv = status_b == st.IpmStatus.CONVERGED
    plain_pobj = plain_b[2].cpu().numpy()
    rel = np.max(np.abs(plain_pobj - pobj_b)[conv] / np.abs(plain_pobj[conv]), initial=0.0)
    check(rel <= 1e-8, f"slice B objectives, kernel vs plain Gram: rel {rel}")
    print(
        f"[slice B] plain Gram: iterations {int(plain_b[0].iterations.max())} vs kernel "
        f"{int(iters_b.max())}, converged objectives max rel diff {rel:.2e}"
    )

    # -- phase 5: slice C, the padded-ELL operator --------------------------
    timers.start("slice_c")
    launches_ell = slice_c_phase(torch, st, gram_mod, dev, card, model_a, highs_a)
    timers.stop("slice_c")

    # -- phase 6: MILP, branch and bound -------------------------------------
    timers.start("milp")
    launches_bnb, milp_seed, milp_opt = milp_phase(torch, st, gram_mod, card)
    timers.stop("milp")

    # -- phase 7: the user entry points ---------------------------------------
    timers.start("interfaces")
    launches_api, launches_cli, latency, k1_b1 = interfaces_phase(
        torch, st, gram_mod, dev, card, model_a, highs_a, model_b, milp_seed, milp_opt
    )
    timers.stop("interfaces")

    # -- phase 8: multi-device on the one card -----------------------------------
    timers.start("multi_device")
    milp_model = st.parse_scp_text(synthetic_scp_text(milp_seed), name=f"syn_scp4x_{milp_seed}")
    launches_mesh, launches_tp, walls = multi_device_phase(
        torch, st, gram_mod, shared, card, batch_a, highs_a, n_real, model_b, lp_b, fix0, fix1,
        node_opts, refs_b, milp_model, milp_opt,
    )
    timers.stop("multi_device")
    print(timers.report())
    print(f"phase 8 walls (s): {json.dumps(walls)} on {card}")
    for label, (full_s, solve_s, k1) in latency.items():
        print(
            f"single-LP latency, {label}: {full_s:.4f} s with pad_lp, {solve_s:.4f} s solve only, "
            f"{k1} gram launches (medians of 5, warm) on {card}"
        )

    bound_a, bound_by, bf16_a = gram_bound(128, 200, 1280)
    bound_b, _, bf16_b = gram_bound(64, 504, 5504)
    slabs = {
        "slab_scpnre": ("slab scpnre", (2, 504, 2752)),
        "slab_scpnrg": ("slab scpnrg", (1, 1024, 5632)),
        "scpnrg": ("scpnrg", (1, 1024, 11264)),
    }

    print(json.dumps({"kernels": [{
        "name": "gram",
        "route": "cuda",
        "source": "sypha_tpu_torch/csrc/gram.cu",
        "replaces": "sypha_tpu/ops/pallas_gram.py:40",
        "launches": launches_a,
        "launches_slice_b": launches_b,
        "launches_ell": launches_ell,
        "launches_bnb": launches_bnb,
        "launches_api": launches_api,
        "launches_cli": launches_cli,
        "launches_mesh": launches_mesh,
        "launches_tp": launches_tp,
        "max_abs_err": kernel_err,
        "ms": times["cell A"][0],
        "plain_ms": times["cell A"][1],
        "bound_ms": bound_a,
        "bound_by": bound_by,
        "library_ms": times["cell A"][2],
        "design": "bf16x6 mma.sync SYRK",
        "bound_ms_bf16x6": bf16_a,
        "max_entry_rel_err": entry_err,
        "plain_max_entry_rel_err": plain_entry_err,
        "ms_cell_b": times["cell B"][0],
        "plain_ms_cell_b": times["cell B"][1],
        "bound_ms_cell_b": bound_b,
        "bound_ms_bf16x6_cell_b": bf16_b,
        "library_ms_cell_b": times["cell B"][2],
        **{
            f"{key}_b1_{label}": k1_b1[(1, m, n)][i]
            for label, m, n in (("scp4x", 200, 1280), ("scpnre", 504, 5504))
            for i, key in enumerate(("ms", "plain_ms", "library_ms"))
        },
        **{
            f"{key}_{name}": (times[label] + (gram_bound(*shape)[0],))[i]
            for name, (label, shape) in slabs.items()
            for i, key in enumerate(("ms", "plain_ms", "library_ms", "bound_ms"))
        },
    }]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
