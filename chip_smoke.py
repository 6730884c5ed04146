#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sypha_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and nvcc; run from the root of a
checkout.  Phases, each printed as it runs:

  1. device: card name and power limit, precision flags, build of the Gram
     kernel from sypha_tpu_torch/csrc/gram.cu;
  2. kernel: the Gram kernel against its plain PyTorch version and an f64
     Gram at four shapes (the last with w over the IPM's full clamp range),
     per entry against |Aw| |Aw|^T, for bit symmetry, with CUDA-event times;
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
     sound bounds; both on the ELL node operator with the Gram kernel.

Any failed check raises, and the script exits non-zero; without a CUDA card
it exits non-zero before doing anything.  The last line is the JSON status
object and the line before it the card's name and power limit; the line
before that lists each kernel with its launch count in the slices (slice A
as ``launches``, then slices B and C and the B&B), its error against the
plain version and both times.
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

    Returns ({label: (kernel ms, plain ms)}, max abs error vs plain at the
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
        times[label] = (ms, plain_ms)
        print(
            f"[kernel] gram B={B} m={m} n={n} ({label}): max_abs_err vs f64 {err64:.3e} "
            f"(limit {1e-5 * scale:.3e}), vs plain {err_plain:.3e}; per-entry rel err "
            f"{rel_k:.3e} vs plain {rel_p:.3e} (limit 4x); symmetric; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20) on {card}"
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

    Returns the K1 launches of both runs."""
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
    return launches


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
    for lane in range(4):
        ref = highs_objective(model_b, fix0[lane, : model_b.ncols], fix1[lane, : model_b.ncols])
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
    launches_bnb = milp_phase(torch, st, gram_mod, card)
    timers.stop("milp")
    print(timers.report())

    print(json.dumps({"kernels": [{
        "name": "gram",
        "route": "cuda",
        "source": "sypha_tpu_torch/csrc/gram.cu",
        "replaces": "sypha_tpu/ops/pallas_gram.py:40",
        "launches": launches_a,
        "launches_slice_b": launches_b,
        "launches_ell": launches_ell,
        "launches_bnb": launches_bnb,
        "max_abs_err": kernel_err,
        "ms": times["cell A"][0],
        "plain_ms": times["cell A"][1],
        "design": "bf16x6 mma.sync SYRK",
        "max_entry_rel_err": entry_err,
        "plain_max_entry_rel_err": plain_entry_err,
        "ms_cell_b": times["cell B"][0],
        "plain_ms_cell_b": times["cell B"][1],
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
