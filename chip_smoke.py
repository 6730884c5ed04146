#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sypha_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and nvcc; run from the root of a
checkout.  Phases, each printed as it runs:

  1. device: card name and power limit, precision flags, build of the Gram
     kernel from sypha_tpu_torch/csrc/gram.cu;
  2. kernel: the Gram kernel against its plain PyTorch version and an f64
     Gram at eleven shapes of its shared form (one A for every lane; one
     shape with w over the IPM's full clamp range; the column slabs of
     phase 8's tensor-parallel ranks and the whole scpnrg-class matrix; one
     and two lanes at slices A's and B's widths, where k is cut) and eight
     of its per-lane form (a distinct A per lane, one shape over the clamp
     range, one and two lanes), each on an A in {0, +-1} (the three-product
     path) and on a general f32 A (the six-product path): per entry against
     |Aw| |Aw|^T, for bit symmetry, a repeated call bit for bit, the
     launches counted by form, path and split-k, with CUDA-event times of
     the kernel, of its six-product path on the same A and of one pass
     where k is cut, of the plain version, and of one cuBLAS matmul of a
     precomputed Aw by its transpose;
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
     of solve_lp (the per-lane engine on one lane) at scpnre and scp4x
     class, K1 at one lane (its time at several k slice counts, and the
     host microseconds of a gram() call); (b) ``python3 -m
     sypha_tpu_torch`` as a subprocess on phase 6's MILP, with no --device;
     (c) the Solver on each route: the scp4x-class model as an LP and as a
     MILP, a general LP with every row type, maximisation and an offset
     (objective and duals against HiGHS), a knapsack (generic binary) and
     bounded general integers (binarized), against scipy; (d)
     solve_lp_batch over four instances in one 64-lane bucket, one call of
     the per-lane engine, then warm-started from the cold iterates;
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
     through the BoundPool: both end at 101, rank 1 by the pooled incumbent;
     (e) phase 9 (a)'s first 8 lanes through solve_lp_batch_sharded on the
     two shards, bit for bit its halves through solve_lp_batch, the per-lane
     K1 launched in both shard threads;
  9. the per-lane engine (ipm.dense) through solve_lp_batch: (a) 32
     distinct scp4x-class LPs against HiGHS and against the plain Gram, the
     per-lane K1 counted from 0; (b) 8 distinct scpnre-class LPs against
     HiGHS; (c) (a)'s first 8 lanes on the Jacobi-CG strategy; walls and
     iterations per lane;
 10. the grouped solve, bench.py's layout: (a) the kernel's grouped form
     (one A per instance group of L lanes) against its plain version at
     (10 x 128, 200, 1280) and a ragged shape; (b) 10 seeded scp4x-class
     instances x 128 lanes through stack_shared_batches and one
     mehrotra_solve_shared call, every lane against HiGHS; (c) the same
     with the plain Gram, and each group alone on the ungrouped engine;
     (d) ``python3 -m sypha_tpu_torch.bench`` as a subprocess, its JSON line
     checked;
 11. the sweep and study tools (sypha_tpu_torch.benchmark), each ``main``
     in process with --synthetic on the default device: (a) run_benchmark
     --lp-only over the scp4 family against HiGHS; (b) run_benchmark's
     MILP rows on scp41 and scp48 against scipy's MILP optimum; (c)
     lp_parity --scipy over scp4 and scpnre, every row PASS; (d)
     ell_vs_dense at 64 lanes on scp41, scpnre1 and scpnrg1, K1 launched on
     both operators, which agree, lane 0 against HiGHS; (e) root_cut_study
     on scpnre1, the dual bound never falling; each tool's wall and K1
     launches; every K1 call of a tool recorded, and the kernel held against
     its plain version and an f64 Gram, as in phase 2, on the last inputs of
     each distinct shape the tool gave it (64 x 1000 x 11008 in (d), the
     cut-extended node windows in (b) and (e)), timed at its largest.
 12. the B&B's operator life cycle and resumable search: (a) phase 6's
     instance under phase 6 (b)'s configuration with the compact re-solve
     off (it delegates the tree to a nested search that is never
     checkpointed), uninterrupted, then cut at max_nodes=1 with a
     checkpoint in a temporary directory, then resumed from it: OPTIMAL at scipy's optimum and at the uninterrupted
     objective within 1e-9, K1 launched in every leg; (b) the padded-ELL
     operator cache over phase 6's runs: builds, hits and the MB of ELL
     tensors not uploaded, every operator built there equal bit for bit to
     a fresh build of its rows, then run (b) again with the cache emptied
     before every call, equal in status and objective, both walls printed.

Every run that drives a path sets K1's counts to 0 just before and reads
them just after, by path: the runs on SCP rows (A in {0, +-1}) launch only
the three-product path, the B&B runs (integer cut rows) launch it, the
general LP of phase 7 (c) launches only the six-product path, and the
single LPs cut k while slices A and B and the grouped solve do not.

Any failed check raises, and the script exits non-zero; without a CUDA card
it exits non-zero before doing anything.  The last line is the JSON status
object and the line before it the card's name and power limit; the line
before that lists each kernel form (shared, per lane, grouped) with the
launches of its main path (slice A, phase 9 (a), phase 10 (b)) by path,
every run's launches by path (``paths``), its error against the plain
version and the f64 Gram, and per phase-2 shape its times (kernel on its
path, six-product path, one pass, plain, cuBLAS), its bound (the larger of
the f32 SYRK's FLOPs over the f32 peak and its bytes over HBM bandwidth),
its share of the bound and its bf16x6 and bf16x3 tensor-core floors.
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


def time_ms(torch, fn, reps: int = 20, inner: int = 10) -> float:
    """Per-call time: median over ``reps`` samples of ``inner`` back-to-back
    calls between two CUDA events, after warm-up.  The host enqueues while
    the card works, so a call whose device work is shorter than its host
    work reads as its host time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(torch, fn, calls: int = 5, reps: int = 20) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph
    (after warm-up on a side stream), the graph's replay timed by CUDA
    events, median of ``reps``.  No host work runs between the kernels, so
    a call shorter than its host work reads as its device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def profiled(torch, fn):
    """One run of ``fn`` under torch.profiler, after a short profiled
    warm-up (the profiler's own start-up): (K1 device ms, K1 kernels run
    (split-k's second pass counted apart), device ms of every kernel, wall
    s).  The device times are None where the profiler records none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_us = all_us = 0.0
    k1_calls = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        all_us += us
        if "gram_kernel<" in e.key or "gram_reduce_kernel" in e.key:  # K1's two kernels
            k1_us += us
            k1_calls += e.count
    if all_us == 0.0:
        return None, 0, None, wall
    return k1_us / 1e3, k1_calls, all_us / 1e3, wall


def entry_rel_err(M, G64, bound) -> float:
    """max_ij |M - G64|_ij / bound_ij; entries with a zero bound must be exact."""
    err = (M.double() - G64).abs()
    pos = bound > 0
    check(bool((err[~pos] == 0).all()), "gram entries with a zero bound are exact")
    return (err[pos] / bound[pos]).max().item()


# K1's counters: all launches, per form, and per path (ops/gram.py)
COUNTERS = ("launches", "launches_per_lane", "launches_grouped", "launches_bf16x3", "launches_split_k")
# the counts of every run that drives a path, by label, for the kernels line
PATHS = {}


def reset_counts(gram_mod):
    for name in COUNTERS:
        setattr(gram_mod.gram, name, 0)


def record_paths(gram_mod, label: str, *, bf16x3: str, split_k: bool | None = None):
    """K1's launches by path since ``reset_counts``, kept under ``label``.
    ``bf16x3``: "all" for a run on SCP rows (A in {0, +-1}), which must
    launch only the three-product path; "some" for a B&B, whose cut rows
    are integers and mostly exact in bf16; "none" for a general-coefficient
    A, only the six-product path; None for a model whose rows the run
    only prints.  ``split_k`` (when given): whether every
    launch cut k or none did."""
    g = gram_mod.gram
    rec = {"launches": g.launches, "bf16x3": g.launches_bf16x3,
           "bf16x6": g.launches - g.launches_bf16x3, "split_k": g.launches_split_k}
    check(rec["launches"] > 0, f"{label}: K1 launched")
    ok = {"all": rec["bf16x6"] == 0, "some": rec["bf16x3"] > 0, "none": rec["bf16x3"] == 0, None: True}[bf16x3]
    check(ok, f"{label}: K1 launches {rec}, bf16x3 on {bf16x3} of them")
    if split_k is not None:
        want = rec["launches"] if split_k else 0
        check(rec["split_k"] == want, f"{label}: {rec['split_k']} of {rec['launches']} K1 launches cut k, want {want}")
    PATHS[label] = rec
    print(f"[paths] {label}: K1 launches {rec['launches']}: bf16x3 {rec['bf16x3']}, bf16x6 {rec['bf16x6']}, split-k {rec['split_k']}")


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


# Phase 2's shapes: (B, m, n, label).  The shared form (one A [m, n] for
# every lane) at slices A and B, a ragged shape, slice B's shape with w over
# the IPM's whole clamp range, phase 8's slabs, and one and two lanes at
# slices A's and B's widths (split-k); the per-lane form (a distinct A
# [B, m, n] per lane) at a ragged shape, the clamp range, phase 9 (a)'s and
# slice B's classes, and one and two lanes.  Each shape runs on an A in
# {0, +-1} (bf16x3) and on a general f32 A (bf16x6).
SHARED_SHAPES = (
    (128, 200, 1280, "cell A"),
    (64, 504, 5504, "cell B"),
    (3, 37, 301, "ragged"),
    (64, 504, 5504, "full range"),
    (2, 504, 2752, "slab scpnre"),
    (1, 1024, 5632, "slab scpnrg"),
    (1, 1024, 11264, "scpnrg"),
    (1, 200, 1280, "B=1 scp4x"),
    (2, 200, 1280, "B=2 scp4x"),
    (1, 504, 5504, "B=1 scpnre"),
    (2, 504, 5504, "B=2 scpnre"),
)
PER_LANE_SHAPES = (
    (3, 37, 301, "per-lane ragged"),
    (16, 504, 5504, "per-lane full range"),
    (128, 200, 1280, "per-lane cell A"),
    (64, 504, 5504, "per-lane cell B"),
    (1, 200, 1280, "per-lane B=1 scp4x"),
    (2, 200, 1280, "per-lane B=2 scp4x"),
    (1, 504, 5504, "per-lane B=1 scpnre"),
    (2, 504, 5504, "per-lane B=2 scpnre"),
)
# Phase 10's: the grouped form (one A per instance group of L lanes) at
# bench.py's layout, 10 groups x 128 lanes of the scp4x class, and ragged;
# B is (G, L)
GROUPED_SHAPES = (
    ((10, 128), 200, 1280, "grouped bench"),
    ((3, 5), 37, 301, "grouped ragged"),
)


def hold_against_plain(torch, gram_mod, A32, w, where: str):
    """One input pair of the Gram kernel, of any form (A [m, n] shared by the
    lanes of w [B, n], A [B, m, n] per lane, or A [G, m, n] per group of w
    [G, L, n]), against its plain version and an f64 Gram: max abs error
    within 1e-5 of max |M|, finite, M == M^T bit for bit, per-entry error at
    most 4x plain's, and a second call equal bit for bit.  Returns (max abs
    error vs f64, vs plain, max |M|, per-entry relative error of kernel and
    of plain)."""
    M = gram_mod.gram(A32, w)
    again = gram_mod.gram(A32, w)
    plain = gram_mod.gram_reference(A32, w)
    torch.cuda.synchronize()
    if w.ndim == 3:
        Aw = A32.double()[:, None] * w.double()[..., None, :]
    else:
        Aw = A32.double() * w.double()[:, None]
    G64 = Aw @ Aw.mT
    bound = Aw.abs() @ Aw.abs().mT  # per entry: sum_k |Aw_ik| |Aw_jk|
    del Aw
    scale = G64.abs().max().item()
    err64 = (M.double() - G64).abs().max().item()
    err_plain = (M - plain).abs().max().item()
    check(err64 <= 1e-5 * scale, f"gram vs f64 at {where}: {err64} > 1e-5 * {scale}")
    check(err_plain <= 1e-5 * scale, f"gram vs plain at {where}: {err_plain}")
    check(torch.isfinite(M).all().item(), f"gram output finite at {where}")
    check(torch.equal(M, M.mT), f"gram output symmetric bit for bit at {where}")
    check(torch.equal(M, again), f"gram repeated call equal bit for bit at {where}")
    rel_k = entry_rel_err(M, G64, bound)
    rel_p = entry_rel_err(plain, G64, bound)
    check(rel_k <= 4 * rel_p, f"gram per-entry error at {where}: {rel_k} > 4 x plain {rel_p}")
    return err64, err_plain, scale, rel_k, rel_p


def gram_splits(torch, gram_mod, A32, w) -> int:
    """The k slices gram() cuts for these operands on this card."""
    sms = torch.cuda.get_device_properties(A32.device).multi_processor_count
    return gram_mod._plan(w[..., 0].numel(), A32.shape[-2], A32.shape[-1], sms)


def gram_times(torch, gram_mod, A32, w) -> dict:
    """K1 and its yardsticks on one input pair, each a median of 20 samples
    of CUDA-event-timed calls: ``ms`` on the path gram() takes (``path``,
    ``splits``), ``plain_ms`` (gram_reference), ``library_ms`` (cuBLAS: one
    torch.matmul of a precomputed Aw by its transpose at f32 "highest"); on
    an A exact in bf16 also ``bf16x6_ms``, the six-product path on the same
    A; where k is cut, ``one_pass_ms``, the same path in one slice.  Each
    also as ``*device_ms``, its time per call replayed from a CUDA graph."""
    exact = gram_mod.bf16_exact(A32)
    splits = gram_splits(torch, gram_mod, A32, w)
    Aw = A32[:, None] * w[..., None, :] if w.ndim == 3 else A32 * w[:, None, :]
    calls = {
        "": lambda: gram_mod.gram(A32, w, a_bf16_exact=exact),
        "plain_": lambda: gram_mod.gram_reference(A32, w),
        "library_": lambda: torch.matmul(Aw, Aw.mT),
    }
    if exact:
        calls["bf16x6_"] = lambda: gram_mod.gram(A32, w, a_bf16_exact=False)
    if splits > 1:
        calls["one_pass_"] = lambda: gram_mod._launch(A32, w, exact, 1)
    out = {"path": "bf16x3" if exact else "bf16x6", "splits": splits}
    for key, fn in calls.items():
        out[f"{key}ms"] = time_ms(torch, fn)
        out[f"{key}device_ms"] = device_ms(torch, fn)
    del Aw
    return out


def kernel_phase(torch, gram_mod, dev, card, shapes, form: str):
    """Phase 2 (and 10 (a)): the Gram kernel against its plain version and an
    f64 Gram, with one A shared by the lanes (``form`` "shared"), a distinct
    A per lane ("per_lane"), or one A per instance group ("grouped", B =
    (G, L)); each shape on an A in {0, +-1} (the three-product path) and on
    a general f32 A, uniform in [-1, 1] (the six-product path), with the
    launches checked by form, path and split-k.

    Returns ({label: gram_times of the {0, +-1} A, with ``general_ms`` (and
    ``general_one_pass_ms``) of the general A}, {max abs error vs plain
    outside the full-range shapes, max per-entry relative error of bf16x3,
    of bf16x6 and of plain})."""
    gen = torch.Generator(device=dev).manual_seed({"shared": 0, "per_lane": 1, "grouped": 2}[form])
    errs = {"max_abs_err": 0.0, "bf16x3_entry": 0.0, "bf16x6_entry": 0.0, "plain_entry": 0.0}
    times = {}
    for B, m, n, label in shapes:
        if form == "grouped":
            a_shape, w_shape = (B[0], m, n), (*B, n)
        else:
            a_shape, w_shape = ((B, m, n) if form == "per_lane" else (m, n)), (B, n)
        if "full range" in label:
            # w = sqrt(d2), d2 log-uniform over the IPM's clamp [1e-30, 1e30]
            log_d2 = torch.rand(w_shape, generator=gen, device=dev, dtype=torch.float64) * 60.0 - 30.0
            w = torch.sqrt(10.0**log_d2).float()
        else:
            w = 10.0 ** (torch.rand(w_shape, generator=gen, device=dev) * 9.0 - 6.0)
        for kind in ("bf16x3", "bf16x6"):
            if kind == "bf16x3":
                A32 = torch.randint(-1, 2, a_shape, generator=gen, device=dev).float()
            else:
                A32 = torch.rand(a_shape, generator=gen, device=dev) * 2.0 - 1.0
            if gram_mod.bf16_exact(A32) != (kind == "bf16x3"):
                rounded = A32.to(torch.bfloat16).to(A32.dtype)
                check(False, (
                    f"bf16 exactness of the {kind} A at {label}: {int((rounded != A32).sum())} entries "
                    f"differ from their bf16 rounding; A in [{A32.min().item()}, {A32.max().item()}], "
                    f"rounded in [{rounded.min().item()}, {rounded.max().item()}]"
                ))
            splits = gram_splits(torch, gram_mod, A32, w)
            before = [getattr(gram_mod.gram, c) for c in COUNTERS]
            err64, err_plain, scale, rel_k, rel_p = hold_against_plain(
                torch, gram_mod, A32, w, f"{(B, m, n)} {kind}"
            )
            counted = [getattr(gram_mod.gram, c) - b for c, b in zip(COUNTERS, before)]
            want = [2, 2 * (form == "per_lane"), 2 * (form == "grouped"), 2 * (kind == "bf16x3"), 2 * (splits > 1)]
            check(counted == want, f"K1 counts at {label} {kind}: {counted}, want {want}")
            if "full range" not in label:  # there the absolute error scales with w^2 ~ 1e30
                errs["max_abs_err"] = max(errs["max_abs_err"], err_plain)
            errs[f"{kind}_entry"] = max(errs[f"{kind}_entry"], rel_k)
            errs["plain_entry"] = max(errs["plain_entry"], rel_p)
            if kind == "bf16x3":
                t = times[label] = gram_times(torch, gram_mod, A32, w)
                timing = (
                    f"bf16x3 {t['ms']:.4f} ms, bf16x6 on the same A {t['bf16x6_ms']:.4f} ms, plain "
                    f"{t['plain_ms']:.4f} ms, cuBLAS matmul {t['library_ms']:.4f} ms; device time per "
                    f"call (CUDA graph) {t['device_ms']:.4f} / {t['bf16x6_device_ms']:.4f} / "
                    f"{t['plain_device_ms']:.4f} / {t['library_device_ms']:.4f} ms"
                )
            else:
                t = times[label]

                def general():
                    return gram_mod.gram(A32, w, a_bf16_exact=False)

                t["general_ms"] = time_ms(torch, general)
                t["general_device_ms"] = device_ms(torch, general)
                timing = f"bf16x6 {t['general_ms']:.4f} ms, device {t['general_device_ms']:.4f} ms"
                if splits > 1:
                    t["general_one_pass_ms"] = time_ms(torch, lambda: gram_mod._launch(A32, w, False, 1))
            if splits > 1:
                one = t["one_pass_ms"] if kind == "bf16x3" else t["general_one_pass_ms"]
                timing += f"; split-k {splits} slices, one pass {one:.4f} ms"
            del A32
            print(
                f"[kernel] gram B={B} m={m} n={n} ({label}, {form}, {kind} A): max_abs_err vs f64 "
                f"{err64:.3e} (limit {1e-5 * scale:.3e}), vs plain {err_plain:.3e}; per-entry rel err "
                f"{rel_k:.3e} vs plain {rel_p:.3e} (limit 4x); symmetric; repeat equal; {timing} "
                f"(medians of 20) on {card}"
            )
        del w
    return times, errs


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
    reset_counts(gram_mod)
    state, _ = solve(ell)
    launches = gram_mod.gram.launches
    record_paths(gram_mod, "slice C (ELL)", bf16x3="all", split_k=False)
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

    Returns the K1 launches of both runs, the instance's seed, its MILP
    optimum and, per run, its EllOperatorLog, result and wall (phase 12
    (b))."""
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
    ell_runs = {}
    for name, extra in runs.items():
        cfg = st.SolverConfig(verbosity=3)
        cfg = cfg.replace(bnb=cfg.bnb.replace(hard_time_limit_sec=120.0, **extra))
        _NodeLpSolver.window_stats.clear()
        reset_counts(gram_mod)
        t0 = time.perf_counter()
        with EllOperatorLog() as ell_log:
            r = branch_and_bound(model, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ell_runs[name] = (ell_log, r, wall)
        k1 = gram_mod.gram.launches
        record_paths(gram_mod, f"phase 6 B&B ({name})", bf16x3="some")
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
    return launches, seed, opt, ell_runs


class EllOperatorLog:
    """Watches the B&B's calls of io.standard_form.pad_standard_form_ell
    (through milp.bnb's name for it) while the block runs: per call whether
    the operator came from the cache and its bytes, and per build the rows
    it was built from, so that phase 12 can hold each operator against a
    fresh build of its rows.  With ``clear_cache`` the cache is emptied
    before every call, so that every call builds and uploads."""

    def __init__(self, clear_cache: bool = False):
        self.clear_cache = clear_cache
        self.calls = []  # (hit, bytes of the four ELL tensors)
        self.built = []  # (rows, ell_from_rows keywords, EllMatrix)

    def __enter__(self):
        from sypha_tpu_torch.io import standard_form
        from sypha_tpu_torch.milp import bnb

        self._bnb, self._sf = bnb, standard_form
        real = standard_form.pad_standard_form_ell

        def watched(row_data, rhs, costs, n_struct, m_pad, n_pad, device=None):
            if self.clear_cache:
                standard_form._ELL_DEVICE_CACHE.clear()
            hits = real.hits
            lp = real(row_data, rhs, costs, n_struct, m_pad, n_pad, device=device)
            hit = real.hits > hits
            ell = lp.A
            tensors = (ell.row_idx, ell.row_val, ell.col_idx, ell.col_val)
            self.calls.append((hit, sum(t.numel() * t.element_size() for t in tensors)))
            if not hit:
                rows = [(idx.copy(), val.copy()) for idx, val in row_data]
                kw = dict(n_struct=n_struct, m_pad=m_pad, n_pad=n_pad, device=ell.device)
                self.built.append((rows, kw, ell))
            return lp

        bnb.pad_standard_form_ell = watched
        return self

    def __exit__(self, *exc):
        self._bnb.pad_standard_form_ell = self._sf.pad_standard_form_ell

    @property
    def builds(self) -> int:
        return sum(not hit for hit, _ in self.calls)

    @property
    def hits(self) -> int:
        return sum(hit for hit, _ in self.calls)

    @property
    def mb_not_uploaded(self) -> float:
        return sum(nbytes for hit, nbytes in self.calls if hit) / 1e6


def checkpoint_phase(torch, st, gram_mod, card, seed: int, opt: float):
    """Phase 12 (a): phase 6's instance under phase 6 (b)'s configuration
    with the compact re-solve off, uninterrupted, then cut at
    ``max_nodes=1`` with a checkpoint written at every loop head, then
    resumed from it.

    Returns the walls and K1 launches of the three legs."""
    import os
    import pickle
    import shutil
    import tempfile

    from sypha_tpu_torch.milp import branch_and_bound
    from sypha_tpu_torch.milp.bnb import _NodeLpSolver

    model = st.parse_scp_text(synthetic_scp_text(seed), name=f"syn_scp4x_{seed}")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_checkpoint_")
    ckpt = os.path.join(out_dir, "bnb.ckpt")
    # compact_resolve off: at this instance the root's reductions leave 83 of
    # 1000 columns, and the B&B (the JAX package's too) then delegates the
    # whole tree to a nested search that it never checkpoints, so a cut run
    # would end without a file
    base = {
        "exact_closure": False, "cuts_enabled": False, "compact_resolve": False,
        "max_nodes": 192, "hard_time_limit_sec": 120.0,
    }
    legs = {
        "uninterrupted": {},
        "cut": {"max_nodes": 1, "checkpoint_path": ckpt, "checkpoint_interval_sec": 0.0},
        "resumed": {"checkpoint_path": ckpt, "checkpoint_interval_sec": 30.0},
    }
    out, walls, launches = {}, {}, {}
    saved = None
    for leg, extra in legs.items():
        cfg = st.SolverConfig(verbosity=3)
        cfg = cfg.replace(bnb=cfg.bnb.replace(**{**base, **extra}))
        _NodeLpSolver.window_stats.clear()
        reset_counts(gram_mod)
        t0 = time.perf_counter()
        r = branch_and_bound(model, cfg)
        torch.cuda.synchronize()
        walls[leg] = time.perf_counter() - t0
        launches[leg] = gram_mod.gram.launches
        # cuts off: every row an SCP row
        record_paths(gram_mod, f"phase 12 (a) {leg}", bf16x3="all")
        windows = dict(_NodeLpSolver.window_stats)
        out[leg] = r
        print(
            f"[checkpoint] {leg}: {r.status.name} objective {r.objective:.6f} dual bound "
            f"{r.dual_bound:.6f} nodes {r.nodes_processed} windows {windows} wall "
            f"{walls[leg]:.3f} s gram.launches={launches[leg]} on {card}"
        )
        check(windows.get("failed", 0) == 0, f"phase 12 (a) {leg}: no window degraded")
        check(launches[leg] > 0 and windows.get("ell", 0) > 0, f"phase 12 (a) {leg}: K1 launched in ELL node windows")
        if leg == "cut":
            check(r.status == st.MilpStatus.FEASIBLE, f"phase 12 (a) cut: status {r.status.name}")
            check(os.path.exists(ckpt), f"phase 12 (a): checkpoint {ckpt} written")
            with open(ckpt, "rb") as f:
                saved = pickle.load(f)["processed"]
            print(f"[checkpoint] the resume starts from {saved} processed nodes ({ckpt})")
        else:
            check(r.status == st.MilpStatus.OPTIMAL, f"phase 12 (a) {leg}: status {r.status.name}")
            check(abs(r.objective - opt) <= 1e-9, f"phase 12 (a) {leg}: objective {r.objective} vs scipy {opt}")
    check(
        abs(out["resumed"].objective - out["uninterrupted"].objective) <= 1e-9,
        f"phase 12 (a): resumed {out['resumed'].objective} vs uninterrupted {out['uninterrupted'].objective}",
    )
    check(out["resumed"].nodes_processed > saved, f"phase 12 (a): the resume went on from {saved} nodes")
    shutil.rmtree(out_dir)
    return walls, launches


def cache_phase(torch, st, gram_mod, card, seed: int, opt: float, ell_runs):
    """Phase 12 (b): the ELL operator cache over phase 6's B&B runs: builds,
    hits and the MB not uploaded; every operator built there equal bit for
    bit to a fresh build of its rows (nothing wrote into a shared one);
    then run (b) again with the cache emptied before every call.

    Returns the cleared run's wall and K1 launches."""
    from sypha_tpu_torch.milp import branch_and_bound
    from sypha_tpu_torch.milp.bnb import _NodeLpSolver
    from sypha_tpu_torch.ops.ell import ell_from_rows

    for name, (log, r, wall) in ell_runs.items():
        print(
            f"[cache] phase 6 run ({name}): {len(log.calls)} operator calls, builds {log.builds}, "
            f"hits {log.hits}, {log.mb_not_uploaded:.4f} MB of ELL tensors not uploaded, wall "
            f"{wall:.3f} s on {card}"
        )
    check(sum(log.hits for log, _, _ in ell_runs.values()) > 0, "phase 12 (b): the cache hit in phase 6")
    held = 0
    for log, _, _ in ell_runs.values():
        for rows, kw, ell in log.built:
            fresh = ell_from_rows(rows, **kw)
            for field in ("row_idx", "row_val", "col_idx", "col_val"):
                check(
                    torch.equal(getattr(ell, field), getattr(fresh, field)),
                    f"phase 12 (b): cached operator's {field} as built",
                )
            held += 1
    print(f"[cache] {held} operators equal bit for bit to a fresh build of their rows")

    model = st.parse_scp_text(synthetic_scp_text(seed), name=f"syn_scp4x_{seed}")
    log_b, r_b, wall_b = ell_runs["b"]
    cfg = st.SolverConfig(verbosity=3)
    cfg = cfg.replace(bnb=cfg.bnb.replace(
        hard_time_limit_sec=120.0, exact_closure=False, cuts_enabled=False, max_nodes=192,
    ))
    _NodeLpSolver.window_stats.clear()
    reset_counts(gram_mod)
    t0 = time.perf_counter()
    with EllOperatorLog(clear_cache=True) as cleared:
        r = branch_and_bound(model, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = gram_mod.gram.launches
    record_paths(gram_mod, "phase 12 (b) cache emptied", bf16x3="all")
    print(
        f"[cache] run (b) with the cache emptied before each call: {r.status.name} objective "
        f"{r.objective:.6f} nodes {r.nodes_processed} builds {cleared.builds} hits {cleared.hits} "
        f"wall {wall:.3f} s against {wall_b:.3f} s with the cache (phase 6) gram.launches={k1} on {card}"
    )
    check(cleared.hits == 0 and cleared.builds == len(cleared.calls) > 0, "phase 12 (b): the emptied cache never hit")
    check(k1 > 0, "phase 12 (b): K1 launched with the cache emptied")
    check(r.status == r_b.status, f"phase 12 (b): status {r.status.name} vs {r_b.status.name} with the cache")
    check(abs(r.objective - r_b.objective) <= 1e-9, f"phase 12 (b): objective {r.objective} vs {r_b.objective}")
    check(abs(r.objective - opt) <= 1e-9, f"phase 12 (b): objective {r.objective} vs scipy {opt}")
    return wall, k1


# H100 SXM published peaks (NVIDIA data sheet, dense): f32 outside the tensor
# cores, bf16 on them, HBM3 bandwidth
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12


def gram_bound(B: int, m: int, n: int, matrices: int = 1):
    """Least time of one Gram call on the card: the lower-triangle SYRK's
    f32 FLOPs (2 B m(m+1)/2 n) over the f32 peak, against A (``matrices``
    of [m, n]: 1 shared, B per lane, G grouped), w read once and M written
    once over HBM bandwidth.  Returns (ms, bound_by, bf16x6 ms, bf16x3 ms):
    the last two are the kernel's own tensor-core work, six or three bf16
    products, over the bf16 peak."""
    flops = 2.0 * B * (m * (m + 1) / 2) * n
    bytes_ = 4.0 * (matrices * m * n + B * n + B * m * m)
    ops_ms, bytes_ms = flops / F32_FLOPS * 1e3, bytes_ / HBM_BYTES * 1e3
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), bound_by, 6.0 * flops / BF16_FLOPS * 1e3, 3.0 * flops / BF16_FLOPS * 1e3


def cli_lines(out: str) -> dict:
    """The CLI's ``KEY: value`` result lines."""
    return {
        line.split(":", 1)[0]: line.split(":", 1)[1].strip()
        for line in out.splitlines()
        if ":" in line and line[:1].isupper()
    }


# Loaded by the CLI subprocess of phase 7 through PYTHONPATH: it reports the
# process's K1 launches at exit (all, grouped, bf16x3), then runs the
# interpreter's own sitecustomize, if there is one.
LAUNCH_HOOK = '''
import atexit, importlib.machinery, importlib.util, os, sys

def _report():
    gram = sys.modules.get("sypha_tpu_torch.ops.gram")
    names = ("launches", "launches_grouped", "launches_bf16x3")
    counts = tuple(getattr(gram.gram, n) for n in names) if gram else (0, 0, 0)
    print("GRAM_LAUNCHES %d %d %d" % counts, file=sys.stderr)

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
    Every run's K1 launches are read by path: the SCP runs on bf16x3 only,
    the general LP (coefficients uniform in [-1, 1]) on bf16x6 only, the
    single LPs with k cut.  Then K1 at one lane: the host microseconds of a
    gram() call, and its time at several k slice counts.
    Returns (K1 launches of the Solver and solve_lp_batch runs, K1 launches
    of the in-process CLI run, {label: (latency s, solve s, launches,
    shared-engine solve s)}, {shape: gram_times} at B = 1, and how many of
    the Solver/solve_lp_batch and of the CLI launches were of the per-lane
    form)."""
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

    per_lane = {}  # label -> launches of the per-lane form in that run

    def counted(label, fn, bf16x3="all", split_k=None):
        reset_counts(gram_mod)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gram_mod.gram.launches
        per_lane[label] = gram_mod.gram.launches_per_lane
        check(launches > 0, f"{label}: gram launched")
        record_paths(gram_mod, f"phase 7 {label}", bf16x3=bf16x3, split_k=split_k)
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
            "cli LP", lambda: cli.main(["--input-file", path_b, "--disable-bnb", "--verbosity", "1"]),
            split_k=True,
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
        res, _, launches = counted(f"solve_lp at {label}", lambda: st.solve_lp(lp), split_k=True)
        check(res.converged, f"solve_lp at {label}: {res.status.name}")
        rel = abs(res.primal_objective - ref) / abs(ref)
        check(rel <= 1e-6, f"solve_lp at {label}: {res.primal_objective} vs HiGHS {ref}")
        st.solve_lp(st.pad_lp(model, device=dev))  # warm-up
        one_lane = st.make_shared_batch(lp, 1)
        st.mehrotra_solve_shared(one_lane, st.IpmOptions())
        full, solve, shared_solve = [], [], []
        for _ in range(5):
            t0 = time.perf_counter()
            st.solve_lp(st.pad_lp(model, device=dev))
            full.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            st.solve_lp(lp)
            solve.append(time.perf_counter() - t0)
            # the engine the port's solve_lp ran before the per-lane one, for comparison
            t0 = time.perf_counter()
            sh = st.mehrotra_solve_shared(one_lane, st.IpmOptions())
            sh.status.cpu()
            shared_solve.append(time.perf_counter() - t0)
        latency[label] = (
            statistics.median(full), statistics.median(solve), launches, statistics.median(shared_solve)
        )
        print(
            f"[interfaces] single-LP latency at {label} ({model.nrows}x{model.ncols}, padded "
            f"{lp.m_pad}x{lp.n_pad}): solve_lp(pad_lp(model)) {latency[label][0]:.4f} s, "
            f"solve_lp of a padded LP {latency[label][1]:.4f} s, the shared-matrix engine on one "
            f"lane {latency[label][3]:.4f} s ({int(sh.iterations[0])} iterations) (medians of 5, "
            f"warm, in turns); {res.iterations} iterations, gram.launches={launches}, CONVERGED at "
            f"{res.primal_objective:.10f} (rel {rel:.2e}) on {card}"
        )
    k1_b1 = {}
    gen = torch.Generator(device=dev).manual_seed(1)
    for m, n in ((200, 1280), (504, 5504), (1024, 11264)):
        A32 = torch.randint(-1, 2, (m, n), generator=gen, device=dev).float()
        w = 10.0 ** (torch.rand((1, n), generator=gen, device=dev) * 9.0 - 6.0)
        M = gram_mod.gram(A32, w)
        err = (M - gram_mod.gram_reference(A32, w)).abs().max().item()
        scale = gram_mod.gram_reference(A32, w).abs().max().item()
        check(err <= 1e-5 * scale, f"gram at B=1 ({m}, {n}): {err}")
        t = k1_b1[(1, m, n)] = gram_times(torch, gram_mod, A32, w)
        bound, by, _, floor3 = gram_bound(1, m, n)
        # the host's share of a call: enqueue only (the exactness passed in,
        # as the IPMs pass it), then with the check gram() makes without it
        reps = 200
        for key, exact in (("host_us", True), ("host_us_checked", None)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                gram_mod.gram(A32, w, a_bf16_exact=exact)
            t[key] = (time.perf_counter() - t0) / reps * 1e6
            torch.cuda.synchronize()
        sweep = {
            s_: device_ms(torch, lambda: gram_mod._launch(A32, w, True, s_))
            for s_ in sorted({1, 2, 4, 8, 16, 32, t["splits"]}) if s_ <= -(-n // 16)
        }
        t["sweep"] = sweep
        print(
            f"[interfaces] gram B=1 m={m} n={n}: bf16x3 split-k ({t['splits']} slices) "
            f"{t['ms']:.4f} ms, one pass {t['one_pass_ms']:.4f} ms, bf16x6 {t['bf16x6_ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, cuBLAS matmul {t['library_ms']:.4f} ms (medians of 20); "
            f"device time per call (CUDA graph) {t['device_ms']:.4f} / {t['one_pass_device_ms']:.4f} / "
            f"{t['bf16x6_device_ms']:.4f} / {t['plain_device_ms']:.4f} / "
            f"{t['library_device_ms']:.4f} ms; bound {bound:.4f} ms ({by}; bf16x3 floor "
            f"{floor3:.4f} ms); max_abs_err vs plain {err:.3e}; device ms by k slices "
            f"{json.dumps({k: round(v, 4) for k, v in sweep.items()})} on {card}"
        )
        print(
            f"[interfaces] host us per gram() call at B=1 m={m} n={n}: {t['host_us']:.1f} with "
            f"a_bf16_exact given, {t['host_us_checked']:.1f} with the check in gram() (means of {reps} "
            f"enqueues) on {card}"
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
    sub_launches, _, sub_bf16x3 = (int(v) for v in hook[0].split()[1:])
    check(sub_launches > 0, "cli MILP subprocess: gram launched")
    check(sub_bf16x3 > 0, f"cli MILP subprocess: bf16x3 launched ({sub_bf16x3} of {sub_launches})")
    print(
        f"[interfaces] (b) python3 -m sypha_tpu_torch (default device) on the MILP: rc 0, PRIMAL "
        f"{primal} = scipy {milp_opt}, cover of {len(cols)} columns, ITERATIONS "
        f"{out['ITERATIONS']}, TIME SOLVER {out['TIME SOLVER']} ms, TIME COMPILE "
        f"{out['TIME COMPILE']} ms, process wall {wall:.3f} s, gram.launches={sub_launches} "
        f"(bf16x3 {sub_bf16x3}) on {card}"
    )

    # (c) the Solver, one route per run
    launches_api = 0

    def solve(label, s, bf16x3):
        nonlocal launches_api
        status, wall, launches = counted(label, s.Solve, bf16x3)
        launches_api += launches
        print(
            f"[interfaces] (c) Solver {label}: {status.name} objective {s.objective_value():.10f} "
            f"dual {s.dual_objective_value():.10f} nodes {s.nodes()} iterations "
            f"{s.iterations()} compile_time {s.compile_time():.3f} s wall_time "
            f"{s.wall_time():.3f} s, gram.launches={launches} on {card}"
        )
        return status

    s = scp_solver(Solver, dev, model_a, disable_bnb=True)
    check(solve("LP route, scp4x class", s, "all") == ResultStatus.OPTIMAL, "Solver LP route OPTIMAL")
    rel = abs(s.objective_value() - highs_a) / abs(highs_a)
    check(rel <= 1e-6, f"Solver LP route {s.objective_value()} vs HiGHS {highs_a}")
    s = scp_solver(Solver, dev, milp_model, disable_bnb=False)
    check(solve("SCP MILP route, scp4x class", s, "some") == ResultStatus.OPTIMAL, "Solver SCP MILP OPTIMAL")
    check(abs(s.objective_value() - milp_opt) <= 1e-6, f"Solver SCP MILP {s.objective_value()} vs {milp_opt}")
    s, ref, duals = general_lp(Solver, dev)
    # a general-coefficient A: the six-product path only
    check(solve("LP route, general rows, maximize + offset", s, "none") == ResultStatus.OPTIMAL, "general LP OPTIMAL")
    rel = abs(s.objective_value() - ref) / abs(ref)
    check(rel <= 1e-6, f"general LP objective {s.objective_value()} vs HiGHS {ref}: rel {rel}")
    got = np.array([c.dual_value() for c in s._constraints])
    dual_err = float(np.max(np.abs(got - duals)))
    check(dual_err <= 1e-6, f"general LP constraint duals vs HiGHS: max abs err {dual_err}")
    print(f"[interfaces] (c) general LP: objective rel {rel:.2e} vs HiGHS, duals max abs err {dual_err:.2e}")
    for label, build in (("generic binary route, knapsack", knapsack),
                         ("binarized route, bounded integers", bounded_integers)):
        s, ref = build(Solver, dev)
        check(solve(label, s, None) == ResultStatus.OPTIMAL, f"Solver {label} OPTIMAL")
        check(abs(s.objective_value() - ref) <= 1e-6, f"Solver {label}: {s.objective_value()} vs scipy {ref}")

    # (d) solve_lp_batch: four instances, 16 lanes each, in one bucket
    models = [model_a] + [
        st.parse_scp_text(synthetic_scp_text(seed), name=f"syn_scp4x_{seed}") for seed in (1, 2, 3)
    ]
    refs = [highs_a] + [highs_objective(m) for m in models[1:]]
    lps = [st.pad_lp(m, device=dev) for m in models]
    stacked = st.stack_lps([lps[lane % 4] for lane in range(64)])
    engine = driver.mehrotra_solve
    calls = []

    def counted_engine(lp, *a, **kw):
        calls.append(lp.A.shape[0])
        return engine(lp, *a, **kw)

    driver.mehrotra_solve = counted_engine
    try:
        cold, wall, launches = counted(
            "solve_lp_batch", lambda: st.solve_lp_batch(stacked, as_results=False), split_k=False
        )
        results = st.solve_lp_batch(stacked)
        x0, s0 = cold.x + 0.1, cold.s + 0.1
        warm, warm_wall, warm_launches = counted(
            "solve_lp_batch warm", lambda: st.solve_lp_batch(stacked, warm_start=(x0, cold.y, s0)),
            split_k=False,
        )
    finally:
        driver.mehrotra_solve = engine
    launches_api += launches + warm_launches
    check(calls == [64] * 3, f"solve_lp_batch: one engine call for the 64 lanes, got {calls}")
    for lane, (res, w) in enumerate(zip(results, warm)):
        ref = refs[lane % 4]
        check(res.converged and w.converged, f"solve_lp_batch lane {lane} CONVERGED")
        check(abs(res.primal_objective - ref) / abs(ref) <= 1e-6, f"lane {lane}: {res.primal_objective} vs {ref}")
        check(w.iterations < res.iterations, f"lane {lane}: warm {w.iterations} < cold {res.iterations}")
    cold_it = sorted({r.iterations for r in results})
    warm_it = sorted({r.iterations for r in warm})
    print(
        f"[interfaces] (d) solve_lp_batch of 64 lanes (4 instances x 16, interleaved, padded "
        f"{stacked.m_pad}x{stacked.n_pad}): one per-lane engine call of 64 lanes, all CONVERGED at their "
        f"HiGHS optima {[round(r, 6) for r in refs]}; iterations cold {cold_it}, warm from the "
        f"cold iterates {warm_it}; cold {wall:.3f} s ({launches} gram launches), warm "
        f"{warm_wall:.3f} s ({warm_launches}) on {card}"
    )
    per_lane_cli = per_lane.pop("cli LP")
    per_lane_api = sum(v for k, v in per_lane.items() if not k.startswith("solve_lp at "))
    return launches_api, launches_cli, latency, k1_b1, per_lane_api, per_lane_cli


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
        reset_counts(gram_mod)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = solve_shared_batch_tensor_parallel(batch, st.IpmOptions())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["tp"].append({
            "label": label,
            "wall": wall,
            "launches": gram_mod.gram.launches,
            "bf16x3": gram_mod.gram.launches_bf16x3,
            "split_k": gram_mod.gram.launches_split_k,
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


def lanes_of(st, lp, sl):
    """Lanes ``sl`` of a stacked PaddedLp."""
    import dataclasses

    return st.PaddedLp(**{f.name: getattr(lp, f.name)[sl] for f in dataclasses.fields(lp)})


def multi_device_phase(torch, st, gram_mod, shared, spd, card, batch_a, highs_a, n_real_a,
                       model_b, lp_b, fix0, fix1, node_opts, refs_b, milp_model, milp_opt, lp8):
    """Phase 8: the multi-device paths on the one card.

    Returns (K1 launches of the lane-sharded legs (a) and (c), K1 launches of
    the tensor-parallel ranks (b), K1 launches of the per-lane leg (e),
    {label: wall s} of every leg)."""
    import collections
    import threading

    import numpy as np

    from sypha_tpu_torch.parallel import (
        make_mesh,
        pooled_stats,
        run_spmd,
        solve_lp_batch_sharded,
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

    def counting_gram(A32, w, **kw):
        per_thread[threading.get_ident()] += 1
        return real_gram(A32, w, **kw)

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

    # (e) the per-lane engine: phase 9 (a)'s first 8 lanes on the two shards
    per_thread_lanes = collections.Counter()
    real_spd_gram = spd.gram

    def counting_lane_gram(A32, w, **kw):
        if A32.ndim == 3:
            per_thread_lanes[threading.get_ident()] += 1
        return real_spd_gram(A32, w, **kw)

    whole = st.solve_lp_batch(lp8, as_results=False)  # unsharded, and warm
    torch.cuda.synchronize()
    before = gram_mod.gram.launches_per_lane
    spd.gram = counting_lane_gram
    try:
        t0 = time.perf_counter()
        st_lb, stats_lb = solve_lp_batch_sharded(lp8, st.IpmOptions(), mesh)
        torch.cuda.synchronize()
        walls["per-lane batch sharded"] = time.perf_counter() - t0
    finally:
        spd.gram = real_spd_gram
    launches_lanes = gram_mod.gram.launches_per_lane - before
    check(
        len(per_thread_lanes) == 2 and min(per_thread_lanes.values()) > 0
        and sum(per_thread_lanes.values()) == launches_lanes,
        f"per-lane K1 launched in both shard threads: {dict(per_thread_lanes)}, total {launches_lanes}",
    )
    halves = [st.solve_lp_batch(lanes_of(st, lp8, sl), as_results=False) for sl in (slice(0, 4), slice(4, 8))]
    fields = ("x", "y", "s", "mu", "gap", "res_p", "res_d", "iterations", "status", "best_gap", "stall_count")
    for name in fields:
        check(
            torch.equal(getattr(st_lb, name), torch.cat([getattr(h, name) for h in halves])),
            f"sharded per-lane batch {name} equals its halves through solve_lp_batch",
        )
    check(bool((st_lb.status == st.IpmStatus.CONVERGED).all()), "sharded per-lane batch CONVERGED")
    check(torch.equal(st_lb.status, whole.status), "sharded per-lane batch statuses = unsharded")
    bitwise = [name for name in fields if torch.equal(getattr(st_lb, name), getattr(whole, name))]
    obj_sh = torch.sum(lp8.c * st_lb.x, dim=-1)
    obj_wh = torch.sum(lp8.c * whole.x, dim=-1)
    rel_wh = float(((obj_sh - obj_wh).abs() / obj_wh.abs()).max())
    check(rel_wh <= 1e-8, f"sharded per-lane batch objectives vs unsharded: rel {rel_wh}")
    check(int(stats_lb[2]) == 8, f"sharded per-lane batch pooled converged {int(stats_lb[2])}")
    print(
        f"[multi] (e) solve_lp_batch_sharded of phase 9 (a)'s first 8 lanes (a distinct A each) on "
        f"2 shards of cuda:0: all CONVERGED, bit for bit its two 4-lane halves through "
        f"solve_lp_batch; against the unsharded 8-lane call: statuses equal, fields equal bit for "
        f"bit {bitwise}, objectives max rel {rel_wh:.2e}, iterations "
        f"{st_lb.iterations.cpu().tolist()} vs {whole.iterations.cpu().tolist()}; per-lane K1 "
        f"launches {launches_lanes} ({sorted(per_thread_lanes.values())} per shard thread); "
        f"{walls['per-lane batch sharded']:.4f} s on {card}"
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
            check(leg["bf16x3"] == leg["launches"], f"TP {label} rank {rk}: SCP slab on bf16x3 only, {leg}")
            launches_tp += leg["launches"]
        check(legs[0]["pobj"] == legs[1]["pobj"], f"TP {label}: the ranks gather the same x")
        walls[f"TP {label}"] = legs[0]["wall"]
        print(
            f"[multi] (b) TP {label} on 2 gloo ranks sharing the card: statuses {legs[0]['status']}, "
            f"iterations {legs[0]['iterations']} (unsharded {ref.iterations.cpu().tolist()}), "
            f"objective {legs[0]['pobj'][0]:.10f} vs unsharded {ref_obj[0]:.10f} (rel "
            f"{abs(legs[0]['pobj'][0] - ref_obj[0]) / abs(ref_obj[0]):.2e}) vs HiGHS {highs:.10f}; "
            f"y equal on both ranks: {bool(np.array_equal(legs[0]['y'], legs[1]['y']))}; "
            f"gram.launches {[leg['launches'] for leg in legs]} (bf16x3 {[leg['bf16x3'] for leg in legs]}, "
            f"split-k {[leg['split_k'] for leg in legs]}); TP wall "
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
    return launches_window + launches_a + launches_bnb, launches_tp, launches_lanes, walls


def per_lane_phase(torch, st, gram_mod, spd, card, models_a, lp_a32):
    """Phase 9: the per-lane engine (ipm.dense) through solve_lp_batch.

    (a) the 32 distinct scp4x-class instances of ``lp_a32`` (the main path
    of the per-lane K1, counted from 0), four lanes against HiGHS, then again
    with the plain Gram; (b) 8 distinct scpnre-class instances, two lanes
    against HiGHS; (c) (a)'s first 8 lanes on the Jacobi-CG strategy with a
    tight per-lane tolerance schedule (1e-8 halving to 1e-11: the default
    1e-2 .. 1e-8 schedule ends scp4x-class lanes GAP_STALLED, on purpose, as
    in the JAX package's Krylov tests).  Returns (per-lane K1 launches of
    (a), of (b) and of (c), {label: wall s}, {label: iterations per lane})."""
    import numpy as np

    from sypha_tpu_torch.testing import synthetic_scp

    walls, iters = {}, {}

    def run(label, lp, opts, min_launches=None):
        torch.cuda.synchronize()
        reset_counts(gram_mod)
        t0 = time.perf_counter()
        res = st.solve_lp_batch(lp, opts)
        walls[label] = time.perf_counter() - t0
        iters[label] = [r.iterations for r in res]
        launches = gram_mod.gram.launches_per_lane
        record_paths(gram_mod, f"phase 9 {label}", bf16x3="all")
        check(launches > 0 and launches == gram_mod.gram.launches, f"phase 9 {label}: per-lane K1 launches {launches}")
        need = max(iters[label]) + 1 if min_launches is None else min_launches
        check(launches >= need, f"phase 9 {label}: {launches} per-lane K1 launches < {need}")
        check(all(r.converged for r in res), f"phase 9 {label}: statuses {[r.status.name for r in res]}")
        return res, launches

    def against_highs(label, res, models, lanes):
        rels = []
        for lane in lanes:
            ref = highs_objective(models[lane])
            rel = abs(res[lane].primal_objective - ref) / abs(ref)
            check(rel <= 1e-6, f"phase 9 {label} lane {lane}: {res[lane].primal_objective} vs HiGHS {ref}")
            rels.append(rel)
        return max(rels)

    # (a) 32 distinct scp4x-class instances
    opts = st.IpmOptions()
    res_a, launches_a = run("(a)", lp_a32, opts)
    rel_a = against_highs("(a)", res_a, models_a, range(4))
    spd.gram = gram_mod.gram_reference
    try:
        t0 = time.perf_counter()
        plain = st.solve_lp_batch(lp_a32, opts)
        walls["(a) plain Gram"] = time.perf_counter() - t0
    finally:
        spd.gram = gram_mod.gram
    check([r.status for r in plain] == [r.status for r in res_a], "phase 9 (a) statuses, kernel vs plain Gram")
    rel_p = max(abs(r.primal_objective - p.primal_objective) / abs(p.primal_objective) for r, p in zip(res_a, plain))
    check(rel_p <= 1e-8, f"phase 9 (a) objectives, kernel vs plain Gram: rel {rel_p}")
    print(
        f"[per-lane] (a) solve_lp_batch of 32 distinct scp4x-class LPs (padded "
        f"{lp_a32.m_pad}x{lp_a32.n_pad}): all CONVERGED, lanes 0-3 vs HiGHS max rel {rel_a:.2e}; "
        f"iterations {iters['(a)']}; per-lane K1 launches {launches_a}; wall {walls['(a)']:.4f} s; "
        f"plain Gram: statuses equal, objectives max rel {rel_p:.2e}, iterations "
        f"{[r.iterations for r in plain]}, wall {walls['(a) plain Gram']:.4f} s on {card}"
    )

    # (b) 8 distinct scpnre-class instances
    models_b = [st.parse_scp_text(synthetic_scp(500, 5000, 0.10, seed=s), name=f"syn_scpnre_{s}") for s in range(8)]
    lp_b8 = st.stack_lps([st.pad_lp(m, device=lp_a32.c.device) for m in models_b])
    res_b, launches_b = run("(b)", lp_b8, opts)
    rel_b = against_highs("(b)", res_b, models_b, range(2))
    print(
        f"[per-lane] (b) solve_lp_batch of 8 distinct scpnre-class LPs (padded "
        f"{lp_b8.m_pad}x{lp_b8.n_pad}, A in f64 and f32 {lp_b8.A.numel() * 12 / 2**20:.0f} MiB): "
        f"all CONVERGED, lanes 0-1 vs HiGHS max rel {rel_b:.2e}; iterations {iters['(b)']}; "
        f"per-lane K1 launches {launches_b}; wall {walls['(b)']:.4f} s on {card}"
    )
    del lp_b8

    # (c) the CG strategy on (a)'s first 8 lanes
    cg = st.IpmOptions(linear_solver="cg", cg_tol_initial=1e-8, cg_tol_final=1e-11, cg_max_iter=2000)
    res_c, launches_c = run("(c)", lanes_of(st, lp_a32, slice(0, 8)), cg, min_launches=1)
    rel_c = max(abs(r.primal_objective - a.primal_objective) / abs(a.primal_objective) for r, a in zip(res_c, res_a))
    check(rel_c <= 1e-7, f"phase 9 (c) objectives vs (a): rel {rel_c}")
    rel_ch = against_highs("(c)", res_c, models_a, range(4))
    print(
        f"[per-lane] (c) the same first 8 lanes on the Jacobi-CG strategy (cg_tol 1e-8 -> 1e-11): "
        f"all CONVERGED, vs HiGHS max rel {rel_ch:.2e}, vs (a) max rel {rel_c:.2e}; iterations "
        f"{iters['(c)']}; per-lane K1 launches {launches_c} (its initial point); wall "
        f"{walls['(c)']:.4f} s on {card}"
    )
    print(f"[per-lane] (d) walls (s) {json.dumps(walls)}; iterations per lane {json.dumps(iters)} on {card}")
    return launches_a, launches_b, launches_c, walls, iters


def grouped_phase(torch, st, shared, gram_mod, dev, card):
    """Phase 10: the grouped shared-matrix solve, bench.py's layout.

    (a) K1's grouped form against its plain version at GROUPED_SHAPES; (b)
    10 seeded scp4x-class instances x 128 lanes in one bucket through
    stack_shared_batches and one mehrotra_solve_shared call (the grouped
    K1's main path, its counts set to 0 just before), every lane against
    HiGHS; (c) the same solve with the plain Gram, and each group alone on
    the ungrouped engine in turn; (d) ``python3 -m sypha_tpu_torch.bench``
    as users run it, its JSON line parsed.  Returns (grouped K1 launches of
    (b), kernel times and errors as kernel_phase returns them, {label: wall
    s})."""
    import atexit
    import os
    import shutil
    import tempfile

    import numpy as np

    times, errs = kernel_phase(torch, gram_mod, dev, card, GROUPED_SHAPES, form="grouped")

    # (b) bench.py's layout: one bucket, 10 groups x 128 lanes
    models = [st.parse_scp_text(synthetic_scp_text(seed), name=f"syn_scp4x_{seed}") for seed in range(10)]
    mp = max(m.nrows for m in models)
    np_ = max(m.nrows + m.ncols for m in models)
    mp += (-mp) % 8
    np_ += (-np_) % 128
    lanes = 128
    lps = [st.pad_lp(m, m_pad=mp, n_pad=np_, device=dev) for m in models]
    batches = [st.make_shared_batch(lp, lanes) for lp in lps]
    grouped = st.stack_shared_batches(batches)
    real = torch.stack([torch.arange(np_, device=dev) < lp.n_real for lp in lps])[:, None, :]
    opts = st.IpmOptions()
    walls = {}

    def objectives(c, x):
        return torch.sum(torch.where(real, c * x, 0.0), dim=-1).cpu().numpy()

    st.mehrotra_solve_shared(grouped, opts)  # warm-up at this shape
    torch.cuda.synchronize()
    reset_counts(gram_mod)
    t0 = time.perf_counter()
    state = st.mehrotra_solve_shared(grouped, opts)
    torch.cuda.synchronize()
    walls["grouped"] = time.perf_counter() - t0
    launches = gram_mod.gram.launches_grouped
    record_paths(gram_mod, "phase 10 (b) grouped", bf16x3="all", split_k=False)
    check(gram_mod.gram.launches == launches, f"every K1 launch grouped: {gram_mod.gram.launches} vs {launches}")
    status = state.status.cpu().numpy()
    iters = state.iterations.cpu().numpy()
    obj = objectives(grouped.c, state.x)
    check(state.x.shape == (10, lanes, np_) and bool(torch.isfinite(state.x).all()), "grouped x shape, finite")
    check(bool(np.all(status == st.IpmStatus.CONVERGED)), f"phase 10 (b) statuses {np.unique(status)}")
    check(launches >= int(iters.max()) + 1, f"grouped K1 launches {launches} < iterations + 1")
    highs = np.array([highs_objective(m) for m in models])
    rel_h = np.abs(obj - highs[:, None]) / np.abs(highs[:, None])
    check(rel_h.max() <= 1e-6, f"phase 10 (b) objectives vs HiGHS: max rel {rel_h.max()}")
    print(
        f"[grouped] (b) 10 groups x {lanes} lanes of scp4x-class LPs (padded {mp}x{np_}) in one "
        f"grouped solve: all CONVERGED, every group vs HiGHS max rel {rel_h.max():.2e}; iterations "
        f"per group {iters.max(axis=1).tolist()}; grouped K1 launches {launches} (of "
        f"{gram_mod.gram.launches}); wall {walls['grouped']:.4f} s = "
        f"{10 * lanes / walls['grouped']:.2f} solves/s on {card}"
    )

    # (c) the plain Gram; then each group alone on the ungrouped engine
    shared.gram = gram_mod.gram_reference
    try:
        t0 = time.perf_counter()
        plain = st.mehrotra_solve_shared(grouped, opts)
        torch.cuda.synchronize()
        walls["grouped plain Gram"] = time.perf_counter() - t0
    finally:
        shared.gram = gram_mod.gram
    check(np.array_equal(plain.status.cpu().numpy(), status), "phase 10 (c) statuses, kernel vs plain Gram")
    rel_p = np.max(np.abs(objectives(grouped.c, plain.x) - obj) / np.abs(obj))
    check(rel_p <= 1e-8, f"phase 10 (c) objectives, kernel vs plain Gram: rel {rel_p}")
    alone_walls, alone_iters, rel_alone = [], [], 0.0
    for g, batch in enumerate(batches):
        t0 = time.perf_counter()
        one = st.mehrotra_solve_shared(batch, opts)
        torch.cuda.synchronize()
        alone_walls.append(time.perf_counter() - t0)
        check(np.array_equal(one.status.cpu().numpy(), status[g]), f"phase 10 (c) group {g} statuses alone")
        obj_g = objectives(batch.c[None], one.x[None])[0]
        rel_alone = max(rel_alone, float(np.max(np.abs(obj_g - obj[g]) / np.abs(obj[g]))))
        alone_iters.append(one.iterations.cpu().numpy())
    check(rel_alone <= 1e-8, f"phase 10 (c) objectives, grouped vs groups alone: rel {rel_alone}")
    d_iters = np.abs(np.stack(alone_iters) - iters)
    check(d_iters.max() <= 1, f"phase 10 (c) iterations, grouped vs alone differ by {d_iters.max()}")
    if d_iters.max() > 0:
        lanes_off = [tuple(int(i) for i in ix) for ix in np.argwhere(d_iters > 0)]
        print(f"[grouped] (c) iterations differ on lanes {lanes_off[:20]}: grouped "
              f"{[int(iters[ix]) for ix in lanes_off[:20]]}, alone "
              f"{[int(np.stack(alone_iters)[ix]) for ix in lanes_off[:20]]}")
    walls["groups alone, sum"] = sum(alone_walls)
    print(
        f"[grouped] (c) plain Gram: statuses equal, objectives max rel {rel_p:.2e}, wall "
        f"{walls['grouped plain Gram']:.4f} s; each group alone: statuses equal, objectives max rel "
        f"{rel_alone:.2e}, iterations equal on {int((d_iters == 0).sum())} of {d_iters.size} lanes; "
        f"grouped wall {walls['grouped']:.4f} s against the groups in turn {walls['groups alone, sum']:.4f} s "
        f"({', '.join(f'{w:.4f}' for w in alone_walls)}) on {card}"
    )

    # (d) the bench as users run it, its K1 launches reported by the hook
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    with open(os.path.join(tmp, "sitecustomize.py"), "w") as f:
        f.write(LAUNCH_HOOK)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (tmp, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sypha_tpu_torch.bench"], capture_output=True, text=True, timeout=600,
        env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    walls["bench process"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"bench rc {proc.returncode}: {proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    hist = {int(k): v for k, v in res["iterations_histogram"].items()}
    check(res["value"] > 0, f"bench value {res['value']}")
    check(res["lanes"] == res["lanes_converged"] == 10 * lanes, f"bench lanes {res['lanes']}, converged {res['lanes_converged']}")
    check(sum(hist.values()) == res["lanes"], "bench histogram covers every lane")
    check(sum(k * v for k, v in hist.items()) == res["ipm_iters_total"], "bench ipm_iters_total = its lanes' iterations")
    hook = [line for line in proc.stderr.splitlines() if line.startswith("GRAM_LAUNCHES ")]
    check(len(hook) == 1, "bench subprocess reported its gram launches")
    bench_launches = [int(v) for v in hook[0].split()[1:]]
    # the grouped solves launch the grouped form, the single-LP ones the shared
    check(0 < bench_launches[1] < bench_launches[0], f"bench subprocess gram launches {bench_launches}")
    check(bench_launches[2] == bench_launches[0], f"bench subprocess: SCP rows on bf16x3 only, {bench_launches}")
    same = hist == {int(k): int(v) for k, v in zip(*np.unique(iters, return_counts=True))}
    print(
        f"[grouped] (d) python3 -m sypha_tpu_torch.bench: rc 0, value {res['value']} {res['unit']}, "
        f"vs_baseline {res['vs_baseline']}, single-LP latency {res['single_lp_latency_s']} s (min "
        f"{res['single_lp_latency_min_s']}), achieved {res['achieved_tflops']} TFLOP/s, "
        f"ipm_iters_total {res['ipm_iters_total']}, {res['lanes_converged']}/{res['lanes']} converged, "
        f"iterations histogram {res['iterations_histogram']} ({'equal to' if same else 'differs from'} (b)'s), "
        f"gram launches {bench_launches[0]} ({bench_launches[1]} grouped, {bench_launches[2]} bf16x3), process wall "
        f"{walls['bench process']:.3f} s, device {res['device']!r}"
    )
    print(f"[grouped] (d) bench line: {proc.stdout.strip().splitlines()[-1]}")
    return launches, times, errs, walls


def tools_phase(torch, gram_mod, shared, spd, card):
    """Phase 11: the sweep and study tools (sypha_tpu_torch.benchmark), each
    ``main`` called in process on --synthetic instances on the default
    device, with K1's counts set to 0 just before and read just after:

    (a) run_benchmark --lp-only over scp4: 10 rows OPTIMAL at HiGHS's
    optimum; (b) run_benchmark MILP on scp41 and scp48: OPTIMAL at scipy's
    MILP optimum, dual <= primal, the warm-up seconds apart; (c) lp_parity
    --scipy over scp4 and scpnre: every row PASS; (d) ell_vs_dense at 64
    lanes on scp41, scpnre1 and scpnrg1: K1 launched on both operators,
    lanes converged on both within 1e-6, lane 0 within 1e-6 of HiGHS, at
    most 1/8 of lanes flipping status; (e) root_cut_study scpnre1 over two
    rounds: the dual bound never falls.

    Every K1 call a tool makes is recorded, and after the tool (its counts
    read) the last (A, w) of each distinct shape is held against the plain
    Gram and an f64 Gram as in phase 2; the largest shape of each tool and
    form is timed.  Returns ({tool: (K1 launches, of them per lane)}, {tool:
    wall s}, {(tool, form): record of its shapes})."""
    import atexit
    import contextlib
    import csv
    import io
    import os
    import shutil
    import tempfile

    import numpy as np
    from scipy.optimize import Bounds, LinearConstraint, milp

    from sypha_tpu_torch import benchmark
    from sypha_tpu_torch.benchmark import ell_vs_dense, lp_parity, root_cut_study, run_benchmark

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    launches, walls, held = {}, {}, {}

    def model(name):
        return benchmark.load(benchmark.require_source(name, None, True), name)

    def rows(name):
        with open(os.path.join(tmp, name), newline="") as f:
            return list(csv.DictReader(f))

    def hold_inputs(label, seen):
        """The kernel against its plain version on the tool's own inputs."""
        for form in ("shared", "per_lane", "grouped"):
            pairs = [(key, A32, w) for key, (A32, w) in seen.items() if key[0] == form]
            if not pairs:
                continue
            rec = {"shapes": len(pairs), "max_rel_err": 0.0, "max_entry_rel_err": 0.0,
                   "plain_max_entry_rel_err": 0.0}
            for key, A32, w in pairs:
                where = f"{label} {form} A {list(A32.shape)} w {list(w.shape)}"
                _, err_plain, scale, rel_k, rel_p = hold_against_plain(torch, gram_mod, A32, w, where)
                rec["max_rel_err"] = max(rec["max_rel_err"], err_plain / scale if scale > 0 else 0.0)
                rec["max_entry_rel_err"] = max(rec["max_entry_rel_err"], rel_k)
                rec["plain_max_entry_rel_err"] = max(rec["plain_max_entry_rel_err"], rel_p)
            # the largest call of the tool in this form, by the SYRK's FLOPs
            _, A32, w = max(pairs, key=lambda p: p[2][..., 0].numel() * p[1].shape[-2] ** 2 * p[1].shape[-1])
            B, m, n = w[..., 0].numel(), A32.shape[-2], A32.shape[-1]
            rec["shape"] = [B, m, n]
            rec.update(gram_times(torch, gram_mod, A32, w))
            rec["bound_ms"], rec["bound_by"], _, rec["bf16x3_floor_ms"] = gram_bound(
                B, m, n, matrices=1 if A32.ndim == 2 else A32.shape[0]
            )
            held[(label, form)] = rec
            print(
                f"[tools] {label}: K1 ({form}) held against the plain and the f64 Gram on the last "
                f"inputs of each of its {rec['shapes']} shapes: max rel err vs plain "
                f"{rec['max_rel_err']:.3e} (limit 1e-5), per-entry rel err {rec['max_entry_rel_err']:.3e} "
                f"vs plain {rec['plain_max_entry_rel_err']:.3e} (limit 4x), symmetric; at its largest, "
                f"B={B} m={m} n={n}: kernel ({rec['path']}, {rec['splits']} k slices) {rec['ms']:.4f} ms"
                + (f", bf16x6 {rec['bf16x6_ms']:.4f} ms" if "bf16x6_ms" in rec else "")
                + f", plain {rec['plain_ms']:.4f} ms, cuBLAS matmul {rec['library_ms']:.4f} ms (medians "
                f"of 20), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}) on {card}"
            )

    def run(label, tool, argv):
        seen = {}  # (form, A shape, w shape) -> the last (A, w) given to K1
        calls = [0]

        def recording(real):
            def gram(A32, w, **kw):
                calls[0] += 1
                form = "grouped" if w.ndim == 3 else "per_lane" if A32.ndim == 3 else "shared"
                seen[(form, tuple(A32.shape), tuple(w.shape))] = (A32, w.clone())
                return real(A32, w, **kw)
            return gram

        reset_counts(gram_mod)
        buf = io.StringIO()
        shared.gram, spd.gram = recording(gram_mod.gram), recording(gram_mod.gram)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = tool.main(argv + ["--synthetic"])
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
        finally:
            shared.gram = spd.gram = gram_mod.gram
        launches[label] = (gram_mod.gram.launches, gram_mod.gram.launches_per_lane)
        # the tools' MILP and cut rounds append integer cut rows
        record_paths(gram_mod, f"phase 11 {label}", bf16x3="some" if "milp" in label or "cut" in label else "all")
        out = buf.getvalue()
        print("".join(f"[tools] {label} | {line}\n" for line in out.splitlines()), end="")
        check(rc == 0, f"phase 11 {label}: rc {rc}")
        check(launches[label][0] > 0, f"phase 11 {label}: K1 launched")
        check(calls[0] == launches[label][0], f"phase 11 {label}: {calls[0]} K1 calls recorded, {launches[label][0]} launched")
        print(
            f"[tools] {label}: rc 0, wall {walls[label]:.3f} s, K1 launches {launches[label][0]} "
            f"({launches[label][1]} per lane) on {card}"
        )
        hold_inputs(label, seen)
        return out

    # (a) LP rows over the scp4 family
    run("run_benchmark lp", run_benchmark, ["--lp-only", "--families", "scp4", "--out", tmp])
    lp_rows = rows("sypha_tpu_lp_scp4_results.csv")
    check(len(lp_rows) == 10, f"phase 11 (a): {len(lp_rows)} rows")
    worst = 0.0
    for row in lp_rows:
        name = row["instance"].split()[-1]
        check(row["instance"] == f"synthetic {name}", f"phase 11 (a) row {row['instance']} named synthetic")
        check(row["status"] == "OPTIMAL", f"phase 11 (a) {name}: {row['status']}")
        ref = highs_objective(model(name))
        worst = max(worst, abs(float(row["primal"]) - ref) / abs(ref))
    check(worst <= 1e-6, f"phase 11 (a) primal vs HiGHS: max rel {worst}")
    print(f"[tools] (a) 10 scp4 LP rows OPTIMAL, primal vs HiGHS max rel {worst:.2e}")

    # (b) MILP rows on scp41 and scp48
    run("run_benchmark milp", run_benchmark,
        ["--families", "scp4", "--instances", "scp41,scp48", "--time-limit", "60", "--out", tmp])
    milp_rows = rows("sypha_tpu_milp_scp4_results.csv")
    check([r["instance"] for r in milp_rows] == ["synthetic scp41", "synthetic scp48"], "phase 11 (b) rows")
    for row in milp_rows:
        m = model(row["instance"].split()[-1])
        ip = milp(c=m.costs, constraints=LinearConstraint(m.dense_matrix(), lb=1.0),
                  integrality=np.ones(m.ncols), bounds=Bounds(0, 1))
        check(ip.status == 0, f"scipy MILP on {row['instance']}: {ip.message}")
        check(row["status"] == "OPTIMAL", f"phase 11 (b) {row['instance']}: {row['status']}")
        check(abs(float(row["incumbent"]) - ip.fun) <= 1e-6, f"phase 11 (b) {row['instance']}: {row['incumbent']} vs {ip.fun}")
        check(float(row["dual"]) <= float(row["primal"]) + 1e-6, f"phase 11 (b) {row['instance']}: dual above primal")
        print(
            f"[tools] (b) {row['instance']}: OPTIMAL {row['incumbent']} = scipy {ip.fun:.6f}, dual {row['dual']}, "
            f"time_solver_s {row['time_solver_s']}, time_compile_s {row['time_compile_s']} on {card}"
        )

    # (c) LP parity against HiGHS
    out = run("lp_parity", lp_parity, ["--scipy", "--families", "scp4,scpnre", "--csv-dir", tmp])
    parity = rows("scp4_sypha_tpu_lp_results.csv") + rows("scpnre_sypha_tpu_lp_results.csv")
    check(len(parity) == 15 and all(r["exit_code"] == "0" for r in parity), "phase 11 (c) every row PASS")
    check(out.splitlines()[-1] == "15/15 passed", f"phase 11 (c): {out.splitlines()[-1]}")

    # (d) the ELL against the dense operator
    out = run("ell_vs_dense", ell_vs_dense,
              ["--lanes", "64", "--instances", "scp41,scpnre1,scpnrg1", "--out", tmp])
    records = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    check(len(records) == 3, "phase 11 (d) records")
    for rec in records:
        name = rec["instance"]
        ref = highs_objective(model(name.split()[-1]))
        check(rec["dense_gram_launches"] > 0 and rec["sparse_gram_launches"] > 0, f"phase 11 (d) {name}: K1 on both operators")
        check(rec["lanes_flipped"] <= 64 // 8, f"phase 11 (d) {name}: {rec['lanes_flipped']} lanes flipped")
        check(rec["max_rel_diff_converged"] <= 1e-6, f"phase 11 (d) {name}: operators differ by {rec['max_rel_diff_converged']}")
        rel = max(abs(rec[f"{op}_obj"] - ref) / abs(ref) for op in ("dense", "sparse"))
        check(rel <= 1e-6, f"phase 11 (d) {name}: lane 0 vs HiGHS rel {rel}")
        print(f"[tools] (d) {name}: lane 0 vs HiGHS {ref:.6f} max rel {rel:.2e} on {card}")

    # (e) the root cut study
    out = run("root_cut_study", root_cut_study, ["scpnre1", "--rounds", "2"])
    duals = [json.loads(line)["dual"] for line in out.splitlines() if line.startswith('{"round"') and '"dual"' in line]
    check(len(duals) >= 2, f"phase 11 (e): {len(duals)} rounds")
    check(all(b >= a - 1e-6 for a, b in zip(duals, duals[1:])), f"phase 11 (e) dual bound falls: {duals}")
    print(f"[tools] (e) dual bound per round {duals}")
    return launches, walls, held


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
    from sypha_tpu_torch.ops import spd
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
    # the card to its clocks before the first timing: about a second of GEMMs
    x = torch.randn(8192, 8192, device=dev)
    for _ in range(50):
        x @ x
    torch.cuda.synchronize()
    del x
    times, errs = kernel_phase(torch, gram_mod, dev, card, SHARED_SHAPES, form="shared")
    times_pl, errs_pl = kernel_phase(torch, gram_mod, dev, card, PER_LANE_SHAPES, form="per_lane")

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

    reset_counts(gram_mod)
    pcg_solve.steps = 0
    timers.start("slice_a_solve")
    t0 = time.perf_counter()
    state_a = st.mehrotra_solve_shared(batch_a, opts)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    timers.stop("slice_a_solve")
    launches_a = gram_mod.gram.launches
    cg_steps_a = pcg_solve.steps
    record_paths(gram_mod, "slice A", bf16x3="all", split_k=False)

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
        f"cg_steps={cg_steps_a} (host syncs: one per IPM iteration and per read of the PCG's flag)"
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
    k1_dev = {"slice A": profiled(torch, lambda: st.mehrotra_solve_shared(batch_a, opts))}

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
    reset_counts(gram_mod)
    pcg_solve.steps = 0
    timers.start("slice_b_solve")
    t0 = time.perf_counter()
    state_b, x_full, pobj, dobj = st.solve_node_batch(lp_b, fix0, fix1, node_opts)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    timers.stop("slice_b_solve")
    launches_b = gram_mod.gram.launches
    cg_steps_b = pcg_solve.steps
    record_paths(gram_mod, "slice B", bf16x3="all", split_k=False)
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
    k1_dev["slice B"] = profiled(torch, lambda: st.solve_node_batch(lp_b, fix0, fix1, node_opts))
    for label, launches in (("slice A", launches_a), ("slice B", launches_b)):
        k1_ms, k1_calls, all_ms, wall = k1_dev[label]
        if k1_ms is None:
            print(f"[{label}] profiled run: the profiler recorded no device time; K1 device time not measured")
            continue
        print(
            f"[{label}] profiled run: K1 device time {k1_ms:.4f} ms in {k1_calls} kernels "
            f"({'all' if k1_calls == launches else 'an incomplete profile: not all'} of the "
            f"{launches} launched in the counted run), all kernels {all_ms:.4f} ms, wall "
            f"{wall:.4f} s (device busy {all_ms / 1e3 / wall:.1%}, profiler on) on {card}"
        )

    # -- phase 5: slice C, the padded-ELL operator --------------------------
    timers.start("slice_c")
    launches_ell = slice_c_phase(torch, st, gram_mod, dev, card, model_a, highs_a)
    timers.stop("slice_c")

    # -- phase 6: MILP, branch and bound -------------------------------------
    timers.start("milp")
    launches_bnb, milp_seed, milp_opt, ell_runs = milp_phase(torch, st, gram_mod, card)
    timers.stop("milp")

    # -- phase 7: the user entry points ---------------------------------------
    timers.start("interfaces")
    launches_api, launches_cli, latency, k1_b1, per_lane_api, per_lane_cli = interfaces_phase(
        torch, st, gram_mod, dev, card, model_a, highs_a, model_b, milp_seed, milp_opt
    )
    timers.stop("interfaces")

    # -- phase 8: multi-device on the one card -----------------------------------
    # phase 9 (a)'s lanes: 32 distinct scp4x-class instances, one bucket
    timers.start("per_lane_setup")
    models_9 = [st.parse_scp_text(synthetic_scp_text(seed), name=f"syn_scp4x_{seed}") for seed in range(32)]
    lp_9 = st.stack_lps([st.pad_lp(m, device=dev) for m in models_9])
    timers.stop("per_lane_setup")

    timers.start("multi_device")
    milp_model = st.parse_scp_text(synthetic_scp_text(milp_seed), name=f"syn_scp4x_{milp_seed}")
    launches_mesh, launches_tp, launches_mesh_lanes, walls = multi_device_phase(
        torch, st, gram_mod, shared, spd, card, batch_a, highs_a, n_real, model_b, lp_b, fix0, fix1,
        node_opts, refs_b, milp_model, milp_opt, lanes_of(st, lp_9, slice(0, 8)),
    )
    timers.stop("multi_device")

    # -- phase 9: the per-lane engine ------------------------------------------
    timers.start("per_lane")
    launches_9a, launches_9b, launches_9c, walls_9, iters_9 = per_lane_phase(
        torch, st, gram_mod, spd, card, models_9, lp_9
    )
    timers.stop("per_lane")

    # -- phase 10: the grouped solve, bench.py's layout ---------------------------
    timers.start("grouped")
    launches_10, times_g, errs_g, walls_10 = grouped_phase(torch, st, shared, gram_mod, dev, card)
    timers.stop("grouped")

    # -- phase 11: the sweep and study tools -----------------------------------
    timers.start("tools")
    launches_11, walls_11, held_11 = tools_phase(torch, gram_mod, shared, spd, card)
    timers.stop("tools")

    # -- phase 12: checkpoint/resume and the ELL operator cache ------------------
    timers.start("lifecycle")
    walls_12, launches_12 = checkpoint_phase(torch, st, gram_mod, card, milp_seed, milp_opt)
    walls_12["cache emptied (b)"], launches_12["cache emptied (b)"] = cache_phase(
        torch, st, gram_mod, card, milp_seed, milp_opt, ell_runs
    )
    walls_12["cache (b), phase 6"] = ell_runs["b"][2]
    timers.stop("lifecycle")
    print(timers.report())
    print(f"phase 8 walls (s): {json.dumps(walls)} on {card}")
    print(f"phase 9 walls (s): {json.dumps(walls_9)}; iterations {json.dumps(iters_9)} on {card}")
    print(f"phase 10 walls (s): {json.dumps(walls_10)} on {card}")
    print(f"phase 11 walls (s): {json.dumps(walls_11)} on {card}")
    print(f"phase 12 walls (s): {json.dumps(walls_12)}; K1 launches {json.dumps(launches_12)} on {card}")
    for label, (full_s, solve_s, k1, shared_s) in latency.items():
        print(
            f"single-LP latency, {label}: {full_s:.4f} s with pad_lp, {solve_s:.4f} s solve only, "
            f"{k1} gram launches; shared-matrix engine on one lane {shared_s:.4f} s (medians of 5, "
            f"warm) on {card}"
        )

    def shapes(times_by_label, table, grouped=False):
        """Phase 2's (10 (a)'s) times per shape, with the bound and floors."""
        out = {}
        for B, m, n, label in table:
            lanes, matrices = (B[0] * B[1], B[0]) if grouped else (B, B if label.startswith("per-lane") else 1)
            bound, by, floor6, floor3 = gram_bound(lanes, m, n, matrices=matrices)
            t = times_by_label[label]
            out[label] = {"shape": [lanes, m, n], **t, "bound_ms": bound, "bound_by": by,
                          "share": bound / t["ms"], "bf16x6_floor_ms": floor6, "bf16x3_floor_ms": floor3}
        return out

    design = (
        "lower-triangle 64x64 tiles, mma.sync m16n8k16 + cp.async; bf16x3 (A and a 3-way split "
        "of A*w^2) where A is exact in bf16, else bf16x6 (3-way splits of A*w, six products); "
        "split-k with a fixed-order second pass below two CTAs a SM"
    )
    shared_shapes = shapes(times, SHARED_SHAPES)
    per_lane_shapes = shapes(times_pl, PER_LANE_SHAPES)
    grouped_shapes = shapes(times_g, GROUPED_SHAPES, grouped=True)

    def main_path(label, shape):
        """The required keys of one kernels-line entry: the launches of
        ``label``'s run, by path, and the kernel's numbers at ``shape``."""
        rec = PATHS[label]
        return {
            "launches": rec["launches"],
            "launches_bf16x3": rec["bf16x3"],
            "launches_bf16x6": rec["bf16x6"],
            "launches_split_k": rec["split_k"],
            "ms": shape["ms"],
            "plain_ms": shape["plain_ms"],
            "bound_ms": shape["bound_ms"],
            "bound_by": shape["bound_by"],
            "library_ms": shape["library_ms"],
        }

    print(json.dumps({"kernels": [{
        "name": "gram",
        "route": "cuda",
        "source": "sypha_tpu_torch/csrc/gram.cu",
        "replaces": "sypha_tpu/ops/pallas_gram.py:40",
        **main_path("slice A", shared_shapes["cell A"]),
        "max_abs_err": errs["max_abs_err"],
        "design": design,
        "library": "torch.matmul(Aw, Aw.mT), Aw precomputed, f32 highest (cuBLAS)",
        "launches_slice_b": launches_b,
        "launches_ell": launches_ell,
        "launches_bnb": launches_bnb,
        "launches_api": launches_api - per_lane_api,
        "launches_cli": launches_cli - per_lane_cli,
        "launches_mesh": launches_mesh,
        "launches_tp": launches_tp,
        "launches_tools": {tool: n - per_lane for tool, (n, per_lane) in launches_11.items()},
        "launches_lifecycle": launches_12,
        "paths": PATHS,
        "tools": {tool: rec for (tool, form), rec in held_11.items() if form == "shared"},
        "max_entry_rel_err_bf16x3": errs["bf16x3_entry"],
        "max_entry_rel_err_bf16x6": errs["bf16x6_entry"],
        "plain_max_entry_rel_err": errs["plain_entry"],
        "shapes": shared_shapes,
        "b1": {f"{m}x{n}": t for (_, m, n), t in k1_b1.items()},
        "profiled_solves": {
            label: dict(zip(("k1_device_ms", "k1_kernels", "device_ms", "wall_s"), rec))
            for label, rec in k1_dev.items()
        },
    }, {
        "name": "gram_per_lane",
        "route": "cuda",
        "source": "sypha_tpu_torch/csrc/gram.cu",
        "replaces": "sypha_tpu/ops/pallas_gram.py:40",
        **main_path("phase 9 (a)", per_lane_shapes["per-lane cell A"]),
        "max_abs_err": errs_pl["max_abs_err"],
        "design": design + "; A lane stride m n",
        "launches_scpnre": launches_9b,
        "launches_cg": launches_9c,
        "launches_api": per_lane_api,
        "launches_cli": per_lane_cli,
        "launches_mesh": launches_mesh_lanes,
        "launches_tools": {tool: per_lane for tool, (_, per_lane) in launches_11.items()},
        "tools": {tool: rec for (tool, form), rec in held_11.items() if form == "per_lane"},
        "max_entry_rel_err_bf16x3": errs_pl["bf16x3_entry"],
        "max_entry_rel_err_bf16x6": errs_pl["bf16x6_entry"],
        "plain_max_entry_rel_err": errs_pl["plain_entry"],
        "shapes": per_lane_shapes,
    }, {
        "name": "gram_grouped",
        "route": "cuda",
        "source": "sypha_tpu_torch/csrc/gram.cu",
        "replaces": "sypha_tpu/ops/pallas_gram.py:40",
        **main_path("phase 10 (b) grouped", grouped_shapes["grouped bench"]),
        "max_abs_err": errs_g["max_abs_err"],
        "design": design + "; one A per group of L lanes",
        "max_entry_rel_err_bf16x3": errs_g["bf16x3_entry"],
        "max_entry_rel_err_bf16x6": errs_g["bf16x6_entry"],
        "plain_max_entry_rel_err": errs_g["plain_entry"],
        "shapes": grouped_shapes,
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
