"""Mehrotra predictor-corrector IPM on dense normal equations, one matrix
per lane.

The port of sypha_tpu/ipm/dense.py, which solves one LP and is vmapped over
a stacked batch by the JAX package's drivers.  Here the batch is the
leading axis of every tensor: a stacked dense PaddedLp (``A`` [B, m, n],
``b`` [B, m], ``c`` [B, n], ``row_pad`` [B, m], as io.standard_form.stack_lps
builds it), and every reduction runs per lane over the last axis.  Each
iteration solves the m x m normal equations

    (A D^2 A^T) dy = f,   D^2 = X / S,

per lane: the f32 Gram matrix comes from the Gram kernel in its per-lane
form (ops.gram), is factored once (ops.spd.normal_eq_factor) and
preconditions f64 flexible PCG for the predictor and the corrector; or,
with the CG strategy, Jacobi-preconditioned CG with a per-lane tolerance
schedule.

Loop semantics are those of ``jax.vmap`` of the JAX package's
``lax.while_loop``s.  The IPM loop runs while any lane is RUNNING; a lane's
fields change only in steps where it is RUNNING at the top of the step, and
in the step where it leaves RUNNING its x, y, s stay and its scalars take
the step's values.  The PCG inside is per lane too (ops.spd.pcg_solve with
``per_lane``).  Eagerly that is one device-to-host sync per IPM iteration
and one per PCG step, as in the shared-matrix engine.

The engine has no Gondzio correctors and no stale factor
(``max_correctors``, ``factor_refresh_every``): those are options of the
shared-matrix engine (ipm.shared), and the JAX dense engine ignores them too.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from sypha_tpu_torch.config import IpmOptions
from sypha_tpu_torch.core.problem import PaddedLp
from sypha_tpu_torch.core.status import IpmStatus
from sypha_tpu_torch.ipm.shared import IpmState, _alpha_max_batch, _factor_params, use_cg_strategy
from sypha_tpu_torch.ops.gram import bf16_exact
from sypha_tpu_torch.ops.spd import _apply_normal_precond, normal_eq_factor, normal_eq_solve, pcg_solve
from sypha_tpu_torch.utils.telemetry import span

RUNNING = int(IpmStatus.RUNNING)
_count_lock = threading.Lock()


def _products(A: torch.Tensor):
    """(Av, ATu) of a per-lane A [B, m, n]: [B, n] -> [B, m] and back."""
    return (
        lambda v: torch.bmm(A, v[:, :, None])[:, :, 0],
        lambda u: torch.bmm(u[:, None, :], A)[:, 0, :],
    )


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(u * v, dim=-1)


def _check(lp: PaddedLp):
    if not isinstance(lp.A, torch.Tensor) or lp.A.ndim != 3:
        raise ValueError(
            "the per-lane IPM takes a stacked dense PaddedLp (A [B, m, n], from stack_lps)"
        )


def initial_point(lp: PaddedLp, opts: IpmOptions = IpmOptions(), A_ft=None, a_bf16_exact=None):
    """Mehrotra's initial-point heuristic per lane (reference
    src/sypha_solver_init.cpp:543-652): x = A^T (A A^T)^-1 b,
    y = (A A^T)^-1 A c, s = c - A^T y, then positivity shifts.  ``row_pad``
    regularises A A^T on pad rows.  ``A_ft`` is A already cast to the factor
    dtype, when the caller has it, and ``a_bf16_exact`` whether it is exact
    in bf16 (``ops.gram.bf16_exact``; None leaves it to the Gram kernel's
    wrapper)."""
    _check(lp)
    A, b, c = lp.A, lp.b, lp.c
    Av, ATu = _products(A)
    ft, ridge = _factor_params(opts)
    ones = torch.ones_like(c)
    with span("ipm.factor"):
        fac = normal_eq_factor(
            A if A_ft is None else A_ft, ones, lp.row_pad, ft, ridge, opts.chol_leaf_size, a_bf16_exact
        )

    def matvec(v):
        return Av(ATu(v)) + lp.row_pad * v

    def solve(f):
        return normal_eq_solve(fac, matvec, f, 1e-12, opts.newton_max_steps, per_lane=True)

    x = ATu(solve(b))
    y = solve(Av(c))
    s = c - ATu(y)

    delta_x = torch.clamp(-1.5 * torch.amin(x, dim=-1, keepdim=True), min=0.0)
    delta_s = torch.clamp(-1.5 * torch.amin(s, dim=-1, keepdim=True), min=0.0)
    x_hat = x + delta_x
    s_hat = s + delta_s
    p = _dot(x_hat, s_hat)[:, None]
    x = x_hat + 0.5 * p / torch.sum(s_hat, dim=-1, keepdim=True)
    s = s_hat + 0.5 * p / torch.sum(x_hat, dim=-1, keepdim=True)
    return x, y, s


def _make_state(lp: PaddedLp, x, y, s) -> IpmState:
    B, n_pad = lp.c.shape
    dev, dt = lp.c.device, lp.c.dtype
    one = torch.ones((B,), dtype=dt, device=dev)
    return IpmState(
        x=x,
        y=y,
        s=s,
        mu=_dot(x, s) / n_pad,
        gap=one,
        res_p=one,
        res_d=one,
        iterations=torch.zeros((B,), dtype=torch.int32, device=dev),
        status=torch.full((B,), RUNNING, dtype=torch.int32, device=dev),
        best_gap=torch.full((B,), float("inf"), dtype=dt, device=dev),
        stall_count=torch.zeros((B,), dtype=torch.int32, device=dev),
    )


def mehrotra_solve(
    lp: PaddedLp,
    opts: IpmOptions,
    x0=None,
    y0=None,
    s0=None,
) -> IpmState:
    """Full Mehrotra solve of every lane of a stacked dense PaddedLp,
    optionally warm-started from (x0, y0, s0) ([B, n], [B, m], [B, n]).
    Returns an IpmState with [B] leaves, on the LP's device.

    The spans and counters of ``ipm.shared.mehrotra_solve_shared``:
    ``ipm.solve`` around the call, ``ipm.initial_point``, ``ipm.iteration``
    (``ipm.factor``, ``ipm.predictor``, ``ipm.corrector``) and ``ipm.sync``;
    ``mehrotra_solve.iterations`` counts the steps and
    ``mehrotra_solve.syncs`` the syncs outside ``pcg_solve``."""
    with span("ipm.solve"):
        return _solve_dense(lp, opts, x0, y0, s0)


def _solve_dense(lp: PaddedLp, opts: IpmOptions, x0, y0, s0) -> IpmState:
    _check(lp)
    A, b, c, row_pad = lp.A, lp.b, lp.c, lp.row_pad
    Av, ATu = _products(A)
    n_pad = c.shape[-1]
    norm_b = 1.0 + torch.linalg.vector_norm(b, dim=-1)
    norm_c = 1.0 + torch.linalg.vector_norm(c, dim=-1)
    ft, ridge = _factor_params(opts)
    use_cg = use_cg_strategy(opts, lp.m_pad)
    # cast once per solve: the factor's Gram reads A in f32 every iteration,
    # the Jacobi diagonal reads A∘A
    A_ft = A.to(ft).contiguous()
    A2 = A * A if use_cg else None
    # once per solve: whether the f32 Gram may take K1's three-product path
    a_exact = False
    syncs = 0
    if ft == torch.float32:
        a_exact = bf16_exact(A_ft)
        syncs += 1

    if x0 is None:
        with span("ipm.initial_point"):
            x, y, s = initial_point(lp, opts, A_ft, a_exact)
    else:
        x, y, s = (torch.as_tensor(v, dtype=c.dtype, device=c.device) for v in (x0, y0, s0))

    def body(st: IpmState, run: torch.Tensor) -> IpmState:
        """One predictor-corrector step of every lane; the caller keeps it
        only for the lanes in ``run``."""
        x, y, s = st.x, st.y, st.s

        # fresh residuals every iteration (two matvecs; no float drift)
        r_b = Av(x) - b
        r_c = ATu(y) + s - c
        mu = _dot(x, s) / n_pad

        pobj = _dot(c, x)
        dobj = _dot(b, y)
        gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj))
        res_p = torch.linalg.vector_norm(r_b, dim=-1) / norm_b
        res_d = torch.linalg.vector_norm(r_c, dim=-1) / norm_c

        feasible = (res_p < opts.tol_feas) & (res_d < opts.tol_feas)
        tiny_mu = mu < opts.mu_tol_hard
        converged = feasible & ((gap < opts.tol_gap) | tiny_mu)
        # mu -> 0 with a stubborn primal residual: an infeasible LP (floor
        # 1e-3, see the JAX package's note on truncated-CG endgame noise)
        infeasible = tiny_mu & (res_p > max(1e3 * opts.tol_feas, 1e-3))
        diverged = ~torch.isfinite(mu) | (mu > opts.mu_max) | infeasible
        hit_max = st.iterations >= opts.max_iter

        # gap-stagnation monitor (reference src/sypha_solver.cpp:739-769)
        improved = gap < st.best_gap * (1.0 - opts.gap_stall_min_improv)
        best_gap = torch.where(improved, gap, st.best_gap)
        stall_count = torch.where(improved, 0, st.stall_count + 1).to(torch.int32)
        if opts.gap_stall_window > 0:
            stalled = stall_count >= opts.gap_stall_window
        else:
            stalled = torch.zeros_like(improved)

        # the step is computed for every lane; lanes that just finished
        # discard it below, lanes not running discard it in the caller
        d2 = torch.clamp(x / s, opts.d2_min, opts.d2_max)

        def matvec(v):
            return Av(d2 * ATu(v)) + row_pad * v

        if use_cg:
            # Jacobi-CG with the adaptive per-lane tolerance schedule
            # (reference src/sypha_solver_krylov.cu, src/sypha_solver.cpp:552-553)
            diag = torch.bmm(A2, d2[:, :, None])[:, :, 0] + row_pad
            cg_tol = torch.clamp(
                opts.cg_tol_initial * opts.cg_tol_decay ** st.iterations.to(c.dtype),
                min=opts.cg_tol_final,
            )[:, None]

            def solve(f):
                return pcg_solve(
                    lambda r: r / torch.clamp(diag, min=1e-300),
                    matvec, f, cg_tol, opts.cg_max_iter, per_lane=run,
                )

            solve_gate = torch.clamp(100.0 * cg_tol[:, 0], min=1e-3)
        else:
            with span("ipm.factor"):
                fac = normal_eq_factor(A_ft, d2, row_pad, ft, ridge, opts.chol_leaf_size, a_exact)

            def solve(f):
                return pcg_solve(
                    lambda r: _apply_normal_precond(fac, r),
                    matvec, f, opts.newton_tol, opts.newton_max_steps, per_lane=run,
                )

            solve_gate = 1e-3

        # 1e-30 floor: sigma*mu/s with s ~ 1e-300 overflows in the Newton rhs
        s_safe = torch.clamp(s, min=1e-30)

        def newton(r_xs):
            vec1 = r_xs / s_safe
            f = Av(vec1 - d2 * r_c) - r_b
            dy, solve_rel = solve(f)
            ds = -r_c - ATu(dy)
            dx = -vec1 - d2 * ds
            return dx, dy, ds, solve_rel

        # predictor (affine scaling)
        r_xs = x * s
        with span("ipm.predictor"):
            dxa, dya, dsa, rel_a = newton(r_xs)
            a_p = _alpha_max_batch(x, dxa)[:, None]
            a_d = _alpha_max_batch(s, dsa)[:, None]
            mu_aff = _dot(x + a_p * dxa, s + a_d * dsa) / n_pad
            sigma = (mu_aff / mu) ** opts.sigma_pow

        # corrector on the same factor (reference corrector_rhs_dev,
        # src/sypha_solver_utils.cu:51-65)
        with span("ipm.corrector"):
            dx, dy, ds, rel_c = newton(r_xs + dxa * dsa - (sigma * mu)[:, None])

        if opts.adaptive_eta:
            eta = torch.clamp(1.0 - mu, min=opts.eta)
        else:
            eta = torch.full_like(mu, opts.eta)
        alpha_p = torch.clamp(eta * _alpha_max_batch(x, dx), max=1.0)[:, None]
        alpha_d = torch.clamp(eta * _alpha_max_batch(s, ds), max=1.0)[:, None]

        x_new = x + alpha_p * dx
        y_new = y + alpha_d * dy
        s_new = s + alpha_d * ds

        step_ok = (
            torch.isfinite(x_new).all(dim=-1)
            & torch.isfinite(y_new).all(dim=-1)
            & torch.isfinite(s_new).all(dim=-1)
        )
        # linear-solve quality gates: a failed solve, or a step that blows
        # up primal feasibility, stops the lane at its current iterate
        res_p_new = torch.linalg.vector_norm(Av(x_new) - b, dim=-1) / norm_b
        step_bad = res_p_new > torch.clamp(10.0 * res_p, min=1e-4)
        solve_failed = (torch.maximum(rel_a, rel_c) > solve_gate) | step_bad

        # a non-finite step ends the lane as GAP_STALLED at its current
        # iterate: numerical exhaustion, not infeasibility
        new_status = torch.where(
            converged,
            int(IpmStatus.CONVERGED),
            torch.where(
                diverged,
                int(IpmStatus.INFEASIBLE_OR_NUMERICAL),
                torch.where(
                    hit_max,
                    int(IpmStatus.MAX_ITER),
                    torch.where(stalled | solve_failed | ~step_ok, int(IpmStatus.GAP_STALLED), RUNNING),
                ),
            ),
        ).to(torch.int32)
        sel = (new_status == RUNNING)[:, None]
        return IpmState(
            x=torch.where(sel, x_new, x),
            y=torch.where(sel, y_new, y),
            s=torch.where(sel, s_new, s),
            mu=mu,
            gap=gap,
            res_p=res_p,
            res_d=res_d,
            iterations=st.iterations + sel[:, 0].to(torch.int32),
            status=new_status,
            best_gap=best_gap,
            stall_count=stall_count,
        )

    st = _make_state(lp, x, y, s)
    iterations = 0
    while True:
        run = st.status == RUNNING
        with span("ipm.sync"):
            go = bool(run.any())
        syncs += 1
        if not go:
            break
        with span("ipm.iteration"):
            new = body(st, run)
            st = IpmState(
                **{
                    f.name: torch.where(
                        run if getattr(st, f.name).ndim == 1 else run[:, None],
                        getattr(new, f.name),
                        getattr(st, f.name),
                    )
                    for f in dataclasses.fields(IpmState)
                }
            )
        iterations += 1
    with _count_lock:
        mehrotra_solve.iterations += iterations
        mehrotra_solve.syncs += syncs
    return st


mehrotra_solve.iterations = 0
mehrotra_solve.syncs = 0
