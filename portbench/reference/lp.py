"""Plain reference for set-covering LP relaxations: a textbook batched
primal-dual interior-point method in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
reads the covering matrix and costs that the benchmark generated, and the
fixings the benchmark drew.  Each lane is

    min  sum_{j free} c_j x_j + offset   s.t.  A_free x >= r,  x >= 0,

with r_i = 0 where a column fixed to 1 covers row i (else 1) and offset the
cost of the columns fixed to 1: the node LP of a branch-and-bound node, in
its own words rather than the program's padded standard form.  A row that
must still be covered and has no free column makes the lane infeasible; that
is decided directly, before any solve.

The method is Mehrotra's predictor-corrector (Wright, "Primal-Dual
Interior-Point Methods", ch. 10) on the standard form [A_free, -I] (x, w) = r,
from an infeasible start, with the normal equations factored by Cholesky in
the working precision.  In float64 it runs to a relative gap and relative
residuals of 1e-10; in a lower precision (the control) it runs until its
gap stops improving.  TF32 is off while it runs.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

@contextlib.contextmanager
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def lane_data(A: np.ndarray, costs: np.ndarray, fix0: np.ndarray, fix1: np.ndarray):
    """Per lane (r, free, offset, feasible) from 0/1 fixing masks over the
    structural columns ([B, n] each)."""
    fix0 = fix0 > 0.5
    fix1 = fix1 > 0.5
    free = ~(fix0 | fix1)
    covered = (fix1.astype(np.float64) @ A.T) > 0.5  # [B, m]
    r = (~covered).astype(np.float64)
    has_free = (free.astype(np.float64) @ A.T) > 0.5
    feasible = np.all(has_free | covered, axis=1)
    offset = fix1.astype(np.float64) @ costs.astype(np.float64)
    return r, free, offset, feasible


def solve_lanes(A, costs, r, free, *, dtype=torch.float64, device="cpu", tol=1e-10, max_iter=100):
    """Solve every lane's LP (without the offset).  A [m, n], costs [n],
    r [B, m], free [B, n] (numpy).  Returns numpy (z, x, y, gap, res_p,
    res_d) of each lane's best iterate: z its primal objective, y the row
    duals, then its relative duality gap and relative primal and dual
    residuals.  Lanes must be feasible (see ``lane_data``)."""
    with torch.no_grad(), _no_tf32():
        At = torch.as_tensor(A, dtype=dtype, device=device)
        c = torch.as_tensor(costs, dtype=dtype, device=device)
        rt = torch.as_tensor(r, dtype=dtype, device=device)
        fr = torch.as_tensor(free, dtype=dtype, device=device)
        out = _ipm(At, c, rt, fr, tol, max_iter)
    return tuple(t.double().cpu().numpy() for t in out)


def _alpha(v, dv):
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.full_like(v, float("inf")))
    return torch.clamp(torch.amin(ratio, dim=-1), max=1.0)


def _ipm(A, c, r, free, tol, max_iter):
    B, m = r.shape
    n = A.shape[1]
    dt = A.dtype
    eps = torch.finfo(dt).eps
    cb = c.expand(B, n) * free
    count = free.sum(dim=1) + m

    def Ax(v):  # [B, n] -> [B, m]
        return (v * free) @ A.T

    def ATy(u):  # [B, m] -> [B, n]
        return (u @ A) * free

    # start near the scale of a cover: A x0 about 2 per row, reduced costs
    # about half the costs
    rows_free = free @ A.T  # [B, m] free columns per row
    cols = (A.sum(dim=0) + 1.0).expand(B, n)
    x = free * (2.0 / torch.clamp(rows_free.median(dim=1).values, min=1.0)).unsqueeze(1)
    w = torch.ones(B, m, dtype=dt, device=A.device)
    ybar = 0.5 * torch.amin(torch.where(free > 0, cb / cols, float("inf")), dim=1)
    y = ybar.unsqueeze(1).expand(B, m).clone()
    sx = torch.clamp(cb - ATy(y), min=1e-2) * free + (1.0 - free)
    sw = y.clone()
    norm_r = 1.0 + torch.linalg.vector_norm(r, dim=1)
    norm_c = 1.0 + torch.linalg.vector_norm(cb, dim=1)
    done = torch.zeros(B, dtype=torch.bool, device=A.device)
    best = torch.full((B,), float("inf"), dtype=dt, device=A.device)
    stall = torch.zeros(B, dtype=torch.int32, device=A.device)
    gap = torch.ones(B, dtype=dt, device=A.device)
    keep_x, keep_y, keep_gap = x.clone(), y.clone(), gap.clone()
    keep_p, keep_d = gap.clone(), gap.clone()

    for _ in range(max_iter):
        rp = r - (Ax(x) - w)
        rdx = (cb - ATy(y) - sx) * free
        rdw = y - sw
        pobj = torch.sum(cb * x, dim=1)
        dobj = torch.sum(r * y, dim=1)
        gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj))
        res_p = torch.linalg.vector_norm(rp, dim=1) / norm_r
        res_d = torch.sqrt(torch.sum(rdx * rdx, dim=1) + torch.sum(rdw * rdw, dim=1)) / norm_c
        worst = torch.maximum(gap, torch.maximum(res_p, res_d))
        # a lower precision cannot reach tol: it stops once its worst
        # residual has not improved by 1% for five iterations
        improved = worst < 0.99 * best
        stall = torch.where(improved, 0, stall + 1)
        better = (worst < best) & ~done
        best = torch.where(better, worst, best)
        keep_x = torch.where(better.unsqueeze(1), x, keep_x)
        keep_y = torch.where(better.unsqueeze(1), y, keep_y)
        keep_gap = torch.where(better, gap, keep_gap)
        keep_p = torch.where(better, res_p, keep_p)
        keep_d = torch.where(better, res_d, keep_d)
        done = done | (worst < tol) | (stall >= 5)
        if bool(done.all()):
            break
        mu = (torch.sum(x * sx, dim=1) + torch.sum(w * sw, dim=1)) / count

        dx_ = x / sx * free
        dw_ = w / sw
        Aw = A.unsqueeze(0) * torch.sqrt(dx_).unsqueeze(1)
        M = Aw @ Aw.mT
        M.diagonal(dim1=1, dim2=2).add_(dw_)
        ridge = eps * M.diagonal(dim1=1, dim2=2).amax(dim=1)
        L, info = torch.linalg.cholesky_ex(M + torch.diag_embed(ridge.unsqueeze(1).expand(B, m)))
        for _ in range(4):  # a larger ridge where the factor failed
            if not bool((info > 0).any()):
                break
            ridge = torch.where(info > 0, 100.0 * ridge, ridge)
            L, info = torch.linalg.cholesky_ex(M + torch.diag_embed(ridge.unsqueeze(1).expand(B, m)))
        # a lane whose factor still fails, or whose iterate is no longer
        # finite, stops at its best iterate
        done = done | (info > 0) | ~torch.isfinite(mu)

        def normal(v):  # the exact normal operator, applied by products
            return Ax(dx_ * ATy(v)) + dw_ * v

        def newton(rxs, rws):
            rhs = rp - Ax((rxs - x * rdx) / sx) + (rws - w * rdw) / sw
            dy = torch.cholesky_solve(rhs.unsqueeze(2), L).squeeze(2)
            for _ in range(2):  # iterative refinement against the exact operator
                dy = dy + torch.cholesky_solve((rhs - normal(dy)).unsqueeze(2), L).squeeze(2)
            dsx = (rdx - ATy(dy)) * free
            dsw = rdw + dy
            dxx = (rxs - x * dsx) / sx * free
            dww = (rws - w * dsw) / sw
            return dxx, dww, dy, dsx, dsw

        dxa, dwa, dya, dsxa, dswa = newton(-x * sx, -w * sw)
        ap = torch.minimum(_alpha(x, dxa), _alpha(w, dwa)).unsqueeze(1)
        ad = torch.minimum(_alpha(sx, dsxa), _alpha(sw, dswa)).unsqueeze(1)
        mu_aff = (
            torch.sum((x + ap * dxa) * (sx + ad * dsxa) * free, dim=1)
            + torch.sum((w + ap * dwa) * (sw + ad * dswa), dim=1)
        ) / count
        sigma = (mu_aff / mu) ** 3
        smu = (sigma * mu).unsqueeze(1)
        ddx, ddw, ddy, ddsx, ddsw = newton(
            (-x * sx - dxa * dsxa + smu) * free, -w * sw - dwa * dswa + smu
        )
        eta = torch.clamp(1.0 - mu, min=0.9, max=0.999).unsqueeze(1)
        ap = eta * torch.minimum(_alpha(x, ddx), _alpha(w, ddw)).unsqueeze(1)
        ad = eta * torch.minimum(_alpha(sx, ddsx), _alpha(sw, ddsw)).unsqueeze(1)
        keep = done.unsqueeze(1)
        ap = torch.where(keep, 0.0, torch.clamp(ap, max=1.0))
        ad = torch.where(keep, 0.0, torch.clamp(ad, max=1.0))
        x = x + ap * ddx
        w = w + ap * ddw
        y = y + ad * ddy
        sx = sx + ad * ddsx
        sw = sw + ad * ddsw

    # the best iterate each lane reached: its objective, iterates, relative
    # gap and relative primal and dual residuals
    z = torch.sum(cb * keep_x, dim=1)
    return z, keep_x, keep_y, keep_gap, keep_p, keep_d


def solve(A, costs, fix0, fix1, *, dtype=torch.float64, device="cpu", block=64):
    """Every lane's optimum (offset included) in blocks of ``block`` lanes.

    Returns a dict of numpy arrays: ``z`` (inf where infeasible), ``dobj``
    (the dual objective r.y + offset), ``feasible``, ``gap``, ``res_p`` and
    ``res_d`` (the reference's own relative gap and residuals, 0 where
    infeasible), ``x``, ``y``, and the lane data ``r``, ``free``,
    ``offset``."""
    r, free, offset, feasible = lane_data(A, costs, fix0, fix1)
    B = r.shape[0]
    z = np.full(B, np.inf)
    dobj = np.full(B, np.inf)
    gap = np.zeros(B)
    res_p = np.zeros(B)
    res_d = np.zeros(B)
    x = np.zeros((B, A.shape[1]))
    y = np.zeros((B, A.shape[0]))
    idx = np.flatnonzero(feasible)
    for k in range(0, len(idx), block):
        sel = idx[k : k + block]
        zz, xx, yy, gg, pp, dd = solve_lanes(A, costs, r[sel], free[sel], dtype=dtype, device=device)
        z[sel] = zz + offset[sel]
        res_p[sel] = pp
        res_d[sel] = dd
        dobj[sel] = np.sum(r[sel] * yy, axis=1) + offset[sel]
        gap[sel] = gg
        x[sel] = xx
        y[sel] = yy
    return {"z": z, "dobj": dobj, "feasible": feasible, "gap": gap, "res_p": res_p, "res_d": res_d, "x": x, "y": y, "r": r, "free": free, "offset": offset}
