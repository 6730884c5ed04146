"""Shared-matrix batched Mehrotra IPM: one A, many LP lanes.

The port of sypha_tpu/ipm/shared.py on the dense operator.  The whole batch
of B&B nodes / replicas shares ONE constraint matrix A on the device; lanes
differ only in

  * ``col_mask`` [B, n]: 0 where a variable is fixed by branching (or pad),
  * ``b`` [B, m]: rhs after substituting fixed-to-1 columns,
  * ``c`` [B, n]: costs (masked columns get cost 1, the pad convention),
  * ``obj_offset`` [B]: sum of costs of fixed-to-1 columns.

Branch decisions x_j = 0 / x_j = 1 are therefore column masks and rhs shifts,
and every A-product in the solver is one GEMM shared across lanes.  Masked
columns follow the pad-column convention of core.problem.PaddedLp.

Per IPM iteration the dense-factor strategy forms the f32 normal matrix with
the Gram kernel (ops.gram), factors it (ops.linalg), and solves the
predictor and corrector Newton systems with f64 flexible PCG preconditioned
by that factor (ops.spd).  The loop runs eagerly: the test that any lane is
still RUNNING is one device-to-host sync per iteration, as the test in the
PCG is one per CG step.

The shared A is a dense f64 tensor or a padded-ELL operator
(ops.ell.EllMatrix, from ``make_shared_batch_sparse`` / ``_auto``).  With
ELL every f64 product is matrix-free, and the dense-factor strategy forms
the f32 Gram from a transient ``A.todense(float32)``, so the Gram kernel
runs on both operators.

The iterate (``IpmState``, from sypha_tpu/ipm/dense.py) and every f64
quantity stay float64; only the Gram matrix, its factor and the
preconditioner apply are float32.

Instance groups: ``stack_shared_batches`` stacks G dense batches of one
bucket, each with its own A and L lanes, into one grouped batch (A
[G, m, n], lane fields [G, L, ...]), the layout that the JAX package's
bench.py solves as ``jax.vmap`` over groups of one ``mehrotra_solve_shared``.
One IPM loop runs every group: A-products are matmuls broadcast over the
group axis, the Gram kernel forms all G L normal matrices in one launch, and
the IPM loop's test and the PCG's are taken per group, so a group stops
where it would stop alone and then keeps its whole state, its stall
monitor included, while the others step.

Tensor parallelism: with ``group`` (a ``torch.distributed`` process group,
the counterpart of the JAX package's ``axis_name``) each rank holds a column
slab of A and the matching slices of c, col_mask, x and s, while b, y and
row_pad are whole on every rank.  Every sum or min over columns and every
A-product onto the row space is all-reduced over the group, at the places
the JAX package psums and pmins; the m x m Gram matrix is the sum of the
ranks' partial Grams, each formed by the Gram kernel on the rank's slab, and
is factored on every rank.  The two host decisions, the IPM loop's "any lane
RUNNING" and the PCG's "any lane above its threshold", are reduced too, so
that every rank takes the same branch and issues the same collectives.
``parallel.mesh.solve_shared_batch_tensor_parallel`` is the entry point.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from sypha_tpu_torch.config import IpmOptions
from sypha_tpu_torch.core.device import resolve_device
from sypha_tpu_torch.core.problem import PaddedLp
from sypha_tpu_torch.core.status import IpmStatus
from sypha_tpu_torch.io.standard_form import bucket_dims, pad_lp, pad_standard_form_ell
from sypha_tpu_torch.ops.ell import EllMatrix
from sypha_tpu_torch.ops.gram import bf16_exact, gram
from sypha_tpu_torch.ops.spd import NormalEqFactor, _apply_normal_precond, factor_gram, pcg_solve


@dataclass(frozen=True)
class IpmState:
    """Iterate of the batched IPM; every field has a leading lane axis [B]
    ([G, L] for a grouped batch)."""

    x: torch.Tensor  # [B, n_pad] f64 primal
    y: torch.Tensor  # [B, m_pad] f64 dual
    s: torch.Tensor  # [B, n_pad] f64 dual slacks
    mu: torch.Tensor  # [B] f64 duality measure x.s / n_pad
    gap: torch.Tensor  # [B] f64 relative duality gap
    res_p: torch.Tensor  # [B] f64 relative primal infeasibility
    res_d: torch.Tensor  # [B] f64 relative dual infeasibility
    iterations: torch.Tensor  # [B] int32
    status: torch.Tensor  # [B] int32 IpmStatus
    best_gap: torch.Tensor  # [B] f64 best gap seen (stagnation monitor)
    stall_count: torch.Tensor  # [B] int32 iterations without gap improvement


def _factor_params(opts: IpmOptions):
    dtype = torch.float32 if opts.factor_dtype == "float32" else torch.float64
    ridge = opts.factor_ridge
    if ridge is None:
        ridge = 2e-6 if dtype == torch.float32 else 1e-12
    return dtype, ridge


@dataclass(frozen=True)
class SharedLpBatch:
    """B standard-form LP lanes min c.x, A(mask)x = b, x >= 0 sharing one A.

    A: [m, n] f64 (shared), a dense tensor or an ops.ell.EllMatrix;
    b: [B, m]; c: [B, n]; col_mask: [B, n] in {0,1}; row_pad: [m] (1 on pad
    rows); obj_offset: [B].  All f64, one device.

    Grouped (``stack_shared_batches``): G instance groups of L lanes, each
    group sharing its own dense A: A [G, m, n], b [G, L, m], c and col_mask
    [G, L, n], row_pad [G, m], obj_offset [G, L]; ``n_lanes`` is L.
    """

    A: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    col_mask: torch.Tensor
    row_pad: torch.Tensor
    obj_offset: torch.Tensor

    @property
    def m_pad(self) -> int:
        return self.A.shape[-2]

    @property
    def n_pad(self) -> int:
        return self.A.shape[-1]

    @property
    def n_lanes(self) -> int:
        return self.b.shape[-2] if self.b.ndim >= 2 else 1

    @property
    def is_sparse(self) -> bool:
        return isinstance(self.A, EllMatrix)

    @property
    def is_grouped(self) -> bool:
        return not self.is_sparse and self.A.ndim == 3


def _A_products(A):
    """(Av, ATu, sqAv) for a dense [m, n] A or an EllMatrix:
    Av: [..., n] -> [..., m] = A @ v;  ATu: [..., m] -> [..., n] = A^T @ u;
    sqAv: [..., n] -> [..., m] = (A∘A) @ d (the Jacobi-diagonal product).
    A dense [G, m, n] A (a grouped batch) takes [G, L, ...] vectors, and the
    products broadcast over the group axis."""
    if isinstance(A, EllMatrix):
        return A.Av, A.ATu, A.sqAv
    A2 = A * A
    return (
        lambda v: v @ A.mT,
        lambda u: u @ A,
        lambda d: d @ A2.mT,
    )


def make_shared_batch(lp: PaddedLp, n_lanes: int) -> SharedLpBatch:
    """Replicate a single PaddedLp into a SharedLpBatch of ``n_lanes``.

    ``lp.A`` may be a dense [m, n] tensor or an EllMatrix (from
    io.standard_form.pad_standard_form_ell); the batch carries it unchanged."""
    if not isinstance(lp.A, EllMatrix) and lp.A.ndim != 2:
        raise ValueError("make_shared_batch expects an unbatched PaddedLp")
    B = n_lanes
    n = lp.n_pad
    col = torch.arange(n, device=lp.c.device)
    mask = (col < lp.n_real).to(lp.c.dtype).expand(B, n).contiguous()
    return SharedLpBatch(
        A=lp.A,
        b=lp.b.expand(B, lp.m_pad).contiguous(),
        c=lp.c.expand(B, n).contiguous(),
        col_mask=mask,
        row_pad=lp.row_pad,
        obj_offset=torch.zeros((B,), dtype=lp.c.dtype, device=lp.c.device),
    )


def make_shared_batch_sparse(
    model,
    n_lanes: int,
    m_pad: int | None = None,
    n_pad: int | None = None,
    device: torch.device | str | None = None,
) -> SharedLpBatch:
    """ScpModel -> SharedLpBatch whose A is a padded-ELL operator on ``device``
    (default ``cuda``).

    Same padding conventions as pad_lp/make_shared_batch (pad columns cost 1
    and masked out; pad rows rhs 0 with row_pad regularisation), but the
    standard form [A0 | -I] is built straight into EllMatrix slots: a dense
    f64 [m_pad, n_pad] matrix never exists.
    """
    device = resolve_device(device)
    m, n0 = model.nrows, model.ncols
    auto_mp, auto_np = bucket_dims(m, n0 + m)
    rows = [(np.asarray(cols, dtype=np.int32), np.ones(len(cols))) for cols in model.rows]
    lp = pad_standard_form_ell(
        rows, np.ones(m), model.costs, n_struct=n0,
        m_pad=m_pad if m_pad is not None else auto_mp,
        n_pad=n_pad if n_pad is not None else auto_np,
        device=device,
    )
    return make_shared_batch(lp, n_lanes)


def make_shared_batch_auto(
    model,
    n_lanes: int,
    m_pad: int | None = None,
    n_pad: int | None = None,
    density_threshold: float = 0.05,
    device: torch.device | str | None = None,
) -> SharedLpBatch:
    """Operator selection by density: padded ELL at or below
    ``density_threshold`` of the standard form [A0 | -I], dense above.  The
    0.05 crossover is the JAX package's (measured there on a TPU v5e); the
    port keeps it for parity.  ``device`` defaults to ``cuda``."""
    device = resolve_device(device)
    nnz = sum(len(r) for r in model.rows) + model.nrows
    density = nnz / float(model.nrows * (model.ncols + model.nrows))
    if density <= density_threshold:
        return make_shared_batch_sparse(model, n_lanes, m_pad, n_pad, device=device)
    return make_shared_batch(pad_lp(model, m_pad=m_pad, n_pad=n_pad, device=device), n_lanes)


def stack_shared_batches(batches) -> SharedLpBatch:
    """Stack G dense batches of one bucket into one grouped batch.

    The counterpart of ``jax.tree.map(jnp.stack, *batches)`` in the JAX
    package's bench.py: every batch holds its own A [m, n] and L lanes, with
    the same m_pad, n_pad and L.  The result has A [G, m, n], b [G, L, m], c
    and col_mask [G, L, n], row_pad [G, m] and obj_offset [G, L], which
    ``mehrotra_solve_shared`` solves as one batch of G instance groups.
    Raises ValueError on an ELL operator, a batch that is already grouped,
    or batches of different shapes.
    """
    batches = list(batches)
    if not batches:
        raise ValueError("stack_shared_batches takes at least one batch")
    if any(bt.is_sparse or bt.A.ndim != 2 for bt in batches):
        raise ValueError("stack_shared_batches takes dense batches with one A [m, n] each")
    fields = [f.name for f in dataclasses.fields(SharedLpBatch)]
    shapes = {tuple(tuple(getattr(bt, f).shape) for f in fields) for bt in batches}
    if len(shapes) != 1:
        raise ValueError(
            "stack_shared_batches takes batches of one bucket and lane count, got "
            f"{sorted((bt.m_pad, bt.n_pad, bt.n_lanes) for bt in batches)}"
        )
    return SharedLpBatch(**{f: torch.stack([getattr(bt, f) for bt in batches]) for f in fields})


def fix_columns(batch: SharedLpBatch, fix0, fix1) -> SharedLpBatch:
    """Apply per-lane branch fixings.

    fix0/fix1: [B, n] ([G, L, n] for a grouped batch) {0,1} float masks
    (tensors or numpy) of variables fixed to 0 / 1.  Fixing to 1 substitutes
    the column out: b -= A_j, offset += c_j.
    """
    Av, _, _ = _A_products(batch.A)
    c0 = batch.c
    fix0 = torch.as_tensor(fix0, dtype=c0.dtype, device=c0.device)
    fix1 = torch.as_tensor(fix1, dtype=c0.dtype, device=c0.device)
    fixed = torch.clamp(fix0 + fix1, 0.0, 1.0)
    mask = batch.col_mask * (1.0 - fixed)
    b = batch.b - Av(fix1)
    c = torch.where(mask > 0, c0, 1.0)
    offset = batch.obj_offset + torch.sum(fix1 * c0, dim=-1)
    return SharedLpBatch(
        A=batch.A, b=b, c=c, col_mask=mask, row_pad=batch.row_pad,
        obj_offset=offset,
    )


# ---------------------------------------------------------------------------
# solver internals: every A-product is a shared GEMM over the lane axis
# ---------------------------------------------------------------------------


def _reducers(group):
    """Cross-rank reducers of tensor parallelism: (psum, pmin, world size,
    agree).  ``psum``/``pmin`` all-reduce a tensor (SUM / MIN) over ``group``
    in place and return it; every call site passes a temporary.  ``agree``
    reduces a local boolean flag (MAX) and returns the host's bool.  With
    ``group`` None (one device, or lane sharding) they are the identity and
    ``bool``."""
    if group is None:
        return (lambda v: v), (lambda v: v), 1, bool

    def reducer(op):
        def reduce(v):
            v = v.contiguous()
            dist.all_reduce(v, op=op, group=group)
            return v

        return reduce

    def agree(flag) -> bool:
        f = flag.to(torch.int32).reshape(1)
        dist.all_reduce(f, op=dist.ReduceOp.MAX, group=group)
        return bool(f)

    return (
        reducer(dist.ReduceOp.SUM),
        reducer(dist.ReduceOp.MIN),
        dist.get_world_size(group),
        agree,
    )


def _shared_factor(
    A32, d2_eff, row_reg, ft, ridge: float, leaf_size: int, group=None, a_bf16_exact=None
):
    """Factor of M_b = A diag(d2_eff_b) A^T + diag(row_reg_b), batched.

    Returns (Linv, dinv): the inverse Cholesky factor of the Jacobi-
    equilibrated M (plus ridge) and the equilibration scales, both in ``ft``.
    In f32 the Gram matrix comes from the Gram kernel (``gram``), which
    applies w = sqrt(d2_eff) to A while loading it; a grouped A32 [G, m, n]
    with d2_eff [G, L, n] forms all G L matrices in one launch;
    ``a_bf16_exact`` (decided once per solve) picks its three-product path.
    Under tensor parallelism (``group``) A32 and d2_eff are the rank's
    column slab, and the partial Grams sum over the ranks before the ridge
    and the scaling.
    """
    psum = _reducers(group)[0]
    w = torch.sqrt(d2_eff).to(ft)
    if ft == torch.float32:
        M = gram(A32, w.contiguous(), a_bf16_exact=a_bf16_exact)
    else:
        Aw = (A32[:, None] if A32.ndim == 3 else A32[None]) * w[..., None, :]
        M = torch.einsum("...ik,...jk->...ij", Aw, Aw)
    return factor_gram(psum(M), row_reg, ridge, leaf_size)


def _precond(Linv, dinv, r):
    """P r = Dg L^-T L^-1 Dg r per lane (batched GEMVs in the factor dtype)."""
    return _apply_normal_precond(NormalEqFactor(Linv=Linv, dinv=dinv), r)


def _pcg(Linv, dinv, matvec, f, tol, max_steps: int, agree=bool, per_group=False):
    """Flexible PCG preconditioned by the f32 Cholesky factor (ops.spd)."""
    return pcg_solve(
        lambda r: _precond(Linv, dinv, r), matvec, f, tol, max_steps, agree, per_group=per_group
    )


def _check_group(batch: SharedLpBatch, group):
    if batch.is_grouped and group is not None:
        raise ValueError(
            "a grouped batch (instance groups) does not run tensor-parallel over a process group"
        )


def _keep_frozen_groups(stepping, new: IpmState, old: IpmState) -> IpmState:
    """Per instance group, the new state where the group was stepping
    (``stepping`` [G]), else its whole old state: ``jax.vmap`` of the while
    loop's select."""
    def pick(a, b):
        return torch.where(stepping.view((-1,) + (1,) * (a.ndim - 1)), a, b)

    return IpmState(**{
        f.name: pick(getattr(new, f.name), getattr(old, f.name)) for f in dataclasses.fields(IpmState)
    })


def use_cg_strategy(opts: IpmOptions, m_pad: int) -> bool:
    """Resolve the linear-solver strategy: "auto" takes matrix-free CG above
    2048 rows, where the O(B m^2) factor footprint grows too large."""
    if opts.linear_solver == "cg":
        return True
    if opts.linear_solver == "auto":
        return m_pad > 2048
    return False


def shared_initial_point(
    batch: SharedLpBatch, opts: IpmOptions, A32, use_cg: bool, group=None, a_bf16_exact=None
):
    """Mehrotra initial point, batched over lanes of the shared matrix
    (``group``: tensor parallelism, as in ``mehrotra_solve_shared``; a
    grouped batch's solves run per instance group; ``a_bf16_exact`` as in
    ``_shared_factor``)."""
    _check_group(batch, group)
    A, b, c, mask = batch.A, batch.b, batch.c, batch.col_mask
    Av, ATu, sqAv = _A_products(A)
    ft, ridge = _factor_params(opts)
    row_pad = batch.row_pad.unsqueeze(-2)  # [1, m], grouped [G, 1, m]
    row_reg = row_pad.expand(b.shape)
    psum, pmin, _, agree = _reducers(group)
    grouped = batch.is_grouped

    def matvec(v):
        return psum(Av(mask * ATu(v))) + row_pad * v

    if use_cg:
        diag = psum(sqAv(mask)) + row_reg

        def solve(f):
            return pcg_solve(
                lambda r: r / torch.clamp(diag, min=1e-300),
                matvec, f, 1e-12, opts.cg_max_iter, agree, per_group=grouped,
            )[0]
    else:
        Linv, dinv = _shared_factor(
            A32, mask, row_reg, ft, ridge, opts.chol_leaf_size, group, a_bf16_exact
        )

        def solve(f):
            return _pcg(
                Linv, dinv, matvec, f, 1e-12, opts.newton_max_steps, agree, per_group=grouped
            )[0]

    vy = solve(b)
    x = mask * ATu(vy)
    Ac = psum(Av(mask * c))
    y = solve(Ac)
    s = c - mask * ATu(y)

    delta_x = torch.clamp(-1.5 * pmin(torch.amin(x, dim=-1, keepdim=True)), min=0.0)
    delta_s = torch.clamp(-1.5 * pmin(torch.amin(s, dim=-1, keepdim=True)), min=0.0)
    x_hat = x + delta_x
    s_hat = s + delta_s
    p = psum(torch.sum(x_hat * s_hat, dim=-1, keepdim=True))
    x = x_hat + 0.5 * p / psum(torch.sum(s_hat, dim=-1, keepdim=True))
    s = s_hat + 0.5 * p / psum(torch.sum(x_hat, dim=-1, keepdim=True))
    return x, y, s


def _alpha_max_batch(v, dv):
    """Per-lane max alpha in [0,1] with v + alpha dv >= 0 (masked min-reduce)."""
    neg = dv < 0.0
    ratios = torch.where(neg, -v / torch.where(neg, dv, -1.0), float("inf"))
    return torch.clamp(torch.amin(ratios, dim=-1), max=1.0)


def mehrotra_solve_shared(
    batch: SharedLpBatch,
    opts: IpmOptions,
    x0=None,
    y0=None,
    s0=None,
    state0: IpmState | None = None,
    iter_limit=None,
    group=None,
) -> IpmState:
    """Batched Mehrotra predictor-corrector over a SharedLpBatch.

    Returns an IpmState whose fields carry a leading lane axis.  Lanes that
    terminate freeze while the rest continue (per-lane status gating): every
    iteration steps every lane and keeps the old iterate where a lane is no
    longer RUNNING, exactly as the JAX ``lax.while_loop`` does.

    A grouped batch (``stack_shared_batches``) runs as ``jax.vmap`` over its
    instance groups of that loop: the fields are [G, L, ...], the loop's
    test and the PCG's are taken per group, and a group with no lane
    RUNNING at the top of a step (of a factor refresh's steps) keeps its
    whole state, ``best_gap`` and ``stall_count`` included, while the other
    groups step.  ``state0``/``iter_limit`` resume it the same way.

    ``iter_limit`` caps the per-lane iteration count (default
    ``opts.max_iter``).  A caller can run a solve in chunks: solve with a
    small limit, check the wall clock, then resume by passing the returned
    state back as ``state0`` with a higher limit.  Lanes that stopped at
    MAX_ITER are revived when the new limit allows more steps; all other
    terminal statuses stay frozen.

    ``group`` runs the solve tensor-parallel over a ``torch.distributed``
    process group: ``batch`` holds this rank's column slab (A, c, col_mask,
    and x0/s0 when given) with b, row_pad and obj_offset whole, and the
    returned x and s are this rank's slabs (see the module docstring).  A
    grouped batch with a ``group`` raises ValueError.
    """
    _check_group(batch, group)
    A, b, c, mask = batch.A, batch.b, batch.c, batch.col_mask
    Av, ATu, sqAv = _A_products(A)
    lanes, n_pad = c.shape[:-1], c.shape[-1]
    grouped = batch.is_grouped
    dev = c.device
    ft, ridge = _factor_params(opts)
    use_cg = use_cg_strategy(opts, batch.m_pad)
    if use_cg:
        A32 = None
    else:
        A32 = A.todense(ft) if batch.is_sparse else A.to(ft).contiguous()
    # once per solve: whether the f32 Gram may take K1's three-product path
    # (SCP rows are exact in bf16, and so are integer cut rows up to 256)
    a_exact = ft == torch.float32 and A32 is not None and bf16_exact(A32)
    row_pad = batch.row_pad.unsqueeze(-2)  # [1, m], grouped [G, 1, m]
    row_reg = row_pad.expand(b.shape)
    RUNNING = int(IpmStatus.RUNNING)
    # tensor parallelism: every sum/min over n and every A-product onto the
    # row space reduces across the ranks; identity reducers without a group
    psum, pmin, world, agree = _reducers(group)
    n_total = n_pad * world

    norm_b = 1.0 + torch.linalg.vector_norm(b, dim=-1)
    norm_c = 1.0 + torch.sqrt(psum(torch.sum(c * c, dim=-1)))

    iter_limit = opts.max_iter if iter_limit is None else int(iter_limit)

    if state0 is not None:
        # resume a chunked solve: revive lanes the previous (lower) limit
        # cut short; every other terminal status is final
        revive = (state0.status == IpmStatus.MAX_ITER) & (state0.iterations < iter_limit)
        state0 = dataclasses.replace(
            state0,
            status=torch.where(revive, RUNNING, state0.status).to(torch.int32),
        )
    else:
        if x0 is None:
            x, y, s = shared_initial_point(batch, opts, A32, use_cg, group, a_exact)
        else:
            x, y, s = x0, y0, s0

        one = torch.ones(lanes, dtype=c.dtype, device=dev)
        state0 = IpmState(
            x=x,
            y=y,
            s=s,
            mu=psum(torch.sum(x * s, dim=-1)) / n_total,
            gap=one,
            res_p=one,
            res_d=one,
            iterations=torch.zeros(lanes, dtype=torch.int32, device=dev),
            status=torch.full(lanes, RUNNING, dtype=torch.int32, device=dev),
            best_gap=torch.full(lanes, float("inf"), dtype=c.dtype, device=dev),
            stall_count=torch.zeros(lanes, dtype=torch.int32, device=dev),
        )

    def one_step(st: IpmState, Linv_c, dinv_c) -> IpmState:
        """One predictor-corrector step.  ``Linv_c/dinv_c`` is the (possibly
        stale) f32 preconditioner factor: with factor_refresh_every > 1 the
        loop body factors once and runs several steps against it; None
        factors inline."""
        x, y, s = st.x, st.y, st.s

        r_b = psum(Av(mask * x)) - b
        r_c = mask * ATu(y) + s - c
        mu = psum(torch.sum(x * s, dim=-1)) / n_total

        pobj = psum(torch.sum(c * x, dim=-1))
        dobj = torch.sum(b * y, dim=-1)
        gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj))
        res_p = torch.linalg.vector_norm(r_b, dim=-1) / norm_b
        res_d = torch.sqrt(psum(torch.sum(r_c * r_c, dim=-1))) / norm_c

        feasible = (res_p < opts.tol_feas) & (res_d < opts.tol_feas)
        tiny_mu = mu < opts.mu_tol_hard
        converged = feasible & ((gap < opts.tol_gap) | tiny_mu)
        # mu -> 0 with a stubborn primal residual = infeasible lane (a node
        # whose fixings make the cover impossible)
        infeasible = tiny_mu & (res_p > max(1e3 * opts.tol_feas, 1e-3))
        diverged = ~torch.isfinite(mu) | (mu > opts.mu_max) | infeasible
        hit_max = st.iterations >= iter_limit

        improved = gap < st.best_gap * (1.0 - opts.gap_stall_min_improv)
        best_gap = torch.where(improved, gap, st.best_gap)
        stall_count = torch.where(improved, 0, st.stall_count + 1).to(torch.int32)
        if opts.gap_stall_window > 0:
            stalled = stall_count >= opts.gap_stall_window
        else:
            stalled = torch.zeros(lanes, dtype=torch.bool, device=dev)

        d2 = torch.clamp(x / s, opts.d2_min, opts.d2_max)
        d2_eff = d2 * mask

        def matvec(v):
            return psum(Av(d2_eff * ATu(v))) + row_pad * v

        if use_cg:
            # Jacobi-CG with the adaptive tolerance schedule per IPM iteration
            diag = psum(sqAv(d2_eff)) + row_reg
            cg_tol = torch.clamp(
                opts.cg_tol_initial
                * opts.cg_tol_decay ** st.iterations.to(c.dtype),
                min=opts.cg_tol_final,
            )[..., None]

            def solve(f):
                return pcg_solve(
                    lambda r: r / torch.clamp(diag, min=1e-300),
                    matvec, f, cg_tol, opts.cg_max_iter, agree, per_group=grouped,
                )

            solve_gate = torch.clamp(100.0 * cg_tol[..., 0], min=1e-3)
        else:
            if Linv_c is None:
                Linv_c, dinv_c = _shared_factor(
                    A32, d2_eff, row_reg, ft, ridge, opts.chol_leaf_size, group, a_exact
                )

            def solve(f):
                return _pcg(
                    Linv_c, dinv_c, matvec, f, opts.newton_tol, opts.newton_max_steps,
                    agree, per_group=grouped,
                )

            solve_gate = 1e-3

        # 1e-30 floor (not 1e-300): sigma*mu/s with s ~ 1e-300 overflows to
        # inf in the Newton rhs and NaNs the step
        s_safe = torch.clamp(s, min=1e-30)

        def newton(r_xs):
            vec1 = r_xs / s_safe
            f = psum(Av(mask * (vec1 - d2 * r_c))) - r_b
            dy, solve_rel = solve(f)
            ds = -r_c - mask * ATu(dy)
            dx = -vec1 - d2 * ds
            return dx, dy, ds, solve_rel

        r_xs = x * s
        dxa, dya, dsa, rel_a = newton(r_xs)
        a_p = pmin(_alpha_max_batch(x, dxa))[..., None]
        a_d = pmin(_alpha_max_batch(s, dsa))[..., None]
        mu_aff = psum(torch.sum((x + a_p * dxa) * (s + a_d * dsa), dim=-1)) / n_total
        sigma = (mu_aff / mu) ** opts.sigma_pow

        dx, dy, ds, rel_c = newton(r_xs + dxa * dsa - (sigma * mu)[..., None])

        # Gondzio multiple centrality correctors: push complementarity
        # products toward [beta_min, beta_max] * sigma*mu with extra solves
        # on the same factor; accept a correction only if it lengthens the
        # step.  The corrector's alphas stay rank-local, as in the JAX package.
        mu_t = (sigma * mu)[..., None]
        for _ in range(opts.max_correctors):
            ap = _alpha_max_batch(x, dx)
            ad = _alpha_max_batch(s, ds)
            ap_t = torch.clamp(ap * 1.08 + 0.08, max=1.0)[..., None]
            ad_t = torch.clamp(ad * 1.08 + 0.08, max=1.0)[..., None]
            v = (x + ap_t * dx) * (s + ad_t * ds)
            target = torch.clamp(
                v, opts.corrector_beta_min * mu_t, opts.corrector_beta_max * mu_t
            )
            t = v - target  # residual to remove (0 inside the window)
            vec1 = t / s_safe
            fcc = psum(Av(mask * vec1))
            dyc, _ = solve(fcc)
            dsc = -(mask * ATu(dyc))
            dxc = -vec1 - d2 * dsc
            ap2 = _alpha_max_batch(x, dx + dxc)
            ad2 = _alpha_max_batch(s, ds + dsc)
            better = ((ap2 >= ap + 0.01) & (ad2 >= ad)) | (
                (ad2 >= ad + 0.01) & (ap2 >= ap)
            )
            sel_c = better[..., None]
            dx = torch.where(sel_c, dx + dxc, dx)
            dy = torch.where(sel_c, dy + dyc, dy)
            ds = torch.where(sel_c, ds + dsc, ds)

        if opts.adaptive_eta:
            eta = torch.clamp(1.0 - mu, min=opts.eta)
        else:
            eta = torch.full_like(mu, opts.eta)
        alpha_p = torch.clamp(eta * pmin(_alpha_max_batch(x, dx)), max=1.0)[..., None]
        alpha_d = torch.clamp(eta * pmin(_alpha_max_batch(s, ds)), max=1.0)[..., None]

        x_new = x + alpha_p * dx
        y_new = y + alpha_d * dy
        s_new = s + alpha_d * ds

        finite_local = torch.all(torch.isfinite(x_new), dim=-1) & torch.all(
            torch.isfinite(s_new), dim=-1
        )
        step_ok = (psum(1.0 - finite_local.to(x.dtype)) == 0.0) & torch.all(
            torch.isfinite(y_new), dim=-1
        )
        # linear-solve quality gates: a Newton system the PCG could not solve
        # to within ~100x of its tolerance gives a garbage direction; also
        # accept the step only if it does not blow up primal feasibility.  A
        # rejected step ends the lane at its current iterate as GAP_STALLED.
        res_p_new = torch.linalg.vector_norm(psum(Av(mask * x_new)) - b, dim=-1) / norm_b
        step_bad = res_p_new > torch.clamp(10.0 * res_p, min=1e-4)
        solve_failed = (torch.maximum(rel_a, rel_c) > solve_gate) | step_bad

        # a non-finite step ends the lane at its current iterate as
        # GAP_STALLED: numerical exhaustion, not infeasibility
        new_status = torch.where(
            converged,
            int(IpmStatus.CONVERGED),
            torch.where(
                diverged,
                int(IpmStatus.INFEASIBLE_OR_NUMERICAL),
                torch.where(
                    hit_max,
                    int(IpmStatus.MAX_ITER),
                    torch.where(
                        stalled | solve_failed | ~step_ok,
                        int(IpmStatus.GAP_STALLED),
                        RUNNING,
                    ),
                ),
            ),
        ).to(torch.int32)
        # lanes already terminated keep their status and iterate no further
        final = st.status != RUNNING
        new_status = torch.where(final, st.status, new_status)
        stepped = new_status == RUNNING
        sel = stepped[..., None]

        return IpmState(
            x=torch.where(sel, x_new, x),
            y=torch.where(sel, y_new, y),
            s=torch.where(sel, s_new, s),
            mu=torch.where(final, st.mu, mu),
            gap=torch.where(final, st.gap, gap),
            res_p=torch.where(final, st.res_p, res_p),
            res_d=torch.where(final, st.res_d, res_d),
            iterations=st.iterations + stepped.to(torch.int32),
            status=new_status,
            best_gap=best_gap,
            stall_count=stall_count,
        )

    st = state0
    while agree((st.status == RUNNING).any()):
        top = st
        if use_cg or opts.factor_refresh_every <= 1:
            Linv = dinv = None  # one_step factors inline (or needs none)
        else:
            d2_eff0 = torch.clamp(st.x / st.s, opts.d2_min, opts.d2_max) * mask
            Linv, dinv = _shared_factor(
                A32, d2_eff0, row_reg, ft, ridge, opts.chol_leaf_size, group, a_exact
            )
        for _ in range(max(1, opts.factor_refresh_every)):
            st = one_step(st, Linv, dinv)
        if grouped:
            st = _keep_frozen_groups((top.status == RUNNING).any(dim=-1), st, top)
    return st

