"""Mixed-precision SPD solves for the IPM normal equations.

The port of sypha_tpu/ops/spd.py.  A Jacobi-equilibrated copy of the normal
matrix is factored in f32 (with a small ridge so the factor always exists),
and flexible preconditioned CG in f64 with that factor as preconditioner
recovers f64 accuracy.  With a Jacobi diagonal instead of the factor the
same loop is the matrix-free CG strategy.

Everything is batch-first ([..., m, m] / [..., m]).  ``pcg_solve`` (and
``spd_solve``, ``normal_eq_solve`` on top of it) has three loop semantics:
batch-wide, as the JAX package's loop runs on a batched call (the
shared-matrix IPM), per lane, as ``jax.vmap`` of that loop runs (the
per-lane IPM of ipm.dense), and per instance group, as ``jax.vmap`` over
groups of a batch-wide loop runs (the grouped shared-matrix IPM).  Its
test is a flag that stays on the device, which the host reads before every
step or, with a ``PcgChunks`` plan that gates the steps on the flag, after
a first batch of steps.  ``normal_pcg``, the shared IPM's Newton solve,
runs it, on a card without a process group as two CUDA graphs per key (the
set-up and a gated step) replayed from static buffers.

``normal_eq_factor`` in f32 forms its Gram matrix with the Gram kernel
(ops.gram), one matrix per lane or one shared by every lane.
``factor_gram`` factors a Gram matrix; for the shared IPM on one card it
replays the chain as one CUDA graph per key.  One class (``_Graphs``)
holds the graphs of a key of either.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch

from sypha_tpu_torch.ops.ell import EllMatrix, products
from sypha_tpu_torch.ops.gram import gram
from sypha_tpu_torch.ops.linalg import block_chol_inverse
from sypha_tpu_torch.utils.telemetry import span

_count_lock = threading.Lock()


@dataclass(frozen=True)
class SpdFactor:
    """Equilibrated factor of an SPD matrix M = Dg Ms Dg.

    Ms: [..., m, m] f64 equilibrated matrix (unit-ish diagonal)
    Linv: [..., m, m] inverse Cholesky factor of Ms (+ ridge), possibly f32
    dinv: [..., m] 1/sqrt(diag M) equilibration scales (f64)
    """

    Ms: torch.Tensor
    Linv: torch.Tensor
    dinv: torch.Tensor


def spd_factor(
    M: torch.Tensor,
    factor_dtype=torch.float32,
    ridge: float = 2e-6,
    leaf_size: int = 64,
) -> SpdFactor:
    """Equilibrate and factor M (SPD, f64)."""
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    dinv = torch.rsqrt(torch.clamp(diag, min=1e-300))
    Ms = M * dinv[..., None, :] * dinv[..., :, None]
    m = M.shape[-1]
    Mf = Ms.to(factor_dtype) + ridge * torch.eye(m, dtype=factor_dtype, device=M.device)
    return SpdFactor(Ms=Ms, Linv=block_chol_inverse(Mf, leaf_size=leaf_size), dinv=dinv)


def _apply_precond(Linv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """P r = L^{-T} L^{-1} r, computed in the factor dtype, returned in r.dtype."""
    z = torch.einsum("...ij,...j->...i", Linv, r.to(Linv.dtype))
    z = torch.einsum("...ji,...j->...i", Linv, z)
    return z.to(r.dtype)


@dataclass(frozen=True)
class NormalEqFactor:
    """Preconditioner factor of the normal matrix M = A D^2 A^T + diag(r),
    built entirely in the factor dtype; the f64 side of the Newton solve
    stays matrix-free (``normal_eq_solve``).

    Linv: [..., m, m] inverse Cholesky of the equilibrated M (factor dtype)
    dinv: [..., m] equilibration scales 1/sqrt(diag M) (factor dtype)
    """

    Linv: torch.Tensor
    dinv: torch.Tensor


def _factor_chain(M: torch.Tensor, row_reg: torch.Tensor, ridge: float, leaf_size: int):
    """``factor_gram``'s mathematics, run eagerly and captured alike."""
    ft = M.dtype
    m = M.shape[-1]
    M = M + torch.diag_embed(row_reg.to(ft))
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    dinv = torch.rsqrt(torch.clamp(diag, min=1e-30))
    Ms = M * dinv[..., None, :] * dinv[..., :, None]
    Ms = Ms + ridge * torch.eye(m, dtype=ft, device=M.device)
    return block_chol_inverse(Ms, leaf_size=leaf_size), dinv


def factor_gram(M: torch.Tensor, row_reg: torch.Tensor, ridge: float, leaf_size: int,
                graph: bool = False):
    """(Linv, dinv) of a batched Gram matrix M [..., m, m] in its own dtype:
    add diag(row_reg), equilibrate by 1/sqrt(diag), add the ridge, factor.

    Where ``graph`` allows it (the shared IPM on one device) and M is on a
    CUDA device (``_graphed``), the chain is replayed from one CUDA graph
    per key, bit for bit the eager chain's; elsewhere it runs eagerly.
    ``factor_gram.calls`` counts the calls, ``.graph_captures`` and
    ``.graph_replays`` the graphs' captures and replays (exactly under host
    threads)."""
    with _count_lock:
        factor_gram.calls += 1
    if _graphed(graph, M):
        return _graphed_factor(M, row_reg, ridge, leaf_size)
    return _factor_chain(M, row_reg, ridge, leaf_size)


factor_gram.calls = 0
factor_gram.graph_captures = 0
factor_gram.graph_replays = 0


def normal_eq_factor(
    A: torch.Tensor,
    d2: torch.Tensor,
    row_reg: torch.Tensor,
    factor_dtype=torch.float32,
    ridge: float = 2e-6,
    leaf_size: int = 64,
    a_bf16_exact: bool | None = None,
) -> NormalEqFactor:
    """Factor M = A diag(d2) A^T + diag(row_reg) in ``factor_dtype``.

    A: [B, m, n] (a matrix per lane) or [m, n] (shared), in any float dtype
    (pass it already in the factor dtype to skip the cast); d2: [B, n] >= 0;
    row_reg: [B, m].  M is formed as Aw Aw^T with Aw = A * sqrt(d2), so it
    is symmetric and PSD; in f32 by the Gram kernel, in f64 by an einsum.
    ``a_bf16_exact`` is ``ops.gram.bf16_exact`` of A in f32 when the caller
    decided it once per solve (None: the Gram kernel's wrapper decides).
    """
    ft = factor_dtype
    A = A.to(ft)
    w = torch.sqrt(d2).to(ft)
    if ft == torch.float32:
        M = gram(A.contiguous(), w.contiguous(), a_bf16_exact=a_bf16_exact)
    else:
        Aw = A * w[:, None, :]
        M = torch.einsum("bik,bjk->bij", Aw, Aw)
    Linv, dinv = factor_gram(M, row_reg, ridge, leaf_size)
    return NormalEqFactor(Linv=Linv, dinv=dinv)


def _apply_normal_precond(fac: NormalEqFactor, r: torch.Tensor) -> torch.Tensor:
    """P r = Dg L^{-T} L^{-1} Dg r in the factor dtype, returned in r.dtype."""
    rf = fac.dinv * r.to(fac.dinv.dtype)
    z = torch.einsum("...ij,...j->...i", fac.Linv, rf)
    z = torch.einsum("...ji,...j->...i", fac.Linv, z)
    return (fac.dinv * z).to(r.dtype)


def pcg_solve(
    precond: Callable[[torch.Tensor], torch.Tensor],
    matvec: Callable[[torch.Tensor], torch.Tensor],
    f: torch.Tensor,
    tol: torch.Tensor | float = 1e-10,
    max_steps: int = 40,
    agree: Callable[[torch.Tensor], bool] = bool,
    per_lane: bool | torch.Tensor = False,
    per_group: bool = False,
    plan: PcgChunks | None = None,
):
    """Flexible (Polak-Ribiere) PCG in f.dtype, matrix-free and batch-first.

    Returns (x, rel): the solution and the relative residual each lane
    reached, which the IPM's step-quality gates read.  ``tol`` is a float or
    a per-lane [..., 1] tensor.

    Loop semantics, all those of the JAX ``lax.while_loop``:

    * ``per_lane=False`` (batch-wide, the loop of a batched call): before
      each step the loop tests ``k < max_steps`` and whether ANY lane's
      residual is above its threshold, and while one is, every lane steps,
      converged ones too.
    * ``per_lane=True``, or a bool [...] tensor of the lanes to solve (the
      loop under ``jax.vmap``): a lane steps while its own residual is above
      its threshold and it has taken fewer than ``max_steps`` steps; from
      then on its x, r, p and rz stay as they were, and ``rel`` is read from
      its frozen r.  Lanes outside the tensor never step.  The loop still
      runs while any lane is active.
    * ``per_group=True`` with f [G, L, m] (the batch-wide loop under
      ``jax.vmap`` over instance groups): a group steps while ANY of its
      lanes is above its threshold and ``k < max_steps``, and then every
      lane of the group steps, converged ones too; from then on the group's
      x, r, p and rz stay as they were.  Every group that still steps has
      taken k steps, so one count serves them all.

    The loop's test is a flag on the device (``_PcgState``), read by the
    host, one device-to-host sync a read.  Without a ``plan`` the host
    reads it before every step below ``max_steps``, where the JAX loop
    tests, through ``agree``, which turns the flag into the host's
    decision: tensor parallelism passes one that reduces it over the
    ranks, so that every rank takes the same steps.  With a ``PcgChunks``
    plan the steps are gated on the flag, which then also holds
    ``k < max_steps``, and the host reads it with the step count after a
    first batch of steps and then after every step; a gated step after the
    flag went down changes nothing, so x and rel do not depend on the plan.
    ``pcg_solve.steps`` counts the steps taken, ``pcg_solve.masked_steps``
    the gated steps that changed nothing and ``pcg_solve.syncs`` the reads,
    over all calls (exactly under host threads).  A call is the span
    ``pcg.solve``, each read the span ``pcg.sync``.
    """
    if per_group and per_lane is not False:
        raise ValueError("pcg_solve takes per_lane or per_group, not both")
    with span("pcg.solve"):
        s = _PcgState(f, per_lane is not False, per_group, gated=plan is not None)
        lanes = per_lane if isinstance(per_lane, torch.Tensor) else None
        _run_loop(
            partial(_pcg_setup, precond, matvec, f, tol, s, lanes),
            partial(_pcg_advance, precond, matvec, s),
            s, max_steps, plan, agree,
        )
        return s.x, s.rel()


def _above(r, thresh, per_group):
    """The loop's test: per lane [..., 1], or per group [G, 1, 1]."""
    hi = torch.linalg.vector_norm(r, dim=-1, keepdim=True) > thresh
    return hi.any(dim=-2, keepdim=True) if per_group else hi


def _pcg_step(precond, matvec, x, r, p, rz):
    """One flexible PCG step from (x, r, p, rz)."""
    Ap = matvec(p)
    pAp = torch.sum(p * Ap, dim=-1, keepdim=True)
    ok = pAp > 0.0
    alpha = torch.where(ok, rz / torch.where(ok, pAp, 1.0), 0.0)
    x_new = x + alpha * p
    r_new = r - alpha * Ap
    z_new = precond(r_new)
    rz_new = torch.sum(r_new * z_new, dim=-1, keepdim=True)
    # flexible (Polak-Ribiere) beta: robust to an inexact preconditioner
    num = torch.sum((r_new - r) * z_new, dim=-1, keepdim=True)
    nz = torch.abs(rz) > 0
    beta = torch.where(nz, num / torch.where(nz, rz, 1.0), 0.0)
    p_new = z_new + beta * p
    return x_new, r_new, p_new, rz_new


class PcgChunks:
    """How the PCG calls of one solve batch their first read of the flag.

    On a card a call runs, before its first read, as many gated steps as
    the previous call of the solve took real steps (at least one), and then
    one step a read: there a read costs a sync (about 25 us on an H100) and
    a masked step its device time (about 130 us at scp4x class).  Off a
    card a read costs no more than a tensor's copy and a masked step a whole
    step, so one step runs before the first read.  A solve makes one plan
    and passes it to each of its calls in turn.

    After the first batch every step is read: on 64-lane scp4x-class node
    windows on an H100, a read every four steps masked 8.1% of the steps
    and a read every eight 20.8%, against 0.04% with a read a step."""

    def __init__(self):
        self.last = 0

    def first(self, device: torch.device) -> int:
        """Gated steps to run before a call's first read, on ``device``."""
        return max(1, self.last) if device.type == "cuda" else 1


class _PcgState:
    """The loop's state: the iterate (x, r, p, rz), the norms of f and the
    thresholds, the mask ``active`` of the lanes ([..., 1], per lane) or
    groups ([G, 1, 1], per group) still stepping (None batch-wide), and the
    flag ``go``, the loop's test for the next step.  Ungated, the set-up and
    the steps bind new tensors.  Gated, they write preallocated ones in
    place, so that CUDA graphs can replay them, and the state also holds
    the step count ``k``, its cap ``kmax`` and ``flags`` = (k, go), which
    the host reads."""

    def __init__(self, f: torch.Tensor, per_lane: bool, per_group: bool, gated: bool):
        self.per_lane, self.per_group, self.gated = per_lane, per_group, gated
        if not gated:
            return
        lead = f.shape[:-1]
        self.x, self.r, self.p = (torch.empty_like(f) for _ in range(3))
        self.rz, self.norm_f, self.thresh = (f.new_empty(lead + (1,)) for _ in range(3))
        scalar = dict(device=f.device, dtype=torch.int64)
        self.k, self.kmax = torch.zeros((), **scalar), torch.zeros((), **scalar)
        self.go = torch.zeros((), dtype=torch.bool, device=f.device)
        self.flags = torch.zeros(2, **scalar)
        self.active = None
        if per_lane or per_group:
            shape = lead[:-1] + (1, 1) if per_group else lead + (1,)
            self.active = torch.zeros(shape, dtype=torch.bool, device=f.device)

    def test(self):
        """go = any lane above its threshold (any lane or group still
        active); gated, also k < kmax, and (k, go) into ``flags``."""
        if self.active is None:
            hi = _above(self.r, self.thresh, False).any()
        else:
            hi = self.active.any()
        if not self.gated:
            self.go = hi
            return
        torch.logical_and(hi, self.k < self.kmax, out=self.go)
        torch.stack((self.k, self.go.to(torch.int64)), out=self.flags)

    def rel(self):
        return torch.linalg.vector_norm(self.r, dim=-1) / torch.clamp(self.norm_f[..., 0], min=1e-300)


def _pcg_setup(precond, matvec, f, tol, s: _PcgState, lanes=None):
    """The set-up into ``s``: x = P f, r = f - M x, p = P r, k = 0, the
    lanes (groups) above their thresholds, per lane only those of ``lanes``
    where it is given, and the first test."""
    norm_f = torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    thresh = tol * torch.clamp(norm_f, min=1e-300)
    x = precond(f)
    r = f - matvec(x)
    p = precond(r)
    rz = torch.sum(r * p, dim=-1, keepdim=True)
    active = None
    if s.per_lane or s.per_group:
        active = _above(r, thresh, s.per_group)
        if lanes is not None:
            active = active & lanes[..., None]
    if s.gated:
        for buf, v in zip((s.norm_f, s.thresh, s.x, s.r, s.p, s.rz), (norm_f, thresh, x, r, p, rz)):
            buf.copy_(v)
        if active is not None:
            s.active.copy_(active)
        s.k.zero_()
    else:
        s.norm_f, s.thresh, s.x, s.r, s.p, s.rz, s.active = norm_f, thresh, x, r, p, rz, active
    s.test()


def _pcg_advance(precond, matvec, s: _PcgState):
    """One step of the loop and the test for the next.  Ungated, the host
    asks for it only where the test held: every lane steps, per lane or
    group only the active ones.  Gated, the step is taken where ``go``
    holds (and the lane or group is active) and the state stays exactly as
    it was elsewhere; k counts the steps taken."""
    old = s.x, s.r, s.p, s.rz
    new = _pcg_step(precond, matvec, *old)
    active = s.active
    if s.gated:
        sel = s.go if active is None else active & s.go
        for buf, v in zip(old, new):
            torch.where(sel, v, buf, out=buf)
        s.k.add_(s.go)
    elif active is None:
        s.x, s.r, s.p, s.rz = new
    else:
        s.x, s.r, s.p, s.rz = (torch.where(active, v, o) for v, o in zip(new, old))
    if active is not None:
        active.logical_and_(_above(s.r, s.thresh, s.per_group))
    s.test()


def _run_loop(setup, step, s: _PcgState, max_steps: int, plan: PcgChunks | None, agree=bool):
    """Set up, then run steps and read the test (the span ``pcg.sync``)
    until the host decides to stop: without a plan before every step below
    ``max_steps``, through ``agree``; with one (gated steps) ``flags`` after
    a first batch of ``plan.first`` steps and then after every step.
    Counts the real steps, the masked ones and the reads, and returns the
    steps run."""
    if s.gated:
        s.kmax.fill_(max_steps)
    setup()
    done = reads = 0
    if plan is None:
        while done < max_steps:
            with span("pcg.sync"):
                go = agree(s.go)
            reads += 1
            if not go:
                break
            step()
            done += 1
        k = done
    else:
        n = plan.first(s.x.device)
        while True:
            n = min(n, max_steps - done)
            for _ in range(n):
                step()
            done += n
            with span("pcg.sync"):
                k, go = s.flags.tolist()
            reads += 1
            if not go:
                break
            n = 1
        plan.last = k
    with _count_lock:
        pcg_solve.steps += k
        pcg_solve.syncs += reads
        pcg_solve.masked_steps += done - k
    return done


pcg_solve.steps = 0
pcg_solve.syncs = 0
pcg_solve.masked_steps = 0
pcg_solve.graph_captures = 0
pcg_solve.graph_replays = 0


def _identity(v):
    return v


def _normal_ops(Linv, dinv, A, d, row_pad, psum=_identity):
    """(precond, matvec) of the shared IPM's Newton system: P r = Dg L^-T
    L^-1 Dg r with the factor (Linv, dinv), and v -> psum(A (d * (A^T v)))
    + row_pad * v."""
    fac = NormalEqFactor(Linv=Linv, dinv=dinv)
    Av, ATu, _ = products(A)
    return (lambda r: _apply_normal_precond(fac, r)), (lambda v: psum(Av(d * ATu(v))) + row_pad * v)


def normal_pcg(Linv, dinv, A, d, row_pad, f, tol: float, max_steps: int,
               plan: PcgChunks | None = None, per_group: bool = False,
               psum=_identity, agree=bool):
    """Solve (A diag(d) A^T + diag(row_pad)) x = f by ``pcg_solve``,
    preconditioned by the factor (Linv, dinv): the shared IPM's Newton
    solve.  A is a dense [m, n] (grouped [G, m, n]) tensor or an EllMatrix;
    d [..., n], row_pad [1, m] (grouped [G, 1, m]), f [..., m].  Under
    tensor parallelism ``psum`` sums the rank's product over the ranks and
    ``agree`` the loop's decision, as in ``pcg_solve``.

    With a ``plan`` (one device, no reducers) and f on a CUDA device
    (``_graphed``), the set-up and the gated step run as two CUDA graphs
    per key, each replay counted in ``pcg_solve.graph_replays``; elsewhere
    the same loop runs eagerly.  Returns (x, rel) as ``pcg_solve`` does."""
    if not _graphed(plan is not None, f):
        precond, matvec = _normal_ops(Linv, dinv, A, d, row_pad, psum)
        return pcg_solve(precond, matvec, f, tol, max_steps, agree, per_group=per_group, plan=plan)
    with span("pcg.solve"):
        return _graphed_pcg((Linv, dinv, A, d, row_pad, f), tol, max_steps, plan, per_group)


# ---------------------------------------------------------------------------
# CUDA graphs of the PCG and of the factor
# ---------------------------------------------------------------------------

GRAPH_KEYS = 24  # keys each graph cache holds; the least recently used goes
_pcg_graphs: "OrderedDict[tuple, _Graphs]" = OrderedDict()
_factor_graphs: "OrderedDict[tuple, _Graphs]" = OrderedDict()
_graphs_lock = threading.Lock()
# one capture at a time in the process: each synchronises the device and
# empties the allocator's cache as it begins
_capture_lock = threading.Lock()


def _graphed(allowed: bool, t: torch.Tensor) -> bool:
    """Whether a call replays CUDA graphs: its caller allows them and ``t``
    is on a CUDA device."""
    return allowed and t.device.type == "cuda"


def _cached(cache: OrderedDict, key, make):
    """The entry of ``key`` in the graph cache ``cache``, made by ``make()``
    where there is none; beyond ``GRAPH_KEYS`` the least recently used goes."""
    with _graphs_lock:
        g = cache.get(key)
        if g is None:
            g = cache[key] = make()
            while len(cache) > GRAPH_KEYS:
                cache.popitem(last=False)
        else:
            cache.move_to_end(key)
    return g


def _capture(fns, device: torch.device):
    """Warm ``fns`` up on a side stream (the libraries' handles and
    workspaces), then capture each as a CUDA graph, all in one private
    memory pool.  Returns (graphs, what each captured call returned)."""
    with _capture_lock:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for fn in fns:
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        graphs, outs = [], []
        for fn in fns:
            g = torch.cuda.CUDAGraph()
            # thread_local: other threads (shard threads, the B&B's closure
            # worker) may use the device while this one captures
            with torch.cuda.graph(g, pool=pool, stream=side, capture_error_mode="thread_local"):
                outs.append(fn())
            graphs.append(g)
        return graphs, outs


class _Graphs:
    """The CUDA graphs of one key: static copies of the key's input tensors
    (``load``); the graphs of the callables that ``capture`` records over
    them, in one private memory pool, and what each captured call returned;
    ``state``, what those callables keep between replays besides the
    inputs; and ``lock``, which serialises the key's calls from the copy-in
    to the copy-out, in the order of the device's current stream."""

    def __init__(self, tensors, state=None):
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
        self.state = state
        self.graphs = self.outs = None
        self.lock = threading.Lock()

    def load(self, tensors):
        for buf, t in zip(self.inputs, tensors):
            buf.copy_(t)

    def capture(self, fns):
        self.graphs, self.outs = _capture(fns, self.inputs[0].device)


def _flat(inputs):
    """The tensors of ``normal_pcg``'s inputs (an EllMatrix gives four)."""
    Linv, dinv, A, d, row_pad, f = inputs
    mats = (A.row_idx, A.row_val, A.col_idx, A.col_val) if isinstance(A, EllMatrix) else (A,)
    return (Linv, dinv) + mats + (d, row_pad, f)


def _unflat(ts, ell: bool):
    Linv, dinv, *mats, d, row_pad, f = ts
    A = EllMatrix(*mats) if ell else mats[0]
    return Linv, dinv, A, d, row_pad, f


def _graphed_pcg(inputs, tol: float, max_steps: int, plan: PcgChunks, per_group: bool):
    """``normal_pcg`` replayed from its key's two graphs, the set-up and the
    gated step, over static copies of its inputs; the key's state is the
    loop's state and the tolerance.  The span ``pcg.capture`` holds a key's
    first capture."""
    tensors, f = _flat(inputs), inputs[-1]
    ell = isinstance(inputs[2], EllMatrix)
    key = (f.device, ell, per_group, tuple((tuple(t.shape), t.dtype) for t in tensors))
    g = _cached(_pcg_graphs, key,
                lambda: _Graphs(tensors, (_PcgState(f, False, per_group, True), f.new_empty(()))))
    s, tol_t = g.state
    with g.lock:
        g.load(tensors)
        tol_t.fill_(tol)
        if g.graphs is None:
            with span("pcg.capture"):
                Linv, dinv, A, d, row_pad, f_in = _unflat(g.inputs, ell)
                precond, matvec = _normal_ops(Linv, dinv, A, d, row_pad)
                g.capture((lambda: _pcg_setup(precond, matvec, f_in, tol_t, s),
                           lambda: _pcg_advance(precond, matvec, s)))
            with _count_lock:
                pcg_solve.graph_captures += 2
        setup, step = g.graphs
        steps = _run_loop(setup.replay, step.replay, s, max_steps, plan)
        x, rel = s.x.clone(), s.rel()
    with _count_lock:
        pcg_solve.graph_replays += 1 + steps
    return x, rel


def _graphed_factor(M, row_reg, ridge: float, leaf_size: int):
    """``factor_gram`` replayed from its key's graph over static copies of M
    and row_reg: the span ``factor.capture`` holds a key's first capture,
    ``factor.replay`` the copy-in, the replay and the copy-out of (Linv,
    dinv)."""
    key = (M.device, M.dtype, tuple(M.shape), row_reg.dtype, tuple(row_reg.shape), leaf_size, ridge)
    g = _cached(_factor_graphs, key, lambda: _Graphs((M, row_reg)))
    with g.lock:
        if g.graphs is None:
            with span("factor.capture"):
                g.load((M, row_reg))
                g.capture((lambda: _factor_chain(*g.inputs, ridge, leaf_size),))
            with _count_lock:
                factor_gram.graph_captures += 1
        with span("factor.replay"):
            g.load((M, row_reg))
            g.graphs[0].replay()
            Linv, dinv = (t.clone() for t in g.outs[0])
    with _count_lock:
        factor_gram.graph_replays += 1
    return Linv, dinv


def normal_eq_solve(
    fac: NormalEqFactor,
    matvec: Callable[[torch.Tensor], torch.Tensor],
    f: torch.Tensor,
    tol: torch.Tensor | float = 1e-10,
    max_steps: int = 40,
    per_lane: bool | torch.Tensor = False,
) -> torch.Tensor:
    """Solve M x = f with the f32 factor as PCG preconditioner.

    ``matvec`` applies the exact f64 operator v -> A (d2 * (A^T v)) + reg*v;
    the factor is only a preconditioner, so the result converges to f64
    accuracy at two matvecs per step.
    """
    return pcg_solve(
        lambda r: _apply_normal_precond(fac, r), matvec, f, tol, max_steps, per_lane=per_lane
    )[0]


def spd_solve(
    fac: SpdFactor,
    f: torch.Tensor,
    tol: torch.Tensor | float = 1e-12,
    max_steps: int = 50,
    per_lane: bool | torch.Tensor = False,
) -> torch.Tensor:
    """Solve M x = f to relative residual ``tol`` (on the equilibrated
    system) by flexible PCG in f64 preconditioned by the factor; the JAX
    package's loop, whose body is ``pcg_solve``'s.  Returns x in f64."""
    Ms = fac.Ms
    x, _ = pcg_solve(
        lambda r: _apply_precond(fac.Linv, r),
        lambda v: torch.einsum("...ij,...j->...i", Ms, v),
        fac.dinv * f,
        tol,
        max_steps,
        per_lane=per_lane,
    )
    return fac.dinv * x
