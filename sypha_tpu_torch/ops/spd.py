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
groups of a batch-wide loop runs (the grouped shared-matrix IPM).  Its test
is one device-to-host sync per step.

``pcg_chunked`` runs the batch-wide and the per-group loop in chunks of
steps gated on a flag that stays on the device, with one read of the flag
per chunk, and gives ``pcg_solve``'s answer bit for bit.  ``normal_pcg``,
the shared IPM's Newton solve on one device, runs it, on a card as two CUDA
graphs per key (the set-up and a chunk) replayed from static buffers.

``normal_eq_factor`` in f32 forms its Gram matrix with the Gram kernel
(ops.gram), one matrix per lane or one shared by every lane.
``factor_gram`` factors a Gram matrix; for the shared IPM on one card it
replays the chain as one CUDA graph per key.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
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

    With ``graph`` on a CUDA device (the shared IPM on one device) the chain
    is replayed from one CUDA graph per key (``_FactorGraph``), bit for bit
    the eager chain's; elsewhere it runs eagerly.  ``factor_gram.calls``
    counts the calls, ``.graph_captures`` and ``.graph_replays`` the
    graphs' captures and replays (exactly under host threads)."""
    with _count_lock:
        factor_gram.calls += 1
    if graph and M.device.type == "cuda":
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

    In eager PyTorch the loop's test is one device-to-host sync per step,
    and one more where the loop ends before ``max_steps``;
    ``pcg_solve.steps`` counts the steps taken and ``pcg_solve.syncs`` the
    tests made, over all calls (exactly under host threads).  A call is the
    span ``pcg.solve``, each test the span ``pcg.sync``.  ``agree`` turns
    the local "any lane" flag into the host's decision; tensor parallelism
    passes one that reduces it over the ranks, so that every rank takes the
    same number of steps.
    """
    with span("pcg.solve"):
        return _pcg_loop(precond, matvec, f, tol, max_steps, agree, per_lane, per_group)


def _above(r, thresh, per_group):
    """The loop's test: per lane [..., 1], or per group [G, 1, 1]."""
    hi = torch.linalg.vector_norm(r, dim=-1, keepdim=True) > thresh
    return hi.any(dim=-2, keepdim=True) if per_group else hi


def _pcg_step(precond, matvec, x, r, p, rz):
    """One flexible PCG step from (x, r, p, rz): the body of the eager loop
    and of the chunked one."""
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


def _pcg_loop(precond, matvec, f, tol, max_steps, agree, per_lane, per_group):
    norm_f = torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    thresh = tol * torch.clamp(norm_f, min=1e-300)

    if per_group and per_lane is not False:
        raise ValueError("pcg_solve takes per_lane or per_group, not both")

    x = precond(f)
    r = f - matvec(x)
    z = precond(r)
    p = z
    rz = torch.sum(r * z, dim=-1, keepdim=True)

    if per_lane is False and not per_group:
        active = None
    else:
        active = _above(r, thresh, per_group)
        if isinstance(per_lane, torch.Tensor):
            active = active & per_lane[..., None]

    k = syncs = 0
    while k < max_steps:
        with span("pcg.sync"):
            go = agree((_above(r, thresh, per_group) if active is None else active).any())
        syncs += 1
        if not go:
            break
        x_new, r_new, p_new, rz_new = _pcg_step(precond, matvec, x, r, p, rz)
        if active is None:
            x, r, p, rz = x_new, r_new, p_new, rz_new
        else:
            x = torch.where(active, x_new, x)
            r = torch.where(active, r_new, r)
            p = torch.where(active, p_new, p)
            rz = torch.where(active, rz_new, rz)
            active = active & _above(r, thresh, per_group)
        k += 1
    with _count_lock:
        pcg_solve.steps += k
        pcg_solve.syncs += syncs
    rel = torch.linalg.vector_norm(r, dim=-1) / torch.clamp(norm_f[..., 0], min=1e-300)
    return x, rel


pcg_solve.steps = 0
pcg_solve.syncs = 0
pcg_solve.masked_steps = 0
pcg_solve.graph_captures = 0
pcg_solve.graph_replays = 0


# ---------------------------------------------------------------------------
# the chunked loop: gated steps, one read of a device flag per chunk
# ---------------------------------------------------------------------------


class PcgChunks:
    """How the chunked PCG calls of one solve read their flag.

    A chunk is ``SIZE`` gated steps.  On a card a call runs, before its
    first read, as many chunks as the previous call of the solve took real
    steps, rounded down to whole chunks (at least one), and then one chunk a
    read: there a read costs a sync (about 25 us on an H100) and a masked
    step its device time (about 130 us at scp4x class).  Off a card a read
    costs no more than a tensor's copy and a masked step a whole step, so
    every chunk is read.  A solve makes one plan and passes it to each of
    its calls in turn.

    On 64-lane scp4x-class node windows on an H100, one step a chunk masked
    0.04% of the steps with 2.4 reads a call; four steps 8.1% with 1.4
    reads, eight steps 20.8% with 1.2."""

    SIZE = 1

    def __init__(self):
        self.last = 0

    def first(self, device: torch.device) -> int:
        """Chunks to run before a call's first read, on ``device``."""
        if device.type != "cuda":
            return 1
        return max(1, self.last // self.SIZE)


class _PcgState:
    """The chunked loop's state, in tensors that the set-up and the steps
    write in place: the iterate (x, r, p, rz), the thresholds, the step
    count ``k`` and its cap ``kmax``, the flag ``go`` (the loop's test for
    the next step), per group the mask ``active``, and ``flags`` = (k, go),
    which the host reads."""

    def __init__(self, f: torch.Tensor, per_group: bool):
        lead = f.shape[:-1]
        self.x, self.r, self.p = (torch.empty_like(f) for _ in range(3))
        self.rz, self.norm_f, self.thresh = (f.new_empty(lead + (1,)) for _ in range(3))
        scalar = dict(device=f.device, dtype=torch.int64)
        self.k, self.kmax = torch.zeros((), **scalar), torch.zeros((), **scalar)
        self.go = torch.zeros((), dtype=torch.bool, device=f.device)
        self.flags = torch.zeros(2, **scalar)
        self.active = (
            torch.zeros(lead[:-1] + (1, 1), dtype=torch.bool, device=f.device) if per_group else None
        )

    def test(self):
        """go = (any lane, or per group any active group, above its
        threshold) and k < kmax."""
        if self.active is None:
            hi = _above(self.r, self.thresh, False).any()
        else:
            hi = self.active.any()
        torch.logical_and(hi, self.k < self.kmax, out=self.go)

    def write_flags(self):
        torch.stack((self.k, self.go.to(torch.int64)), out=self.flags)

    def rel(self):
        return torch.linalg.vector_norm(self.r, dim=-1) / torch.clamp(self.norm_f[..., 0], min=1e-300)


def _chunked_setup(precond, matvec, f, tol, s: _PcgState):
    """The eager loop's set-up, into ``s``, with k = 0 and the first test."""
    norm_f = torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    s.norm_f.copy_(norm_f)
    s.thresh.copy_(tol * torch.clamp(norm_f, min=1e-300))
    x = precond(f)
    r = f - matvec(x)
    z = precond(r)
    s.x.copy_(x)
    s.r.copy_(r)
    s.p.copy_(z)
    s.rz.copy_(torch.sum(r * z, dim=-1, keepdim=True))
    s.k.zero_()
    if s.active is not None:
        s.active.copy_(_above(r, s.thresh, True))
    s.test()
    s.write_flags()


def _chunk(precond, matvec, s: _PcgState, size: int):
    """``size`` gated steps: each takes the step where ``go`` holds (per
    group, where the group is active too) and keeps the state exactly as it
    was elsewhere; k counts the steps taken.  Ends by writing ``flags``."""
    for _ in range(size):
        new = _pcg_step(precond, matvec, s.x, s.r, s.p, s.rz)
        sel = s.go if s.active is None else s.active & s.go
        for buf, v in zip((s.x, s.r, s.p, s.rz), new):
            torch.where(sel, v, buf, out=buf)
        s.k.add_(s.go)
        if s.active is not None:
            s.active.logical_and_(_above(s.r, s.thresh, True))
        s.test()
    s.write_flags()


def _run_chunks(setup, chunk, s: _PcgState, size: int, max_steps: int, plan: PcgChunks):
    """Set up, then run chunks and read ``flags`` after each batch of them
    (the span ``pcg.sync``) until the flag is down; count the real steps,
    the masked ones and the reads, and return the chunks run.  A step after
    the flag went down changes nothing, and once down the flag stays down,
    so a batch never runs past ``max_steps`` rounded up to a whole chunk."""
    setup()
    n = plan.first(s.x.device)
    done = chunks = reads = 0
    while True:
        n = min(n, -(-(max_steps - done) // size))
        for _ in range(n):
            chunk()
        chunks += n
        done += n * size
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
    return chunks


def pcg_chunked(precond, matvec, f, tol, max_steps: int, plan: PcgChunks, per_group: bool = False):
    """``pcg_solve``'s batch-wide loop (per group with ``per_group``), run
    eagerly in chunks of ``plan.SIZE`` gated steps with one read of a
    device flag per batch of chunks (``PcgChunks``) instead of one test per
    step.  x and rel are bit for bit ``pcg_solve``'s, after the same
    number of real steps; ``pcg_solve.steps`` counts those,
    ``pcg_solve.masked_steps`` the gated steps that changed nothing, and
    ``pcg_solve.syncs`` the reads.  A call is the span ``pcg.solve``."""
    with span("pcg.solve"):
        s = _PcgState(f, per_group)
        s.kmax.fill_(max_steps)
        _run_chunks(
            lambda: _chunked_setup(precond, matvec, f, tol, s),
            lambda: _chunk(precond, matvec, s, plan.SIZE),
            s, plan.SIZE, max_steps, plan,
        )
        return s.x, s.rel()


def _normal_ops(Linv, dinv, A, d, row_pad):
    """(precond, matvec) of the shared IPM's Newton system: P r = Dg L^-T
    L^-1 Dg r with the factor (Linv, dinv), and v -> A (d * (A^T v)) +
    row_pad * v."""
    fac = NormalEqFactor(Linv=Linv, dinv=dinv)
    Av, ATu, _ = products(A)
    return (lambda r: _apply_normal_precond(fac, r)), (lambda v: Av(d * ATu(v)) + row_pad * v)


def normal_pcg(Linv, dinv, A, d, row_pad, f, tol: float, max_steps: int, plan: PcgChunks,
               per_group: bool = False):
    """Solve (A diag(d) A^T + diag(row_pad)) x = f by ``pcg_chunked``,
    preconditioned by the factor (Linv, dinv): the shared IPM's Newton
    solve on one device.  A is a dense [m, n] (grouped [G, m, n]) tensor or
    an EllMatrix; d [..., n], row_pad [1, m] (grouped [G, 1, m]), f [..., m].

    On a CUDA device the set-up and the chunk run as two CUDA graphs
    (``_PcgGraphs``), each replay counted in ``pcg_solve.graph_replays``;
    elsewhere the same loop runs eagerly.  Returns (x, rel) as
    ``pcg_solve`` does."""
    if f.device.type != "cuda":
        precond, matvec = _normal_ops(Linv, dinv, A, d, row_pad)
        return pcg_chunked(precond, matvec, f, tol, max_steps, plan, per_group)
    with span("pcg.solve"):
        return _graphed_pcg((Linv, dinv, A, d, row_pad, f), tol, max_steps, plan, per_group)


# ---------------------------------------------------------------------------
# CUDA graphs of the chunked loop and of the factor
# ---------------------------------------------------------------------------

GRAPH_KEYS = 24  # keys each graph cache holds; the least recently used goes
_graphs: "OrderedDict[tuple, _PcgGraphs]" = OrderedDict()
_factor_graphs: "OrderedDict[tuple, _FactorGraph]" = OrderedDict()
_graphs_lock = threading.Lock()
# one capture at a time in the process: each synchronises the device and
# empties the allocator's cache as it begins
_capture_lock = threading.Lock()


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


def _flat(inputs):
    """The tensors of ``normal_pcg``'s inputs (an EllMatrix gives four)."""
    Linv, dinv, A, d, row_pad, f = inputs
    mats = (A.row_idx, A.row_val, A.col_idx, A.col_val) if isinstance(A, EllMatrix) else (A,)
    return (Linv, dinv) + mats + (d, row_pad, f)


def _unflat(ts, ell: bool):
    Linv, dinv, *mats, d, row_pad, f = ts
    A = EllMatrix(*mats) if ell else mats[0]
    return Linv, dinv, A, d, row_pad, f


class _PcgGraphs:
    """The CUDA graphs of ``normal_pcg`` for one key: static copies of its
    inputs, the loop's state, and two graphs in one private memory pool, the
    set-up and a chunk of ``PcgChunks.SIZE`` steps, which read and write
    only those.  ``lock`` serialises the calls of the key, which run in
    the order of the device's current stream."""

    def __init__(self, inputs, per_group: bool):
        self.ell = isinstance(inputs[2], EllMatrix)
        self.bufs = [torch.empty_like(t) for t in _flat(inputs)]
        f = inputs[-1]
        self.tol = torch.empty((), dtype=f.dtype, device=f.device)
        self.state = _PcgState(f, per_group)
        self.graphs = None
        self.lock = threading.Lock()

    def load(self, inputs, tol: float, max_steps: int):
        for buf, t in zip(self.bufs, _flat(inputs)):
            buf.copy_(t)
        self.tol.fill_(tol)
        self.state.kmax.fill_(max_steps)

    def capture(self, size: int):
        """Capture the set-up and the chunk from the loaded inputs."""
        Linv, dinv, A, d, row_pad, f = _unflat(self.bufs, self.ell)
        precond, matvec = _normal_ops(Linv, dinv, A, d, row_pad)
        s = self.state
        self.graphs, _ = _capture(
            (lambda: _chunked_setup(precond, matvec, f, self.tol, s),
             lambda: _chunk(precond, matvec, s, size)),
            f.device,
        )


def _graphed_pcg(inputs, tol: float, max_steps: int, plan: PcgChunks, per_group: bool):
    size = plan.SIZE
    key = (
        inputs[-1].device, isinstance(inputs[2], EllMatrix), per_group, size,
        tuple((tuple(t.shape), t.dtype) for t in _flat(inputs)),
    )
    g = _cached(_graphs, key, lambda: _PcgGraphs(inputs, per_group))
    with g.lock:
        g.load(inputs, tol, max_steps)
        if g.graphs is None:
            with span("pcg.capture"):
                g.capture(size)
            with _count_lock:
                pcg_solve.graph_captures += 2
        setup, chunk = g.graphs
        chunks = _run_chunks(setup.replay, chunk.replay, g.state, size, max_steps, plan)
        x, rel = g.state.x.clone(), g.state.rel()
    with _count_lock:
        pcg_solve.graph_replays += 1 + chunks
    return x, rel


class _FactorGraph:
    """The CUDA graph of ``factor_gram``'s chain for one key: static copies
    of M and row_reg, and one graph in a private memory pool that reads
    them and writes the static (Linv, dinv).  ``lock`` serialises the calls
    of the key from the copy-in to the copy-out."""

    def __init__(self, M: torch.Tensor, row_reg: torch.Tensor):
        self.M = torch.empty(M.shape, dtype=M.dtype, device=M.device)
        self.row_reg = torch.empty(row_reg.shape, dtype=row_reg.dtype, device=row_reg.device)
        self.graph = self.out = None
        self.lock = threading.Lock()

    def load(self, M: torch.Tensor, row_reg: torch.Tensor):
        self.M.copy_(M)
        self.row_reg.copy_(row_reg)

    def capture(self, ridge: float, leaf_size: int):
        (self.graph,), (self.out,) = _capture(
            (lambda: _factor_chain(self.M, self.row_reg, ridge, leaf_size),), self.M.device
        )


def _graphed_factor(M, row_reg, ridge: float, leaf_size: int):
    """``factor_gram`` replayed from its key's graph: the span
    ``factor.capture`` holds a key's first capture, ``factor.replay`` the
    copy-in, the replay and the copy-out of (Linv, dinv)."""
    key = (M.device, M.dtype, tuple(M.shape), row_reg.dtype, tuple(row_reg.shape), leaf_size, ridge)
    g = _cached(_factor_graphs, key, lambda: _FactorGraph(M, row_reg))
    with g.lock:
        if g.graph is None:
            with span("factor.capture"):
                g.load(M, row_reg)
                g.capture(ridge, leaf_size)
            with _count_lock:
                factor_gram.graph_captures += 1
        with span("factor.replay"):
            g.load(M, row_reg)
            g.graph.replay()
            Linv, dinv = (t.clone() for t in g.out)
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
