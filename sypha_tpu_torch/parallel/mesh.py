"""Multi-device execution: lane-sharded solves and tensor parallelism.

The port of sypha_tpu/parallel/mesh.py.  Two modes, as in the JAX package:

* **Lane sharding** (``solve_shared_batch_sharded``,
  ``solve_node_batch_sharded``, ``solve_lp_batch_sharded``): every device
  solves its own block of lanes, and nothing crosses devices during a solve.
  So it is single-controller: one process holds a ``Mesh`` (an ordered
  tuple of torch devices; a device may repeat, which puts two shards on one
  card), places one contiguous block of lanes on each device with A and
  row_pad copied there, and runs each shard's eager solve on a host thread
  of its own under ``torch.cuda.device(dev)``, so that the launches and the
  syncs of several cards overlap.  Only scalar statistics are pooled
  (``pooled_stats``), and the shards' results are gathered on the mesh's
  first device.  A shard computes exactly what it computes when the shards
  run one after another.  For the shared-matrix engine that is NOT the
  unsharded solve, because its PCG steps every lane of the batch until all
  of them converge; a sharded result equals the concatenation of its shards
  each solved alone, and the JAX package's sharded result at the same mesh
  size.  The per-lane engine of ``solve_lp_batch_sharded`` steps each lane
  on its own, so there a shard differs from the unsharded solve only where
  a batched library call rounds differently at another batch size.

* **Tensor parallelism** (``solve_shared_batch_tensor_parallel``): the
  column axis of one batch is split over the ranks of a
  ``torch.distributed`` process group, and the IPM all-reduces inside every
  iteration (ipm.shared's reducers).  It is therefore SPMD, one process per
  column slab, which is PyTorch's idiom for collectives
  (parallel.distributed.initialize_distributed brings the group up).

PyTorch has no PartitionSpec: the JAX package's ``IpmState_lane_spec``,
``IpmState_tp_spec`` and its axis-name constants have no counterpart here.
Their role is played by the split and gather helpers below
(``_lane_blocks``/``_gather_lanes`` for lanes, ``_gather_cols`` for column
slabs).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from sypha_tpu_torch.config import IpmOptions
from sypha_tpu_torch.core.device import resolve_device
from sypha_tpu_torch.core.problem import PaddedLp
from sypha_tpu_torch.core.status import IpmStatus
from sypha_tpu_torch.ipm.driver import solve_lp_batch
from sypha_tpu_torch.ipm.node_batch import solve_node_batch
from sypha_tpu_torch.ipm.shared import IpmState, SharedLpBatch, mehrotra_solve_shared
from sypha_tpu_torch.ops.ell import EllMatrix, ell_column_slabs
from sypha_tpu_torch.ops.gram import load_kernel


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices, one lane shard on each."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _checked(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None and dev.index >= torch.cuda.device_count():
        raise ValueError(f"{dev} requested, only {torch.cuda.device_count()} CUDA devices")
    return dev


def make_mesh(
    n_devices: Optional[int] = None,
    device: torch.device | str | None = None,
    devices: Optional[Sequence[torch.device | str]] = None,
) -> Mesh:
    """A mesh of ``n_devices`` devices.

    With ``device`` None (``cuda``) the mesh is ``cuda:0 .. cuda:n-1``, all
    the cards by default, and asking for more cards than
    ``torch.cuda.device_count()`` raises; without a card it raises as every
    entry point does.  ``device="cpu"`` gives ``n_devices`` CPU shards (one
    by default).  An explicit ``devices`` list is taken as it is and may
    repeat a device.
    """
    if devices is not None:
        devs = tuple(_checked(d) for d in devices)
        if not devs or (n_devices is not None and n_devices != len(devs)):
            raise ValueError(f"n_devices={n_devices} with devices={list(devices)}")
        return Mesh(devs)
    dev = resolve_device(device)
    if dev.type != "cuda":
        return Mesh((dev,) * (n_devices or 1))
    count = torch.cuda.device_count()
    n = n_devices or count
    if n > count:
        raise ValueError(f"requested {n} devices, only {count} available")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


# ---- split, move, gather ----


def _tree_map(fn, obj):
    """Apply ``fn`` to every tensor of a (nested) dataclass or tuple."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(_tree_map(fn, o) for o in obj)
    if dataclasses.is_dataclass(obj):
        return type(obj)(
            **{f.name: _tree_map(fn, getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        )
    raise TypeError(f"cannot map over {type(obj).__name__}")


def _lane_blocks(n_lanes: int, mesh: Mesh) -> List[slice]:
    """Contiguous lane blocks, one per device."""
    k = mesh.size
    if n_lanes % k:
        raise ValueError(f"{n_lanes} lanes do not divide over a mesh of {k} devices")
    per = n_lanes // k
    return [slice(i * per, (i + 1) * per) for i in range(k)]


def _gather_lanes(parts, device: torch.device):
    """Concatenate the shards' lane-leading results on ``device``."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, tuple):
        return tuple(_gather_lanes([p[i] for p in parts], device) for i in range(len(first)))
    return type(first)(
        **{
            f.name: _gather_lanes([getattr(p, f.name) for p in parts], device)
            for f in dataclasses.fields(first)
        }
    )


def _run_shards(mesh: Mesh, jobs: Sequence[Callable[[], object]]) -> list:
    """Run ``jobs[i]()`` for shard i on a host thread of its own, under
    ``torch.cuda.device`` for a CUDA shard; results in shard order.  The
    Gram kernel is built and bound before any thread starts."""

    def run(dev, job):
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return job()
        return job()

    if any(d.type == "cuda" for d in mesh.devices):
        load_kernel()
    if mesh.size == 1:
        return [run(mesh.devices[0], jobs[0])]
    with ThreadPoolExecutor(max_workers=mesh.size) as pool:
        futures = [pool.submit(run, d, job) for d, job in zip(mesh.devices, jobs)]
        return [f.result() for f in futures]


def shard_batch(lp: PaddedLp, mesh: Mesh) -> Tuple[PaddedLp, ...]:
    """A stacked batch of LPs (leading [B] on every field) as one block of
    lanes per device."""
    blocks = _lane_blocks(lp.A.shape[0], mesh)
    return tuple(
        _tree_map(lambda t: t[sl].to(dev), lp) for sl, dev in zip(blocks, mesh.devices)
    )


def _shared_shard(batch: SharedLpBatch, sl: slice, dev: torch.device) -> SharedLpBatch:
    return SharedLpBatch(
        A=_tree_map(lambda t: t.to(dev), batch.A),
        b=batch.b[sl].to(dev),
        c=batch.c[sl].to(dev),
        col_mask=batch.col_mask[sl].to(dev),
        row_pad=batch.row_pad.to(dev),
        obj_offset=batch.obj_offset[sl].to(dev),
    )


def shard_shared_batch(batch: SharedLpBatch, mesh: Mesh) -> Tuple[SharedLpBatch, ...]:
    """A SharedLpBatch as one block of lanes per device, the shared A (dense
    or ELL) and row_pad copied to every device."""
    blocks = _lane_blocks(batch.n_lanes, mesh)
    return tuple(_shared_shard(batch, sl, dev) for sl, dev in zip(blocks, mesh.devices))


def _shards(batch, mesh: Mesh, shard):
    """Shards of ``batch``: as given when it is already a sequence of them
    (from ``shard_batch``/``shard_shared_batch``), else cut here."""
    if isinstance(batch, (tuple, list)):
        if len(batch) != mesh.size:
            raise ValueError(f"{len(batch)} shards for a mesh of {mesh.size} devices")
        return list(batch)
    return list(shard(batch, mesh))


# ---- pooled statistics and lane-sharded solves ----


def pooled_stats(states: Sequence[IpmState]):
    """The shards' scalar statistics pooled across devices: (worst gap,
    max iterations, converged count), 0-dim tensors on the first shard's
    device; the counterpart of the JAX package's psum/pmax inside
    ``shard_map``, and the state the reference's B&B keeps in host variables
    (incumbent, global dual bound, stop flag)."""
    dev = states[0].gap.device
    converged = sum(
        torch.sum(st.status == IpmStatus.CONVERGED).to(torch.int32).to(dev) for st in states
    )
    max_iters = torch.stack([torch.amax(st.iterations).to(dev) for st in states]).amax()
    worst_gap = torch.stack([torch.amax(st.gap).to(dev) for st in states]).amax()
    return worst_gap, max_iters, converged


def solve_shared_batch_sharded(
    batch,
    opts: Optional[IpmOptions] = None,
    mesh: Optional[Mesh] = None,
):
    """Shard the lane axis of a SharedLpBatch over the mesh: each device runs
    the shared-matrix batched Mehrotra solve on its lane block (A copied to
    every device) and only pooled scalars cross devices.  ``batch`` is a
    SharedLpBatch or the shards ``shard_shared_batch`` made of it; ``mesh``
    defaults to every card.

    Returns (IpmState of all lanes on the mesh's first device, (worst_gap,
    max_iters, n_converged, min_dual)); min_dual is the smallest lane dual
    objective b.y + offset, the pooled bound a distributed B&B prunes
    against.
    """
    opts = opts or IpmOptions()
    mesh = mesh or make_mesh()
    shards = _shards(batch, mesh, shard_shared_batch)

    def job(local: SharedLpBatch):
        st = mehrotra_solve_shared(local, opts)
        local_dual = torch.amin(torch.sum(local.b * st.y, dim=-1) + local.obj_offset)
        return st, local_dual

    out = _run_shards(mesh, [lambda s=s: job(s) for s in shards])
    states = [st for st, _ in out]
    dev = mesh.devices[0]
    min_dual = torch.stack([d.to(dev) for _, d in out]).amin()
    return _gather_lanes(states, dev), (*pooled_stats(states), min_dual)


def solve_node_batch_sharded(
    base: PaddedLp,
    fix0,
    fix1,
    opts: IpmOptions,
    mesh: Mesh,
    warm=None,
    resume: Optional[IpmState] = None,
    iter_limit=None,
):
    """A B&B node window (ipm.node_batch.solve_node_batch: per-lane branch
    fixings, warm starts, chunked resume) with its lane axis sharded over
    the mesh.

    The padded base LP (one A, dense or ELL, for the whole window) is copied
    to every device; each device solves its block of the window, and nothing
    crosses devices during the solve: the B&B pools its incumbent, dual
    bound and stop flag across processes through parallel.distributed's
    BoundPool instead.  The lane count must divide by the mesh size (the
    B&B pads its window by replicating the last node).  Returns the
    (state, x_full, pobj, dobj) of solve_node_batch, every lane on the
    mesh's first device.
    """
    fix0 = torch.as_tensor(fix0)
    fix1 = torch.as_tensor(fix1)
    blocks = _lane_blocks(fix0.shape[0], mesh)

    def job(sl, dev):
        on_dev = lambda t: t[sl].to(dev)  # noqa: E731
        return solve_node_batch(
            _tree_map(lambda t: t.to(dev), base),
            on_dev(fix0),
            on_dev(fix1),
            opts,
            _tree_map(on_dev, warm),
            _tree_map(on_dev, resume),
            iter_limit,
        )

    out = _run_shards(
        mesh, [lambda sl=sl, dev=dev: job(sl, dev) for sl, dev in zip(blocks, mesh.devices)]
    )
    return _gather_lanes(out, mesh.devices[0])


def solve_lp_batch_sharded(
    lp,
    opts: Optional[IpmOptions] = None,
    mesh: Optional[Mesh] = None,
):
    """Solve a stacked batch of LPs (lanes may have different A) lane-sharded
    over the mesh: each device runs ``ipm.driver.solve_lp_batch``, the
    per-lane dense IPM (ipm.dense), on its block, as the JAX package vmaps
    its dense IPM over each shard.  ``lp`` is a stacked PaddedLp or the
    shards ``shard_batch`` made of it.

    Returns (IpmState of all lanes in their order, on the mesh's first
    device, (worst_gap, max_iters, n_converged))."""
    opts = opts or IpmOptions()
    mesh = mesh or make_mesh()
    shards = _shards(lp, mesh, shard_batch)
    states = _run_shards(
        mesh, [lambda s=s: solve_lp_batch(s, opts, as_results=False) for s in shards]
    )
    return _gather_lanes(states, mesh.devices[0]), pooled_stats(states)


# ---- tensor parallelism ----


def _gather_cols(v: torch.Tensor, cols: slice, n_pad: int, group) -> torch.Tensor:
    """The whole [B, n_pad] vector from each rank's [B, n_pad/k] slab: an
    all-reduce (SUM) of zero-padded copies, exact since every other rank
    adds zeros; gloo's all_reduce takes CUDA tensors."""
    full = torch.zeros((v.shape[0], n_pad), dtype=v.dtype, device=v.device)
    full[:, cols] = v
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    return full


def solve_shared_batch_tensor_parallel(
    batch: SharedLpBatch,
    opts: Optional[IpmOptions] = None,
    group=None,
) -> IpmState:
    """Tensor-parallel solve of ONE SharedLpBatch whose COLUMN axis is split
    over the ranks of a process group (the default group when None).

    SPMD: every rank calls it with the same whole batch and keeps column slab
    ``rank`` of A (a dense slab, or ``ell_column_slabs``' slab of an ELL
    operator with shard-local column indices) and of c and col_mask; b,
    row_pad and obj_offset stay whole.  Every A-product onto the row space
    and every sum over columns all-reduces over the group, and the m x m
    Gram matrix is the sum of the ranks' partial Grams (the Gram kernel on
    each slab), factored on every rank.  This scales the column dimension
    of instances that outgrow one device; lane sharding stays the
    throughput mode.

    ``batch.n_pad`` must divide by the world size.  Returns the IpmState
    with x and s gathered whole on every rank.  The backend is the group's:
    ``nccl`` where each rank has a card of its own, ``gloo`` where ranks
    share one (both all-reduce CUDA tensors).
    """
    opts = opts or IpmOptions()
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "solve_shared_batch_tensor_parallel runs on every rank of an initialised "
            "process group (parallel.distributed.initialize_distributed)"
        )
    group = group if group is not None else dist.group.WORLD
    k = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n_pad = batch.n_pad
    if n_pad % k:
        raise ValueError(f"n_pad {n_pad} not divisible by {k} ranks")
    nl = n_pad // k
    cols = slice(rank * nl, (rank + 1) * nl)
    if batch.is_sparse:
        slabs = ell_column_slabs(batch.A, k)
        A = EllMatrix(
            row_idx=slabs.row_idx[rank],
            row_val=slabs.row_val[rank],
            col_idx=slabs.col_idx[rank],
            col_val=slabs.col_val[rank],
        )
    else:
        A = batch.A[:, cols].contiguous()
    local = SharedLpBatch(
        A=A,
        b=batch.b,
        c=batch.c[:, cols].contiguous(),
        col_mask=batch.col_mask[:, cols].contiguous(),
        row_pad=batch.row_pad,
        obj_offset=batch.obj_offset,
    )
    st = mehrotra_solve_shared(local, opts, group=group)
    return dataclasses.replace(
        st,
        x=_gather_cols(st.x, cols, n_pad, group),
        s=_gather_cols(st.s, cols, n_pad, group),
    )
