"""Coordination of the B&B across processes: the port of
sypha_tpu/parallel/distributed.py.

The reference keeps the cross-worker state (incumbent objective, global
dual bound, stop flag) in plain host variables of its single process
(src/sypha_solver_bnb_driver.cpp:256-261, :1048-1079).  Across processes
those become the only traffic: tiny scalar publishes on a cadence.

Transport: the key-value store of the ``torch.distributed`` process group
(its c10d store, TCP or file), not a collective.  A collective forces every
process to reach the same call site in lockstep, and B&B processes are
asynchronous by nature (different tree shapes, different warm-ups).  The
pooled quantities are monotone (incumbents only decrease, proven bounds
only increase, stop is sticky), so an asynchronous read of a peer's LAST
PUBLISHED value is always sound: staleness delays propagation and never
corrupts it.  The JAX package uses the jax.distributed key-value store the
same way, with the same wire format.

``initialize_distributed`` brings the process group up; a run with no group
has one process, and its pool is a no-op, so the B&B driver calls
``sync()`` unconditionally.  ``run_spmd`` starts a group of processes on
one machine and runs one function on every rank.
"""

from __future__ import annotations

import multiprocessing
import pathlib
import queue as queue_mod
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from sypha_tpu_torch.core.device import resolve_device


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def initialize_distributed(
    coordinator_address=None,
    num_processes=None,
    process_id=None,
    backend: str | None = None,
    device: torch.device | str | None = None,
) -> int:
    """Bring up the ``torch.distributed`` process group of this process.
    Returns the world size: 1 when no address is given and no group is up.

    ``coordinator_address`` is the rendezvous, an ``init_process_group``
    init method (``tcp://host:port`` or ``file:///path``; a bare
    ``host:port`` means TCP).  ``backend`` must be given: ``"nccl"`` where
    each rank has a card of its own, ``"gloo"`` where ranks share one card or
    run on the CPU; it is never chosen here, and a failed rendezvous raises.
    ``device`` is the rank's device, ``cuda`` by default (raises without a
    card, as every entry point does); a CUDA device with an index becomes the
    process's current device.
    """
    if coordinator_address is None:
        return _world_size()
    if backend is None:
        raise ValueError('initialize_distributed needs backend="nccl" or backend="gloo"')
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend=backend,
        init_method=coordinator_address,
        world_size=num_processes,
        rank=process_id,
    )
    return dist.get_world_size()


def _spmd_rank(fn, rank, world, init, backend, device, args, results):
    """Body of one spawned rank: join the group, run ``fn``, report."""
    try:
        if torch.device(device).type == "cpu":
            # ranks share the host's cores: split them rather than oversubscribe
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        initialize_distributed(init, world, rank, backend=backend, device=device)
        results.put((rank, True, fn(*args)))
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


_SPMD_TIMEOUT_SEC = 600.0


def run_spmd(fn, devices, backend: str, args=()) -> list:
    """Run ``fn(*args)`` on ``len(devices)`` ranks of one new process group
    on this machine, rank r a spawned process on ``devices[r]`` (a device may
    repeat: ranks can share a card).  ``fn`` must be importable by name and
    return something picklable.  The ranks meet through a ``file://``
    rendezvous in a temporary directory.  Returns the ranks' results in rank
    order; raises if a rank raises, dies or runs past ``_SPMD_TIMEOUT_SEC``,
    and leaves no process behind."""
    ctx = multiprocessing.get_context("spawn")
    n = len(devices)
    with tempfile.TemporaryDirectory(prefix="sypha_spmd_") as tmp:
        init = pathlib.Path(tmp, "rendezvous").as_uri()
        results = ctx.Queue()
        procs = [
            ctx.Process(
                target=_spmd_rank,
                args=(fn, r, n, init, backend, str(devices[r]), tuple(args), results),
            )
            for r in range(n)
        ]
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + _SPMD_TIMEOUT_SEC
        try:
            while len(out) < n:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"ranks {dead} exited without a result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"ranks still running after {_SPMD_TIMEOUT_SEC} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=30.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(n)]


@dataclass
class PooledBounds:
    incumbent: float
    dual_bound: float
    stop: bool
    # every process has announced departure (finished its own search): the
    # finalize() drain loop may end
    all_departed: bool = False
    # 0/1 column-selection bits of the process owning the pooled incumbent
    # (None when that process did not publish a solution): the incumbent's
    # cover ships with its objective, so adopters never pair a remote
    # objective with a stale local solution vector
    incumbent_solution: np.ndarray | None = None


class BoundPool:
    """Scalar bound pooling across processes over the process group's store.

    Each process owns one key and overwrites it with
    ``seq,incumbent,dual_bound,stop,departed,bits``; ``sync()`` publishes
    ours and folds whatever peer values are visible (non-blocking by
    default).  ``finalize()`` marks this process departed and polls until
    every process has departed, so all processes exit near-simultaneously.

    Namespacing: each construction bumps a per-process counter and works
    under its own ``PrefixStore``, so back-to-back solves in one process pair
    never read the previous run's keys.  All processes must construct their
    BoundPools in the same order (they run the same program).
    """

    _instance_counter = 0

    def __init__(self):
        self.n_processes = _world_size()
        self.pid = dist.get_rank() if self.n_processes > 1 else 0
        self._seq = 0
        # Per-peer cache of the highest-seq row ever read: a row with
        # seq <= the cached seq is ignored, so pooled views never regress.
        self._peer_cache = {}
        BoundPool._instance_counter += 1
        self._ns = f"sypha_bound_pool/{BoundPool._instance_counter}/"
        self._store = None
        if self.n_processes > 1:
            store = dist.distributed_c10d._get_default_store()
            self._store = dist.PrefixStore(self._ns, store)

    # ---- wire format (the JAX package's, character for character) ----

    @staticmethod
    def _encode(seq, incumbent, dual_bound, stop, departed, solution) -> str:
        # float() casts matter: numpy scalars reach sync/finalize (heuristics
        # return np.float64 costs), and repr(np.float64(429.0)) is
        # 'np.float64(429.0)' under numpy>=2, which _decode cannot parse.
        # The solution ships as hex-packed bits (n=10000 cols -> 2.5 KB).
        bits = ""
        if solution is not None:
            bits = np.packbits(np.asarray(solution).ravel() > 0.5).tobytes().hex()
        return (
            f"{int(seq)},{float(incumbent)!r},{float(dual_bound)!r},"
            f"{int(stop)},{int(departed)},{bits}"
        )

    @staticmethod
    def _decode(v: str):
        seq, inc, db, stop, dep, bits = v.split(",")
        sol = None
        if bits:
            sol = np.unpackbits(
                np.frombuffer(bytes.fromhex(bits), dtype=np.uint8)
            ).astype(np.float64)
        return int(seq), float(inc), float(db), stop == "1", dep == "1", sol

    def _publish(self, incumbent, dual_bound, stop, departed, solution):
        self._seq += 1
        self._store.set(
            str(self.pid),
            self._encode(self._seq, incumbent, dual_bound, stop, departed, solution),
        )

    def _read_peer(self, pid):
        # Only a missing key means "peer has not published yet"; a value
        # that exists but does not parse is wire corruption and raises
        # (swallowing it would disable pooling and deadlock finalize's
        # departure drain, which waits on all_departed).  Keys are never
        # deleted, so check-then-get cannot miss.
        key = str(pid)
        if not self._store.check([key]):
            return None
        return self._decode(self._store.get(key).decode())

    def _barrier(self, name: str, timeout_sec: float):
        """Every process has arrived at ``name`` (or the wait times out and
        raises)."""
        if self._store.add(name, 1) == self.n_processes:
            self._store.set(f"{name}/done", "1")
        self._store.wait([f"{name}/done"], timedelta(seconds=timeout_sec))

    # ---- pooling ----

    def sync(
        self,
        incumbent: float,
        dual_bound: float,
        stop: bool,
        departed: bool = False,
        wait: bool = False,
        wait_timeout_sec: float = 600.0,
        solution=None,
    ) -> PooledBounds:
        """Publish our scalars (plus the optional incumbent cover bits), fold
        the peers' latest.

        ``wait=False`` (the B&B cadence): non-blocking; peers that have not
        published yet do not contribute this round.  ``wait=True``: block
        until every peer has published as many rounds as we have
        (synchronous gather semantics, for tests and one-shot exchanges)."""
        if self.n_processes <= 1:
            return PooledBounds(float(incumbent), float(dual_bound), bool(stop), departed)
        self._publish(incumbent, dual_bound, stop, departed, solution)
        if wait:
            # double barrier: everyone has published round `seq` before
            # anyone reads, and everyone has read before anyone may
            # overwrite with round seq+1
            self._barrier(f"pub{self._seq}", wait_timeout_sec)
        for pid in range(self.n_processes):
            if pid != self.pid:
                self._fold_peer(pid, self._read_peer(pid))
        if wait:
            self._barrier(f"read{self._seq}", wait_timeout_sec)
        mine = (
            self._seq,
            float(incumbent),
            float(dual_bound),
            stop,
            departed,
            None if solution is None else np.asarray(solution, np.float64),
        )
        rows = [mine] + list(self._peer_cache.values())
        best = min(rows, key=lambda r: r[1])
        return PooledBounds(
            incumbent=float(best[1]),
            dual_bound=float(min(r[2] for r in rows)),
            stop=bool(any(r[3] for r in rows)),
            all_departed=len(rows) == self.n_processes and all(r[4] for r in rows),
            incumbent_solution=best[5],
        )

    def _fold_peer(self, pid, row):
        """Keep the highest-seq row per peer (monotone: stale reads or
        out-of-order arrivals never regress the pooled view)."""
        if row is None:
            return
        cached = self._peer_cache.get(pid)
        if cached is None or row[0] > cached[0]:
            self._peer_cache[pid] = row

    def finalize(
        self,
        incumbent: float,
        dual_bound: float,
        stop_peers: bool,
        poll_sec: float = 0.2,
        drain_timeout_sec: float | None = None,
        solution=None,
    ) -> PooledBounds:
        """Drain loop for a process whose search ended: announce departure
        (with our final incumbent/bound) and poll until every process has
        departed.

        ``stop_peers``: True when this process CLOSED the shared search
        (optimality proven / infeasible), so peers on the same instance stop
        at their next sync; False on a local time/node limit, where we only
        donate our final incumbent/bound and wait.  Returns the last pooled
        view.

        A crashed peer never departs.  By default (``drain_timeout_sec``
        None) the drain polls indefinitely; a finite ``drain_timeout_sec``
        gives up after that many seconds and returns the last pooled view
        with ``all_departed=False`` (the caller decides whether that is
        fatal)."""
        deadline = None if drain_timeout_sec is None else time.monotonic() + drain_timeout_sec
        out = self.sync(incumbent, dual_bound, stop_peers, departed=True, solution=solution)
        while self.n_processes > 1 and not out.all_departed:
            if deadline is not None and time.monotonic() > deadline:
                break
            time.sleep(poll_sec)
            out = self.sync(incumbent, dual_bound, stop_peers, departed=True, solution=solution)
        return out
