"""The port's BoundPool wire format and fold robustness, in one process: the
eight cases of tests/test_bound_pool_wire.py, with the process group's
store in place of the jax.distributed client, and the encoded row equal to
the JAX package's character for character."""

import numpy as np
import pytest

from sypha_tpu.parallel.distributed import BoundPool as JBoundPool
from sypha_tpu_torch.parallel.distributed import BoundPool, PooledBounds, initialize_distributed


def test_encode_accepts_numpy_scalars():
    s = BoundPool._encode(np.int64(3), np.float64(429.0), np.float32(417.5), np.bool_(True), 0, None)
    seq, inc, db, stop, dep, sol = BoundPool._decode(s)
    assert seq == 3 and inc == 429.0 and db == 417.5
    assert stop is True and dep is False and sol is None


def test_encode_roundtrips_full_float_precision():
    v = 429.0000001234567
    s = BoundPool._encode(1, v, -v, False, True, None)
    _, inc, db, stop, dep, _ = BoundPool._decode(s)
    assert inc == v and db == -v
    assert stop is False and dep is True


def test_solution_bits_roundtrip():
    x = np.zeros(37)
    x[[0, 5, 11, 36]] = 1.0
    s = BoundPool._encode(2, 4.0, 3.0, False, False, x)
    *_, sol = BoundPool._decode(s)
    # unpackbits pads to a byte multiple; the prefix must match exactly
    assert sol is not None and sol.shape[0] >= 37
    np.testing.assert_array_equal(sol[:37], x)
    assert not sol[37:].any()


def test_solution_bits_accept_numpy_float_solution():
    x = np.asarray([1.0, 0.0, 1.0], dtype=np.float64)
    s = BoundPool._encode(1, np.float64(2.0), np.float64(1.0), 0, 0, x)
    *_, sol = BoundPool._decode(s)
    np.testing.assert_array_equal(sol[:3], x)


def test_decode_raises_on_corrupt_value():
    with pytest.raises(ValueError):
        BoundPool._decode("1,np.float64(429.0),417.5,0,0,")


def _mk_pool(store=None):
    """A two-process pool with the process group's store stubbed out."""
    pool = BoundPool.__new__(BoundPool)
    pool.n_processes = 2
    pool.pid = 0
    pool._seq = 0
    pool._peer_cache = {}
    pool._ns = "test_ns/"
    pool._store = store
    return pool


def test_fold_peer_is_monotone_in_seq():
    pool = _mk_pool()
    pool._fold_peer(1, (5, 420.0, 410.0, False, False, None))
    # an out-of-order (stale) read must not overwrite the newer row
    pool._fold_peer(1, (3, 500.0, 300.0, True, False, None))
    assert pool._peer_cache[1][0] == 5 and pool._peer_cache[1][1] == 420.0
    # a newer row does
    pool._fold_peer(1, (6, 415.0, 410.0, False, True, None))
    assert pool._peer_cache[1][0] == 6 and pool._peer_cache[1][4] is True
    # a miss (None) leaves the cache untouched
    pool._fold_peer(1, None)
    assert pool._peer_cache[1][0] == 6


class _Store:
    """The part of a c10d store the pool reads: check and get."""

    def __init__(self, values=None, error=None):
        self.values = values or {}
        self.error = error

    def check(self, keys):
        if self.error:
            raise self.error
        return all(k in self.values for k in keys)

    def get(self, key):
        return self.values[key].encode()


def test_read_peer_reraises_non_miss_errors():
    """A store failure raises; only a missing key means "not published
    yet"; a value that exists but does not parse raises too."""
    with pytest.raises(RuntimeError):
        _mk_pool(_Store(error=RuntimeError("Socket Timeout")))._read_peer(1)
    assert _mk_pool(_Store())._read_peer(1) is None
    row = BoundPool._encode(4, 430.0, 420.0, True, False, None)
    assert _mk_pool(_Store({"1": row}))._read_peer(1)[:5] == (4, 430.0, 420.0, True, False)
    with pytest.raises(ValueError):
        _mk_pool(_Store({"1": "4,np.float64(430.0),420.0,1,0,"}))._read_peer(1)


def test_single_process_sync_casts_numpy():
    assert initialize_distributed() == 1
    pool = BoundPool()
    assert pool.n_processes == 1 and pool._store is None
    out = pool.sync(np.float64(429.0), np.float64(417.0), np.bool_(False))
    assert isinstance(out, PooledBounds)
    assert isinstance(out.incumbent, float) and out.incumbent == 429.0
    assert isinstance(out.stop, bool)
    assert pool.finalize(429.0, 417.0, True).incumbent == 429.0


@pytest.mark.parametrize(
    "row",
    [
        (3, np.float64(429.0), np.float32(417.5), np.bool_(True), 0, None),
        (7, 429.0000001234567, -np.inf, False, True, np.asarray([1.0, 0.0, 1.0] * 13)),
        (1, np.inf, 12.25, 0, 1, np.zeros(8)),
    ],
)
def test_encode_equals_jax_package(row):
    assert BoundPool._encode(*row) == JBoundPool._encode(*row)
