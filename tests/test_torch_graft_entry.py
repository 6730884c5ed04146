"""The port's graft entry points (sypha_tpu_torch.graft_entry) against the
JAX package's __graft_entry__: ``entry()`` on the same tiny batch, and the
multi-device dry run on CPU shards, its tensor-parallel legs on two spawned
gloo ranks."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from sypha_tpu_torch import graft_entry
from sypha_tpu_torch.core.status import IpmStatus


@pytest.fixture(autouse=True)
def _two_intra_op_threads():
    """Each shard thread opens an intra-op team of its own: cap the teams so
    that these sharded solves do not oversubscribe the cores that the other
    test workers share (the results hold at any thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_entry_matches_jax():
    fn, args = graft_entry.entry(device="cpu")
    x, status, gap = fn(*args)
    jfn, jargs = jentry.entry()
    jx, jstatus, jgap = jfn(*jargs)
    assert status.tolist() == np.asarray(jstatus).tolist() == [IpmStatus.CONVERGED] * 4
    c = args[0].c.numpy()
    np.testing.assert_allclose(
        np.einsum("bn,bn->b", c, x.numpy()), np.einsum("bn,bn->b", c, np.asarray(jx)), rtol=1e-8
    )
    assert gap.max().item() < 1e-8 and np.asarray(jgap).max() < 1e-8


def test_dryrun_multichip_on_cpu_shards(capsys):
    graft_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "shared-A node window: 4/4 lanes converged" in out
    assert "per-lane batch: 4/4 lanes converged" in out
    assert "tensor-parallel (dense): 2/2 lanes converged" in out
    assert "tensor-parallel (ell): 2/2 lanes converged" in out
    assert "mesh B&B syn_scp4x_0: OPTIMAL obj=460" in out
