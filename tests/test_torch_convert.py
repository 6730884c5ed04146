"""State carried between the JAX package and the PyTorch port through numpy:
the round trip is exact, and the port resumes a JAX solve to the JAX result."""

import numpy as np
import pytest
import torch

import sypha_tpu.config as jconfig
import sypha_tpu.io.scp_reader as jreader
import sypha_tpu.io.standard_form as jsf
from sypha_tpu.ipm import shared as jshared
import sypha_tpu_torch.config as tconfig
from sypha_tpu_torch.convert import from_numpy, to_numpy
from sypha_tpu_torch.core.problem import PaddedLp
from sypha_tpu_torch.ipm.shared import IpmState, SharedLpBatch, mehrotra_solve_shared
from sypha_tpu_torch.testing import synthetic_scp

TEXT = synthetic_scp(40, 200, 0.1, 4)


@pytest.fixture(scope="module")
def jax_objects():
    lp = jsf.pad_lp(jreader.parse_scp_text(TEXT))
    batch = jshared.make_shared_batch(lp, 3)
    mid = jshared.mehrotra_solve_shared(batch, jconfig.IpmOptions(), iter_limit=4)
    full = jshared.mehrotra_solve_shared(batch, jconfig.IpmOptions())
    return lp, batch, mid, full


@pytest.mark.parametrize("which,cls", [(0, PaddedLp), (1, SharedLpBatch), (2, IpmState)])
def test_round_trip_is_exact(jax_objects, which, cls):
    arrays = to_numpy(jax_objects[which])
    obj = from_numpy(cls, arrays, device="cpu")
    back = to_numpy(obj)
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype, k
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert isinstance(getattr(obj, k), torch.Tensor)


def test_from_numpy_names_missing_fields():
    with pytest.raises(KeyError, match="status"):
        from_numpy(IpmState, {"x": np.zeros((1, 2))})


def test_port_resumes_jax_state(jax_objects):
    _, jbatch, jmid, jfull = jax_objects
    batch = from_numpy(SharedLpBatch, to_numpy(jbatch))
    state0 = from_numpy(IpmState, to_numpy(jmid))
    opts = tconfig.IpmOptions()
    st = mehrotra_solve_shared(batch, opts, state0=state0, iter_limit=opts.max_iter)
    np.testing.assert_array_equal(st.status.numpy(), np.asarray(jfull.status))
    assert np.abs(st.iterations.numpy() - np.asarray(jfull.iterations)).max() <= 1
    c = np.asarray(jbatch.c)
    np.testing.assert_allclose(
        np.einsum("bn,bn->b", c, st.x.numpy()),
        np.einsum("bn,bn->b", c, np.asarray(jfull.x)),
        rtol=1e-8,
    )
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jfull.x), rtol=0, atol=1e-6)
