"""Reader, standard form and padding of the PyTorch port against the JAX
package, on the demo files and on seeded synthetic instances: exact equality."""

import pathlib

import numpy as np
import pytest
import torch

import sypha_tpu.io.scp_reader as jreader
import sypha_tpu.io.standard_form as jsf
import sypha_tpu_torch.io.scp_reader as treader
import sypha_tpu_torch.io.standard_form as tsf
from sypha_tpu_torch.testing import synthetic_scp

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
TINY = "3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n"

TEXTS = {
    "tiny": lambda: TINY,
    "demo_tiny": lambda: (DATA / "demo_tiny.txt").read_text(),
    "demo_small": lambda: (DATA / "demo_small.txt").read_text(),
    "syn24x120": lambda: synthetic_scp(24, 120, 0.1, 3),
    "syn40x200": lambda: synthetic_scp(40, 200, 0.1, 4),
    "syn200x1000": lambda: synthetic_scp(200, 1000, 0.02, 0),
}


def _same_model(jm, tm):
    assert (tm.nrows, tm.ncols, tm.name) == (jm.nrows, jm.ncols, jm.name)
    np.testing.assert_array_equal(tm.costs, jm.costs)
    assert tm.costs.dtype == jm.costs.dtype
    assert len(tm.rows) == len(jm.rows)
    for tr, jr in zip(tm.rows, jm.rows):
        np.testing.assert_array_equal(tr, jr)
        assert tr.dtype == jr.dtype


def _same_lp(jlp, tlp):
    for f in ("A", "b", "c", "row_pad", "m_real", "n_real", "n_struct"):
        j = np.asarray(getattr(jlp, f))
        t = getattr(tlp, f)
        assert isinstance(t, torch.Tensor)
        assert t.numpy().dtype == j.dtype, f
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_parse_scp_text_matches_jax(name):
    text = TEXTS[name]()
    _same_model(jreader.parse_scp_text(text, name=name), treader.parse_scp_text(text, name=name))


@pytest.mark.parametrize("fname", ["demo_tiny.txt", "demo_small.txt"])
def test_read_scp_file_matches_jax(fname):
    path = str(DATA / fname)
    _same_model(jreader.read_scp_file(path), treader.read_scp_file(path))


def test_parse_errors_match():
    for bad in ("", "2 3\n1 2 3\n", "1 2\n1 1\n1 3\n", "0 2\n"):
        with pytest.raises(ValueError):
            treader.parse_scp_text(bad)
        with pytest.raises(ValueError):
            jreader.parse_scp_text(bad)


@pytest.mark.parametrize("name", sorted(TEXTS))
@pytest.mark.parametrize("pad", [{}, {"extra_rows": 5}, {"m_pad": 256, "n_pad": 1536}])
def test_pad_lp_matches_jax(name, pad):
    text = TEXTS[name]()
    tm = treader.parse_scp_text(text)
    if "m_pad" in pad and tm.nrows > pad["m_pad"]:
        pytest.skip("instance larger than the fixed bucket")
    jlp = jsf.pad_lp(jreader.parse_scp_text(text), **pad)
    tlp = tsf.pad_lp(tm, **pad, device="cpu")
    assert tlp.A.device.type == "cpu"
    _same_lp(jlp, tlp)


def test_pad_lp_too_small_raises():
    tm = treader.parse_scp_text(TINY)
    with pytest.raises(ValueError):
        tsf.pad_lp(tm, m_pad=2, device="cpu")


def test_stack_lps_matches_jax():
    texts = [TINY, (DATA / "demo_small.txt").read_text()]
    jlps = [jsf.pad_lp(jreader.parse_scp_text(t), m_pad=8, n_pad=128) for t in texts]
    tlps = [tsf.pad_lp(treader.parse_scp_text(t), m_pad=8, n_pad=128, device="cpu") for t in texts]
    _same_lp(jsf.stack_lps(jlps), tsf.stack_lps(tlps))
    assert tsf.stack_lps(tlps).batch_shape == (2,)
    with pytest.raises(ValueError):
        tsf.stack_lps([tlps[0], tsf.pad_lp(treader.parse_scp_text(TINY), m_pad=16, device="cpu")])


@pytest.mark.parametrize(
    "m,n,extra", [(3, 7, 0), (8, 128, 0), (9, 129, 0), (200, 1200, 0), (500, 5500, 0), (40, 240, 17)]
)
def test_bucket_dims_matches_jax(m, n, extra):
    assert tsf.bucket_dims(m, n, extra_rows=extra) == jsf.bucket_dims(m, n, extra_rows=extra)


def test_scp_standard_form_matches_jax():
    text = synthetic_scp(24, 120, 0.1, 3)
    for jarr, tarr in zip(
        jsf.scp_standard_form(jreader.parse_scp_text(text)),
        tsf.scp_standard_form(treader.parse_scp_text(text)),
    ):
        np.testing.assert_array_equal(tarr, jarr)


@pytest.mark.parametrize(
    "nrows,ncols,density,seed", [(24, 120, 0.1, 3), (200, 1000, 0.02, 0), (50, 60, 0.001, 9)]
)
def test_synthetic_scp_follows_orlib_generator(nrows, ncols, density, seed):
    text = synthetic_scp(nrows, ncols, density, seed)
    assert text == synthetic_scp(nrows, ncols, density, seed)
    assert text != synthetic_scp(nrows, ncols, density, seed + 1)
    model = treader.parse_scp_text(text)
    assert (model.nrows, model.ncols) == (nrows, ncols)
    cover = model.dense_matrix()
    assert np.all(cover.sum(axis=0) >= 1), "every column covers a row"
    assert np.all(cover.sum(axis=1) >= 2), "every row is covered twice"
    assert np.all((model.costs >= 1) & (model.costs <= 100))
    assert np.all(model.costs == np.round(model.costs))
    # the repairs add few entries beyond the sampled density
    assert cover.mean() <= density + 2.0 / ncols + 1.0 / nrows


@pytest.mark.parametrize("name", ["tiny", "demo_small", "syn24x120"])
def test_orlib_round_trip_matches_jax(tmp_path, name):
    import sypha_tpu.io.orlib as jorlib
    import sypha_tpu_torch.io.orlib as torlib

    path = tmp_path / f"{name}.txt"
    path.write_text(TEXTS[name]())
    parsed = torlib.parse_scp_file(str(path))
    assert parsed == jorlib.parse_scp_file(str(path))
    _same_model(jorlib.orlib_to_model(parsed, name=name), torlib.orlib_to_model(parsed, name=name))
    _same_model(treader.read_scp_file(str(path)), torlib.orlib_to_model(parsed, name=path.stem))


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_debug_printers_match_jax(kind):
    import io

    import sypha_tpu.utils.debug as jdebug
    import sypha_tpu_torch.utils.debug as tdebug

    rng = np.random.default_rng(5)
    M = rng.normal(size=(20, 18))
    M[0, :3] = [1e-21, -1e-25, 0.0]  # under the zero clamp
    v = np.concatenate([[1e-30, -2e-21], rng.normal(size=40)])
    arg = (lambda a: a) if kind == "numpy" else torch.from_numpy
    for printer, data, kw in (
        ("print_mat", M, {"name": "M"}),
        ("print_mat", M[:4, :5], {}),
        ("print_vec", v, {"name": "v"}),
        ("print_vec", v[:5], {}),
    ):
        t, j = io.StringIO(), io.StringIO()
        getattr(tdebug, printer)(arg(data), file=t, **kw)
        getattr(jdebug, printer)(data, file=j, **kw)
        assert t.getvalue() == j.getvalue(), printer
    # the values under the clamp print as 0
    out = io.StringIO()
    tdebug.print_vec(arg(v[:3]), file=out)
    assert out.getvalue().split()[:2] == ["0", "0"]
