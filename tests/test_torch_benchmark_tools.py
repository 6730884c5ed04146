"""The port's sweep and study tools (sypha_tpu_torch.benchmark) against the
JAX package's benchmark/ scripts on the CPU, and the port's native module's
two tuning switches (SYPHA_TPU_DUMP_FACES, SYPHA_TPU_NATIVE_LIB) against
the JAX package's.

The instances are seeded ``synthetic_scp`` ones of 36 rows x 180 columns,
written under OR-Library names (scp41.txt, ...) into a temporary directory:
the JAX tools read it through their module-level DATA_DIR, the port's
through ``--data-dir``.  The JAX tools run in process with ``sys.argv`` set,
the port's through ``main(argv)`` with ``--device cpu``.
"""

import contextlib
import csv
import io
import json
import os
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

from sypha_tpu_torch import native as tnative
from sypha_tpu_torch import benchmark as tbench
from sypha_tpu_torch.benchmark import ell_vs_dense as ted
from sypha_tpu_torch.benchmark import face_make as tfm
from sypha_tpu_torch.benchmark import face_replay as tfr
from sypha_tpu_torch.benchmark import lp_parity as tlp
from sypha_tpu_torch.benchmark import root_cut_study as trc
from sypha_tpu_torch.benchmark import run_benchmark as trb
from sypha_tpu_torch.benchmark import tune_exact_cover as tte
from sypha_tpu_torch.testing import synthetic_scp

ROOT = pathlib.Path(__file__).resolve().parent.parent

# name -> synthetic_scp(36, 180, density, seed), each with a root gap (LP
# 174.5 < 175, 250.33 < 254, 290 < 297, 182.66 < 188).  The cut study's
# parity instances are ones whose cuts per round do not hang on the last
# bits of the LP point; test_root_cut_study_on_a_degenerate_optimum holds
# one where they do.
INSTANCES = {
    "scp41": (0.06, 5),
    "scp42": (0.06, 7),
    "scp43": (0.06, 11),
    "scpnre1": (0.06, 3),
}
TIMES = ("time_pre_s", "time_solver_s", "time_compile_s", "time_total_s")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("orlib")
    for name, (density, seed) in INSTANCES.items():
        (d / f"{name}.txt").write_text(synthetic_scp(36, 180, density, seed))
    return d


@pytest.fixture(scope="module")
def jax_tools(data_dir):
    """The JAX package's benchmark scripts, reading ``data_dir``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT))
        import benchmark.ell_vs_dense as jed
        import benchmark.face_make as jfm
        import benchmark.lp_parity as jlp
        import benchmark.root_cut_study as jrc
        import benchmark.run_benchmark as jrb

        for mod in (jrb, jlp, jed):
            mp.setattr(mod, "DATA_DIR", str(data_dir))
        yield {"run_benchmark": jrb, "lp_parity": jlp, "ell_vs_dense": jed, "root_cut_study": jrc,
               "face_make": jfm}


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _jax(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main()
    return rc, buf.getvalue()


def _port(mod, argv):
    """The port's tool in process, on one intra-op thread: beside the other
    test workers a full team of threads per worker runs many times slower."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), _one_thread():
        rc = mod.main(argv)
    return rc, buf.getvalue()


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _close(a, b, rel):
    a, b = float(a), float(b)
    return abs(a - b) <= rel * max(1.0, abs(b))


def test_run_benchmark_lp_rows_match_jax(jax_tools, data_dir, tmp_path, monkeypatch):
    argv = ["--lp-only", "--families", "scp4,scpnre"]
    jrc, _ = _jax(jax_tools["run_benchmark"], argv + ["--out", str(tmp_path / "jax")], monkeypatch)
    rc, out = _port(trb, argv + ["--out", str(tmp_path / "port"), "--device", "cpu", "--data-dir", str(data_dir)])
    assert jrc is None and rc == 0
    name = "sypha_tpu_lp_scp4_scpnre_results.csv"
    jrows, rows = _rows(tmp_path / "jax" / name), _rows(tmp_path / "port" / name)
    assert [r["instance"] for r in rows] == ["scp41.txt", "scp42.txt", "scp43.txt", "scpnre1.txt"]
    assert list(rows[0]) == list(jrows[0]) == trb.FIELDS
    for r, j in zip(rows, jrows, strict=True):
        for key in trb.FIELDS:
            if key in ("primal", "dual"):
                assert _close(r[key], j[key], 1e-8), (r["instance"], key, r[key], j[key])
            elif key in TIMES:
                assert float(r[key]) >= 0.0
            else:
                assert r[key] == j[key], (r["instance"], key)
    assert "synthetic" not in out


def test_run_benchmark_milp_row_matches_jax(jax_tools, data_dir, tmp_path, monkeypatch):
    argv = ["--families", "scp4", "--instances", "scp41", "--no-warmup", "--time-limit", "60"]
    jrc, _ = _jax(jax_tools["run_benchmark"], argv + ["--out", str(tmp_path / "jax")], monkeypatch)
    rc, _ = _port(trb, argv + ["--out", str(tmp_path / "port"), "--device", "cpu", "--data-dir", str(data_dir)])
    assert jrc is None and rc == 0
    name = "sypha_tpu_milp_scp4_results.csv"
    (j,), (r,) = _rows(tmp_path / "jax" / name), _rows(tmp_path / "port" / name)
    assert r["instance"] == j["instance"] == "scp41.txt"
    assert r["status"] == j["status"] == "OPTIMAL"
    assert float(r["primal"]) == float(j["primal"]) == float(r["incumbent"]) == 175.0
    assert _close(r["dual"], j["dual"], 1e-6) and float(r["dual"]) <= float(r["primal"])
    assert float(r["time_compile_s"]) > 0.0
    assert all(float(r[k]) >= 0.0 for k in TIMES)


def test_lp_parity_verdicts_match_jax(jax_tools, data_dir, tmp_path, monkeypatch):
    argv = ["--scipy", "--families", "scp4,scpnre"]
    jrc, jout = _jax(jax_tools["lp_parity"], argv + ["--csv-dir", str(tmp_path / "jax")], monkeypatch)
    rc, out = _port(tlp, argv + ["--csv-dir", str(tmp_path / "port"), "--device", "cpu", "--data-dir", str(data_dir)])
    assert rc == jrc == 0

    def verdicts(text):
        return [(ln.split()[0], ln.split()[-1]) for ln in text.splitlines() if ln.endswith(("PASS", "FAIL"))]

    assert verdicts(out) == verdicts(jout) and len(verdicts(out)) == 4
    assert out.splitlines()[-1] == jout.splitlines()[-1] == "4/4 passed"
    for fam in ("scp4", "scpnre"):
        name = f"{fam}_sypha_tpu_lp_results.csv"
        jrows, rows = _rows(tmp_path / "jax" / name), _rows(tmp_path / "port" / name)
        assert list(rows[0]) == list(jrows[0])
        for r, j in zip(rows, jrows, strict=True):
            assert (r["instance"], r["exit_code"], r["status"], r["sypha_iterations"]) == (
                j["instance"], j["exit_code"], j["status"], j["sypha_iterations"])
            assert _close(r["sypha_primal"], j["sypha_primal"], 1e-8)


def test_lp_parity_synthetic_needs_scipy(capsys):
    with pytest.raises(SystemExit) as exc:
        tlp.main(["--synthetic", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--synthetic needs --scipy" in capsys.readouterr().err


def test_ell_vs_dense_matches_jax(jax_tools, data_dir, tmp_path, monkeypatch):
    argv = ["--lanes", "4", "--instances", "scpnre1"]
    jrc, _ = _jax(jax_tools["ell_vs_dense"], argv + ["--out", str(tmp_path / "jax")], monkeypatch)
    rc, out = _port(ted, argv + ["--out", str(tmp_path / "port"), "--device", "cpu", "--data-dir", str(data_dir)])
    assert jrc is None and rc == 0
    jrows, rows = _rows(tmp_path / "jax" / "ell_vs_dense.csv"), _rows(tmp_path / "port" / "ell_vs_dense.csv")
    assert list(rows[0]) == list(jrows[0])
    for r, j in zip(rows, jrows, strict=True):
        for key in ("instance", "lanes", "strategy", "ell_mb", "dense_mb", "mem_ratio", "dense_conv", "sparse_conv"):
            assert r[key] == j[key], (r["instance"], key, r[key], j[key])
        for key in ("dense_obj", "sparse_obj"):
            assert _close(r[key], j[key], 1e-8), (r["instance"], key, r[key], j[key])
    records = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [rec["instance"] for rec in records] == ["scpnre1"]
    for rec in records:
        # the CPU path never launches the Gram kernel
        assert rec["dense_gram_launches"] == rec["sparse_gram_launches"] == 0
        assert rec["lanes_flipped"] == 0 and rec["max_rel_diff_converged"] <= 1e-8


def _round_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("name", ["scpnre1", "scp43"])
def test_root_cut_study_matches_jax(jax_tools, data_dir, monkeypatch, name):
    path = str(data_dir / f"{name}.txt")
    _, jout = _jax(jax_tools["root_cut_study"], [path, "--rounds", "2"], monkeypatch)
    rc, out = _port(trc, [path, "--rounds", "2", "--device", "cpu"])
    assert rc == 0
    jlines, lines = _round_lines(jout), _round_lines(out)
    assert [sorted(ln) for ln in lines] == [sorted(ln) for ln in jlines]
    assert lines[1]["separated"] > 0 and len(lines) >= 3
    for ln, jl in zip(lines, jlines, strict=True):
        if "dual" in ln:
            assert (ln["round"], ln["status"], ln["cuts_total"]) == (jl["round"], jl["status"], jl["cuts_total"])
            assert _close(ln["dual"], jl["dual"], 1e-6) and _close(ln["pobj"], jl["pobj"], 1e-6)
        else:
            assert (ln["round"], ln["separated"], ln["room"]) == (jl["round"], jl["separated"], jl["room"])



def test_root_cut_study_on_a_degenerate_optimum(jax_tools, tmp_path, monkeypatch):
    """synthetic_scp(36, 180, 0.12, seed=2) has a degenerate LP optimum, where
    the cuts separated hang on the last bits of the LP point, and those on the
    CPU's intra-op thread count: the port separates 20 cuts in round 0 at
    eight threads, against the JAX package's 14.  At one thread (``_port``)
    round 0 is JAX's, and the dual bound of every round agrees within 1e-6
    (round 1 separates 2 cuts against JAX's 5; both end at 59)."""
    path = tmp_path / "scp44.txt"
    path.write_text(synthetic_scp(36, 180, 0.12, 2))
    _, jout = _jax(jax_tools["root_cut_study"], [str(path), "--rounds", "2"], monkeypatch)
    rc, out = _port(trc, [str(path), "--rounds", "2", "--device", "cpu"])
    assert rc == 0
    jlines, lines = _round_lines(jout), _round_lines(out)
    assert lines[1]["separated"] == jlines[1]["separated"] == 14
    assert lines[2]["cuts_total"] == jlines[2]["cuts_total"] == 14
    duals = [ln["dual"] for ln in lines if "dual" in ln]
    jduals = [ln["dual"] for ln in jlines if "dual" in ln]
    assert len(duals) == len(jduals) == 3
    for d, jd in zip(duals, jduals):
        assert _close(d, jd, 1e-6), (duals, jduals)


def _face_inputs(data_dir):
    """(LP duals, budget = the LP bound rounded up, two cut rows) for scpnre1."""
    from scipy.optimize import linprog

    from sypha_tpu_torch.io.scp_reader import read_scp_file

    model = read_scp_file(str(data_dir / "scpnre1.txt"))
    A = model.dense_matrix()
    lp = linprog(model.costs, A_ub=-A, b_ub=-np.ones(model.nrows), bounds=(0, None), method="highs")
    y = -lp.ineqlin.marginals
    coef = np.zeros((2, model.ncols))
    coef[0, :20] = 1.0
    coef[1, 40:70] = 1.0
    return y, float(np.ceil(lp.fun)), (np.array([0.25, 0.5]), coef, np.array([1.0, 2.0]))


@pytest.fixture(scope="module")
def both_libs():
    from sypha_tpu import native as jnative

    if tnative.get_lib() is None:
        pytest.fail("the native library did not build from csrc/sypha_host.cpp")
    if jnative.get_lib() is None:
        pytest.skip("the JAX package's native library is unavailable")
    return jnative


@pytest.mark.parametrize("with_cuts", [False, True], ids=["plain", "cuts"])
def test_dumped_faces_equal_jax(both_libs, data_dir, tmp_path, monkeypatch, with_cuts):
    from sypha_tpu.io.scp_reader import read_scp_file as jread
    from sypha_tpu.milp.base_model import BaseModel as JBase

    from sypha_tpu_torch.io.scp_reader import read_scp_file as tread
    from sypha_tpu_torch.milp.base_model import BaseModel as TBase

    jnative = both_libs
    y, budget, cuts = _face_inputs(data_dir)
    path = str(data_dir / "scpnre1.txt")
    faces = {}
    for tag, native, base in (("jax", jnative, JBase(jread(path))), ("port", tnative, TBase(tread(path)))):
        monkeypatch.setenv("SYPHA_TPU_DUMP_FACES", str(tmp_path / tag))
        native.exact_cover(base, budget, 60.0, duals=y, cuts=cuts if with_cuts else None)
        (face,) = (tmp_path / tag).iterdir()
        faces[tag] = np.load(face)
    keys = {"masks", "costs", "active", "col_ptr", "col_idx", "nrows", "nwords", "budget", "deadline", "duals"}
    if with_cuts:
        keys |= {"cut_w", "cut_coef", "cut_rhs"}
    assert set(faces["port"].files) == set(faces["jax"].files) == keys
    for key in keys:
        t, j = faces["port"][key], faces["jax"][key]
        assert t.dtype == j.dtype and t.shape == j.shape, key
        np.testing.assert_array_equal(t, j, err_msg=key)


@pytest.mark.parametrize("budget_shift", [0.0, 10.0], ids=["lp-bound", "loose"])
def test_face_replay_matches_the_in_process_call(data_dir, tmp_path, monkeypatch, budget_shift, capsys):
    from sypha_tpu_torch.io.scp_reader import read_scp_file
    from sypha_tpu_torch.milp.base_model import BaseModel

    y, budget, cuts = _face_inputs(data_dir)
    base = BaseModel(read_scp_file(str(data_dir / "scpnre1.txt")))
    monkeypatch.setenv("SYPHA_TPU_DUMP_FACES", str(tmp_path))
    found, _ = tnative.exact_cover(base, budget + budget_shift, 60.0, duals=y, cuts=cuts)
    monkeypatch.delenv("SYPHA_TPU_DUMP_FACES")
    (face,) = tmp_path.iterdir()
    rc, _ = tfr.replay(str(face))
    assert rc == {True: 1, False: 0, None: -1}[found]
    assert tfr.main([str(face), "--no-cuts"]) == 0
    assert tfr.VERDICTS[rc] in capsys.readouterr().out


def test_native_lib_override_loads_that_path(data_dir, tmp_path, monkeypatch):
    built = tnative.library_path()
    if tnative.get_lib() is None or not built.exists():
        pytest.fail("the native library did not build from csrc/sypha_host.cpp")
    alt = tmp_path / "alt" / "libsypha_host_alt.so"
    alt.parent.mkdir()
    shutil.copy(built, alt)
    monkeypatch.setenv("SYPHA_TPU_NATIVE_LIB", str(alt))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    lib = tnative.get_lib()
    assert lib is not None and lib._name == str(alt)
    # face_replay --lib binds a given build the same way
    y, budget, _ = _face_inputs(data_dir)
    from sypha_tpu_torch.io.scp_reader import read_scp_file
    from sypha_tpu_torch.milp.base_model import BaseModel

    monkeypatch.setenv("SYPHA_TPU_DUMP_FACES", str(tmp_path / "faces"))
    found, _ = tnative.exact_cover(BaseModel(read_scp_file(str(data_dir / "scpnre1.txt"))), budget, 60.0, duals=y)
    (face,) = (tmp_path / "faces").iterdir()
    assert tfr.replay(str(face), lib_path=str(alt))[0] == {True: 1, False: 0, None: -1}[found]



def test_exact_cover_refuses_cuts_without_the_cut_entry(data_dir, monkeypatch):
    """An alternate build without sypha_exact_cover_cuts (SYPHA_TPU_NATIVE_LIB)
    must not search without the cut rows it was given."""
    import types

    from sypha_tpu_torch.io.scp_reader import read_scp_file
    from sypha_tpu_torch.milp.base_model import BaseModel

    y, budget, cuts = _face_inputs(data_dir)
    base = BaseModel(read_scp_file(str(data_dir / "scpnre1.txt")))
    old = types.SimpleNamespace(_name="libsypha_host_old.so", sypha_exact_cover=lambda *a: 0)
    monkeypatch.setattr(tnative, "get_lib", lambda: old)
    with pytest.raises(RuntimeError, match="libsypha_host_old.so has no sypha_exact_cover_cuts"):
        tnative.exact_cover(base, budget, 60.0, duals=y, cuts=cuts)
    assert tnative.exact_cover(base, budget, 60.0, duals=y) == (False, None)


def test_face_make_matches_jax(jax_tools, both_libs, data_dir, tmp_path, monkeypatch):
    jfm = jax_tools["face_make"]
    from sypha_tpu.io.scp_reader import read_scp_file as jread

    monkeypatch.setattr(jfm, "read_scp_file", lambda p: jread(str(data_dir / os.path.basename(p))))
    with contextlib.redirect_stdout(io.StringIO()):
        jbase, jz, jy = jfm.make_face("scpnre1", 188.0, 1)
    out = tmp_path / "face.npz"
    rc, text = _port(tfm, ["scpnre1", "188", str(out), "1", "--data-dir", str(data_dir)])
    assert rc == 0 and "synthetic" not in text
    model = tbench.load(tbench.require_source("scpnre1", str(data_dir), False), "scpnre1")
    tbase, tz, ty = tfm.make_face(model, 188.0, 1)
    assert tz == pytest.approx(jz, rel=1e-9) and len(tbase.cuts) == len(jbase.cuts) > 0
    np.testing.assert_array_equal(tbase.active, jbase.active)
    np.testing.assert_allclose(ty, jy, rtol=1e-7, atol=1e-9)
    face = np.load(out)
    jar = both_libs._arrays(jbase)
    for key in ("masks", "costs", "col_ptr", "col_idx"):
        np.testing.assert_array_equal(face[key], getattr(jar, key), err_msg=key)
    assert int(face["nrows"]) == jar.nrows and face["cut_coef"].shape == (len(jbase.cuts), jbase.ncols)
    assert float(face["budget"]) == np.ceil(jz - 1e-6)


def test_tune_exact_cover_replays_in_a_subprocess(data_dir, tmp_path, capsys):
    face = tmp_path / "face.npz"
    assert _port(tfm, ["scpnre1", "188", str(face), "--data-dir", str(data_dir)])[0] == 0
    rc = tte.main([str(face), "--budget", "187", "--deadline", "30"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "REFUTED" in out or "FOUND" in out, out
    assert "[ec]" in out


def test_synthetic_stand_ins(data_dir, tmp_path, capsys):
    # instance i of a family is synthetic_scp at its class with seed i
    assert tbench.instance_source("scp41", None, True) == (None, synthetic_scp(200, 1000, 0.02, seed=0))
    assert tbench.instance_source("scp43", None, True) == (None, synthetic_scp(200, 1000, 0.02, seed=2))
    assert tbench.instance_source("scp41", None, False) is None
    # a file in the data directory wins; the unicost families have no stand-in
    assert tbench.instance_source("scp41", str(data_dir), True) == (str(data_dir / "scp41.txt"), None)
    assert tbench.family_instances("scpclr", None, True) == []
    assert "[scpclr] skipped scpclr10,scpclr11,scpclr12,scpclr13" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        tbench.require_source("scpcyc06", None, True)
    # scp41's stand-in is chip_smoke's scp4x-class instance: LP optimum 458.5
    rc, out = _port(trb, ["--lp-only", "--families", "scp4", "--instances", "scp41", "--synthetic",
                          "--no-warmup", "--out", str(tmp_path), "--device", "cpu"])
    (row,) = _rows(tmp_path / "sypha_tpu_lp_scp4_results.csv")
    assert rc == 0 and row["instance"] == "synthetic scp41" and row["status"] == "OPTIMAL"
    assert _close(row["primal"], 458.5, 1e-8) and "synthetic scp41: OPTIMAL" in out
