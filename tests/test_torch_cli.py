"""The port's CLI (sypha_tpu_torch.cli) against the JAX package's on the CPU:
the same flags plus ``--device``, the same config, the same output lines and
numbers, run in process with ``--device cpu``."""

import contextlib
import dataclasses
import io
import pathlib
import subprocess
import sys

import pytest

from sypha_tpu import cli as jcli
from sypha_tpu_torch import cli as tcli

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = "3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n"


def _flags(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_flags_are_the_jax_flags_plus_device():
    assert _flags(tcli.build_parser()) == _flags(jcli.build_parser()) | {"--device"}
    jdefaults = vars(jcli.build_parser().parse_args([]))
    tdefaults = vars(tcli.build_parser().parse_args([]))
    assert tdefaults.pop("device") == "cuda"
    assert tdefaults == jdefaults


@pytest.mark.parametrize(
    "argv",
    [[], ["--bnb-var-select", "highest_cost_fractional", "--time-limit", "7", "--tol", "1e-7",
          "--bnb-device-queue", "500", "--bnb-cuts", "0", "--bnb-warm-start-nodes", "1"]],
    ids=["defaults", "flags"],
)
def test_config_from_args_matches_jax(argv):
    tcfg = tcli.config_from_args(tcli.build_parser().parse_args(argv))
    jcfg = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().splitlines()
    return rc, {l.split(":")[0]: l.split(":", 1)[1].strip() for l in lines if ":" in l and l[:1].isupper()}


@pytest.mark.parametrize("instance", ["tiny", "demo_small"])
@pytest.mark.parametrize("mode", ["lp", "milp"])
def test_cli_matches_jax(tmp_path, instance, mode):
    path = tmp_path / "tiny.txt"
    path.write_text(TINY)
    f = str(path) if instance == "tiny" else str(ROOT / "data" / "demo_small.txt")
    argv = ["--model", "SCP", "--input-file", f, "--verbosity", "0", "--show-solution"]
    if mode == "lp":
        argv.append("--disable-bnb")
    rc, out = _run(tcli.main, argv + ["--device", "cpu"])
    jrc, jout = _run(jcli.main, argv)
    assert rc == jrc == 0
    for key in ("PRIMAL", "DUAL"):
        t, j = float(out[key]), float(jout[key])
        assert abs(t - j) <= 1e-8 * max(1.0, abs(j)), (key, t, j)
    if mode == "lp":
        assert out["ITERATIONS"] == jout["ITERATIONS"]
    assert int(out["ITERATIONS"]) >= 0
    for key in ("TIME START SOL", "TIME PRE SOL", "TIME SOLVER", "TIME COMPILE"):
        assert float(out[key]) >= 0.0, key
    selected = [k for k in out if k.startswith("SELECTED COLUMNS")]
    assert selected
    if mode == "milp":
        assert out[selected[0]] == jout[[k for k in jout if k.startswith("SELECTED COLUMNS")][0]]


def test_cli_missing_input_file():
    assert tcli.main(["--model", "SCP"]) == -1
    assert tcli.main(["--model", "LP", "--input-file", "x.txt"]) == -1


def test_cli_unreadable_input_file(tmp_path):
    assert tcli.main(["--input-file", str(tmp_path / "absent.txt"), "--device", "cpu", "--verbosity", "0"]) == 1


def test_cli_mesh_is_not_ported(tmp_path):
    """The mesh is ported (the name dates from before): --bnb-mesh-devices 2
    on --device cpu lane-shards the windows over two CPU shards and prints
    the JAX CLI's mesh run's PRIMAL."""
    path = tmp_path / "tiny.txt"
    path.write_text(TINY)
    argv = ["--input-file", str(path), "--verbosity", "0", "--bnb-mesh-devices", "2"]
    rc, out = _run(tcli.main, argv + ["--device", "cpu"])
    jrc, jout = _run(jcli.main, argv)
    assert rc == jrc == 0
    assert float(out["PRIMAL"]) == float(jout["PRIMAL"])


def test_cli_profile_dir_writes_a_trace(tmp_path):
    path = tmp_path / "tiny.txt"
    path.write_text(TINY)
    trace = tmp_path / "trace"
    rc, out = _run(tcli.main, ["--input-file", str(path), "--device", "cpu", "--verbosity", "0",
                               "--disable-bnb", "--profile-dir", str(trace)])
    assert rc == 0 and "PRIMAL" in out
    assert list(trace.iterdir()), "no trace file written"


def test_module_help_runs():
    proc = subprocess.run(
        [sys.executable, "-m", "sypha_tpu_torch", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--input-file" in proc.stdout
    assert "GPU" in proc.stdout and "TPU" not in proc.stdout
