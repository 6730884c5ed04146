"""Package hygiene of the PyTorch port: it imports without JAX, no source
under it imports JAX or the JAX package, importing it builds nothing, and
chip_smoke.py refuses to run without a CUDA card or outside a checkout."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "sypha_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sypha_tpu")


def _run(code, cwd=ROOT, timeout=120):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True, timeout=timeout
    )


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, pkgutil, importlib, sypha_tpu_torch\n"
        "for m in pkgutil.walk_packages(sypha_tpu_torch.__path__, 'sypha_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from sypha_tpu_torch.ops._build import load_library\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'sypha_tpu'))\n"
        "print('LOADED', bad, load_library.cache_info().currsize)\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED [] 0" in proc.stdout, proc.stdout


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_import_in_port_sources(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_chip_smoke_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card; the smoke run itself covers it")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_no_entry_point_picks_the_cpu_by_itself():
    """Where a device is not given, the port uses ``cuda``; no source chooses
    the CPU because the card is missing."""
    for path in sorted(PORT.rglob("*.py")):
        assert "is_available() else" not in path.read_text(), path


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device exists")


def _tiny_model():
    from sypha_tpu_torch.io.scp_reader import parse_scp_text

    return parse_scp_text("3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n")


def test_resolve_device():
    from sypha_tpu_torch.core.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


@pytest.fixture
def cpu_forbidden(monkeypatch):
    """Make the first step of each solve route raise if it is reached, so a
    test can show that a missing card stops the route before any work."""
    import sypha_tpu_torch.api as api
    import sypha_tpu_torch.io.standard_form as sf
    import sypha_tpu_torch.milp.bnb as bnb

    def ran(*a, **kw):
        raise AssertionError("ran on the CPU")

    monkeypatch.setattr(sf, "scp_standard_form", ran)
    monkeypatch.setattr(bnb, "_branch_and_bound", ran)
    monkeypatch.setattr(api.Solver, "_build_standard_form", ran)


@pytest.mark.parametrize(
    "entry",
    ["resolve_device", "pad_lp", "pad_standard_form", "pad_standard_form_ell", "ell_from_rows",
     "ell_from_dense", "make_shared_batch_sparse", "make_shared_batch_auto", "branch_and_bound",
     "Solver", "make_mesh", "solve_shared_batch_sharded", "solve_lp_batch_sharded",
     "solve_node_batch_sharded", "initialize_distributed", "graft_entry"],
)
def test_entry_point_without_a_card_raises(no_card, cpu_forbidden, entry):
    import numpy as np

    import sypha_tpu_torch.io.standard_form as sf
    from sypha_tpu_torch import api, config
    from sypha_tpu_torch.core.device import resolve_device
    from sypha_tpu_torch.ipm import shared
    from sypha_tpu_torch.milp.bnb import branch_and_bound
    from sypha_tpu_torch.ops import ell
    from sypha_tpu_torch.parallel import distributed, mesh
    from sypha_tpu_torch import graft_entry

    model = _tiny_model()
    rows = [(np.asarray(r, np.int32), np.ones(len(r))) for r in model.rows]
    cpu_lp = sf.pad_standard_form(np.eye(2), np.ones(2), np.ones(2), n_struct=2, device="cpu")
    calls = {
        "resolve_device": lambda: resolve_device(),
        "pad_lp": lambda: sf.pad_lp(model),
        "pad_standard_form": lambda: sf.pad_standard_form(np.eye(2), np.ones(2), np.ones(2), n_struct=2),
        "pad_standard_form_ell": lambda: sf.pad_standard_form_ell(
            rows, np.ones(3), model.costs, n_struct=4, m_pad=8, n_pad=128),
        "ell_from_rows": lambda: ell.ell_from_rows(rows, n_struct=4, m_pad=8, n_pad=128),
        "ell_from_dense": lambda: ell.ell_from_dense(np.eye(3)),
        "make_shared_batch_sparse": lambda: shared.make_shared_batch_sparse(model, 2),
        "make_shared_batch_auto": lambda: shared.make_shared_batch_auto(model, 2),
        "branch_and_bound": lambda: branch_and_bound(model, config.SolverConfig(verbosity=0)),
        "Solver": lambda: api.Solver().Solve(),
        "make_mesh": lambda: mesh.make_mesh(2),
        "solve_shared_batch_sharded": lambda: mesh.solve_shared_batch_sharded(
            shared.make_shared_batch(cpu_lp, 2)),
        "solve_lp_batch_sharded": lambda: mesh.solve_lp_batch_sharded(sf.stack_lps([cpu_lp] * 2)),
        "solve_node_batch_sharded": lambda: mesh.solve_node_batch_sharded(
            cpu_lp, np.zeros((2, cpu_lp.n_pad)), np.zeros((2, cpu_lp.n_pad)),
            config.IpmOptions(), mesh.make_mesh(2)),
        "initialize_distributed": lambda: distributed.initialize_distributed(
            "file:///nonexistent/rendezvous", 2, 0, backend="gloo"),
        "graft_entry": lambda: graft_entry.entry(),
    }
    with pytest.raises(RuntimeError, match="no CUDA device.*device=\"cpu\""):
        calls[entry]()


def test_cli_without_a_card_fails_before_solving(no_card, cpu_forbidden, tmp_path, capsys):
    from sypha_tpu_torch import cli

    path = tmp_path / "tiny.txt"
    path.write_text("3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n")
    assert cli.main(["--input-file", str(path)]) != 0
    out, err = capsys.readouterr()
    assert "PRIMAL:" not in out
    assert "no CUDA device" in err and "--device cpu" in err
