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
