"""Whole runs at a small size on the CPU: the harness's look for a card
skipped, the rest of a run driven.  Sound runs come out correct; the control
and each fault that a cell can have, planted underneath the timed path, come
out not correct.  Without a card the command exits non-zero and prints no
result; on the card (``-m cuda``) a short run of each cell is correct."""

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import faults, harness

ROOT = Path(__file__).resolve().parents[2]
KIND_TRAFFIC = {"node_window": "window64", "bnb": "bnb"}


def run(kind, small, seed=20260001, seconds=0.2, traced=False):
    config, traffic, limits = small
    name = f"small.{KIND_TRAFFIC[kind]}"
    entry = {"name": name, "config": "scp4x", "traffic": KIND_TRAFFIC[kind], "chips": 1}
    res, rows = harness.run_cell(name, seed, seconds, traced, "cpu", t_start=time.perf_counter(),
                                 files=(config, traffic[kind], limits[kind]), entry=entry,
                                 log=lambda m: None)
    return res


@pytest.mark.parametrize("kind", ["node_window", "bnb"])
def test_sound_run_is_correct_and_loads_nothing_foreign(kind, small):
    res = run(kind, small, traced=kind == "node_window")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert harness.foreign_modules() == []


@pytest.mark.parametrize("kind, rule", [("node_window", "claims"), ("node_window", "program"),
                                        ("bnb", "claims")])
def test_control_is_not_correct(kind, rule, small):
    """The control in the program's place at scp4x class, at a size a test
    run holds: the float32 reference for an LP cell, every feasible lane
    claiming its optimum (over 32 lanes, whose largest error passes the
    limit on the CPU as on the card) or under the port's own status rule;
    the unproven root cover for the B&B.  The sound runs are the test
    above."""
    config, traffic, limits = small
    config = dict(config, rows=200, cols=1000, density=0.02)
    traffic = dict(traffic[kind])
    if kind == "bnb":
        config["instances"] = ["scp41", "scp42"]
    if kind == "node_window":
        traffic.update(instances=1, lanes=32, fixing_sets=1)
    cell = harness.kind(kind).setup(config, traffic, 20260002, "cpu")
    if kind == "node_window":
        cell.answers = [(0, 0, None, None, None, None)]
    assert not harness.judge.verdict(cell.control(rule), limits[kind])[1]


@pytest.mark.parametrize("kind, fault", [(k, f) for k, fs in sorted(faults.FAULTS.items()) for f in fs])
def test_planted_fault_is_not_correct(kind, fault, small):
    undo = faults.plant(fault, kind)
    try:
        res = run(kind, small, seed=20260003)
    finally:
        undo()
    assert not res["correct"], res["checks"]


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("sypha_tpu_torch", "sypha_tpu", "jax", "jaxlib", "flax"), (path, n)
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.judge, portbench.reference.milp; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'sypha_tpu_torch', 'sypha_tpu', 'jax'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_without_a_card_the_command_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "scp4x.window64", "--seed", "2147483659",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.spec()["workloads"]])
def test_short_run_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "4000000001",
         "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res
    assert np.isfinite(res["metrics"]["setup_s"]["value"])
