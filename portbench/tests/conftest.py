"""The benchmark's own tests: the checkout's root on the path, and small
configurations that a CPU test run can hold."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def small():
    """(config, traffic by kind, limits by kind) at a size the CPU runs in
    seconds; the limits are the committed ones of each kind's cell."""
    from portbench import harness

    config = dict(harness.load_json(harness.PKG / "configs" / "scp4x.json"),
                  rows=30, cols=120, density=0.1, instances=[f"t{i}" for i in range(1, 5)])
    traffic = {
        "node_window": dict(harness.load_json(harness.PKG / "traffic" / "window64.json"),
                            instances=2, lanes=8, fixing_sets=2, check_windows=4, trace_calls=1),
        "bnb": dict(harness.load_json(harness.PKG / "traffic" / "bnb.json"), instances=2, trace_calls=1),
    }
    limits = {
        "node_window": harness.load_json(harness.PKG / "limits" / "scp4x.window64.json"),
        "bnb": harness.load_json(harness.PKG / "limits" / "scp4x.bnb.json"),
    }
    return config, traffic, limits
