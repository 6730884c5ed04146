"""BENCHMARK.json and the files it names: every cell, configuration, traffic
mix, limit file and metric is found by name, and the file keeps the
contract's shape."""

import json
import re

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_configuration_traffic_and_limit_loads_by_name():
    sp = harness.spec()
    configs = {c["name"] for c in sp["configs"]}
    for w in sp["workloads"]:
        assert w["config"] in configs
        config, traffic, limits = harness.cell_files(w)
        assert config["name"] == w["config"]
        kind = harness.kind(traffic["kind"])
        assert callable(kind.setup)
        assert limits and all(set(v) in ({"max"}, {"min"}) for v in limits.values())


def test_every_metric_has_a_reader():
    sp = harness.spec()
    for m in sp["end_to_end"] + sp["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    sp = harness.spec()
    for w in sp["workloads"]:
        e2e = [m["name"] for m in harness.metrics_for(sp, w, traced=False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = harness.metrics_for(sp, w, traced=True)
        assert per_layer
        for m in per_layer:
            assert m["moves"] in e2e


def test_contract_shape():
    sp = harness.spec()
    assert set(sp) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= sp["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p for p in sp["paths"] + sp["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in sp[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in sp["end_to_end"] + sp["per_layer"])) == len(sp["end_to_end"]) + len(sp["per_layer"])
    for c in sp["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(sp["paths"][0] + "/") and len(c["source"]) <= 200
    for w in sp["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in sp["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in sp["end_to_end"]}
    for m in sp["per_layer"]:
        assert UNIT.match(m["unit"]) and "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(sp)) < 64 * 1024
