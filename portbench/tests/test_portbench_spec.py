"""BENCHMARK.json and the files it names: they parse, every name resolves to
a file, and a new cell, configuration, traffic mix or metric is found by
name without an edit to a file that is there."""

import json
import re
import shutil
import time

import pytest
import torch

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits its 43,200 seconds.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_and_names(section):
    names = [entry["name"] for entry in BENCH[section]]
    assert len(names) == len(set(names))
    for entry in BENCH[section]:
        assert set(entry) - {"workloads"} == KEYS[section], entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        for text in ("why", "layer", "source"):
            if text in entry:
                assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text] and "\t" not in entry[text]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        if "workloads" in entry:
            assert set(entry["workloads"]) <= set(CELLS)


def test_bounds():
    for metric in BENCH["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    spec = harness.Spec(cell)
    workload = spec.workload
    assert workload["chips"] == 1 and NAME.match(workload["config"]) and NAME.match(workload["traffic"])
    assert (harness.HERE / "loads" / f"{spec.traffic['kind']}.py").exists()
    assert (harness.HERE / "programs" / f"{spec.traffic['program']}.py").exists()
    assert (harness.HERE / "families" / f"{spec.cfg['family']}.py").exists()
    assert (harness.HERE / "reference" / f"{spec.cfg['family']}.py").exists()
    assert set(spec.limits) == {"logit_gap", "score_off_share", "pca_gap"}
    assert spec.compared["tau"] > 0.0
    reported = [m["name"] for m in spec.end_to_end()]
    assert "setup_s" in reported and len(reported) >= 2
    layers = spec.per_layer()
    assert layers
    for metric in layers:
        assert harness.metric_file(metric["name"]).exists()
        assert metric["moves"] in reported


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for entry in BENCH["configs"]:
        assert entry["file"].startswith("portbench/configs/") and entry["reduced"] == []
        assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
        harness.load_json(harness.ROOT / entry["file"])


def test_metrics_of_one_layer_share_its_name():
    layers = {}
    for metric in BENCH["per_layer"]:
        base = metric["name"].split(".")[0]
        layers.setdefault(base, set()).add(metric["layer"])
    assert all(len(names) == 1 for names in layers.values())


PROGRAM = """
from types import SimpleNamespace


def make_inputs(cfg, traffic, seed, device):
    return {}


def build(cfg, traffic, seed, made, device):
    return SimpleNamespace(value=float(seed % 7))


def checked_state(program):
    return None


def release(program):
    pass


def judge(cfg, traffic, seed, made, blocks, state, device, compared, controls=(), record=()):
    return {"numbers": {"gap": abs(blocks[0] - seed % 7)}, "controls": {}}
"""

LOAD = """
class Load:
    def __init__(self, cfg, traffic, seed, program, device):
        self.program = program

    def warmup(self):
        pass

    def window(self, seconds):
        return {"seconds": seconds, "images": 3, "attempted": 3, "failed": 0,
                "end_to_end": {"img_per_s": 3.0 / seconds}}

    def traced(self):
        return 1, 3

    def sample(self, rng):
        return [self.program.value]
"""


def test_a_new_cell_traffic_program_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """A copy of the harness's folder gains a traffic mix, a program, a load
    generator, a cell, its limits and a per-layer metric as new files and
    entries only, and a run of the new cell goes through them."""
    copy = tmp_path / "portbench"
    shutil.copytree(harness.HERE, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (copy / "traffic" / "constant.json").write_text(json.dumps({"program": "constant", "kind": "once"}))
    (copy / "programs" / "constant.py").write_text(PROGRAM)
    (copy / "loads" / "once.py").write_text(LOAD)
    (copy / "cells" / "constant.once.json").write_text(json.dumps({"limits": {"gap": 0.0}}))
    (copy / "metrics" / "calls.py").write_text("def read(ctx):\n    return 7.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "constant.once", "config": "resnet18_cifar10", "traffic": "constant",
                               "chips": 1, "why": "a new system under test"})
    bench["end_to_end"][0]["workloads"].append("constant.once")
    bench["per_layer"].append({"name": "calls.once", "unit": "1", "better": "higher", "source": "host_clock",
                               "layer": "loader", "moves": "img_per_s", "workloads": ["constant.once"]})
    monkeypatch.setattr(harness, "HERE", copy)
    spec = harness.Spec("constant.once", bench=bench)
    assert spec.limits == {"gap": 0.0} and spec.compared == {}
    assert "calls.once" in [m["name"] for m in spec.per_layer()]
    assert harness.metric_file("calls.once") == copy / "metrics" / "calls.py"
    assert harness.read_metric("calls.once", None) == 7.0
    out = harness.execute(spec, 2**40 + 5, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert out["numbers"] == {"gap": 0.0} and out["metrics"]["img_per_s"]["value"] == 6.0
