"""BENCHMARK.json and the files it names: they parse, every name resolves to
a file, and a new cell, configuration, traffic mix or metric is found by
name without an edit to a file that is there."""

import contextlib
import hashlib
import importlib
import json
import re
import shutil
import sys

import pytest

from portbench import harness
from portbench.tests import cellchecks

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = cellchecks.NAME
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


@pytest.mark.parametrize("cell", [w["name"] for w in cellchecks.with_left_out(BENCH)["workloads"]])
def test_cell_files_resolve(cell):
    cellchecks.check_files(cellchecks.with_left_out(BENCH), cell)


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for entry in BENCH["configs"]:
        assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
        cellchecks.check_config(BENCH, entry["name"])


def test_metrics_of_one_layer_share_its_name():
    layers = {}
    for metric in BENCH["per_layer"]:
        base = metric["name"].split(".")[0]
        layers.setdefault(base, set()).add(metric["layer"])
    assert all(len(names) == 1 for names in layers.values())


NEW_CELL = harness.HERE / "tests" / "newcell"
TOY = "toy.rows"


def digests(folder):
    return {str(path.relative_to(folder)): hashlib.sha256(path.read_bytes()).hexdigest()
            for path in sorted(folder.rglob("*")) if path.is_file() and "__pycache__" not in path.parts}


@contextlib.contextmanager
def portbench_at(root):
    """``portbench`` imported afresh from ``root``, and the one imported
    before put back afterwards."""
    def ours(name):
        return name == "portbench" or name.startswith("portbench.")

    saved = {name: module for name, module in sys.modules.items() if ours(name)}
    for name in saved:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        yield importlib.import_module("portbench.tests.cellchecks")
    finally:
        sys.path.remove(str(root))
        for name in [name for name in sys.modules if ours(name)]:
            del sys.modules[name]
        sys.modules.update(saved)


def copy_with_a_new_cell(tmp_path, edit=None):
    """A copy of the harness's folder, its tests included, and of
    ``BENCHMARK.json``, to which the toy cell of ``tests/newcell`` (a
    program, a traffic kind and mix, a configuration family with its
    reference, a reduced key, its limits, CPU sizes, faults and a per-layer
    reader) is added as new files and entries only; ``edit(root)`` then
    changes what it will. Returns the copy's root, the digests of every
    file that was in the copy before, and its benchmark."""
    copy = tmp_path / "portbench"
    shutil.copytree(harness.HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(copy)
    for path in sorted(NEW_CELL.rglob("*")):
        relative = path.relative_to(NEW_CELL)
        if path.is_file() and "__pycache__" not in relative.parts and relative.name != "bench.json":
            target = copy / relative
            assert not target.exists(), relative
            target.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(path, target)
    bench = json.loads(json.dumps(BENCH))
    for section, entries in harness.load_json(NEW_CELL / "bench.json").items():
        bench[section] += entries
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    if edit is not None:
        edit(tmp_path)
    return tmp_path, before, bench


def test_a_new_cell_traffic_program_and_metric_are_found_by_name(tmp_path):
    """A copy of the harness's folder, its tests included, gains a cell of
    a new program and a new configuration family as new files and entries
    only: every per-cell check passes on it, a run goes through its
    program, load and per-layer reader, and no file that was in the copy
    changes."""
    root, before, bench = copy_with_a_new_cell(tmp_path)
    with portbench_at(root) as checks:
        copied = checks.harness
        assert copied.HERE == root / "portbench"
        cell_spec = copied.Spec(TOY)
        assert cell_spec.limits == {"gap": 0.01} and cell_spec.compared == {"scale": 1.0}
        assert [m["name"] for m in cell_spec.end_to_end()] == ["setup_s", "rows_per_s"]
        assert [m["name"] for m in cell_spec.per_layer()] == ["rows_calls.rows"]
        assert copied.metric_file("rows_calls.rows") == root / "portbench" / "metrics" / "rows_calls.py"
        assert copied.read_metric("rows_calls.rows", None) == 7.0
        checks.check_files(bench, TOY)
        checks.check_fault_cases(bench, TOY)
        out = checks.tiny_run(bench, TOY, controls=[checks.CONTROL])
        assert out["metrics"]["rows_per_s"]["value"] > 0.0 and out["attempted"] >= 16 and out["failed"] == 0
        checks.check_f32_agreement(bench, TOY, out)
        checks.check_control_fails(bench, TOY, out)
        for fault in checks.fault_names(TOY):
            checks.check_fault_fails(bench, TOY, fault)
    after = digests(root / "portbench")
    assert {name: after[name] for name in before} == before


def test_a_reduced_key_needs_its_published_value(tmp_path):
    """The same cell, its configuration's cut stated without the published
    value: the cell's files check fails."""
    def unpublished(root):
        path = root / "portbench" / "configs" / "toy_affine.json"
        cfg = json.loads(path.read_text())
        del cfg["reduced"]["layers"]["published"]
        path.write_text(json.dumps(cfg))

    root, _, bench = copy_with_a_new_cell(tmp_path, unpublished)
    with portbench_at(root) as checks:
        with pytest.raises(AssertionError, match="published"):
            checks.check_files(bench, TOY)
