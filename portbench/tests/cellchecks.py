"""The benchmark's per-cell CPU checks, each a function of ``(bench, cell)``:
``bench`` the content of ``BENCHMARK.json``, ``cell`` the name of one of its
workloads. The tests call them on every cell of the benchmark, and the
new-cell test calls them, on a copy of this folder, on a cell that it adds
as new files and entries only. A check finds all it needs by name:

* the names of a cell's limits in its program's ``CHECKS``, and the keys of
  its comparison's parameters in its ``COMPARE`` (``programs/<program>.py``);
* a configuration's cuts in its file's ``reduced``: for each key that
  ``BENCHMARK.json`` lists as reduced, the ``published`` value and the
  ``deployment`` that the cut stands for (how many chips share a layer, and
  how);
* the CPU sizes, put over the cell's own, in ``tiny/configs/<config>.json``
  and ``tiny/traffic/<traffic>.json``;
* the faults a cell can have in ``tiny/faults/<cell>.json``, by the names of
  functions of ``tests/faults/<program>.py`` that each break the timed path
  underneath with a ``pytest.MonkeyPatch``.
"""

from __future__ import annotations

import json
import re
import time
from typing import List, Optional

import pytest
import torch

from portbench import harness
from portbench.reference.precision import CONTROL

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# A width may not be cut: a hidden, intermediate, latent, state or
# projection size, a key ending in _dim or _rank, a head size, an expansion
# factor, or the experts per token.
WIDTH = re.compile(r"(_dim|_rank|hidden_size|intermediate_size|_width|state_size|d_state|expand|expansion_factor|"
                   r"head_size|experts_per_tok|experts_per_token|num_filters)$|latent|projection")
SEED = 2**35 + 17
AGREE = 1e-3  # with the program in f32 the two sides differ by rounding alone
# Cells whose files are all here but which BENCHMARK.json leaves out for
# now (PERF.md, section 7), each with the cell whose metrics it would report
# and its own traffic mix: their checks run all the same, until
# BENCHMARK.json names them.
LEFT_OUT = {"larex_rn50_224.dataset_resize": ("larex_rn50_224.dataset", "dataset10k_b128_resize256")}


def with_left_out(bench: dict) -> dict:
    """``bench`` with each cell of ``LEFT_OUT`` that it does not name put in
    beside its sibling: in the same configuration, on the same chips, and in
    every metric's ``workloads`` that lists the sibling."""
    out = json.loads(json.dumps(bench))
    named = {w["name"] for w in out["workloads"]}
    for cell, (sibling, traffic) in LEFT_OUT.items():
        if cell in named:
            continue
        entry = next(w for w in out["workloads"] if w["name"] == sibling)
        out["workloads"].append(dict(entry, name=cell, traffic=traffic))
        for metric in out["end_to_end"] + out["per_layer"]:
            if sibling in metric.get("workloads", ()):
                metric["workloads"].append(cell)
    return out


def spec(bench: dict, cell: str, overrides: Optional[dict] = None) -> harness.Spec:
    return harness.Spec(cell, overrides=overrides, bench=bench)


def program_of(cell_spec: harness.Spec):
    name = cell_spec.traffic["program"]
    return harness.load_file(harness.HERE / "programs" / f"{name}.py", f"portbench_program_{name}")


def check_config(bench: dict, name: str) -> None:
    """The configuration's file parses, is its own, and states each cut that
    ``BENCHMARK.json`` lists: its published value, which the file no longer
    holds, and the deployment it stands for. No width is cut."""
    entry = [c for c in bench["configs"] if c["name"] == name][0]
    assert entry["file"].startswith("portbench/configs/"), entry["file"]
    cfg = harness.load_json(harness.ROOT / entry["file"])
    stated = cfg.get("reduced", {})
    assert set(stated) == set(entry["reduced"]), (name, sorted(stated), entry["reduced"])
    for key in entry["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key), f"{name}: {key} is a width, which is never cut"
        cut = stated[key]
        assert cut.get("published") is not None, f"{name}: {key} states no published value"
        assert cut["published"] != cfg.get(key), f"{name}: {key} is as published"
        deployment = cut.get("deployment")
        assert isinstance(deployment, str) and 1 <= len(deployment) <= 200 and "\n" not in deployment, \
            f"{name}: {key} states no deployment"


def check_files(bench: dict, cell: str) -> None:
    """Every name the cell gives resolves to a file, its limits are those
    its program checks, its comparison's parameters are positive numbers,
    and it reports ``setup_s``, another end-to-end metric and per-layer
    metrics whose readers exist."""
    cell_spec = spec(bench, cell)
    workload = cell_spec.workload
    assert workload["chips"] == 1 and NAME.match(workload["config"]) and NAME.match(workload["traffic"])
    for folder, name in (("loads", cell_spec.traffic["kind"]), ("programs", cell_spec.traffic["program"]),
                         ("families", cell_spec.cfg["family"]), ("reference", cell_spec.cfg["family"])):
        assert (harness.HERE / folder / f"{name}.py").exists(), f"{folder}/{name}.py"
    program = program_of(cell_spec)
    assert cell_spec.limits is not None and set(cell_spec.limits) == set(program.CHECKS), cell_spec.limits
    assert all(isinstance(v, (int, float)) for v in cell_spec.limits.values()), cell_spec.limits
    for key in program.COMPARE:
        value = cell_spec.compared[key]
        assert isinstance(value, (int, float)) and value > 0.0, (key, value)
    reported = [m["name"] for m in cell_spec.end_to_end()]
    assert "setup_s" in reported and len(reported) >= 2
    layers = cell_spec.per_layer()
    assert layers
    for metric in layers:
        assert harness.metric_file(metric["name"]).exists(), metric["name"]
        assert metric["moves"] in reported
    check_config(bench, workload["config"])


def fault_names(cell: str) -> List[str]:
    """The faults the cell lists (``tiny/faults/<cell>.json``); none where
    it has no such file."""
    path = harness.HERE / "tiny" / "faults" / f"{cell}.json"
    return list(harness.load_json(path)["faults"]) if path.exists() else []


def faults_of(cell_spec: harness.Spec):
    name = cell_spec.traffic["program"]
    return harness.load_file(harness.HERE / "tests" / "faults" / f"{name}.py", f"portbench_faults_{name}")


def check_fault_cases(bench: dict, cell: str) -> None:
    """The cell has its CPU sizes and at least one fault, each a function
    of its program's faults module."""
    workload = spec(bench, cell).workload
    tiny = harness.HERE / "tiny"
    assert (tiny / "configs" / f"{workload['config']}.json").exists(), workload["config"]
    assert (tiny / "traffic" / f"{workload['traffic']}.json").exists(), workload["traffic"]
    names = fault_names(cell)
    assert names, f"{cell} lists no fault"
    faults = faults_of(spec(bench, cell))
    assert all(callable(getattr(faults, name, None)) for name in names), names


def tiny_spec(bench: dict, cell: str) -> harness.Spec:
    """The cell at its CPU sizes."""
    workload = spec(bench, cell).workload
    tiny = harness.HERE / "tiny"
    return spec(bench, cell, {"config": harness.load_json(tiny / "configs" / f"{workload['config']}.json"),
                              "traffic": harness.load_json(tiny / "traffic" / f"{workload['traffic']}.json")})


def tiny_run(bench: dict, cell: str, controls=()) -> dict:
    """One run of the cell at its CPU sizes, judged (with ``controls``,
    each control too)."""
    torch.set_num_threads(2)
    return harness.execute(tiny_spec(bench, cell), SEED, 0.3, False, torch.device("cpu"), time.perf_counter(),
                           controls=controls)


def correct(bench: dict, cell: str, numbers: dict) -> bool:
    return all(c["ok"] for c in harness.verdict(numbers, spec(bench, cell).limits).values())


def check_f32_agreement(bench: dict, cell: str, out: dict) -> None:
    """With the program in f32 (the CPU sizes' dtype), every number the run
    compared is rounding alone."""
    numbers = out["numbers"]
    assert set(numbers) >= set(spec(bench, cell).limits)
    assert all(value < AGREE for value in numbers.values()), numbers


def check_control_fails(bench: dict, cell: str, out: dict) -> None:
    """The control, the reference a precision lower, fails the cell's limits."""
    assert not correct(bench, cell, out["control_numbers"][CONTROL]), out["control_numbers"]


def check_fault_fails(bench: dict, cell: str, fault: str) -> None:
    """A run with the timed path broken by ``fault`` is not correct."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        getattr(faults_of(spec(bench, cell)), fault)(monkeypatch)
        out = tiny_run(bench, cell)
    assert not correct(bench, cell, out["numbers"]), out["numbers"]
