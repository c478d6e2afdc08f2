"""The entry point's guards: no card, no result; nothing the benchmark runs
loads JAX, flax or the JAX package; the card test runs a whole cell."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

RUN = [sys.executable, "portbench/run.py"]


def run(args, cwd=harness.ROOT, env=None, timeout=600):
    return subprocess.run(RUN + args, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


def imported_top_level_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in harness.HERE.rglob("*.py"):
        assert not imported_top_level_names(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").rglob("*.py"):
        assert imported_top_level_names(path) <= {"__future__", "math", "typing", "torch"}, path


def test_a_cpu_run_loads_none_of_them():
    """A whole tiny run on the CPU, in a process of its own."""
    code = (
        "import sys, time, torch\n"
        "from portbench import harness\n"
        "spec = harness.Spec('larex_rn18_cifar.dataset', overrides={'config': {'num_filters': 8, 'image_size': 16,"
        " 'larex': {'tap_shape': [2, 2, 64], 'pca_components': 8, 'fit_images': 32}}, 'traffic': {'images': 40,"
        " 'batch': 16, 'fit_batch': 16, 'max_in_flight': 2, 'sample': 16}})\n"
        "harness.execute(spec, 2**40 + 3, 0.2, False, torch.device('cpu'), time.perf_counter())\n"
        "print(harness.forbidden_modules())\n"
    )
    done = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "runia_core_tpu_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert harness.forbidden_modules() == ["flax"]


def test_without_a_card_the_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = run(["--workload", "larex_rn18_cifar.dataset", "--seed", str(2**33 + 1), "--seconds", "1"], env=env)
    assert done.returncode != 0
    assert not any(line.startswith("{") for line in done.stdout.splitlines())


def test_with_only_the_benchmark_files_the_run_fails(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    done = run(["--workload", "larex_rn18_cifar.dataset", "--seed", "7", "--seconds", "1"], cwd=tmp_path)
    assert done.returncode != 0
    assert not any(line.startswith("{") for line in done.stdout.splitlines())


@pytest.mark.requires_cuda
def test_a_cell_runs_on_the_card_and_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run only on the card")
    done = run(["--workload", "larex_rn18_cifar.dataset", "--seed", str(2**33 + 11), "--seconds", "2",
                "--trace", "1"], timeout=1200)
    assert done.returncode == 0, done.stderr[-4000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert list(result)[-1] == "checks" and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert "mfu.dataset" in result["metrics"] and result["metrics"]["mfu.dataset"]["value"] <= 100.0
