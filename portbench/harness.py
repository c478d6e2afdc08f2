"""The benchmark's harness: one cell, one seed, one process.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` finds everything by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic mix (``traffic/<name>.json``, whose
``program`` names the system under test and how its answers are judged,
``programs/<program>.py``, and whose ``kind`` names its load generator,
``loads/<kind>.py``), the limits of its correctness check and the
parameters of its comparison (``cells/<cell>.json``) and, with ``--trace
1``, the reader of each per-layer metric (``metrics/<name>.py``, or the
reader of all its variants, ``metrics/<name up to its first dot>.py``). A
new cell, configuration, traffic mix, program or metric is new files and
entries only.

A run: set-up (seeded weights and data made on the device, the program's
fit, one warm-up of every shape the traffic uses), the measured window,
with ``--trace 1`` a traced stretch and the per-layer readers, then the
program is freed and the reference checks a seeded sample of the window's
answers. The last line on standard output is the result; the last lines on
standard error are the compared numbers beside their limits.
"""

from __future__ import annotations

import argparse
import copy
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "runia_core_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def merge(base: dict, extra: Optional[dict]) -> dict:
    """``base`` with ``extra``'s keys put in, nested dicts merged."""
    out = copy.deepcopy(base)
    for key, value in (extra or {}).items():
        out[key] = merge(out[key], value) if isinstance(value, dict) and isinstance(out.get(key), dict) else value
    return out


class Spec:
    """One cell of ``BENCHMARK.json`` and the files it names."""

    def __init__(self, cell: str, overrides: Optional[dict] = None, bench: Optional[dict] = None):
        overrides = overrides or {}
        self.bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
        found = [w for w in self.bench["workloads"] if w["name"] == cell]
        if not found:
            raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
        self.workload = found[0]
        self.cell = cell
        entry = [c for c in self.bench["configs"] if c["name"] == self.workload["config"]][0]
        self.cfg = merge(load_json(ROOT / entry["file"]), overrides.get("config"))
        self.traffic = merge(load_json(HERE / "traffic" / f"{self.workload['traffic']}.json"),
                             overrides.get("traffic"))
        cell_file = HERE / "cells" / f"{cell}.json"
        judged = load_json(cell_file) if cell_file.exists() else {}
        self.limits = overrides.get("limits", judged.get("limits"))
        self.compared = merge(judged.get("compare", {}), overrides.get("compare"))

    def _applies(self, entry: dict, reported: List[str]) -> bool:
        if "workloads" in entry:
            return self.cell in entry["workloads"]
        return entry.get("moves") in reported if "moves" in entry else True

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if self._applies(m, [])]

    def per_layer(self) -> List[dict]:
        reported = [m["name"] for m in self.end_to_end()]
        return [m for m in self.bench["per_layer"] if self._applies(m, reported)]


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_file(name: str) -> Path:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    else the one reader of all its variants, ``metrics/<name up to its
    first dot>.py`` (``replay_ms.py`` reads ``replay_ms.dataset`` and
    ``replay_ms.stream``)."""
    own = HERE / "metrics" / f"{name}.py"
    return own if own.exists() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def read_metric(name: str, ctx) -> Optional[float]:
    """The value of per-layer metric ``name`` from its reader's
    ``read(ctx)``; None where it finds nothing."""
    module = load_file(metric_file(name), "portbench_metric_" + name.replace(".", "_"))
    return module.read(ctx)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def execute(spec: Spec, seed: int, seconds: float, trace: bool, device, started: float,
            controls: Sequence[str] = (), record: bool = False) -> dict:
    """One run of ``spec``'s cell on ``device``; the result's fields. The
    traffic mix names its program (``programs/<program>.py``), which makes
    the seeded inputs, builds the system under test and judges its answers.
    With ``controls``, each control's answers are judged too
    (``control_numbers``); ``record`` asks the program for its raw readings."""
    import torch

    from portbench import inputs
    from portbench import trace as tracing

    cfg, traffic = spec.cfg, spec.traffic
    cuda = device.type == "cuda"
    system = load_file(HERE / "programs" / f"{traffic['program']}.py", f"portbench_program_{traffic['program']}")
    made = system.make_inputs(cfg, traffic, seed, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    program = system.build(cfg, traffic, seed, made, device)
    load_module = load_file(HERE / "loads" / f"{traffic['kind']}.py", f"portbench_load_{traffic['kind']}")
    load = load_module.Load(cfg, traffic, seed, program, device)
    load.warmup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - started

    window = load.window(seconds)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    e2e_values = dict(window["end_to_end"], setup_s=setup_s)
    out: dict = {"attempted": window["attempted"], "failed": window["failed"], "memory_peak_bytes": memory_peak}
    power = card() if cuda else "cpu"
    if trace:
        traced = tracing.capture(load.traced)
        ctx = SimpleNamespace(spec=spec, cfg=cfg, traffic=traffic, seed=seed, device=device, program=program,
                              load=load, window=window, trace=traced, card=power)
        out["metrics"] = {}
        for metric in spec.per_layer():
            value = read_metric(metric["name"], ctx)
            if value is not None:
                out["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}
        out["busy_s"], out["window_s"] = traced.busy_s(), traced.window_s
        out["breakdown"] = traced.breakdown()
        ctx = None
    else:
        out["metrics"] = {m["name"]: {"value": e2e_values[m["name"]], "unit": m["unit"]} for m in spec.end_to_end()}

    # The program's state goes before the reference runs, so that the
    # reference neither finds the memory taken nor sets the peak.
    blocks = load.sample(np.random.default_rng(inputs.seed_word(seed, inputs.TAGS["sample"])))
    state = system.checked_state(program)
    system.release(program)
    load.program = program = None
    del load
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    judged = system.judge(cfg, traffic, seed, made, blocks, state, device, spec.compared, controls, record)
    out["numbers"] = judged["numbers"]
    out["control_numbers"] = judged["controls"]
    if record:
        out["raw"] = judged["raw"]
    out["card"] = power
    return out


def verdict(numbers: dict, limits: dict) -> dict:
    """Each number beside its limit; a number that is not finite fails."""
    return {name: {"value": numbers[name], "limit": limits[name], "ok": numbers[name] <= limits[name]}
            for name in limits}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None, started: Optional[float] = None) -> int:
    started = time.perf_counter() if started is None else started
    args = parse_args(argv)
    spec = Spec(args.workload)
    if spec.limits is None:
        print(f"no limits for {spec.cell}: cells/{spec.cell}.json is missing", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.workload["chips"]:
        print(f"{spec.cell} needs {spec.workload['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = execute(spec, args.seed, args.seconds, bool(args.trace), device, started)
    bad = forbidden_modules()
    if bad:
        print(f"modules that the run may not load were loaded: {bad}", file=sys.stderr)
        return 3
    # A score or logit that is not finite is a wrong answer wherever it falls.
    checks = verdict(dict(out["numbers"], nonfinite_answers=out["failed"]),
                             dict(spec.limits, nonfinite_answers=0))
    result = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": out["metrics"],
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": spec.workload["chips"],
                   "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if args.trace:
        result["device"].update(busy_s=out["busy_s"], window_s=out["window_s"])
        result["breakdown"] = out["breakdown"]
    result["card"] = out["card"]
    result["checks"] = {name: {"value": c["value"], "limit": c["limit"]} for name, c in checks.items()}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

