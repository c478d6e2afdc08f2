"""What the serving cell's device-trace readers read: one profiled stretch
of the load (``ctx.load.traced()``), run once and kept on ``ctx``, with
what the harness's trace (``ctx.trace``) leaves out:

* which kernels each ``runia.engine.decode`` and ``runia.engine.prefill``
  span launched: CUPTI gives a graph launch and the kernels it runs one
  correlation id, and the span holds the launch;
* each prefill span's lanes: the same stretch runs inside the program's
  ``recording()``, whose spans carry ``batch`` and end in the trace's
  order;
* the grouped expert kernel's and kernel 4's work counts over the stretch
  (``moe_grouped.work``, ``flash_prefix_attention.work``: the kernels add
  them on the device).

A program without those spans or counters gives None where they are read.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

DECODE, PREFILL = "runia.engine.decode", "runia.engine.prefill"


@dataclass
class Stretch:
    kernels: List[Tuple[str, float]] = field(default_factory=list)  # (name, seconds) of every kernel
    decode_s: List[float] = field(default_factory=list)  # device seconds of each decode chunk's kernels
    prefill_s: List[Tuple[float, int]] = field(default_factory=list)  # (device seconds, lanes) of each lane call
    work: Dict[str, Optional[List[int]]] = field(default_factory=dict)  # counter rises over the stretch


def _work_counters() -> Dict[str, torch.Tensor]:
    """The grouped experts' and kernel 4's device work counters (the one
    card's), where the program has them."""
    out = {}
    for module, name in (("runia_core_tpu_torch.ops.moe_grouped", "moe_grouped"),
                         ("runia_core_tpu_torch.ops.flash_prefill", "flash_prefix_attention")):
        try:
            fn = getattr(__import__(module, fromlist=[name]), name)
        except ImportError:
            continue
        out.update({name: work for work in getattr(fn, "work", {}).values()})
    return out


def stretch(ctx) -> Stretch:
    if not hasattr(ctx, "engine_trace"):
        ctx.engine_trace = capture(ctx)
    return ctx.engine_trace


def capture(ctx) -> Stretch:
    from torch.profiler import ProfilerActivity, profile

    try:
        from runia_core_tpu_torch.utils.profiling import recording
    except ImportError:
        recording = None
    torch.cuda.synchronize()
    before = {name: work.tolist() for name, work in _work_counters().items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if recording is None:
            ctx.load.traced()
            rec = None
        else:
            with recording() as rec:
                ctx.load.traced()
        torch.cuda.synchronize()
    after = {name: work.tolist() for name, work in _work_counters().items()}
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = parse(events, [s.batch for s in rec.spans if s.name == PREFILL] if rec is not None else [])
    out.work = {name: [a - b for a, b in zip(after[name], before.get(name, [0] * len(after[name])))]
                for name in after}
    return out


def parse(events: List[dict], lanes: List[int]) -> Stretch:
    """A :class:`Stretch` from Chrome-trace events; ``lanes``: each prefill
    span's lanes, in the order the spans ended."""
    out = Stretch()
    by_correlation: Dict[int, float] = {}
    launches: List[Tuple[float, int]] = []
    spans = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        corr = (e.get("args") or {}).get("correlation")
        if cat == "kernel":
            seconds = float(e["dur"]) * 1e-6
            out.kernels.append((str(e.get("name", "")), seconds))
            if corr is not None:
                by_correlation[corr] = by_correlation.get(corr, 0.0) + seconds
        elif cat == "cuda_runtime" and corr is not None:
            launches.append((float(e["ts"]), corr))
        elif cat == "user_annotation" and e.get("name") in (DECODE, PREFILL):
            spans.append((float(e["ts"]) + float(e["dur"]), float(e["ts"]), e["name"]))
    launches.sort()
    prefills = iter(lanes)
    for end, start, name in sorted(spans):
        seconds = sum(by_correlation.get(corr, 0.0) for ts, corr in launches if start <= ts <= end)
        if name == DECODE:
            out.decode_s.append(seconds)
        else:
            out.prefill_s.append((seconds, next(prefills, None)))
    return out
