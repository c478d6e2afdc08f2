"""Arithmetic that more than one per-layer reader (``metrics/*.py``) uses.

A reader gets the run's context: ``cfg``, ``traffic``, ``device``,
``program`` (the fitted scorer), ``load`` (the traffic's load generator,
with its data), ``window`` (the measured window's images and seconds), ``trace``
(``trace.Trace`` of the traced stretch) and ``card`` (name and power limit).
"""

from __future__ import annotations

import re
from typing import Iterable, Optional, Sequence

import torch

from portbench import inputs, workcounts


def mfu(ctx) -> float:
    """The whole step's share of the bf16 peak, in %: the model's FLOPs
    (published shapes) times the images scored over the window's seconds."""
    flops = workcounts.model_flops(ctx.cfg) * ctx.window["images"]
    return 100.0 * flops / ctx.window["seconds"] / workcounts.PEAK_BF16_FLOPS


def idle_share(ctx) -> float:
    """The share of the measured window in which nothing ran on the device,
    in %: the device's busy seconds an image over the traced stretch (the
    union of its intervals) times the window's images, over the window's
    seconds. The profiler slows the host and not the device, so the traced
    stretch's own idle share would read high where the host sets the pace."""
    busy = ctx.trace.busy_s() / ctx.trace.images * ctx.window["images"]
    return 100.0 * (1.0 - busy / ctx.window["seconds"])


def stage_seconds(ctx, ends: Iterable[str], leads: Sequence[str]) -> float:
    """Device seconds of a stage over the traced stretch: each kernel whose
    name matches one of ``ends`` patterns, with the run of kernels just
    before it that match ``leads`` (given in launch order) one by one,
    walking back from it and stopping at the first that does not."""
    ends = [re.compile(p) for p in ends]
    leads = [re.compile(p) for p in leads]
    kernels = sorted((e for e in ctx.trace.device if not e[0].startswith(("Memcpy", "Memset"))),
                     key=lambda e: e[1])
    seconds = 0.0
    for i, (name, start, end) in enumerate(kernels):
        if not any(p.search(name) for p in ends):
            continue
        seconds += end - start
        j = i - 1
        for pattern in reversed(leads):
            if j < 0 or not pattern.search(kernels[j][0]):
                break
            seconds += kernels[j][2] - kernels[j][1]
            j -= 1
    return seconds


def roofline_share(bound_s: float, seconds: float) -> Optional[float]:
    """``bound_s`` over ``seconds`` in %; None where nothing was timed."""
    return 100.0 * bound_s / seconds if seconds > 0.0 else None


def event_ms(ctx, fn, calls: int, warmup: int = 3) -> float:
    """Mean device milliseconds a call of ``fn(i)`` takes, by CUDA events
    around ``calls`` calls after ``warmup``."""
    for i in range(warmup):
        fn(i)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(ctx.device)
    start.record()
    for i in range(calls):
        fn(warmup + i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def replay_ms(ctx, calls: int = 20) -> float:
    """Device ms of one scorer call at the cell's batch, a new generator
    each call: the graph replay and the results' copies."""
    images = ctx.load.batch_images()
    generators = [inputs.generator(ctx.device, ctx.seed, inputs.TAGS["sample"], i) for i in range(calls + 3)]
    return event_ms(ctx, lambda i: ctx.program.scorer(images, generators[i]), calls)
