"""Timing on the GPU with CUDA events.

PyTorch returns before the device has finished, so a host clock around
enqueued work measures the enqueue. :func:`cuda_time_ms` records events on
the current stream around a run of calls and reads the device's time. Where
one call's device time is shorter than the time the host needs to enqueue it,
that still measures the host: :func:`cuda_graph_time_ms` records the calls
into a CUDA graph first and times its replays, which the host does not pace.
:func:`device_profile` says how busy the device was while a call ran: the
kernels ``torch.profiler`` saw and the share of the wall time they took.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Optional

import torch

from runia_core_tpu_torch.utils.graphs import CudaGraph

__all__ = ["cuda_graph_time_ms", "cuda_time_ms", "device_profile"]


def cuda_time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn()`` over ``iters`` calls,
    after ``warmup`` calls. Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_time_ms(fn: Callable[[], object], iters: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds per call of ``fn()``: ``iters`` calls are
    captured into one CUDA graph (``utils/graphs.py::CudaGraph``, after its
    warm-up, so that builds and first-use allocations happen outside the
    capture) and the graph is replayed ``replays`` times between two events,
    after one untimed replay. ``fn`` must enqueue on the current stream and
    not synchronise."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_graph_time_ms needs a CUDA device")

    def calls():
        for _ in range(iters):
            fn()

    graph = CudaGraph(calls, warmup=1)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def device_profile(fn: Callable[[], object], units: int = 1,
                   category: Optional[Callable[[str], str]] = None) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` (CPU and CUDA activity)
    and return per unit (a decode step, a call): the wall milliseconds, the
    kernels the device ran (those of CUDA-graph replays included), their
    summed milliseconds (they run on one stream, so this is the time the
    device was busy) and the busy share of the wall time; with
    ``category``, device milliseconds and kernels by ``category(kernel
    name)``. The profiler slows the host, so an eager call's share is a
    lower bound. Raises without a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_profile needs a CUDA device")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    by_category, count_by_category = collections.defaultdict(float), collections.Counter()
    kernels, busy_us = 0, 0.0
    for event in prof.events():
        if str(event.device_type).endswith("CUDA") and event.name and not event.name.startswith("Memcpy HtoD (Pageable"):
            micros = float(getattr(event, "device_time", 0.0) or getattr(event, "cuda_time", 0.0) or 0.0)
            if micros <= 0.0:
                continue
            kernels += 1
            busy_us += micros
            if category is not None:
                by_category[category(event.name)] += micros
                count_by_category[category(event.name)] += 1
    record = {
        "device_time_seen": busy_us > 0.0,
        "wall_ms_per_unit": wall_ms / units,
        "kernels_per_unit": kernels / units,
        "device_busy_ms_per_unit": busy_us / 1e3 / units,
        "device_busy_share": busy_us / 1e3 / wall_ms,
    }
    if category is not None:
        record["device_ms_per_unit_by_category"] = {
            k: v / 1e3 / units for k, v in sorted(by_category.items(), key=lambda kv: -kv[1])
        }
        record["kernels_per_unit_by_category"] = {k: n / units for k, n in count_by_category.most_common()}
    return record
