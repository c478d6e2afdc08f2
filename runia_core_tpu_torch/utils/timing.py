"""Timing on the GPU with CUDA events.

PyTorch returns before the device has finished, so a host clock around
enqueued work measures the enqueue. :func:`cuda_time_ms` records events on
the current stream around a run of calls and reads the device's time. Where
one call's device time is shorter than the time the host needs to enqueue it,
that still measures the host: :func:`cuda_graph_time_ms` records the calls
into a CUDA graph first and times its replays, which the host does not pace.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["cuda_graph_time_ms", "cuda_time_ms"]


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
    captured into one CUDA graph (after one eager call, so that builds and
    first-use allocations happen outside the capture) and the graph is
    replayed ``replays`` times between two events, after one untimed replay.
    ``fn`` must enqueue on the current stream and not synchronise."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_graph_time_ms needs a CUDA device")
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
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
