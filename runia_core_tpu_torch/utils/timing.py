"""Timing on the GPU with CUDA events.

PyTorch returns before the device has finished, so a host clock around
enqueued work measures the enqueue. :func:`cuda_time_ms` records events on
the current stream around a run of calls and reads the device's time.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["cuda_time_ms"]


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
