"""The device's activity over a traced stretch, from ``torch.profiler``.

A copy of the program's ``utils/timing.py::device_profile`` with one
change: busy time is the union of the intervals in which a kernel, copy or
memset ran on the device, not the sum of their durations, so work on two
streams at once (a copy beside a kernel) is counted once. The trace is
exported as Chrome JSON into ``TMPDIR``, read and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "user_annotation")
WINDOW = "portbench.traced_window"


@dataclass
class Trace:
    """Device and host events of the traced window, times in seconds from
    the window's start."""

    window_s: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, start, end)
    host: List[Tuple[str, float, float]] = field(default_factory=list)  # the main thread's
    units: int = 0  # calls or requests in the window
    images: int = 0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, clipped to the window."""
        spans = sorted((max(0.0, s), min(self.window_s, e)) for _, s, e in self.device if e > 0 and s < self.window_s)
        merged: List[Tuple[float, float]] = []
        for start, end in spans:
            if merged and start <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], end))
            else:
                merged.append((start, end))
        return merged

    def busy_s(self) -> float:
        return sum(end - start for start, end in self.busy_intervals())

    def kernel_seconds(self) -> Dict[str, float]:
        """Device seconds in the window by operation name, summed."""
        out: Dict[str, float] = {}
        for name, start, end in self.device:
            if end > 0.0 and start < self.window_s:
                out[name] = out.get(name, 0.0) + (min(end, self.window_s) - max(start, 0.0))
        return out

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle device time by what the host's main thread was doing when
        each gap began: the innermost host event running at that moment,
        summed by its name."""
        busy = self.busy_intervals()
        edges = [0.0] + [t for span in busy for t in span] + [self.window_s]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        events = sorted(self.host, key=lambda event: (event[1], -event[2]))
        stack: List[Tuple[str, float, float]] = []
        totals: Dict[str, float] = {}
        i = 0
        for start, end in gaps:
            while i < len(events) and events[i][1] <= start:
                while stack and stack[-1][2] < events[i][1]:
                    stack.pop()
                stack.append(events[i])
                i += 1
            while stack and stack[-1][2] < start:
                stack.pop()
            name = stack[-1][0] if stack else "none"
            totals[name] = totals.get(name, 0.0) + (end - start)
        return sorted(totals.items(), key=lambda kv: -kv[1])

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_seconds().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name[:160], seconds] for name, seconds in ops],
                "idle_gaps": [[name[:160], seconds] for name, seconds in self.idle_gaps()[:top]]}


def capture(fn: Callable[[], Tuple[int, int]]) -> Trace:
    """Run ``fn()`` (which returns the calls or requests it made and the
    images they carried) under the profiler, inside a named host span that
    marks the window, and return what ran on the device in it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            units, images = fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return parse(events, units, images)


def parse(events: List[dict], units: int = 0, images: int = 0) -> Trace:
    """A :class:`Trace` from Chrome-trace events (microseconds)."""
    window = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
              and str(e.get("cat", "")).lower() == "user_annotation"]
    if not window:
        raise RuntimeError("the traced window's span is missing from the profiler's trace")
    t0, main_thread = float(window[0]["ts"]), window[0].get("tid")
    trace = Trace(window_s=float(window[0]["dur"]) * 1e-6, units=units, images=images)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        start = (float(e["ts"]) - t0) * 1e-6
        span = (str(e.get("name", "")), start, start + float(e["dur"]) * 1e-6)
        if cat in DEVICE_CATEGORIES:
            trace.device.append(span)
        elif cat in HOST_CATEGORIES and span[0] != WINDOW and e.get("tid") == main_thread:
            trace.host.append(span)
    if not trace.device:
        raise RuntimeError("the profiler saw no device activity in the traced window")
    return trace

