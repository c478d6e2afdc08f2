"""What the per-layer readers read from the program's own spans.

The port opens a span, named ``runia.<layer>.<stage>``, at each layer
boundary of its scoring path (``runia_core_tpu_torch.utils.profiling``).
Two readings of them:

* host times, from more traced stretches (``ctx.load.traced()``), as many
  as it takes to hold ``MIN_CALLS`` calls or requests, run inside the
  program's ``recording()`` with no profiler on, so that the profiler's
  slowing of the host stays out of them. :func:`recorded` runs them once a
  run and keeps the recording on ``ctx`` for every reader;
* the device's idle time over the harness's profiler trace, put down to
  the innermost ``runia.*`` span of the main thread running when each idle
  gap began (the spans are ``user_annotation`` events there).

A program without spans (no ``recording``, no ``runia.*`` event) gives
None, and the metric is left out of the line.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional

from portbench import trace as tracing

PREFIX = "runia."
MIN_CALLS = 10  # root spans the recording holds at least: a ResNet-50 dataset call takes about 1 s


def recorded(ctx):
    """The program's ``Recording`` of traced stretches until it holds
    ``MIN_CALLS`` root spans (or a stretch records none), made on the first
    call and kept on ``ctx``; None where the program has no recording."""
    if not hasattr(ctx, "spans"):
        try:
            from runia_core_tpu_torch.utils.profiling import recording
        except ImportError:
            ctx.spans = None
        else:
            with recording() as rec:
                ctx.load.traced()
                while rec.spans and sum(s.parent is None for s in rec.spans) < MIN_CALLS:
                    ctx.load.traced()
            ctx.spans = rec
    return ctx.spans


def mean_ms(rec, name: str) -> Optional[float]:
    """Mean duration of the spans called ``name``, in ms."""
    ms = [(s.end_ns - s.start_ns) * 1e-6 for s in rec.spans if s.name == name]
    return statistics.fmean(ms) if ms else None


def per_root_ms(rec, name: str, root: str) -> Optional[float]:
    """The spans called ``name`` summed by the call (root span ``root``)
    they belong to, in ms; the median over those calls (a call without one
    counts 0). The median, since a few calls of a stretch wait two to three
    times the rest."""
    roots = {s.id: 0.0 for s in rec.spans if s.name == root and s.parent is None}
    for s in rec.spans:
        if s.name == name and s.trace in roots:
            roots[s.trace] += (s.end_ns - s.start_ns) * 1e-6
    return statistics.median(roots.values()) if roots else None


def idle_by_span(trace: tracing.Trace) -> Dict[str, float]:
    """The traced stretch's device-idle seconds by the innermost ``runia.*``
    span of the main thread running when each gap began; ``none`` where
    none was (the client's, or the harness's, host time)."""
    spans = tracing.Trace(window_s=trace.window_s, device=trace.device,
                          host=[e for e in trace.host if e[0].startswith(PREFIX)])
    return dict(spans.idle_gaps())


def program_idle_share(ctx) -> Optional[float]:
    """The share of the traced stretch's device-idle time that falls to the
    program's spans, in %; None where the trace holds none of them."""
    if not any(e[0].startswith(PREFIX) for e in ctx.trace.host):
        return None
    idle = idle_by_span(ctx.trace)
    total = sum(idle.values())
    return 100.0 * (total - idle.get("none", 0.0)) / total if total > 0.0 else 0.0
