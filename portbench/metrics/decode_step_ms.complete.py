"""decode_step_ms.complete: device ms of one decode step, over a traced
stretch: the kernels of each decode chunk's replay (those its launch inside
``runia.engine.decode`` ran, tied by CUPTI's correlation id), summed, over
the chunk's steps (``chunk_tokens``), the mean over the chunks."""

import statistics

from portbench import engine_trace


def read(ctx):
    chunks = [s for s in engine_trace.stretch(ctx).decode_s if s > 0.0]
    if not chunks:
        return None
    return 1e3 * statistics.fmean(chunks) / ctx.traffic["engine"]["chunk_tokens"]
