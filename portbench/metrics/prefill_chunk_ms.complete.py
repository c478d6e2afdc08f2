"""prefill_chunk_ms.complete: device ms of one 512-token lane of chunked
prefill, over a traced stretch: the kernels of each lane program's replay
(those its launch inside ``runia.engine.prefill`` ran, tied by CUPTI's
correlation id), summed, over the call's lanes (the span's ``batch``), the
mean over the calls."""

import statistics

from portbench import engine_trace


def read(ctx):
    calls = [s / lanes for s, lanes in engine_trace.stretch(ctx).prefill_s if s > 0.0 and lanes]
    return 1e3 * statistics.fmean(calls) if calls else None
