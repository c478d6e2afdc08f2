"""The readers of the program's spans: the device's idle time put down to
the innermost ``runia.*`` span, on a Chrome trace written by hand; the
loader's wait a call and the scorer's host time, on a recording built by
hand; and nothing read from a program without spans."""

import sys
from types import SimpleNamespace

import pytest

from portbench import harness, spans
from portbench import trace as tracing
from runia_core_tpu_torch.utils import profiling
from runia_core_tpu_torch.utils.profiling import Recording, SpanRecord


def event(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": 1000.0 + ts, "dur": dur, "tid": tid}


# A 100-us stretch. The device is busy at 10-30, 50-60 and 80-90 us, so idle
# at 0-10 (the call not begun: the client's), 30-50 (inside submit, whose
# graph launch is running), 60-80 (inside fetch, waiting on its event) and
# 90-100 (the call's own end): 60 us idle, 50 of them the program's.
EVENTS = [
    {"ph": "X", "name": tracing.WINDOW, "cat": "user_annotation", "ts": 1000.0, "dur": 100.0, "tid": 1},
    event("aten::empty", "cpu_op", 0.0, 4.0),
    event("runia.service.score_dataset", "user_annotation", 5.0, 90.0),
    event("runia.service.submit", "user_annotation", 25.0, 15.0),
    event("cudaGraphLaunch", "cuda_runtime", 28.0, 7.0),
    event("runia.service.fetch", "user_annotation", 55.0, 15.0),
    event("cudaEventSynchronize", "cuda_runtime", 56.0, 13.0),
    event("runia.loader.gather", "user_annotation", 0.0, 100.0, tid=2),  # the loader's thread: not counted
    event("kernel_a", "kernel", 10.0, 20.0),
    event("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 50.0, 10.0),
    event("kernel_b", "kernel", 80.0, 10.0),
]


def test_idle_time_goes_to_the_innermost_program_span():
    trace = tracing.parse(EVENTS, units=1, images=8)
    idle = spans.idle_by_span(trace)
    assert idle == {"runia.service.submit": pytest.approx(20e-6), "runia.service.fetch": pytest.approx(20e-6),
                    "runia.service.score_dataset": pytest.approx(10e-6), "none": pytest.approx(10e-6)}
    # Every host event counted, the same gaps go to CUDA runtime calls instead.
    assert dict(trace.idle_gaps())["cudaGraphLaunch"] == pytest.approx(20e-6)
    ctx = SimpleNamespace(trace=trace)
    for cell in ("dataset", "stream"):
        assert harness.read_metric(f"program_idle_share.{cell}", ctx) == pytest.approx(100.0 * 50 / 60)


def test_a_trace_without_program_spans_reads_nothing():
    plain = [e for e in EVENTS if not e["name"].startswith("runia.")]
    ctx = SimpleNamespace(trace=tracing.parse(plain, units=1, images=8))
    assert harness.read_metric("program_idle_share.dataset", ctx) is None


def span(name, start_ms, end_ms, id, parent=None, trace=None):
    return SpanRecord(name, round(start_ms * 1e6), round(end_ms * 1e6), id, parent, trace or id, None, 1)


def test_loader_wait_a_call_and_the_scorer_host_time_from_a_recording():
    rec = Recording()
    rec.spans = [
        span("runia.loader.wait", 0.0, 2.0, 2, 1, 1), span("runia.loader.wait", 3.0, 4.0, 3, 1, 1),
        span("runia.scorer.call", 4.0, 4.1, 4, 5, 1), span("runia.service.submit", 4.0, 4.2, 5, 1, 1),
        span("runia.service.score_dataset", 0.0, 10.0, 1),
        span("runia.loader.wait", 10.0, 15.0, 7, 6, 6), span("runia.scorer.call", 15.0, 15.3, 8, 6, 6),
        span("runia.service.score_dataset", 10.0, 20.0, 6),
        span("runia.loader.wait", 30.0, 39.0, 9),  # a loader used outside a call: not a call's wait
        span("runia.service.score_dataset", 40.0, 50.0, 10),  # a call that never waited
    ]
    ctx = SimpleNamespace(spans=rec)
    assert harness.read_metric("loader_wait_ms.dataset", ctx) == pytest.approx(3.0)  # the median of 3, 5 and 0
    for cell in ("dataset", "stream"):
        assert harness.read_metric(f"scorer_host_ms.{cell}", ctx) == pytest.approx(0.2)
    assert spans.mean_ms(rec, "runia.service.fetch") is None
    assert spans.per_root_ms(Recording(), "runia.loader.wait", "runia.service.score_dataset") is None


def test_one_recorded_stretch_serves_every_reader():
    class Load:
        stretches = 0

        def traced(self):
            Load.stretches += 1
            with profiling.span("runia.service.score_dataset"):
                with profiling.span("runia.loader.wait", batch=0):
                    pass
                with profiling.span("runia.scorer.call"):
                    pass
            return 1, 8

    ctx = SimpleNamespace(load=Load())
    first = harness.read_metric("loader_wait_ms.dataset", ctx)
    host = harness.read_metric("scorer_host_ms.dataset", ctx)
    # One call a stretch: stretches until the recording holds MIN_CALLS calls, for both readers.
    assert Load.stretches == spans.MIN_CALLS and first >= 0.0 and host >= 0.0
    assert [s.name for s in ctx.spans.spans] == ["runia.loader.wait", "runia.scorer.call",
                                                 "runia.service.score_dataset"] * spans.MIN_CALLS


def test_a_stretch_that_records_nothing_is_run_once():
    class Load:
        stretches = 0

        def traced(self):
            Load.stretches += 1
            return 1, 8

    ctx = SimpleNamespace(load=Load())
    assert harness.read_metric("loader_wait_ms.dataset", ctx) is None
    assert harness.read_metric("scorer_host_ms.stream", ctx) is None
    assert Load.stretches == 1 and ctx.spans.spans == []


def test_a_program_without_a_recording_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "runia_core_tpu_torch.utils.profiling", SimpleNamespace())
    ctx = SimpleNamespace(load=None)
    assert harness.read_metric("loader_wait_ms.dataset", ctx) is None
    assert harness.read_metric("scorer_host_ms.stream", ctx) is None
