"""The serving cell's work counts against sums worked out by hand, and its
device-trace readers on a Chrome trace written by hand."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import engine_trace, harness, workcounts
from portbench import trace as tracing
from portbench.reference import mellum_work

CFG = harness.load_json(harness.HERE / "configs" / "mellum2_12b_a2.5b.json")


def test_active_parameters_are_about_2_21_billion():
    # a layer: q and o 2,304 x 4,096 each, k and v 2,304 x 512 each, the
    # router 2,304 x 64, 8 experts of 3 x 2,304 x 896; the head 2,304 x 98,304
    layer = 2 * 2304 * 4096 + 2 * 2304 * 512 + 2304 * 64 + 8 * 3 * 2304 * 896
    assert mellum_work.active_parameters(CFG) == 28 * layer + 2304 * 98304 == 2_212_429_824


@pytest.mark.parametrize("tokens", [1, 1000, 1024, 1025, 5715])
def test_attended_keys_are_the_masks_sum(tokens):
    full = sum(i + 1 for i in range(tokens))
    sliding = sum(min(i + 1, 1024) for i in range(tokens))
    assert mellum_work.attended_keys(CFG, tokens) == 7 * full + 21 * sliding
    heads = 32 * 128
    assert mellum_work.sequence_flops(CFG, tokens) == (2.0 * mellum_work.active_parameters(CFG) * tokens
                                                      + 4.0 * heads * (7 * full + 21 * sliding))


def test_kernel_work_by_hand():
    work = mellum_work.experts_work(CFG, pairs=64, touched=41)
    assert work["flops"] == 64 * 2 * 3 * 2304 * 896
    assert work["bytes"] == 41 * 3 * 2304 * 896 * 2 + 64 * 2304 * (2 + 4)
    work = mellum_work.attention_work(CFG, pairs=512 * 1024, keys=1535, queries=512)
    assert work["flops"] == 4 * 512 * 1024 * 32 * 128
    assert work["bytes"] == 512 * 32 * 128 * 2 * 2 + 1535 * 4 * 128 * 2 * 2


def _event(name, cat, ts, dur, correlation=None, tid=1):
    out = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if correlation is not None:
        out["args"] = {"correlation": correlation}
    return out


# A decode chunk's graph launch (correlation 7) inside its span runs two
# kernels later on the device; a lane call's launch (correlation 9, two
# lanes) runs three; a kernel of an eager call outside the spans
# (correlation 11) is nobody's.
EVENTS = [
    _event(engine_trace.DECODE, "user_annotation", 0.0, 20.0),
    _event("cudaGraphLaunch", "cuda_runtime", 5.0, 3.0, 7),
    _event("kernel_a", "kernel", 30.0, 10.0, 7),
    _event("moe_grouped_kernel<64, 2>", "kernel", 40.0, 30.0, 7),
    _event(engine_trace.PREFILL, "user_annotation", 100.0, 10.0),
    _event("cudaGraphLaunch", "cuda_runtime", 102.0, 2.0, 9),
    _event("flash_mma_kernel<128, false>", "kernel", 120.0, 40.0, 9),
    _event("moe_grouped_kernel<128, 3>", "kernel", 160.0, 100.0, 9),
    _event("kernel_b", "kernel", 260.0, 20.0, 9),
    _event("cudaLaunchKernel", "cuda_runtime", 300.0, 1.0, 11),
    _event("kernel_c", "kernel", 301.0, 5.0, 11),
]


def test_the_trace_ties_kernels_to_their_spans():
    trace = engine_trace.parse(EVENTS, lanes=[2])
    assert trace.decode_s == [pytest.approx(40e-6)]
    assert trace.prefill_s == [(pytest.approx(160e-6), 2)]
    ctx = SimpleNamespace(engine_trace=trace, traffic={"engine": {"chunk_tokens": 4}}, cfg=CFG)
    assert harness.read_metric("decode_step_ms.complete", ctx) == pytest.approx(40e-3 / 4)
    assert harness.read_metric("prefill_chunk_ms.complete", ctx) == pytest.approx(160e-3 / 2)


def test_rooflines_from_the_work_counters():
    trace = engine_trace.parse(EVENTS, lanes=[2])
    trace.work = {"moe_grouped": [64 + 4096, 41 + 64], "flash_prefix_attention": [512 * 1024, 1535, 512]}
    ctx = SimpleNamespace(engine_trace=trace, cfg=CFG)
    experts = mellum_work.experts_work(CFG, 64 + 4096, 41 + 64)
    bound = max(experts["bytes"] / workcounts.PEAK_HBM_BYTES, experts["flops"] / workcounts.PEAK_BF16_FLOPS)
    assert harness.read_metric("moe_roofline.complete", ctx) == pytest.approx(100.0 * bound / 130e-6)
    attention = mellum_work.attention_work(CFG, 512 * 1024, 1535, 512)
    bound = max(attention["bytes"] / workcounts.PEAK_HBM_BYTES, attention["flops"] / workcounts.PEAK_BF16_FLOPS)
    assert harness.read_metric("attention_roofline.complete", ctx) == pytest.approx(100.0 * bound / 40e-6)


def test_a_program_without_spans_or_counters_reads_nothing():
    plain = [e for e in EVENTS if e["cat"] != "user_annotation"]
    trace = engine_trace.parse(plain, lanes=[])
    ctx = SimpleNamespace(engine_trace=trace, traffic={"engine": {"chunk_tokens": 4}}, cfg=CFG)
    for name in ("decode_step_ms.complete", "prefill_chunk_ms.complete", "moe_roofline.complete",
                 "attention_roofline.complete"):
        assert harness.read_metric(name, ctx) is None, name


def test_mfu_counts_the_window_s_prompts_and_answers():
    """A request drained after the window's end is left out of its rate."""
    load = SimpleNamespace(pool=[[0] * 3000, [0] * 9000, [0] * 5000],
                           results=[{"index": 0, "tokens": [1] * 64, "ended": True},
                                    {"index": 1, "tokens": [1] * 64, "ended": True},
                                    {"index": 2, "tokens": [1] * 64, "ended": False}])
    ctx = SimpleNamespace(load=load, cfg=CFG, window={"seconds": 30.0})
    flops = mellum_work.sequence_flops(CFG, 3064) + mellum_work.sequence_flops(CFG, 9064)
    assert harness.read_metric("mfu.complete", ctx) == pytest.approx(100.0 * flops / 30.0 / 989e12)


class _Clock:
    t = 0.0

    def perf_counter(self):
        return self.t


class _Server:
    """Serves its requests in order, each taking one second of ``clock``."""

    def __init__(self, clock):
        self.clock, self.pending, self.done, self.next_id = clock, [], {}, 0

    def submit(self, prompt):
        self.next_id += 1
        self.pending.append(self.next_id)
        return self.next_id

    def stream(self):
        while self.pending:
            rid = self.pending.pop(0)
            self.clock.t += 1.0
            self.done[rid] = {"tokens": [1] * 4, "log_probs": [0.0] * 4, "entropies": [0.0] * 4}
            yield rid, {"perplexity": 1.0}

    def completion(self, rid):
        return self.done.pop(rid)


def test_the_closed_loop_counts_the_requests_drained_after_the_window(monkeypatch):
    """Two clients, a request a second, a 2.5 s window: the two requests
    sent at 1 s and 2 s end after it, at 3 s and 4 s, and give their
    latencies; the window's rate counts the two that ended inside it."""
    module = harness.load_file(harness.HERE / "loads" / "complete.py", "portbench_load_complete_test")
    clock = _Clock()
    monkeypatch.setattr(module, "time", clock)
    pool = [np.zeros(100 + i, dtype=np.int64) for i in range(4)]
    program = SimpleNamespace(server=_Server(clock), pool=pool, warmup_pool=pool[:1])
    traffic = {"pool_prompts": 4, "clients": 2, "new_tokens": 4}
    load = module.Load(CFG, traffic, 2**40 + 5, program, None)
    window = load.window(2.5)
    assert [r["latency"] for r in load.results] == [1.0, 2.0, 2.0, 2.0]
    assert [r["ended"] for r in load.results] == [True, True, False, False]
    assert window["attempted"] == 4 and window["images"] == 2 and window["seconds"] == 2.5
    assert window["end_to_end"]["latency_p95_ms"] == pytest.approx(2000.0)


def test_idle_share_reads_the_closed_loop_s_part_of_the_stretch():
    """Busy 0-3 s and 4-7 s of an 8 s loop, then a drain the reading leaves out."""
    trace = tracing.Trace(window_s=11.0, device=[("k", 0.0, 3.0), ("k", 4.0, 7.0), ("k", 8.5, 9.0)])
    ctx = SimpleNamespace(trace=trace, traffic={"trace_seconds": 8})
    assert harness.read_metric("idle_share.complete", ctx) == pytest.approx(25.0)
    assert harness.metric_file("program_idle_share.complete").name == "program_idle_share.py"
