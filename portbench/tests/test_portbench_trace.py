"""Reading a profiler trace: the union of device intervals, idle time by
host activity, the entropy stage's kernels and the idle share, on a
Chrome trace written by hand."""

from types import SimpleNamespace

import pytest

from portbench import harness, readers
from portbench import trace as tracing


def event(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


EVENTS = [
    event(tracing.WINDOW, "user_annotation", 1000.0, 100.0),
    event("cudaGraphLaunch", "cuda_runtime", 1000.0, 10.0),
    event("cudaEventSynchronize", "cuda_runtime", 1050.0, 40.0),
    event("aten::copy_", "cpu_op", 1060.0, 5.0, tid=2),  # another thread: not the host's main one
    event("direct_copy_kernel_cuda", "kernel", 1010.0, 10.0),
    event("sm80_xmma_gemm_f32f32_nn", "kernel", 1020.0, 10.0),
    event("BUnaryFunctor<MulFunctor>", "kernel", 1030.0, 5.0),
    event("runia::marginal_entropy_kernel<16, 5>", "kernel", 1035.0, 5.0),
    event("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1038.0, 4.0),  # overlaps the kernel
    event("some_forward_kernel", "kernel", 1060.0, 20.0),
    event("after_the_window", "kernel", 1200.0, 20.0),
]


def test_union_gaps_and_breakdown():
    trace = tracing.parse(EVENTS, units=2, images=10)
    assert trace.window_s == pytest.approx(100e-6)
    # Busy: 10-42 and 60-80 us of the window; the copy beside the kernel counts once.
    assert trace.busy_intervals() == [pytest.approx((10e-6, 42e-6)), pytest.approx((60e-6, 80e-6))]
    assert trace.busy_s() == pytest.approx(52e-6)
    gaps = dict(trace.idle_gaps())
    assert gaps["cudaGraphLaunch"] == pytest.approx(10e-6)  # 0-10 us, the launch running
    assert gaps["none"] == pytest.approx(18e-6)  # 42-60 us: no host event of the main thread running
    assert gaps["cudaEventSynchronize"] == pytest.approx(20e-6)  # 80-100 us
    assert "aten::copy_" not in gaps
    breakdown = trace.breakdown()
    assert breakdown["device_ops"][0] == ["some_forward_kernel", pytest.approx(20e-6)]
    assert "after_the_window" not in dict(breakdown["device_ops"])
    assert len(breakdown["device_ops"]) <= 10 and len(breakdown["idle_gaps"]) <= 10


def test_a_trace_without_its_window_or_device_work_is_refused():
    with pytest.raises(RuntimeError):
        tracing.parse(EVENTS[1:])
    with pytest.raises(RuntimeError):
        tracing.parse([e for e in EVENTS if e["cat"] not in tracing.DEVICE_CATEGORIES])


def test_entropy_stage_walks_back_from_kernel_1():
    ctx = SimpleNamespace(trace=tracing.parse(EVENTS))
    module = harness.load_file(harness.metric_file("entropy_roofline.dataset"), "entropy_roofline")
    # Kernel 1 with the cast, the product and the division before it: 30 us.
    assert readers.stage_seconds(ctx, module.TWO_STEP, module.TWO_STEP_LEADS) == pytest.approx(30e-6)
    assert readers.stage_seconds(ctx, module.FUSED, ()) == 0.0
    assert readers.roofline_share(3e-6, 30e-6) == pytest.approx(10.0)
    assert readers.roofline_share(3e-6, 0.0) is None


def test_idle_share_scales_the_traced_busy_time_to_the_window():
    ctx = SimpleNamespace(trace=tracing.parse(EVENTS, units=2, images=10),
                          window={"images": 1000, "seconds": 52e-6 * 100 / 0.8})
    assert readers.idle_share(ctx) == pytest.approx(20.0)


def test_the_entropy_roofline_reads_the_stretch_s_images_against_their_bound():
    """The stage's bound is linear in the images, so a tail batch counts as
    its own images, not as a full batch."""
    from portbench import workcounts

    cfg = harness.Spec("larex_rn18_cifar.dataset").cfg
    ctx = SimpleNamespace(trace=tracing.parse(EVENTS, units=1, images=10_000), cfg=cfg)
    module = harness.load_file(harness.metric_file("entropy_roofline.stream"), "entropy_roofline")
    bound = workcounts.entropy_stage(cfg, 1)["bound_s"] * 10_000
    assert workcounts.entropy_stage(cfg, 10_000)["bound_s"] == pytest.approx(bound)
    assert module.read(ctx) == pytest.approx(100.0 * bound / 30e-6)
