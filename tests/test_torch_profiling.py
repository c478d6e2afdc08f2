"""Timing and profiling of the port (``utils/profiling.py``) against the JAX
package's: the benchmark's contract (warm-up clamped to 1, the median of
its windows, the last result), the CUDA-only timer, the per-stage
truncation of a forward (the tap a truncated forward returns equals the JAX
model's tap) and the profiler trace."""

import contextlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.models import ResNet as JaxResNet
from runia_core_tpu.models.resnet import ResNetBlock as JaxResNetBlock
from runia_core_tpu.utils import benchmark as jax_benchmark
from runia_core_tpu_torch.models import ResNet, resnet_from_flax
from runia_core_tpu_torch.models.resnet import ResNetBlock
from runia_core_tpu_torch.utils import benchmark, cuda_profile, profile_taps, sync, trace_annotation
from runia_core_tpu_torch.utils import profiling
from runia_core_tpu_torch.utils.profiling import truncated_forward

torch.set_num_threads(1)

IMG = 16


class _HostClock:
    """Stand-in for ``cuda_time_ms`` on a host without a GPU: runs the
    calls as it would and answers the next of ``ms``."""

    def __init__(self, ms):
        self.ms, self.calls = list(ms), []

    def __call__(self, fn, iters=20, warmup=3):
        self.calls.append((iters, warmup))
        for _ in range(warmup + iters):
            fn()
        return self.ms.pop(0)


def test_benchmark_returns_the_median_window_and_the_last_result(monkeypatch):
    clock = _HostClock([3.0, 1.0, 2.0])
    monkeypatch.setattr(profiling, "cuda_time_ms", clock)
    counter = []
    result, seconds = benchmark(lambda x: counter.append(x) or len(counter), 7, iters=4, warmup=0, windows=3)
    assert seconds == pytest.approx(2e-3)
    assert clock.calls == [(4, 1), (4, 0), (4, 0)]  # warm-up clamped to 1, in the first window only
    assert result == len(counter) == 13
    jax_result, jax_seconds = jax_benchmark(lambda x: x * 2, jnp.ones(3), iters=2, warmup=0, windows=1)
    assert np.asarray(jax_result).tolist() == (2 * torch.ones(3)).tolist() and jax_seconds > 0


def test_benchmark_and_profile_taps_need_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")
    with pytest.raises(RuntimeError, match="CUDA device"):
        benchmark(lambda: torch.ones(2))
    with pytest.raises(RuntimeError, match="CUDA device"):
        profile_taps(torch.nn.Sequential(torch.nn.Linear(2, 2)), torch.ones(1, 2))


def test_sync_leaves_cpu_tensors_alone(monkeypatch):
    def refuse(*args):
        raise AssertionError("synchronized a CPU result")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    sync({"a": (torch.ones(2), [torch.zeros(1), 3])})


@pytest.fixture(scope="module")
def models():
    """A narrow JAX ResNet (CIFAR stem, two stages) with seeded random
    variables, and the port's copy of it."""
    rng = np.random.RandomState(0)
    jax_model = JaxResNet(stage_sizes=(1, 1), block_cls=JaxResNetBlock, num_classes=4, num_filters=8,
                          cifar_stem=True)
    shapes = jax.eval_shape(jax_model.init, jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                (rng.uniform(0.5, 1.5, v.shape) if k in ("scale", "var") else 0.3 * rng.randn(*v.shape))
                .astype(np.float32) for k, v in tree.items()}

    variables = {name: fill(shapes[name]) for name in ("params", "batch_stats")}
    port = ResNet((1, 1), ResNetBlock, 4, num_filters=8, cifar_stem=True, device="cpu")
    port.load_state_dict(resnet_from_flax(variables, device="cpu"))
    images = rng.rand(2, IMG, IMG, 3).astype(np.float32)
    return jax_model, variables, port, images


@pytest.mark.parametrize("submodule, jax_tap", [("stage1_block0", "block1"), ("stage2_block0", "block2")])
def test_a_truncated_forward_returns_the_jax_models_tap(models, submodule, jax_tap):
    """Cut after a block, the forward returns that block's output (NCHW),
    the JAX model's tap of the same stage, to 1e-5 of its largest value;
    nothing after the cut runs."""
    jax_model, variables, port, images = models
    _, jax_taps = jax_model.apply(variables, jnp.asarray(images))
    later = []
    handle = port.stage2_block0.register_forward_hook(lambda *a: later.append(1))
    try:
        got = truncated_forward(port, submodule)(torch.from_numpy(images)).permute(0, 2, 3, 1).numpy()
    finally:
        handle.remove()
    want = np.asarray(jax_taps[jax_tap])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert later == ([1] if submodule == "stage2_block0" else [])
    with pytest.raises(ValueError, match="never reached"):
        truncated_forward(port, "head")(torch.from_numpy(images))  # the ResNet applies its head by F.linear


def test_profile_taps_times_every_called_stage_in_order(models, monkeypatch):
    _, _, port, images = models
    monkeypatch.setattr(profiling, "cuda_time_ms", _HostClock([0.1] * 3 + [0.2] * 3 + [0.3] * 3 + [0.4] * 3))
    stages = profile_taps(port, torch.from_numpy(images), iters=2, warmup=1)
    assert list(stages) == ["conv_init", "bn_init", "stage1_block0", "stage2_block0"]
    assert [round(s * 1e3, 6) for s in stages.values()] == [0.1, 0.2, 0.3, 0.4]


def test_cuda_profile_writes_a_trace_with_the_annotation(tmp_path):
    with cuda_profile(str(tmp_path)) as log_dir:
        with trace_annotation("runia_stage"):
            torch.ones(8) @ torch.ones(8)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert log_dir == str(tmp_path)
    assert any(event.get("name") == "runia_stage" for event in trace["traceEvents"])


def _raise(*args, **kwargs):
    raise AssertionError("called with the spans off")


def test_a_span_off_opens_no_record_function_reads_no_clock_and_allocates_nothing(monkeypatch):
    import tracemalloc

    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(profiling.time, "perf_counter_ns", _raise)
    assert profiling.span("runia.a") is profiling.span("runia.b", batch=3)  # one shared null context
    assert profiling.trace_annotation is profiling.span

    def spans(n):
        for _ in range(n):
            with profiling.span("runia.service.submit", batch=7):
                with profiling.span("runia.scorer.call"):
                    pass

    spans(10)
    tracemalloc.start()
    try:
        start, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        spans(10_000)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak - start < 1024  # not one object a span: 20,000 spans would take 20,000 x 56 bytes or more
    with contextlib.ExitStack() as stack:
        with profiling.span("runia.service.score_dataset"):  # entered off, it ends inside a recording
            monkeypatch.undo()
            rec = stack.enter_context(profiling.recording())
            assert profiling.current_span() is None
    assert rec.spans == []


def test_nested_spans_give_parent_trace_and_self_ms(monkeypatch):
    """A root of 100 ms with a child at 10-30 ms, and another at 40-90 ms
    holding a grandchild at 50-60 ms; a span of another thread given the
    root as its parent at 20-70 ms. Self ms is what no child covers."""
    import threading

    ticks = iter([0, 10, 30, 40, 50, 60, 90, 100, 20, 70])
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(ticks) * 1_000_000)
    with profiling.recording() as rec:
        with profiling.span("runia.root") as root:
            with profiling.span("runia.a", batch=0):
                pass
            with profiling.span("runia.b", batch=1):
                assert profiling.current_span().name == "runia.b"
                with profiling.span("runia.c"):
                    pass
        assert profiling.current_span() is None

        def worker():
            with profiling.span("runia.worker", batch=5, parent=root):
                pass

        thread = threading.Thread(target=worker)
        thread.start()
        thread.join(timeout=10)
        assert not thread.is_alive()
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["runia.a", "runia.c", "runia.b", "runia.root", "runia.worker"]
    assert by["runia.root"].parent is None and {s.trace for s in rec.spans} == {by["runia.root"].id}
    assert by["runia.a"].parent == by["runia.b"].parent == by["runia.worker"].parent == by["runia.root"].id
    assert by["runia.c"].parent == by["runia.b"].id
    assert (by["runia.a"].batch, by["runia.b"].batch, by["runia.c"].batch, by["runia.worker"].batch) == (0, 1, None, 5)
    assert by["runia.worker"].thread != by["runia.root"].thread == threading.get_ident()
    summary = rec.summary()
    # The root's children cover 10-30 and 40-90 on its thread and 20-70 on the other: 10-90 in all.
    assert summary["runia.root"] == {"count": 1, "total_ms": pytest.approx(100.0), "self_ms": pytest.approx(20.0)}
    assert summary["runia.b"] == {"count": 1, "total_ms": pytest.approx(50.0), "self_ms": pytest.approx(40.0)}
    assert summary["runia.a"]["self_ms"] == pytest.approx(20.0)


def test_spans_are_user_annotations_in_the_profilers_trace(tmp_path):
    with profiling.recording() as rec:
        with cuda_profile(str(tmp_path)):
            with profiling.span("runia.service.score_dataset"):
                with profiling.span("runia.service.submit", batch=0):
                    torch.ones(8) @ torch.ones(8)
                with trace_annotation("runia.service.fetch", batch=0):
                    pass
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = ["runia.service.score_dataset", "runia.service.submit", "runia.service.fetch"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(names) <= annotated
    assert sorted(s.name for s in rec.spans) == sorted(names)  # recorded under the profiler too


def test_a_recording_counts_captures_and_launches_over_its_life(monkeypatch):
    from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda
    from runia_core_tpu_torch.ops.mc_entropy_cuda import fused_mc_entropy
    from runia_core_tpu_torch.utils.graphs import CudaGraph

    monkeypatch.setattr(CudaGraph, "captures", 5)
    monkeypatch.setattr(marginal_entropy_cuda, "launches", 9)
    monkeypatch.setattr(fused_mc_entropy, "launches", 2)
    monkeypatch.setattr(conv_epilogue, "launches", 4)
    with profiling.recording() as outer:
        CudaGraph.captures += 1
        with profiling.recording() as inner:
            marginal_entropy_cuda.launches += 3
            conv_epilogue.launches += 17
        fused_mc_entropy.launches += 1
    llm = {"moe_grouped.launches": 0, "flash_prefix_attention.launches": 0,
           "flash_prefix_attention.window_launches": 0}
    assert inner.counters == {"CudaGraph.captures": 0, "marginal_entropy_cuda.launches": 3,
                              "fused_mc_entropy.launches": 0, "conv_epilogue.launches": 17, **llm}
    assert outer.counters == {"CudaGraph.captures": 1, "marginal_entropy_cuda.launches": 3,
                              "fused_mc_entropy.launches": 1, "conv_epilogue.launches": 17, **llm}


def test_spans_of_many_threads_all_reach_the_recording():
    """More threads than cores, a short switch interval: every span of
    every thread is recorded once, under its own thread's root."""
    import os
    import sys
    import threading

    threads, per = 2 * (os.cpu_count() or 4), 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            def work():
                with profiling.span("runia.root"):
                    for i in range(per):
                        with profiling.span("runia.leaf", batch=i):
                            pass

            workers = [threading.Thread(target=work) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    roots = {s.id: s.thread for s in rec.spans if s.name == "runia.root"}
    leaves = [s for s in rec.spans if s.name == "runia.leaf"]
    assert len(roots) == threads and len(leaves) == threads * per
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    assert all(s.parent == s.trace and roots[s.parent] == s.thread for s in leaves)
