"""Timing and profiling of the port (``utils/profiling.py``) against the JAX
package's: the benchmark's contract (warm-up clamped to 1, the median of
its windows, the last result), the CUDA-only timer, the per-stage
truncation of a forward (the tap a truncated forward returns equals the JAX
model's tap) and the profiler trace."""

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
