"""The port's ResNet against the flax ResNet of runia_core_tpu, on the same
weights carried across with resnet_from_flax.

Every parameter and batch statistic is randomised first: a fresh flax init
sets the last norm of each block to scale 0 and the stats to (0, 1), which
would hide a broken residual branch. Both sides run f32; the convolutions
sum in other orders (about 1e-6 relative per layer), so outputs agree to
1e-4 of their largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.models import resnet as jax_resnet
from runia_core_tpu_torch.models import build_tapped_forward, resnet_from_flax
from runia_core_tpu_torch.models import resnet as torch_resnet
from runia_core_tpu_torch.models.resnet import same_padding

torch.set_num_threads(1)

TAPS = ("stem", "block1", "block2", "pre_pool", "penultimate")


def randomize(tree, rng):
    """Random values for every leaf of a flax params / batch_stats tree."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out[name] = randomize(value, rng)
            continue
        value = np.asarray(value)
        if name == "kernel":
            out[name] = (value + 0.05 * rng.randn(*value.shape)).astype(np.float32)
        elif name in ("scale", "var"):
            out[name] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        else:  # bias, mean
            out[name] = (0.1 * rng.randn(*value.shape)).astype(np.float32)
    return out


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


CASES = {
    # name: (flax constructor kwargs, port constructor, image size)
    "rn18_cifar": (dict(stage_sizes=(2, 2, 2, 2), block_cls=jax_resnet.ResNetBlock, cifar_stem=True),
                   dict(stage_sizes=(2, 2, 2, 2), block_cls=torch_resnet.ResNetBlock, cifar_stem=True), 32),
    "rn18_standard_stem": (dict(stage_sizes=(2, 2, 2, 2), block_cls=jax_resnet.ResNetBlock),
                           dict(stage_sizes=(2, 2, 2, 2), block_cls=torch_resnet.ResNetBlock), 32),
    "bottleneck_torch_padding": (
        dict(stage_sizes=(1, 1, 1), block_cls=jax_resnet.BottleneckResNetBlock, torch_padding=True),
        dict(stage_sizes=(1, 1, 1), block_cls=torch_resnet.BottleneckResNetBlock, torch_padding=True), 30),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_and_taps_match_flax(case):
    flax_kw, torch_kw, size = CASES[case]
    rng = np.random.RandomState(0)
    images = rng.rand(2, size, size, 3).astype(np.float32)
    model = jax_resnet.ResNet(num_classes=10, num_filters=8, **flax_kw)
    init = model.init(jax.random.key(0), jnp.asarray(images))
    variables = {name: randomize(init[name], rng) for name in ("params", "batch_stats")}
    want_logits, want_taps = model.apply(variables, jnp.asarray(images))

    port = torch_resnet.ResNet(num_classes=10, num_filters=8, device="cpu", **torch_kw)
    port.load_state_dict(resnet_from_flax(variables, device="cpu"), strict=True)
    logits, taps = build_tapped_forward(port, TAPS)(torch.from_numpy(images))
    _close(logits.numpy(), np.asarray(want_logits))
    for name in TAPS:
        assert taps[name].shape == want_taps[name].shape, name
        _close(taps[name].numpy(), np.asarray(want_taps[name]))


def test_same_padding_is_xla_same():
    assert same_padding(32, 3, 2) == (0, 1)  # asymmetric on even inputs
    assert same_padding(31, 3, 2) == (1, 1)
    assert same_padding(32, 3, 1) == (1, 1)
    assert same_padding(32, 1, 2) == (0, 0)
    assert same_padding(16, 3, 2, dilation=2) == (1, 2)


def test_channel_first_taps_and_bf16_compute():
    port = torch_resnet.ResNet18(num_classes=10, cifar_stem=True, num_filters=8, device="cpu")
    port.init_weights(torch.Generator().manual_seed(0))
    images = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    _, taps = build_tapped_forward(port, ("pre_pool",), channel_first_taps=True)(images)
    assert taps["pre_pool"].shape == (2, 64, 2, 2)
    port.dtype = torch.bfloat16
    logits, taps = build_tapped_forward(port)(images)
    assert logits.dtype == torch.bfloat16 and taps["pre_pool"].dtype == torch.bfloat16
    assert port.conv_init.weight.dtype == torch.float32  # parameters stay f32
    assert bool(torch.isfinite(logits).all())
