"""Forward-hook taps (``extraction.taps``) against runia_core_tpu's
``tap_flax_model``.

The parity case taps the same layer of a narrow ResNet-18 (8 filters, 16 px)
in both frameworks, the port's weights carried across from flax with
``resnet_from_flax``: the port's block outputs are NCHW, flax's NHWC, so the
port's tap is compared after a permute, to 1e-5 relative (the forwards'
f32 sums run in other orders, ``tests/test_torch_resnet.py``).
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from runia_core_tpu.extraction import Hook as JaxHook
from runia_core_tpu.extraction import apply_dropout as jax_apply_dropout
from runia_core_tpu.extraction import tap_flax_model
from runia_core_tpu.models import ResNet18 as JaxResNet18
from runia_core_tpu_torch.extraction import Hook, apply_dropout, tap_torch_model
from runia_core_tpu_torch.models import ResNet18, build_tapped_forward, resnet_from_flax

torch.set_num_threads(1)


class Plain(nn.Module):
    """A model with no taps of its own; ``conv1`` runs twice."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 3, 3, padding=1)
        self.conv2 = nn.Conv2d(3, 8, 3, padding=1)
        self.drop = nn.Dropout(0.5)
        self.head = nn.Sequential(nn.Linear(8, 6), nn.Dropout1d(0.2), nn.Linear(6, 4))

    def forward(self, x):
        x = torch.relu(self.conv1(torch.relu(self.conv1(x))))
        x = torch.relu(self.conv2(x)).mean(dim=(2, 3))
        return self.head(self.drop(x))


@pytest.fixture(scope="module")
def plain():
    torch.manual_seed(0)
    return Plain().eval()


def _images(seed, n=2, size=8):
    return torch.from_numpy(np.random.RandomState(seed).rand(n, 3, size, size).astype(np.float32))


def test_capture_by_substring(plain):
    out, taps = tap_torch_model(plain, ("conv2", "head"), device="cpu")(_images(0))
    assert out.shape == (2, 4)
    assert list(taps) == ["conv2", "head", "head.0", "head.1", "head.2"]
    assert taps["conv2"].shape == (2, 8, 8, 8) and torch.equal(taps["head"], out)


def test_capture_by_filter_and_the_last_of_two_calls(plain):
    x = _images(1)
    _, taps = tap_torch_model(plain, lambda module, name: isinstance(module, nn.Conv2d), device="cpu")(x)
    assert list(taps) == ["conv1", "conv2"]
    with torch.no_grad():
        first = plain.conv1(x)
        second = plain.conv1(torch.relu(first))
    assert torch.equal(taps["conv1"], second) and not torch.equal(taps["conv1"], first)


def test_alias_takes_the_first_match_and_hooks_do_not_stay(plain):
    forward = tap_torch_model(plain, ("head",), tap_aliases={"logits": "head", "fc": "head.0"}, device="cpu")
    out, taps = forward(_images(2))
    assert taps["logits"] is taps["head"] and taps["fc"] is taps["head.0"]
    assert all(not m._forward_hooks for m in plain.modules())
    again = forward(_images(3))[1]
    assert not torch.equal(again["head"], taps["head"])  # each call returns its own taps


def test_inputs_move_to_the_device_asked():
    seen = []
    module = nn.Identity()
    module.register_forward_pre_hook(lambda m, args: seen.append(args[0].device))
    tap_torch_model(module, (), device="cpu")(np.zeros((1, 2), np.float32))
    assert seen == [torch.device("cpu")]


def test_hook_copies_and_closes():
    for cls in (Hook, JaxHook):
        hook = cls("pre_pool")
        assert hook.output is None and hook.input is None
    taps = {"pre_pool": torch.ones(2, 3)}
    hook = Hook("pre_pool").capture(taps)
    taps["pre_pool"].add_(1.0)  # a later replay overwrites the graph's buffer
    assert torch.equal(hook.output, torch.ones(2, 3))
    hook.close()
    assert hook.output is None
    with pytest.raises(AssertionError) as want:
        JaxHook("x", backward=True)
    with pytest.raises(ValueError) as got:
        Hook("x", backward=True)
    assert str(got.value) == str(want.value)


def test_apply_dropout_switches_only_the_dropouts(plain):
    model = Plain().eval()
    assert apply_dropout(model) is model and jax_apply_dropout(model) is model
    modes = {name: m.training for name, m in model.named_modules()}
    assert modes["drop"] and modes["head.1"]
    assert not any(modes[n] for n in ("", "conv1", "conv2", "head", "head.0", "head.2"))
    x = _images(4)
    with torch.no_grad():
        assert not torch.equal(model(x), model(x))  # dropout is live: MC samples differ


@pytest.fixture(scope="module")
def resnets():
    rng = np.random.RandomState(0)
    model = JaxResNet18(num_classes=5, cifar_stem=True, num_filters=8)
    variables = model.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)))
    variables = jax.tree_util.tree_map(lambda v: np.asarray(v) + 0.05 * rng.randn(*np.shape(v)).astype(np.float32),
                                       {k: variables[k] for k in ("params", "batch_stats")})
    variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    port = ResNet18(num_classes=5, cifar_stem=True, num_filters=8, device="cpu")
    port.load_state_dict(resnet_from_flax(variables, device="cpu"))
    images = rng.rand(3, 16, 16, 3).astype(np.float32)
    return model, variables, port.eval(), images


def test_resnet_tap_matches_build_tapped_forward_and_jax(resnets):
    model, variables, port, images = resnets
    forward = tap_torch_model(port, ("stage4_block1",), tap_aliases={"pre_pool": "stage4_block1"}, device="cpu")
    (logits, _), taps = forward(torch.from_numpy(images))
    assert list(taps)[0] == "stage4_block1" and taps["pre_pool"] is taps["stage4_block1"]
    built_logits, built = build_tapped_forward(port)(torch.from_numpy(images))
    assert torch.equal(taps["pre_pool"].permute(0, 2, 3, 1), built["pre_pool"])
    assert torch.equal(logits, built_logits)
    jax_forward = tap_flax_model(model, variables, capture=lambda mdl, _: mdl.path == ("stage4_block1",),
                                 tap_aliases={"pre_pool": "stage4_block1"}, train=False)
    _, want = jax_forward(jnp.asarray(images))
    want = np.asarray(want["pre_pool"])
    got = taps["pre_pool"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
