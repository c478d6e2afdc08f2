"""The port's DeepLabv3+ (``models/deeplab.py``) and per-pixel uncertainty
scorer (``inference/segmentation.py``) against the JAX package, on the CPU.

A small JAX ``DeepLabV3Plus`` (tests/test_deeplab.py's ``SMALL`` widths)
with its parameters and BatchNorm statistics randomised from a seed is
carried across by ``deeplab_from_flax``; logits and every tap must agree
within 1e-4 of their largest magnitude (f32), at output strides 16 and 8
and with a three-stage backbone. The scorer is held to JAX's at atol 1e-4
(tests/test_deeplab.py's bar for its ``pred_h``): its ``apply_fn`` returns,
for the i-th call, JAX's stochastic forward under the i-th key of
``jax.random.split(key, S)``, computed outside ``jit``, so both sides
decompose the same S logit maps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.inference import build_pixel_uncertainty_scorer as jax_pixel_scorer
from runia_core_tpu.models import DeepLabV3Plus as JaxDeepLab
from runia_core_tpu.models.resnet import ResNetBlock as JaxResNetBlock
from runia_core_tpu_torch.inference import build_pixel_uncertainty_scorer
from runia_core_tpu_torch.models import DeepLabV3Plus, deeplab_from_flax
from runia_core_tpu_torch.models.resnet import ResNetBlock

torch.set_num_threads(1)

IMG = 64
REL = 1e-4
SMALL = dict(num_filters=8, aspp_features=16, low_level_features=8)
CASES = {  # name -> (JAX kwargs without the block class, port kwargs)
    "os16": dict(num_classes=5, output_stride=16, backbone_stages=(1, 1, 1, 1), aspp_rates=(2, 4), **SMALL),
    "os8": dict(num_classes=3, output_stride=8, backbone_stages=(1, 1, 1, 1), aspp_rates=(2, 4), **SMALL),
    "three_stages": dict(num_classes=3, output_stride=16, backbone_stages=(1, 1, 1), aspp_rates=(2,), **SMALL),
}
TAPS = ("stem", "block1", "block2", "block3", "aspp", "pre_pool", "penultimate", "decoder")


def _randomize(tree, rng):
    """Every leaf replaced by seeded values of its shape: kernels and biases
    N(0, 0.2), BatchNorm scales and variances in [0.5, 1.5), means 0.1 N."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict) or hasattr(leaf, "items"):
            out[name] = _randomize(leaf, rng)
        elif name in ("scale", "var"):
            out[name] = (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        elif name == "mean":
            out[name] = (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        else:
            out[name] = (0.2 * rng.randn(*leaf.shape)).astype(np.float32)
    return out


def _jax_model(case, **extra):
    return JaxDeepLab(backbone_block=JaxResNetBlock, **CASES[case], **extra)


_PAIRS = {}


def _pair(case):
    """(case, JAX model, randomised numpy variables, the port's model), built
    once per case."""
    if case not in _PAIRS:
        _PAIRS[case] = _build_pair(case)
    return _PAIRS[case]


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def os16():
    return _pair("os16")


def _build_pair(case):
    model = _jax_model(case)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))
    variables = _randomize(dict(shapes), np.random.RandomState(1))
    port = DeepLabV3Plus(backbone_block=ResNetBlock, device="cpu", **CASES[case])
    port.load_state_dict(deeplab_from_flax(variables, device="cpu"))
    return case, model, variables, port


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def test_forward_and_taps_match_jax(pair):
    case, model, variables, port = pair
    x = np.random.RandomState(2).rand(2, IMG, IMG, 3).astype(np.float32)
    want_logits, want_taps = jax.jit(model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        logits, taps = port(torch.from_numpy(x))
    _close(logits, want_logits)
    assert set(taps) == set(want_taps)
    for name in TAPS:
        if name in want_taps:
            _close(taps[name], want_taps[name])
    assert taps["pre_pool"] is taps["aspp"]
    assert ("block4" in taps) == (case != "three_stages")
    n = len(CASES[case]["backbone_stages"])
    assert taps[f"block{n}"].shape[1] == IMG // CASES[case]["output_stride"]


def test_a_single_stage_backbone_is_refused_as_in_jax():
    with pytest.raises(ValueError, match=">= 2 stages"):
        DeepLabV3Plus(backbone_stages=(1,), backbone_block=ResNetBlock, device="cpu")
    with pytest.raises(ValueError, match=">= 2 stages"):
        JaxDeepLab(backbone_stages=(1,), backbone_block=JaxResNetBlock).init(
            jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))


def test_decoder_dropout_is_active_only_with_a_generator(pair):
    case, _, variables, _ = pair
    port = DeepLabV3Plus(backbone_block=ResNetBlock, dropout_rate=0.5, device="cpu", **CASES[case])
    port.load_state_dict(deeplab_from_flax(variables, device="cpu"))
    x = torch.from_numpy(np.random.RandomState(3).rand(1, IMG, IMG, 3).astype(np.float32))
    with torch.no_grad():
        plain = port(x)[0]
        a = port(x, torch.Generator().manual_seed(5))[0]
        b = port(x, torch.Generator().manual_seed(5))[0]
        c = port(x, torch.Generator().manual_seed(6))[0]
    assert torch.equal(plain, port(x)[0]) and torch.equal(a, b)
    assert not torch.allclose(a, plain) and not torch.allclose(a, c)


def test_pixel_scorer_matches_jax_on_the_same_draws(os16):
    case, _, variables, port = os16
    s = 4
    mc_model = _jax_model(case, dropout_rate=0.5)
    x = jnp.asarray(np.random.RandomState(4).rand(2, IMG, IMG, 3).astype(np.float32))
    key = jax.random.key(7)
    want = jax_pixel_scorer(lambda images, k: mc_model.apply(variables, images, rngs={"dropout": k}),
                            mc_samples=s)(x, key)
    draws = [np.array(mc_model.apply(variables, x, rngs={"dropout": k})[0]) for k in jax.random.split(key, s)]
    calls = []

    def apply_fn(images, generator):
        calls.append(generator)
        return torch.from_numpy(draws[len(calls) - 1]), {}

    got = build_pixel_uncertainty_scorer(apply_fn, mc_samples=s)(torch.from_numpy(np.array(x)),
                                                                 torch.Generator().manual_seed(0))
    assert len(calls) == s
    for name in ("pred_h", "mi", "msp"):
        assert got[name].shape == (2, IMG, IMG) and got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=1e-4)
    assert got["pred"].dtype == torch.int32
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(want["pred"]))
    assert float(got["mi"].max()) > 1e-4  # the draws disagree


def test_pixel_scorer_on_the_port_model(os16):
    """With the port's own dropout: finite maps, MI >= 0 up to f32 noise and
    positive somewhere; the deterministic model's MI collapses and its
    pred_h is the entropy of its one softmax (tests/test_deeplab.py's
    checks)."""
    case, _, variables, port = os16
    mc = DeepLabV3Plus(backbone_block=ResNetBlock, dropout_rate=0.5, device="cpu", **CASES[case])
    mc.load_state_dict(deeplab_from_flax(variables, device="cpu"))
    x = torch.from_numpy(np.random.RandomState(5).rand(2, IMG, IMG, 3).astype(np.float32))
    out = build_pixel_uncertainty_scorer(mc, mc_samples=4)(x, torch.Generator().manual_seed(1))
    assert all(bool(torch.isfinite(out[k]).all()) for k in ("pred_h", "mi", "msp"))
    assert float(out["mi"].min()) > -1e-5 and float(out["mi"].max()) > 1e-4
    det = build_pixel_uncertainty_scorer(lambda images, g: port(images), mc_samples=4)(x)
    assert float(det["mi"].abs().max()) < 1e-5
    with torch.no_grad():
        p = torch.softmax(port(x)[0], dim=-1)
    np.testing.assert_allclose(det["pred_h"].numpy(), (-(p * torch.log(p + 1e-12)).sum(-1)).numpy(), atol=1e-4)
