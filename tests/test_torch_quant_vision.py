"""The port's int8 PTQ (models/quant_vision.py) against runia_core_tpu's.

Flax ResNets of 8 filters with every weight and batch statistic randomised
(a fresh init would fold each block's last conv to zero codes) are carried
across with ``resnet_from_flax``. Tolerances:

- the f32 BN-folded mirror against JAX's and against the port's own model:
  1e-4 (JAX's own bar; the convolutions sum in other orders);
- ``w_q`` bit for bit; ``w_scale`` and ``bias`` 1e-6 relative (both fold in
  f32 in numpy's operation order, so they come out equal);
- ``x_scale``: the percentile follows the JAX calibration's f32 arithmetic,
  so the stem's (whose input is the images themselves) is equal; deeper
  sites read activations of f32 convolutions summed in other orders (a few
  ulps apart), so their percentiles may differ by as much: at most
  ``X_SCALE_ULPS``;
- the int8 forward with JAX's ``qparams`` put in: logits and taps 1e-5 of
  their largest magnitude. The int32 sums are exact on both sides; the f32
  activations between convs differ by summation order, so a code can flip
  at a rounding boundary, one step of ``x_scale``: none did at these sizes;
- the float-vs-int8 bars are those of tests/test_quant_vision.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from runia_core_tpu.models import quantize_resnet as jax_quantize_resnet
from runia_core_tpu.models import quantize_resnet_params as jax_quantize_resnet_params
from runia_core_tpu.models import resnet as jax_resnet
from runia_core_tpu.models.quant_vision import _float_forward as jax_float_forward
from runia_core_tpu_torch.detectors import MDLatentSpace
from runia_core_tpu_torch.evaluation import torch_auroc
from runia_core_tpu_torch.models import build_tapped_forward, quantize_resnet, quantize_resnet_params, resnet_from_flax
from runia_core_tpu_torch.models import resnet as torch_resnet
from runia_core_tpu_torch.models.quant_vision import _float_forward, _weight_matrix, int8_conv, jax_percentile

from test_torch_resnet import randomize

torch.set_num_threads(1)

X_SCALE_ULPS = 4
TAPS = ("stem", "block2", "pre_pool", "penultimate")
CONFIGS = {
    # name: (flax kwargs, port kwargs, image size)
    "rn18_cifar": (dict(stage_sizes=(2, 2, 2, 2), block_cls=jax_resnet.ResNetBlock, cifar_stem=True),
                   dict(stage_sizes=(2, 2, 2, 2), block_cls=torch_resnet.ResNetBlock, cifar_stem=True), 16),
    "bottleneck_imagenet_stem": (
        dict(stage_sizes=(1, 1, 1), block_cls=jax_resnet.BottleneckResNetBlock),
        dict(stage_sizes=(1, 1, 1), block_cls=torch_resnet.BottleneckResNetBlock), 32),
    "basic_torch_padding": (
        dict(stage_sizes=(1, 1, 1), block_cls=jax_resnet.ResNetBlock, torch_padding=True),
        dict(stage_sizes=(1, 1, 1), block_cls=torch_resnet.ResNetBlock, torch_padding=True), 30),
}


@pytest.fixture(scope="module")
def built():
    """name -> (flax model, variables, port model, calibration images,
    test images, JAX's qparams)."""
    out = {}
    for name, (flax_kw, torch_kw, size) in CONFIGS.items():
        rng = np.random.RandomState(0)
        model = jax_resnet.ResNet(num_classes=10, num_filters=8, **flax_kw)
        init = model.init(jax.random.key(0), jnp.zeros((1, size, size, 3)))
        variables = {k: randomize(init[k], rng) for k in ("params", "batch_stats")}
        port = torch_resnet.ResNet(num_classes=10, num_filters=8, device="cpu", **torch_kw)
        port.load_state_dict(resnet_from_flax(variables, device="cpu"))
        calib = rng.rand(24, size, size, 3).astype(np.float32)
        images = rng.rand(6, size, size, 3).astype(np.float32)
        out[name] = (model, variables, port.eval(), calib, images,
                     jax_quantize_resnet_params(model, variables, calib))
    return out


@pytest.fixture(scope="module")
def anchor():
    """tests/test_quant_vision.py's fixture carried across: a (1, 1, 1)
    basic-block ResNet of 16 filters with the CIFAR stem, flax's fresh init."""
    model = jax_resnet.ResNet(stage_sizes=(1, 1, 1), block_cls=jax_resnet.ResNetBlock, num_classes=10,
                              num_filters=16, cifar_stem=True)
    variables = model.init(jax.random.key(0), jnp.zeros((2, 32, 32, 3), jnp.float32))
    port = torch_resnet.ResNet((1, 1, 1), torch_resnet.ResNetBlock, 10, num_filters=16, cifar_stem=True,
                               device="cpu")
    port.load_state_dict(resnet_from_flax(jax.tree_util.tree_map(np.asarray, variables), device="cpu"))
    return port.eval()


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float_mirror_matches_jax_and_the_model(built, name):
    model, variables, port, _, images, _ = built[name]
    want_logits, want_taps = jax_float_forward(model, variables)(images)
    logits, taps = _float_forward(port)(torch.from_numpy(images))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    own_logits, own_taps = build_tapped_forward(port, TAPS)(torch.from_numpy(images))
    np.testing.assert_allclose(logits.numpy(), own_logits.numpy(), rtol=1e-4, atol=1e-4)
    for tap in TAPS:
        np.testing.assert_allclose(taps[tap].numpy(), np.asarray(want_taps[tap]), rtol=1e-4, atol=1e-4, err_msg=tap)
        np.testing.assert_allclose(taps[tap].numpy(), own_taps[tap].numpy(), rtol=1e-4, atol=1e-4, err_msg=tap)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_qparams_match_jax(built, name):
    _, _, port, calib, _, want = built[name]
    got = quantize_resnet_params(port, torch.from_numpy(calib))
    assert sorted(got) == sorted(want)
    for site, p in want.items():
        q = got[site]
        assert q["w_q"].dtype == np.int8 and q["w_q"].shape == p["w_q"].shape, site
        np.testing.assert_array_equal(q["w_q"], p["w_q"], err_msg=site)
        np.testing.assert_allclose(q["w_scale"], p["w_scale"], rtol=1e-6, err_msg=site)
        np.testing.assert_allclose(q["bias"], p["bias"], rtol=1e-6, atol=1e-7, err_msg=site)
        assert q["x_scale"].dtype == np.float32, site
        ulps = abs(int(q["x_scale"].view(np.int32)) - int(np.float32(p["x_scale"]).view(np.int32)))
        assert ulps <= (0 if site == "conv_init" else X_SCALE_ULPS), (site, q["x_scale"], p["x_scale"])


@pytest.mark.parametrize("n,seed", [(1000, 0), (12345, 1), (73728, 0), (100003, 2), (300000, 0)])
def test_percentile_follows_the_jax_calibration(n, seed):
    """Inside JAX's jitted calibration the percentile's q is a constant:
    ``f32(99.9) / f32(100)`` folds to 0.999f, the index and weights are f32,
    and the interpolation is one fused multiply-add. The port reproduces
    that bit for bit, where ``np.percentile`` (an f64 index, two roundings)
    parts from it at (12345, 1)."""
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    want = float(jax.jit(lambda v: jnp.percentile(jnp.abs(v), 99.9))(x))
    got = jax_percentile(torch.from_numpy(np.abs(x)), 99.9)
    assert got == want == float(np.float32(want))
    if (n, seed) == (12345, 1):
        assert float(np.percentile(np.abs(x), 99.9)) != want


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_int8_forward_with_jax_qparams_matches_jax(built, name):
    model, variables, port, _, images, qparams = built[name]
    taps = ("stem", "block1", "pre_pool", "penultimate")
    want_logits, want_taps = jax_quantize_resnet(model, variables, None, taps=taps, qparams=qparams)(images)
    logits, got_taps = quantize_resnet(port, None, taps=taps, qparams=qparams)(torch.from_numpy(images))
    assert logits.dtype == torch.float32 and sorted(got_taps) == sorted(taps)
    assert _rel(logits.numpy(), want_logits) <= 1e-5
    for tap in taps:
        assert got_taps[tap].dtype == torch.float32
        assert _rel(got_taps[tap].numpy(), want_taps[tap]) <= 1e-5, tap


def _int_conv_reference(xq, w_q, stride, padding):
    """The int32 convolution in f64 (exact: every partial sum is an integer
    below 2^53)."""
    (h_lo, h_hi), (w_lo, w_hi) = padding
    x = F.pad(xq.double().permute(0, 3, 1, 2), (w_lo, w_hi, h_lo, h_hi))
    y = F.conv2d(x, w_q.double().permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1).round().to(torch.int32)


@pytest.mark.parametrize("b,h,cin,cout,k,stride,padding", [
    (2, 8, 3, 8, 3, 1, ((1, 1), (1, 1))),  # the CIFAR stem: depth 27 padded to 32
    (1, 4, 16, 12, 3, 2, ((0, 1), (0, 1))),  # 4 rows (< 17) and 12 outputs padded to 16
    (2, 6, 16, 32, 1, 2, ((0, 0), (0, 0))),  # a strided 1x1 projection
    (2, 4, 16, 24, 1, 1, ((0, 0), (0, 0))),  # a 1x1 conv: the codes themselves are the patches
    (1, 9, 5, 8, 7, 2, ((3, 3), (3, 3))),  # a 7x7/2 stem
])
def test_int8_conv_sums_exactly_in_int32(b, h, cin, cout, k, stride, padding):
    rng = np.random.RandomState(h + k)
    xq = torch.from_numpy(rng.randint(-127, 128, (b, h, h, cin)).astype(np.int8))
    w_q = torch.from_numpy(rng.randint(-127, 128, (k, k, cin, cout)).astype(np.int8))
    got = int8_conv(xq, _weight_matrix(w_q), (k, k), cout, stride, padding)
    want = _int_conv_reference(xq, w_q, stride, padding)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


def test_int8_conv_sums_beyond_f32_exactly():
    """|sums| past 2^24, where an f32 convolution of the codes would round."""
    xq = torch.full((1, 4, 4, 512), 127, dtype=torch.int8)
    w_q = torch.full((3, 3, 512, 8), 127, dtype=torch.int8)
    w_q[0, 0, 0, 0] = 126
    got = int8_conv(xq, _weight_matrix(w_q), (3, 3), 8, 1, ((1, 1), (1, 1)))
    assert int(got[0, 1, 1, 1]) == 127 * 127 * 9 * 512 > 2**24
    assert int(got[0, 1, 1, 0]) == 127 * 127 * 9 * 512 - 127
    assert torch.equal(got, _int_conv_reference(xq, w_q, 1, ((1, 1), (1, 1))))


def test_refuses_what_the_structural_walk_does_not_model():
    calib = torch.rand(2, 16, 16, 3)
    s2d = torch_resnet.ResNet18(num_classes=10, num_filters=8, s2d_stem=True, device="cpu")
    with pytest.raises(NotImplementedError, match="space-to-depth"):
        quantize_resnet_params(s2d, calib)
    for kw in (dict(output_stride=8), dict(include_head=False)):
        model = torch_resnet.ResNet18(num_classes=10, num_filters=8, cifar_stem=True, device="cpu", **kw)
        with pytest.raises(NotImplementedError, match="plain classification"):
            quantize_resnet(model, calib)


def test_given_qparams_skip_calibration_and_equal_the_calibrated_forward(built):
    _, _, port, calib, images, _ = built["rn18_cifar"]
    qparams = quantize_resnet_params(port, torch.from_numpy(calib))
    stem = qparams["conv_init"]
    assert stem["w_q"].dtype == np.int8 and stem["w_scale"].shape == (8,) and np.all(np.abs(stem["w_q"]) <= 127)
    x = torch.from_numpy(images)
    from_qparams = quantize_resnet(port, None, qparams=qparams)(x)
    calibrated = quantize_resnet(port, torch.from_numpy(calib))(x)
    assert torch.equal(from_qparams[0], calibrated[0])
    assert torch.equal(from_qparams[1]["pre_pool"], calibrated[1]["pre_pool"])
    assert from_qparams[1]["pre_pool"].shape == (6, 2, 2, 64)


def test_quantile_clips_outliers(built):
    _, _, port, calib, _, _ = built["rn18_cifar"]
    calib = calib.copy()
    calib[0, 0, 0, 0] = 1e4  # one absurd pixel must not blow the scale
    clipped = quantize_resnet_params(port, torch.from_numpy(calib), act_quantile=99.9)
    top = quantize_resnet_params(port, torch.from_numpy(calib), act_quantile=100.0)
    assert clipped["conv_init"]["x_scale"] < top["conv_init"]["x_scale"] / 10


def test_logits_and_taps_track_the_float_model(anchor):
    """The bars of tests/test_quant_vision.py::test_logits_and_taps_track_float."""
    port = anchor
    rng = np.random.RandomState(2)
    calib = torch.from_numpy(rng.rand(64, 32, 32, 3).astype(np.float32))
    x = torch.from_numpy(rng.rand(32, 32, 32, 3).astype(np.float32))
    logits_q, taps_q = quantize_resnet(port, calib, taps=("pre_pool", "penultimate"))(x)
    logits_f, taps_f = build_tapped_forward(port, ("pre_pool", "penultimate"))(x)
    agree = float((logits_q.argmax(-1) == logits_f.argmax(-1)).float().mean())
    assert agree >= 0.9, agree
    rel = float(torch.linalg.norm(taps_q["penultimate"] - taps_f["penultimate"])
                / (torch.linalg.norm(taps_f["penultimate"]) + 1e-12))
    assert rel < 0.15, rel
    corr = np.corrcoef(taps_q["pre_pool"].numpy().ravel(), taps_f["pre_pool"].numpy().ravel())[0, 1]
    assert corr > 0.99, corr


def test_ood_separability_survives_quantization(anchor):
    """The bar of tests/test_quant_vision.py::test_ood_separability_preserved:
    Mahalanobis on the penultimate features, InD uniform images against
    ``rand * 2.5 - 0.75``."""
    port = anchor
    rng = np.random.RandomState(3)
    ind = torch.from_numpy(rng.rand(96, 32, 32, 3).astype(np.float32))
    ood = torch.from_numpy((rng.rand(96, 32, 32, 3) * 2.5 - 0.75).astype(np.float32))
    forwards = {"f32": build_tapped_forward(port, ("penultimate",)),
                "int8": quantize_resnet(port, ind[:64], taps=("penultimate",))}

    def auroc(forward):
        feats_ind, feats_ood = forward(ind)[1]["penultimate"], forward(ood)[1]["penultimate"]
        md = MDLatentSpace()
        md.setup(feats_ind[:64])
        return float(torch_auroc(md.postprocess(feats_ind[64:]), md.postprocess(feats_ood)))

    a_f, a_q = auroc(forwards["f32"]), auroc(forwards["int8"])
    assert a_f > 0.9, a_f
    assert abs(a_f - a_q) < 0.05, (a_f, a_q)
