"""The port's DETR (``models/detr.py``) and the HF DETR adapter
(``extraction/hf_adapters.py``) against transformers and the JAX package,
on the CPU.

One small random ``DetrForObjectDetection`` (tests/test_detr_convert.py's
config, HF-native ResNet backbone) is converted by the port's and by JAX's
``convert_hf_detr``. The port's eval forward is held to HF's and to JAX's
at tests/test_detr_convert.py's tolerances (logits rtol 1e-4 / atol 1e-5,
boxes rtol 1e-4 / atol 1e-6); ``detr_from_flax`` carries JAX's variables
across; ``DetrAdapter`` is held to ``DetrJaxAdapter`` and the port's
``HFDetrAdapter`` to JAX's at that test's adapter tolerances (boxes 1e-3,
scores rtol 1e-4 / atol 1e-5, logits 1e-4, features and fmaps rtol 1e-3 /
atol 1e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from runia_core_tpu.extraction.hf_adapters import HFDetrAdapter as JaxHFDetrAdapter
from runia_core_tpu.models import DetrJaxAdapter as JaxDetrAdapter
from runia_core_tpu.models import convert_hf_detr as jax_convert_hf_detr
from runia_core_tpu_torch.detectors import MDLatentSpace
from runia_core_tpu_torch.extraction import BoxFeaturesExtractor, HFDetrAdapter, cxcywh_to_xyxy
from runia_core_tpu_torch.models import DETR, DetrAdapter, DetrJaxAdapter, ResNet, convert_hf_detr, detr_from_flax
from runia_core_tpu_torch.models.resnet import BottleneckResNetBlock

torch.set_num_threads(1)

IMG = 64
N_QUERIES = 7
N_LABELS = 5
D_MODEL = 32


def _config(**overrides):
    kw = dict(
        use_timm_backbone=False, use_pretrained_backbone=False,
        backbone_config=transformers.ResNetConfig(embedding_size=4, hidden_sizes=[16, 32], depths=[1, 1],
                                                  layer_type="bottleneck"),
        d_model=D_MODEL, encoder_layers=2, decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64, num_queries=N_QUERIES, num_labels=N_LABELS,
    )
    kw.update(overrides)
    return transformers.DetrConfig(**kw)


@pytest.fixture(scope="module")
def hf_detr():
    torch.manual_seed(0)
    model = transformers.DetrForObjectDetection(_config()).eval()
    rng = np.random.RandomState(0)  # non-trivial BatchNorm statistics in the frozen backbone norms
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.from_numpy(0.1 * rng.randn(*buf.shape).astype(np.float32)))
        elif name.endswith("running_var"):
            buf.copy_(torch.from_numpy(rng.rand(*buf.shape).astype(np.float32) + 0.5))
    return model


@pytest.fixture(scope="module")
def converted(hf_detr):
    return convert_hf_detr(hf_detr, device="cpu")


@pytest.fixture(scope="module")
def jax_converted(hf_detr):
    return jax_convert_hf_detr(hf_detr)


def _images(seed, n=2):
    return np.random.RandomState(seed).rand(n, IMG, IMG, 3).astype(np.float32)


def test_forward_matches_hf_eval_and_jax(hf_detr, converted, jax_converted):
    model, state = converted
    x = _images(0)
    with torch.no_grad():
        ref = hf_detr(pixel_values=torch.from_numpy(x.transpose(0, 3, 1, 2)),
                      pixel_mask=torch.ones(2, IMG, IMG, dtype=torch.long))
        outputs, taps = model(torch.from_numpy(x))
    np.testing.assert_allclose(outputs["logits"].numpy(), ref.logits.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(outputs["pred_boxes"].numpy(), ref.pred_boxes.numpy(), rtol=1e-4, atol=1e-6)
    jax_model, variables = jax_converted
    want, want_taps = jax_model.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(outputs["logits"].numpy(), np.asarray(want["logits"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(outputs["pred_boxes"].numpy(), np.asarray(want["pred_boxes"]), rtol=1e-4, atol=1e-6)
    for name in ("backbone_fmap", "encoder_tokens", "decoder_queries"):
        np.testing.assert_allclose(taps[name].numpy(), np.asarray(want_taps[name]), rtol=1e-3, atol=1e-4)
    assert taps["decoder_queries"].shape == (2, N_QUERIES, D_MODEL)
    assert all(t.device.type == "cpu" for t in state.values())


def test_detr_from_flax_carries_jax_variables(jax_converted):
    jax_model, variables = jax_converted
    backbone = ResNet((1, 1), BottleneckResNetBlock, 0, num_filters=4, include_head=False, torch_padding=True,
                      device="cpu")
    model = DETR(backbone, num_labels=N_LABELS, num_queries=N_QUERIES, d_model=D_MODEL, num_heads=4,
                 num_encoder_layers=2, num_decoder_layers=2, ffn_dim=64, device="cpu")
    numpy_vars = {k: jax.tree_util.tree_map(np.asarray, v) for k, v in variables.items()}
    model.load_state_dict(detr_from_flax(numpy_vars, device="cpu"))
    x = _images(1)
    want, _ = jax_model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["pred_boxes"].numpy(), np.asarray(want["pred_boxes"]), rtol=1e-4, atol=1e-6)


def _same_detections(got, want):
    assert got.boxes.shape == want.boxes.shape and got.img_shape == want.img_shape
    np.testing.assert_allclose(got.boxes, want.boxes, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.classes, want.classes)
    np.testing.assert_allclose(got.logits, want.logits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.features, want.features, rtol=1e-3, atol=1e-4)
    fmap = got.fmaps[0]
    assert isinstance(fmap, torch.Tensor) and fmap.ndim == 4
    np.testing.assert_allclose(fmap.numpy(), np.asarray(want.fmaps[0]), rtol=1e-3, atol=1e-4)


def test_detr_adapter_matches_jax_adapter(converted, jax_converted):
    assert DetrJaxAdapter is DetrAdapter
    image = _images(2, 1)[0]
    got = DetrAdapter(converted[0])(image, predict_conf=0.1)
    want = JaxDetrAdapter(*jax_converted)(image, predict_conf=0.1)
    assert 0 < got.boxes.shape[0]
    _same_detections(got, want)


def test_hf_adapter_matches_jax_hf_adapter_and_the_port_model(hf_detr, converted):
    image = _images(3, 1)[0]
    got = HFDetrAdapter(hf_detr, device="cpu")(image, predict_conf=0.1)
    want = JaxHFDetrAdapter(hf_detr)(image, predict_conf=0.1)
    assert 0 < got.boxes.shape[0] and got.fmaps[0].shape == (1, 32, IMG // 8, IMG // 8)
    _same_detections(got, want)
    _same_detections(DetrAdapter(converted[0])(image, predict_conf=0.1), got)
    every = HFDetrAdapter(hf_detr, device="cpu")(torch.from_numpy(image).permute(2, 0, 1), predict_conf=0.0)
    assert every.boxes.shape == (N_QUERIES, 4) and every.logits.shape == (N_QUERIES, N_LABELS)


def test_hf_adapter_scores_conditional_detr_by_sigmoid():
    """ConditionalDETR has no no-object column: the logits' width picks the
    sigmoid scoring (tests/test_hf_detr_adapter.py's genericity case)."""
    cfg = transformers.ConditionalDetrConfig(
        use_timm_backbone=False, use_pretrained_backbone=False, backbone=None,
        backbone_config=transformers.ResNetConfig(embedding_size=16, hidden_sizes=[16, 32, 64, 128],
                                                  depths=[1, 1, 1, 1]),
        d_model=D_MODEL, encoder_layers=1, decoder_layers=1, encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=64, decoder_ffn_dim=64, num_queries=10, num_labels=N_LABELS)
    torch.manual_seed(0)
    model = transformers.ConditionalDetrForObjectDetection(cfg)
    det = HFDetrAdapter(model, device="cpu")(_images(4, 1)[0], predict_conf=0.0)
    assert det.boxes.shape == (10, 4) and det.logits.shape == (10, N_LABELS)
    np.testing.assert_allclose(det.scores, 1 / (1 + np.exp(-det.logits.max(-1))), rtol=1e-5)
    assert det.fmaps[0].shape == (1, 128, IMG // 32, IMG // 32)


def test_cxcywh_conversion():
    out = cxcywh_to_xyxy(np.array([[0.5, 0.5, 0.5, 0.25]]), img_h=100, img_w=200)
    np.testing.assert_allclose(out, [[50.0, 37.5, 150.0, 62.5]])


def test_object_level_extraction_over_the_port_detr(converted):
    """The converted model drives the per-detection extraction and scoring
    stack through the DetectionResult protocol (ROIAlign's plain version on
    the CPU), every query kept."""
    adapter = DetrAdapter(converted[0])
    extractor = BoxFeaturesExtractor(model=adapter, architecture="detr-backbone", roi_output_sizes=[2], device="cpu")
    data = [(f"im{i}", image, i) for i, image in enumerate(_images(5))]
    out = extractor.get_ls_samples(data, predict_conf=0.0)
    feats = np.concatenate([out[i]["latent_space_means"] for i in range(2)])
    assert feats.shape == (2 * N_QUERIES, 32) and np.isfinite(feats).all()
    md = MDLatentSpace()
    md.setup(torch.from_numpy(feats))
    assert bool(torch.isfinite(md.postprocess(torch.from_numpy(out[0]["latent_space_means"]))).all())


@pytest.mark.parametrize("case", ["timm", "hidden_sizes", "heads", "ffn", "first_stage"])
def test_the_converter_refuses_what_jax_refuses(hf_detr, case):
    """The JAX converter's refusals, with its messages."""
    if case == "timm":
        object.__setattr__(hf_detr.config, "use_timm_backbone", True)
        try:
            with pytest.raises(NotImplementedError, match="timm"):
                convert_hf_detr(hf_detr, device="cpu")
        finally:
            object.__setattr__(hf_detr.config, "use_timm_backbone", False)
        return
    backbone = dict(embedding_size=4, hidden_sizes=[16, 32], depths=[1, 1], layer_type="bottleneck")
    overrides, match = {
        "hidden_sizes": (dict(backbone_config=transformers.ResNetConfig(**{**backbone, "hidden_sizes": [16, 24]})),
                         "hidden_sizes"),
        "heads": (dict(decoder_attention_heads=2), "decoder_attention_heads"),
        "ffn": (dict(decoder_ffn_dim=32), "decoder_ffn_dim"),
        "first_stage": (dict(backbone_config=transformers.ResNetConfig(**backbone, downsample_in_first_stage=True)),
                        "downsample_in_first_stage"),
    }[case]
    torch.manual_seed(1)
    odd = transformers.DetrForObjectDetection(_config(encoder_layers=1, decoder_layers=1, **overrides)).eval()
    with pytest.raises(NotImplementedError, match=match):
        jax_convert_hf_detr(odd)
    with pytest.raises(NotImplementedError, match=match):
        convert_hf_detr(odd, device="cpu")
