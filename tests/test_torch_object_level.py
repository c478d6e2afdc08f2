"""The port's object level (``extraction/object_level_batched.py``,
``extraction/object_level.py``, ``extraction/adapters.py``,
``models/detection.py``) against the JAX package on the CPU.

The JAX side builds a narrow flax ResNet-18 (ImageNet stem, 8 filters,
randomised weights and statistics) and a flax SimpleDetector; their weights
are carried across (``resnet_from_flax``, ``simple_detector_from_flax``) and
both sides take the same numpy inputs. Tolerances: ROI features and scores
within REL = 1e-5 of the largest magnitude (the convolutions and the two
ROIAlign contractions sum in other orders on each side); padding, masks,
boxes kept and `no_obj` lists equal; the MC route's entropies within
ENT_ATOL = 1e-4 (each entropy is a mean of logs of distances between DropBlock
channel means, which carry the means' relative error).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.detectors import MDLatentSpace as JaxMD
from runia_core_tpu.extraction import BoxFeaturesExtractor as JaxBoxFeaturesExtractor
from runia_core_tpu.extraction import postprocess_architecture_taps as jax_taps
from runia_core_tpu.extraction.object_level import _dropblock_rois_get_entropy as jax_dropblock_entropy
from runia_core_tpu.extraction.object_level import _reduce_features_to_rois as jax_reduce
from runia_core_tpu.extraction.object_level_batched import batched_roi_features as jax_batched_roi_features
from runia_core_tpu.extraction.object_level_batched import build_object_scorer as jax_build_object_scorer
from runia_core_tpu.extraction.object_level_batched import pad_detections as jax_pad_detections
from runia_core_tpu.models import JaxDetectorAdapter as JaxAdapter
from runia_core_tpu.models import ResNet18 as JaxResNet18
from runia_core_tpu.models import SimpleDetector as JaxSimpleDetector
from runia_core_tpu.models import build_tapped_forward as jax_tapped_forward
from runia_core_tpu.ops.mc_entropy_pallas import mc_dropblock_weights as jax_mc_weights
from runia_core_tpu.reduction import apply_pca_ds_split as jax_pca_split
from runia_core_tpu.sampling import MCSamplerModule as JaxSampler
from runia_core_tpu_torch.detectors import MDLatentSpace
from runia_core_tpu_torch.extraction import (
    SUPPORTED_OBJECT_DETECTION_ARCHITECTURES,
    BoxFeaturesExtractor,
    batched_roi_features,
    build_object_scorer,
    pad_detections,
    postprocess_architecture_taps,
)
from runia_core_tpu_torch.extraction.object_level import _dropblock_rois_get_entropy, _reduce_features_to_rois
from runia_core_tpu_torch.models import (
    JaxDetectorAdapter,
    ResNet18,
    SimpleDetector,
    build_tapped_forward,
    detector_state_from_arrays,
    pca_state_from_arrays,
    resnet_from_flax,
    simple_detector_from_flax,
)
from runia_core_tpu_torch.sampling import MCSamplerModule
from test_torch_larex_slice import _randomize

torch.set_num_threads(1)

REL = 1e-5
ENT_ATOL = 1e-4
IMG_H, IMG_W = 96, 128
MAX_DET = 6


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def make_dets(rng, n):
    if n == 0:
        return {"boxes": np.zeros((0, 4), np.float32)}
    xy = rng.rand(n, 2) * np.array([IMG_W * 0.7, IMG_H * 0.7])
    wh = rng.rand(n, 2) * 30 + 5
    return {
        "boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
        "scores": rng.rand(n).astype(np.float32),
        "classes": rng.randint(0, 4, n),
        "logits": rng.randn(n, 4).astype(np.float32),
    }


@pytest.fixture(scope="module")
def resnet():
    rng = np.random.RandomState(0)
    model = JaxResNet18(num_classes=10, num_filters=8)
    init = model.init(jax.random.key(0), jnp.zeros((1, IMG_H, IMG_W, 3)))
    variables = {name: _randomize(init[name], rng) for name in ("params", "batch_stats")}
    port = ResNet18(num_classes=10, num_filters=8, device="cpu")
    port.load_state_dict(resnet_from_flax(variables, device="cpu"))
    return model, variables, port


def test_pad_detections_equal_jax():
    rng = np.random.RandomState(1)
    dets = [make_dets(rng, 3), make_dets(rng, 0), make_dets(rng, 9)]
    got = pad_detections(dets, MAX_DET, (IMG_H, IMG_W), device="cpu")
    want = jax_pad_detections(dets, MAX_DET, (IMG_H, IMG_W))
    for name in ("boxes", "valid", "scores", "classes", "logits"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert got.valid.sum(dim=1).tolist() == [3, 1, MAX_DET]


def test_batched_roi_features_match_jax():
    rng = np.random.RandomState(2)
    fmaps = [rng.rand(3, 8, 6, 8).astype(np.float32), rng.rand(3, 4, 12, 16).astype(np.float32)]
    dets = [make_dets(rng, 3), make_dets(rng, 2), make_dets(rng, 0)]
    want_pad = jax_pad_detections(dets, MAX_DET, (IMG_H, IMG_W))
    pad = pad_detections(dets, MAX_DET, (IMG_H, IMG_W), device="cpu")
    want = jax_batched_roi_features(tuple(jnp.asarray(f) for f in fmaps), want_pad.boxes, (IMG_H, IMG_W), (7, 3))
    got = batched_roi_features([torch.from_numpy(f) for f in fmaps], pad.boxes, (IMG_H, IMG_W), (7, 3))
    _close(got.numpy(), want)
    nchw_views = [torch.from_numpy(f).permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2) for f in fmaps]
    same = batched_roi_features(nchw_views, pad.boxes, (IMG_H, IMG_W), (7, 3))
    torch.testing.assert_close(same, got, rtol=0, atol=0)


@pytest.mark.parametrize("with_pca", [False, True], ids=["md", "pca_md"])
def test_object_scorer_matches_jax(resnet, with_pca):
    model, variables, port = resnet
    rng = np.random.RandomState(3)
    images = rng.rand(3, IMG_H, IMG_W, 3).astype(np.float32)
    fit = rng.randn(200, 64).astype(np.float32)
    pca_state = pca = None
    if with_pca:
        fit, pca_state = jax_pca_split(fit, nro_components=16)
        pca = pca_state_from_arrays(pca_state, device="cpu")
    md = JaxMD()
    md.setup(np.asarray(fit))
    dets = [make_dets(rng, 3), make_dets(rng, 0), make_dets(rng, 5)]
    jax_scorer = jax_build_object_scorer(jax_tapped_forward(model, variables), md.state, output_sizes=(7,),
                                         img_shape=(IMG_H, IMG_W), pca_state=pca_state)
    want = np.asarray(jax_scorer(jnp.asarray(images), jax_pad_detections(dets, MAX_DET, (IMG_H, IMG_W))))
    scorer = build_object_scorer(build_tapped_forward(port), detector_state_from_arrays(md.state, device="cpu"),
                                 output_sizes=(7,), img_shape=(IMG_H, IMG_W), pca_state=pca)
    got = scorer(torch.from_numpy(images), pad_detections(dets, MAX_DET, (IMG_H, IMG_W), device="cpu")).numpy()
    assert got.shape == (3, MAX_DET)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got[1, 0]) and (got[1, 1:] == -np.inf).all()  # the whole-image fallback row
    finite = np.isfinite(want)
    _close(got[finite], want[finite])


def test_reduce_features_to_rois_means_and_stds():
    rng = np.random.RandomState(4)
    fmaps = [rng.rand(1, 8, 10, 15).astype(np.float32), rng.rand(1, 4, 5, 8).astype(np.float32)]
    boxes = np.array([[5, 5, 40, 30], [0, 0, IMG_W, IMG_H], [60, 20, 100, 80]], np.float32)
    want_m, want_s = jax_reduce([jnp.asarray(f) for f in fmaps], [7, 3], jnp.asarray(boxes), (IMG_H, IMG_W), -1, 2, 3,
                                return_stds=True)
    got_m, got_s = _reduce_features_to_rois([torch.from_numpy(f) for f in fmaps], [7, 3], boxes, (IMG_H, IMG_W), -1,
                                            2, 3, return_stds=True)
    _close(got_m.numpy(), want_m)
    _close(got_s.numpy(), want_s)
    means_only, none = _reduce_features_to_rois([torch.from_numpy(f) for f in fmaps], [7, 3], boxes,
                                                (IMG_H, IMG_W), -1, 2, 3)
    assert none is None
    _close(means_only.numpy(), want_m)


def test_dropblock_rois_entropy_with_jaxs_masks():
    rng = np.random.RandomState(5)
    fmaps = [rng.rand(1, 16, 12, 12).astype(np.float32)]
    boxes = np.array([[5, 5, 40, 30], [10, 10, 80, 60], [0, 0, 60, 90]], np.float32)
    key = jax.random.key(7)
    want = jax_dropblock_entropy([jnp.asarray(f) for f in fmaps], [7], jnp.asarray(boxes), (IMG_H, IMG_W), -1, 1, 16,
                                 JaxSampler(mc_samples=16, block_size=3, drop_prob=0.5), key=key)
    weights = torch.from_numpy(np.array(jax_mc_weights(key, 3, 7, 7, 16, 3, 0.5)))
    got = _dropblock_rois_get_entropy([torch.from_numpy(f) for f in fmaps], [7], boxes, (IMG_H, IMG_W), -1, 1, 16,
                                      MCSamplerModule(mc_samples=16, block_size=3, drop_prob=0.5), weights=weights)
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ENT_ATOL)


@pytest.fixture(scope="module")
def detector():
    model = JaxSimpleDetector(num_classes=4, features=8, stride=8)
    variables = model.init(jax.random.key(3), jnp.zeros((1, 64, 64, 3)))
    port = SimpleDetector(num_classes=4, features=8, stride=8, device="cpu")
    port.load_state_dict(simple_detector_from_flax(variables, device="cpu"))
    return model, variables, port


def test_simple_detector_forward_matches_flax(detector):
    model, variables, port = detector
    x = np.random.RandomState(6).rand(2, 64, 64, 3).astype(np.float32)
    want_raw, want_taps = model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        raw, taps = port(torch.from_numpy(x))
    _close(raw.numpy(), want_raw)
    _close(taps["pre_pool"].numpy(), want_taps["pre_pool"])


def test_box_features_extractor_over_simple_detector(detector):
    model, variables, port = detector
    rng = np.random.RandomState(7)
    loader = [(f"im{i}.png", rng.rand(64, 64, 3).astype(np.float32), i) for i in range(3)]
    kwargs = dict(architecture="yolov8", roi_output_sizes=[3], return_stds=True)
    want = JaxBoxFeaturesExtractor(model=JaxAdapter(model, variables), **kwargs).get_ls_samples(loader, 0.1)
    got = BoxFeaturesExtractor(model=JaxDetectorAdapter(port), device="cpu", **kwargs).get_ls_samples(loader, 0.1)
    assert got["no_obj"] == want["no_obj"]
    assert set(got) == set(want)
    for i in range(3):
        assert got[i]["boxes"].shape == want[i]["boxes"].shape and got[i]["boxes"].shape[0] > 0
        np.testing.assert_allclose(got[i]["boxes"], want[i]["boxes"], rtol=REL, atol=REL)
        for name in ("latent_space_means", "stds", "logits"):
            _close(got[i][name], want[i][name])
    # No detection above the threshold: the whole image, flagged.
    extractor = BoxFeaturesExtractor(model=JaxDetectorAdapter(port), device="cpu", **kwargs)
    results, found = extractor._get_samples_one_image(loader[0][1], 1.1)
    assert not found
    np.testing.assert_array_equal(results["boxes"], [[0, 0, 64, 64]])
    empty = extractor.get_ls_samples([("none.png", loader[0][1], 9)], 1.1)
    assert empty["no_obj"] == ["none.png"] and empty[9]["boxes"] == []


def test_extractor_noise_entropies_route(detector):
    _, _, port = detector
    extractor = BoxFeaturesExtractor(model=JaxDetectorAdapter(port), architecture="yolov8", roi_output_sizes=[3],
                                     extract_noise_entropies=True, mcd_nro_samples=8, dropblock_probs=0.5,
                                     dropblock_sizes=1, device="cpu", generator=torch.Generator().manual_seed(0))
    results, found = extractor._get_samples_one_image(np.random.RandomState(8).rand(64, 64, 3).astype(np.float32),
                                                      0.1)
    assert found and results["latent_space_means"].shape == (results["boxes"].shape[0], 64)
    assert np.isfinite(results["latent_space_means"]).all()


def _arch_inputs(rng):
    level = lambda c, s: rng.rand(1, c, s, s).astype(np.float32)  # noqa: E731
    return {
        ("rcnn", "backbone"): [{"p2": level(4, 8), "p3": level(4, 4)}],
        ("rcnn", "rpn_head"): [((level(3, 8), level(3, 4)), (level(12, 8), level(12, 4)))],
        ("owlv2", None): [(rng.rand(1, 1 + 16, 8).astype(np.float32),)],
        ("dino", None): [(None, [None, None, level(6, 5)])],
        ("rtdetr-encoder", None): [(rng.rand(1, 400, 256).astype(np.float32),)],
        ("yolov8", None): [level(5, 4)],
        ("detr-backbone", None): [level(5, 4), level(3, 2)],
        ("rtdetr-backbone", None): [level(5, 4)],
    }


@pytest.mark.parametrize("arch", sorted({a for a, _ in _arch_inputs(np.random.RandomState(0))} | {"rcnn"}))
def test_postprocess_architecture_taps_equal_jax(arch):
    assert arch in SUPPORTED_OBJECT_DETECTION_ARCHITECTURES
    for (name, kind), sample in _arch_inputs(np.random.RandomState(9)).items():
        if name != arch:
            continue
        want = jax_taps(name, sample, kind)
        got = postprocess_architecture_taps(name, sample, kind, device="cpu")
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
