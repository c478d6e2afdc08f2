"""The port's online object-level inference (``inference/object_level.py``,
``ObjectDetectionInferenceBase``, ``ImageLvlFeatureExtractor``) and its
RCNN / YOLOv8 helpers (``rcnn.py``, ``yolov8.py``) against the JAX package,
on the CPU.

Both sides read the same deterministic mock detector (numpy maps for JAX,
CPU tensors for the port) and the same random draws (the JAX package's
DropBlock seed masks and keep-weights are injected into the port).
Tolerances: scores and features within REL = 1e-5 of the largest magnitude
(ROIAlign and the Mahalanobis products sum in other orders); classes,
rewrites, boxes, 'no_obj' lists and shapes equal; entropies within
ENT_ATOL = 1e-4 (logs of distances between DropBlock channel means).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu import rcnn as jax_rcnn
from runia_core_tpu import yolov8 as jax_yolov8
from runia_core_tpu.detectors import MDLatentSpace as JaxMD
from runia_core_tpu.extraction import DetectionResult as JaxDetectionResult
from runia_core_tpu.extraction.image_level import ImageLvlFeatureExtractor as JaxImageLvlFeatureExtractor
from runia_core_tpu.inference import BoxInferenceYolo as JaxBoxInferenceYolo
from runia_core_tpu.inference import ObjectLevelInference as JaxObjectLevelInference
from runia_core_tpu.inference.object_level import adjust_predictions_faster_rcnn as jax_adjust
from runia_core_tpu_torch import rcnn, yolov8
from runia_core_tpu_torch.detectors import MDLatentSpace
from runia_core_tpu_torch.extraction import DetectionResult, ImageLvlFeatureExtractor
from runia_core_tpu_torch.inference import (
    BoxInferenceYolo,
    ObjectDetectionInferenceBase,
    ObjectLevelInference,
    adjust_predictions_faster_rcnn,
)
from test_torch_extraction import _fast_draws, _loader, _same_results, models  # noqa: F401

torch.set_num_threads(1)

REL = 1e-5
ENT_ATOL = 1e-4
IMG_H, IMG_W = 64, 96
C = 12


def _close(got, want, rel=REL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


class Mock:
    """A detector returning fixed detections and maps: n boxes, and two maps."""

    def __init__(self, n: int, port: bool, seed: int = 0):
        rng = np.random.RandomState(seed)
        xy = rng.rand(n, 2) * np.array([IMG_W / 2, IMG_H / 2])
        self.boxes = np.concatenate([xy, xy + rng.rand(n, 2) * 25 + 5], 1).astype(np.float32)
        self.scores = rng.rand(n).astype(np.float32)
        self.classes = rng.randint(0, 4, n)
        self.logits = rng.randn(n, 4).astype(np.float32)
        self.fmaps = [rng.rand(1, C, 8, 12).astype(np.float32), rng.rand(1, 4, 4, 6).astype(np.float32)]
        self.port = port

    def __call__(self, image, predict_conf, **kwargs):
        cls = DetectionResult if self.port else JaxDetectionResult
        fmaps = [torch.from_numpy(f) for f in self.fmaps] if self.port else self.fmaps
        return cls(boxes=self.boxes, img_shape=(IMG_H, IMG_W), scores=self.scores, classes=self.classes,
                   logits=self.logits, fmaps=fmaps, extra={"names": {0: "a", 1: "b", 2: "c", 3: "d"}})


def _ind(rng, d=C + 4):
    return rng.randn(80, d).astype(np.float32)


@pytest.mark.parametrize("pca,stds", [(None, False), (6, False), (None, True)], ids=["plain", "pca", "stds"])
def test_box_inference_yolo_rewrites_as_jax(pca, stds):
    ind = _ind(np.random.RandomState(1), 2 * (C + 4) if stds else C + 4)
    kw = dict(postprocessor=None, postprocessor_type="LaREM", roi_output_sizes=[3, 2], n_pca_components=pca)
    want_model = JaxBoxInferenceYolo(Mock(5, False), ind_samples=ind, **kw)
    got_model = BoxInferenceYolo(Mock(5, True), ind_samples=torch.from_numpy(ind), **kw)
    reference = want_model.get_score(None, 0.25, threshold=-1e9, use_stds=stds)
    ranked = np.sort(reference.extra["ood_scores"])
    threshold = float(ranked[1] + ranked[2]) / 2  # between two scores: two detections rewritten
    want = want_model.get_score(None, 0.25, threshold=threshold, use_stds=stds)
    got = got_model.get_score(None, 0.25, threshold=threshold, use_stds=stds)
    _close(got.extra["ood_scores"], want.extra["ood_scores"])
    np.testing.assert_array_equal(got.classes, want.classes)
    assert got.extra["ood_class_id"] == want.extra["ood_class_id"] == 4
    assert 0 < int((got.classes == 4).sum()) < 5
    np.testing.assert_array_equal(got.boxes, want.boxes)
    np.testing.assert_array_equal(got.scores, want.scores)


def test_box_inference_yolo_whole_image_fallback():
    ind = _ind(np.random.RandomState(2))
    kw = dict(postprocessor=None, postprocessor_type="LaREM", roi_output_sizes=[3, 2], ood_class_id=9)
    want = JaxBoxInferenceYolo(Mock(0, False), ind_samples=ind, **kw).get_score(None, 0.3, threshold=1e9)
    got = BoxInferenceYolo(Mock(0, True), ind_samples=torch.from_numpy(ind), **kw).get_score(None, 0.3,
                                                                                              threshold=1e9)
    np.testing.assert_array_equal(got.boxes, [[0, 0, IMG_W, IMG_H]])
    np.testing.assert_array_equal(got.classes, want.classes)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert got.classes.tolist() == [9] and got.scores.tolist() == [pytest.approx(0.3)]
    _close(got.extra["ood_scores"], want.extra["ood_scores"])


@pytest.mark.parametrize("n", [4, 0])
def test_object_level_inference_matches_jax(n):
    ind = _ind(np.random.RandomState(3))
    jax_md, md = JaxMD(), MDLatentSpace()
    jax_md.setup(ind)
    md.setup(torch.from_numpy(ind))
    kw = dict(architecture="yolov8", latent_space_method=True, postprocessor_input=["latent_space_means"],
              roi_output_sizes=[3, 2])
    want_raw, want = JaxObjectLevelInference(Mock(n, False), jax_md, **kw).get_score(None, 0.25)
    got_raw, got = ObjectLevelInference(Mock(n, True), md, device="cpu", **kw).get_score(None, 0.25)
    if n == 0:
        assert got == [] and want == []
        return
    _close(got, want)
    np.testing.assert_array_equal(got_raw.boxes, want_raw.boxes)


def test_adjust_predictions_faster_rcnn():
    class Predictions:
        def __init__(self):
            self.det_labels = [0, 1, 2, 3]

    scores = np.array([0.1, 0.9, -0.2, 0.5])
    got = adjust_predictions_faster_rcnn(Predictions(), scores, 7, 0.3)
    assert got.det_labels == jax_adjust(Predictions(), scores, 7, 0.3).det_labels == [7, 1, 7, 3]

    class Post:
        threshold = 0.6

    inference = ObjectLevelInference(Mock(2, True), Post(), "rcnn", True, ["latent_space_means"], [3],
                                     rcnn_extraction_type="shortcut", device="cpu")
    assert inference.adjust_predictions_faster_rcnn(Predictions(), scores, 5).det_labels == [5, 1, 5, 5]


def test_object_detection_inference_base_keeps_its_configuration():
    base = ObjectDetectionInferenceBase("model", "post", "yolov8", hooked_layers=["p5"], pca_transform="pca",
                                        rcnn_extraction_type="backbone")
    assert (base.model, base.postprocessor, base.architecture, base.hooked_layers, base.pca_transform,
            base.rcnn_extraction_type) == ("model", "post", "yolov8", ["p5"], "pca", "backbone")
    with pytest.raises(NotImplementedError):
        base.get_score(None)


def test_image_level_feature_extractor_matches_jax():
    loader = [(f"im{i}.png", None, i) for i in range(3)]
    want = JaxImageLvlFeatureExtractor(Mock(3, False), "yolov8", return_raw_predictions=True).get_ls_samples(loader)
    got = ImageLvlFeatureExtractor(Mock(3, True), "yolov8", return_raw_predictions=True,
                                   device="cpu").get_ls_samples(loader)
    _close(got["latent_space_means"], want["latent_space_means"], 1e-6)
    assert got["latent_space_means"].shape == (3, C + 4)
    np.testing.assert_array_equal(got["logits"], want["logits"])
    assert got["no_obj"] == want["no_obj"] == []
    empty = ImageLvlFeatureExtractor(Mock(0, True), "yolov8", device="cpu").get_ls_samples(loader[:2])
    assert empty["no_obj"] == ["im0.png", "im1.png"]
    with pytest.raises(NotImplementedError):
        ImageLvlFeatureExtractor(Mock(1, True), "yolov8", return_stds=True)


# ---------------------------------------------------------------------------
# rcnn.py
# ---------------------------------------------------------------------------


class MockRCNN:
    """Fixed RCNN outputs; the random draw argument is ignored."""

    def __init__(self, port: bool, seed: int = 0, proposals: int = 1000):
        rng = np.random.RandomState(seed)
        self.port = port
        self.arrays = dict(
            scores=rng.rand(5).astype(np.float32), inter_feat=rng.randn(5, 11).astype(np.float32),
            box_cls=rng.randn(proposals, 11).astype(np.float32), latent=rng.rand(1, 6, 5, 5).astype(np.float32),
            fc_latent=rng.rand(proposals, 6).astype(np.float32),
            rpn_feats=[rng.rand(1, 3, 8, 8).astype(np.float32), rng.rand(1, 3, 4, 4).astype(np.float32)],
            backbone_feats={"p2": rng.rand(1, 4, 8, 8).astype(np.float32), "p3": rng.rand(1, 4, 4, 4).astype(np.float32)},
        )
        self.fc = False

    def __call__(self, image, draw=None):
        wrap = (lambda a: torch.from_numpy(np.array(a))) if self.port else (lambda a: a)
        a = self.arrays
        out = rcnn.RCNNOutput if self.port else jax_rcnn.RCNNOutput
        return out(scores=wrap(a["scores"]), inter_feat=wrap(a["inter_feat"]), box_cls=wrap(a["box_cls"]),
                   latent=wrap(a["fc_latent"] if self.fc else a["latent"]), rpn_feats=[wrap(f) for f in a["rpn_feats"]],
                   backbone_feats={k: wrap(v) for k, v in a["backbone_feats"].items()})


def _seeds(key, shapes, samples, p, bs):
    """The JAX sampler's Bernoulli seeds: per sample, per map (1, H, W)."""
    keys = jax.random.split(key, samples)
    return [[torch.from_numpy(np.array(jax.random.bernoulli(jax.random.fold_in(k, i), p / bs**2, (1, *hw)),
                                       np.float32)) for i, hw in enumerate(shapes)] for k in keys]


def test_rcnn_score_helpers_match_jax():
    loader = [None, None]
    np.testing.assert_array_equal(rcnn.get_msp_score_rcnn(MockRCNN(True), loader),
                                  jax_rcnn.get_msp_score_rcnn(MockRCNN(False), loader))
    port_fc, jax_fc = MockRCNN(True), MockRCNN(False)
    port_fc.fc = jax_fc.fc = True
    got = rcnn.get_dice_feat_mean_react_percentile_rcnn(port_fc, loader, 80)
    want = jax_rcnn.get_dice_feat_mean_react_percentile_rcnn(jax_fc, loader, 80)
    _close(got[0], want[0], 1e-6)
    assert got[1] == pytest.approx(want[1], rel=1e-6)
    for g, w in zip(rcnn.get_energy_score_rcnn(MockRCNN(True), loader, device="cpu"),
                    jax_rcnn.get_energy_score_rcnn(MockRCNN(False), loader)):
        _close(g, w, 1e-6)


def test_mc_sampler_rcnn_with_jaxs_masks():
    key = jax.random.key(4)
    feats = MockRCNN(False).arrays["rpn_feats"]
    want = jax_rcnn.MCSamplerRCNN(mc_samples=5, block_size=3, drop_prob=0.5)(feats, key)
    sampler = rcnn.MCSamplerRCNN(mc_samples=5, block_size=3, drop_prob=0.5, device="cpu")
    got = sampler([torch.from_numpy(f) for f in feats], seeds=_seeds(key, [(8, 8), (4, 4)], 5, 0.5, 3))
    assert got.shape == (5, 6)
    _close(got, want, 1e-6)
    drawn = rcnn.MCSamplerRCNN(mc_samples=5, block_size=3, drop_prob=0.5,
                               generator=torch.Generator().manual_seed(0))([torch.from_numpy(f) for f in feats])
    assert drawn.shape == (5, 6) and bool(torch.isfinite(drawn).all())


@pytest.mark.parametrize("layer_type", ["Conv", "RPN", "FC", "backbone"])
def test_get_ls_mcd_samples_rcnn_matches_jax(layer_type):
    loader, samples = [None, None], 3
    models = [MockRCNN(True), MockRCNN(False)]
    for m in models:
        m.fc = layer_type == "FC"
    key = jax.random.key(5)
    kw = dict(mcd_nro_samples=samples, layer_type=layer_type, return_raw_predictions=True, dropblock_prob=0.5,
              dropblock_size=1)
    want, want_raw = jax_rcnn.get_ls_mcd_samples_rcnn(models[1], loader, rng=key, **kw)
    seeds = None
    if layer_type == "backbone":
        seeds = [[[torch.from_numpy(np.array(jax.random.bernoulli(
            jax.random.fold_in(key, i * 7919 + s * 131 + j), 0.5, (1, hw, hw)), np.float32)) for j, hw in
            enumerate((8, 4))] for s in range(samples)] for i in range(len(loader))]
    got, got_raw = rcnn.get_ls_mcd_samples_rcnn(models[0], loader, device="cpu", seeds=seeds, **kw)
    _close(got, want, 1e-6)
    _close(got_raw, want_raw, 1e-6)
    short = MockRCNN(True, proposals=999)
    short.fc = True
    if layer_type == "FC":
        with pytest.raises(ValueError):  # every image skipped: nothing to concatenate, as in JAX
            rcnn.get_ls_mcd_samples_rcnn(short, loader, device="cpu", **kw)


def test_larex_and_lard_inference_rcnn_match_jax():
    rng = np.random.RandomState(6)
    fit = rng.randn(40, 6).astype(np.float32)
    jax_md, md = JaxMD(), MDLatentSpace()
    jax_md.setup(fit)
    md.setup(torch.from_numpy(fit))
    key = jax.random.key(8)
    want = jax_rcnn.LaRexInferenceRCNN(MockRCNN(False), jax_md, 0.5, 3, 8).get_score(None, key=key)[1]
    got = rcnn.LaRexInferenceRCNN(MockRCNN(True), md, 0.5, 3, 8).get_score(
        None, seeds=_seeds(key, [(8, 8), (4, 4)], 8, 0.5, 3))[1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=ENT_ATOL)
    (samples, seconds) = rcnn.LaRexInferenceRCNN(MockRCNN(True), md, 0.5, 3, 8,
                                                 generator=torch.Generator().manual_seed(1)).get_layer_mc_samples(None)
    assert samples.shape == (8, 6) and seconds >= 0
    for layer_type in ("RPN", "Conv"):
        mocks = MockRCNN(False), MockRCNN(True)
        for m in mocks:  # LaRDInference reduces a Conv latent as NHWC (its channel_axis 3)
            m.arrays["latent"] = np.ascontiguousarray(m.arrays["latent"].transpose(0, 2, 3, 1))
        want = jax_rcnn.LaRDInferenceRCNN(mocks[0], jax_md, layer_type=layer_type).get_score(None)[1]
        got = rcnn.LaRDInferenceRCNN(mocks[1], md, layer_type=layer_type).get_score(None)[1]
        _close(got, want)


def test_remove_background_dimension_matches_jax():
    rng = np.random.RandomState(7)

    def dicts():
        fc = {"weight": rng.randn(11, 4), "bias": rng.randn(11)}
        ind = {"train logits": rng.randn(5, 11), "valid logits": rng.randn(3, 10)}
        ood = {"o logits": rng.randn(2, 11)}
        return fc, ind, ood

    fc, ind, ood = dicts()
    want = jax_rcnn.remove_background_dimension({k: v.copy() for k, v in fc.items()}, dict(ind), dict(ood), ["o"])
    got = rcnn.remove_background_dimension({k: torch.from_numpy(v) for k, v in fc.items()},
                                           {k: torch.from_numpy(v) for k, v in ind.items()},
                                           {k: torch.from_numpy(v) for k, v in ood.items()}, ["o"])
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_fast_mcd_extractor_yolov8_flips_bgr_loaders(models):  # noqa: F811
    jax_fwd, port_fwd = models[3]
    loader = _loader(0)
    bgr = [(np.ascontiguousarray(x[..., ::-1].transpose(0, 3, 1, 2)), y) for x, y in loader]
    single = [(bgr[0][0][0], bgr[0][1][:1])]
    kw = dict(layer_type="Conv", reduction_method="fullmean", mcd_nro_samples=4, dropblock_probs=0.4,
              dropblock_sizes=3)
    for data, plain in ((bgr, loader), (single, [(loader[0][0][:1], loader[0][1][:1])])):
        want = jax_yolov8.FastMCDSamplesExtractorYolov8(model=jax_fwd, rng=jax.random.key(1), **kw).get_ls_samples(
            data)
        extractor = yolov8.FastMCDSamplesExtractorYolov8(model=port_fwd, device="cpu", **kw)
        assert extractor.return_variances is False
        got = extractor.get_ls_samples([(torch.from_numpy(x), y) for x, y in data],
                                       draws=_fast_draws(jax.random.key(1), plain, [("Conv", 0.4, 3, None)]))
        _same_results(got, want)
