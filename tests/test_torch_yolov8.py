"""The port's YOLOv8 (``models/yolov8.py``) and the YOLO logits replay
(``extraction/adapters.py::yolo_get_logits``) against the JAX package, on
the CPU.

A torch replica of the published architecture with ultralytics' layout
(``TYoloV8`` from tests/test_yolov8_convert.py, randomised BatchNorm
statistics) gives the ``state_dict``; the JAX package converts it to flax,
the port to its module, directly and through ``yolov8_from_flax``.
Tolerances: predictions within 1e-4 of the largest magnitude (JAX's own bar
for its converter is rtol 1e-3, atol 1e-4); kept detections, classes and
recovered logits equal where both sides read the same numpy predictions;
adapter logits within 1e-5 relative (the two forwards sum in other orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from runia_core_tpu.extraction.adapters import yolo_get_logits as jax_yolo_get_logits
from runia_core_tpu.models.yolov8 import YoloV8JaxAdapter as JaxYoloAdapter
from runia_core_tpu.models.yolov8 import convert_ultralytics_yolov8 as jax_convert
from runia_core_tpu_torch.extraction import yolo_get_logits
from runia_core_tpu_torch.models import YoloV8, YoloV8JaxAdapter, convert_ultralytics_yolov8, yolov8_from_flax
from runia_core_tpu_torch.ops.nms import nms_keep_cuda
from test_yolov8_convert import NC, TYoloV8

torch.set_num_threads(1)

IMG = 64
PRED_REL = 1e-4


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def yolo():
    torch.manual_seed(0)
    replica = TYoloV8(NC).eval()
    rng = np.random.RandomState(1)
    for mod in replica.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            n = mod.running_mean.shape[0]
            mod.running_mean.data = torch.from_numpy(rng.randn(n).astype(np.float32) * 0.1)
            mod.running_var.data = torch.from_numpy(rng.rand(n).astype(np.float32) * 0.8 + 0.6)
    sd = replica.state_dict()
    flax_model, variables = jax_convert(sd, num_classes=NC, scale="n")
    port = convert_ultralytics_yolov8(sd, num_classes=NC, scale="n", device="cpu")
    return replica, flax_model, variables, port


def test_forward_matches_flax_and_the_replica(yolo):
    replica, flax_model, variables, port = yolo
    x = np.random.RandomState(0).rand(2, IMG, IMG, 3).astype(np.float32)
    with torch.no_grad():
        got, taps = port(torch.from_numpy(x))
        ref = replica(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    want, want_taps = flax_model.apply(variables, jnp.asarray(x))
    assert got.shape == (2, 4 + NC, 8 * 8 + 4 * 4 + 2 * 2)
    _close(got.numpy(), want, PRED_REL)
    _close(got.numpy(), ref, PRED_REL)
    for name in ("p3", "p4", "p5", "backbone_p5"):
        _close(taps[name].numpy(), want_taps[name], PRED_REL)
    assert taps["p3"].shape[1:3] == (IMG // 8, IMG // 8) and taps["backbone_p5"].shape[1:3] == (IMG // 32, IMG // 32)


def test_yolov8_from_flax_gives_the_converted_weights(yolo):
    _, _, variables, port = yolo
    carried = YoloV8(NC, "n", device="cpu")
    carried.load_state_dict(yolov8_from_flax(variables, device="cpu"))
    for name, value in port.state_dict().items():
        torch.testing.assert_close(carried.state_dict()[name], value, rtol=0, atol=0)


def test_converter_refuses_a_wrong_scale(yolo):
    replica = yolo[0]
    with pytest.raises((KeyError, ValueError)):
        convert_ultralytics_yolov8(replica.state_dict(), num_classes=NC, scale="s", device="cpu")


def test_adapter_matches_jaxs(yolo):
    _, flax_model, variables, port = yolo
    rng = np.random.RandomState(3)
    for conf in (0.0, 0.3):
        image = rng.rand(IMG, IMG, 3).astype(np.float32)
        want = JaxYoloAdapter(flax_model, variables, fmap_taps=("backbone_p5", "p3"), iou_threshold=0.5)(image, conf)
        before = nms_keep_cuda.launches
        got = YoloV8JaxAdapter(port, fmap_taps=("backbone_p5", "p3"), iou_threshold=0.5)(image, conf)
        assert nms_keep_cuda.launches == before  # CPU tensors take the plain version
        assert got.boxes.shape[0] > 0
        np.testing.assert_allclose(got.boxes, want.boxes, rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(got.classes, want.classes)
        assert got.classes.dtype == np.int64 and got.img_shape == want.img_shape
        _close(got.scores, want.scores, 1e-5)
        _close(got.logits, want.logits, 1e-5)
        _close(got.raw_prediction, want.raw_prediction, PRED_REL)
        for g, w in zip(got.fmaps, want.fmaps):
            assert g.shape == w.shape  # NCHW
            _close(g.numpy(), w, PRED_REL)


def test_adapter_keeps_jaxs_indices_on_the_same_predictions(yolo):
    """Both adapters' selection on one prediction tensor: the port's NMS
    over every anchor (non-candidates at -inf) keeps JAX's candidates."""
    _, flax_model, variables, port = yolo
    image = np.random.RandomState(4).rand(1, IMG, IMG, 3).astype(np.float32)
    preds, taps = flax_model.apply(variables, jnp.asarray(image))
    jax_adapter = JaxYoloAdapter(flax_model, variables, iou_threshold=0.45, max_det=4)
    jax_adapter._forward = lambda _: (preds, taps)
    want = jax_adapter(image, 0.2)
    port_taps = {name: torch.from_numpy(np.array(t)) for name, t in taps.items()}
    stub = torch.nn.Module()
    stub.register_parameter("w", torch.nn.Parameter(torch.zeros(1)))
    stub.forward = lambda x: (torch.from_numpy(np.array(preds)), port_taps)
    got = YoloV8JaxAdapter(stub, iou_threshold=0.45, max_det=4)(image, 0.2)
    np.testing.assert_array_equal(got.boxes, want.boxes)
    np.testing.assert_array_equal(got.classes, want.classes)
    np.testing.assert_array_equal(got.logits, want.logits)
    assert len(got.boxes) == 4  # max_det cut the kept list


def _prediction(rng, bs=2, anchors=300, nc=4, nm=0, size=64.0):
    xy = rng.rand(bs, anchors, 2) * size
    boxes = np.concatenate([xy, xy + rng.rand(bs, anchors, 2) * 20 + 2], -1)
    cls = rng.rand(bs, anchors, nc) ** 3
    cls[0, :5] = 0.0  # zero class scores: -inf logits
    extra = rng.randn(bs, anchors, nm)
    return np.concatenate([boxes, cls, extra], -1).transpose(0, 2, 1).astype(np.float32)


@pytest.mark.parametrize("kwargs", [
    {}, {"multi_label": True}, {"classes": [1, 3]}, {"agnostic": True}, {"max_det": 5}, {"max_nms": 40},
    {"multi_label": True, "agnostic": True, "classes": [0]}, {"nc": 4, "iou_thres": 0.3},
], ids=["default", "multi_label", "classes", "agnostic", "max_det", "max_nms", "mixed", "masks"])
def test_yolo_get_logits_equals_jax(kwargs):
    rng = np.random.RandomState(5)
    prediction = _prediction(rng, nm=3 if "nc" in kwargs else 0)
    kw = {"conf_thres": 0.2, "iou_thres": 0.5, **kwargs}
    want = jax_yolo_get_logits(prediction, **kw)
    got = yolo_get_logits(torch.from_numpy(prediction), **kw)
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(yolo_get_logits(prediction, device="cpu", **kw), want)


def test_yolo_get_logits_on_the_converted_model(yolo):
    _, flax_model, variables, port = yolo
    x = np.random.RandomState(6).rand(1, IMG, IMG, 3).astype(np.float32)
    with torch.no_grad():
        preds, _ = port(torch.from_numpy(x))
    got = yolo_get_logits(preds, conf_thres=0.01, iou_thres=0.7, nc=NC)
    want = jax_yolo_get_logits(np.asarray(flax_model.apply(variables, jnp.asarray(x))[0]), conf_thres=0.01,
                               iou_thres=0.7, nc=NC)
    assert got.shape == want.shape and np.isfinite(got).all()
    _close(got, want, 1e-5)
