"""Detection-architecture adapters and the YOLO logits-recovery path.

Counterpart of ``runia_core_tpu/extraction/adapters.py``. An adapted
detection model is a callable

    model(image, predict_conf, **kw) -> DetectionResult

returning boxes, scores and classes (numpy, on the host) and the named
feature maps the extractor pools (tensors, on the model's device).
:func:`postprocess_architecture_taps` shapes each architecture's captured
maps into (1, C, H, W) tensors; :func:`yolo_get_logits` replays a YOLOv8
head's NMS (``ops/nms.py``, the CUDA kernel on the card) to recover the
class scores of the survivors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from runia_core_tpu_torch.ops.nms import nms_indices
from runia_core_tpu_torch.utils.placement import as_tensor, to_numpy

__all__ = [
    "SUPPORTED_OBJECT_DETECTION_ARCHITECTURES",
    "DetectionResult",
    "postprocess_architecture_taps",
    "yolo_get_logits",
]

SUPPORTED_OBJECT_DETECTION_ARCHITECTURES = [
    "yolov8",
    "rcnn",
    "detr-backbone",
    "owlv2",
    "rtdetr-backbone",
    "rtdetr-encoder",
    "dino",
]


@dataclass
class DetectionResult:
    """What an adapted detection model returns.

    boxes (N, 4) xyxy in image coordinates, scores (N,), classes (N,),
    logits (N, C) per-detection class logits and features (N, d): numpy
    arrays on the host, as the JAX package keeps them. fmaps: (1, C, H, W)
    tensors for ROI pooling, on the model's device. raw_prediction: the YOLO
    head's (1, 4 + nc, anchors) output, for the logits replay. img_shape:
    (height, width).
    """

    boxes: np.ndarray
    img_shape: Tuple[int, int]
    scores: Optional[np.ndarray] = None
    classes: Optional[np.ndarray] = None
    logits: Optional[np.ndarray] = None
    features: Optional[np.ndarray] = None
    fmaps: List[Any] = field(default_factory=list)
    raw_prediction: Optional[np.ndarray] = None
    extra: Dict[str, Any] = field(default_factory=dict)


def yolo_get_logits(
    prediction,
    conf_thres: float,
    iou_thres: float,
    classes=None,
    agnostic: bool = False,
    multi_label: bool = False,
    max_det: int = 300,
    nc: int = 0,
    max_nms: int = 30000,
    max_wh: int = 7680,
    device=None,
) -> np.ndarray:
    """Per-survivor log class scores recovered from a raw YOLOv8 head output
    by replaying its NMS: the candidates above ``conf_thres`` on their best
    class, the best-class (or every class above the threshold with
    ``multi_label``) rows, class-offset NMS, then ``log`` of the survivors'
    class scores.

    ``prediction`` is (bs, 4 + nc [+ nm], anchors), a tensor or an array.
    The filters run on the host in numpy, as in JAX; the NMS runs where the
    prediction tensor lies, or on ``device`` (None: the GPU) for an array.

    Returns:
        (n_survivors, nc) numpy array of log class scores.
    """
    assert 0 <= conf_thres <= 1, (
        f"Invalid Confidence threshold {conf_thres}, valid values are between 0.0 and 1.0"
    )
    assert 0 <= iou_thres <= 1, f"Invalid IoU {iou_thres}, valid values are between 0.0 and 1.0"
    if isinstance(prediction, torch.Tensor):
        device = prediction.device
    prediction = to_numpy(prediction)
    bs = prediction.shape[0]
    nc = nc or (prediction.shape[1] - 4)
    mi = 4 + nc
    xc = prediction[:, 4:mi].max(1) > conf_thres  # candidates

    multi_label &= nc > 1
    prediction = prediction.transpose(0, 2, 1)  # (bs, anchors, 4 + nc + nm)

    output = [np.zeros((0, nc)) for _ in range(bs)]
    for xi, x in enumerate(prediction):
        x = x[xc[xi]]
        if not x.shape[0]:
            continue
        box, cls, mask = np.split(x, [4, 4 + nc], axis=1)
        # cls_rows follows every filter applied to x below: the NMS survivors'
        # indices select class rows, so a misaligned row would corrupt every
        # score downstream.
        if multi_label:
            i, j = np.where(cls > conf_thres)
            x = np.concatenate([box[i], x[i, 4 + j, None], j[:, None].astype(np.float32), mask[i]], 1)
            cls_rows = cls[i]
        else:
            conf = cls.max(1, keepdims=True)
            j = cls.argmax(1, keepdims=True)
            sel = conf.ravel() > conf_thres
            x = np.concatenate([box, conf, j.astype(np.float32), mask], 1)[sel]
            cls_rows = cls[sel]
        if classes is not None:
            sel = np.isin(x[:, 5].astype(int), np.asarray(classes))
            x = x[sel]
            cls_rows = cls_rows[sel]
        n = x.shape[0]
        if not n:
            continue
        if n > max_nms:
            order = np.argsort(-x[:, 4])[:max_nms]
            x = x[order]
            cls_rows = cls_rows[order]

        c = x[:, 5:6] * (0 if agnostic else max_wh)
        keep = nms_indices(x[:, :4] + c, x[:, 4], iou_thres, max_det=max_det, device=device)
        # A zero class probability maps to a -inf logit, as the reference's
        # torch.log does; only the divide-by-zero warning is silenced.
        with np.errstate(divide="ignore"):
            output[xi] = np.log(cls_rows[keep])
    return np.concatenate(output, axis=0)


def postprocess_architecture_taps(
    architecture: str,
    latent_sample: List[Any],
    rcnn_extraction_type: Optional[str] = None,
    owlv2_hidden_size: Optional[int] = None,
    owlv2_patch_grid: Optional[int] = None,
    device=None,
) -> List[torch.Tensor]:
    """Architecture-specific shaping of captured feature maps into
    (1, C, H, W) tensors ready for ROIAlign:

      - rcnn 'backbone': a dict of pyramid levels -> its values;
      - rcnn 'rpn_head': an (objectness_logits, anchor_deltas) tuple ->
        the two concatenated on channels, per level;
      - owlv2: a (1, 1 + P*P, hidden) token sequence -> the CLS token
        dropped, (1, hidden, P, P);
      - dino: encoder level [1][2];
      - rtdetr-encoder: (1, HW, 256) -> (1, 256, 20, 20).

    Tensors stay on their device; arrays go to ``device`` (None: the GPU).
    """
    if architecture == "rcnn" and rcnn_extraction_type == "backbone":
        if len(latent_sample) == 1 and isinstance(latent_sample[0], dict):
            latent_sample = list(latent_sample[0].values())
    if (
        architecture == "rcnn"
        and rcnn_extraction_type == "rpn_head"
        and len(latent_sample) == 1
        and isinstance(latent_sample[0], tuple)
        and len(latent_sample[0]) == 2
    ):
        latent_sample = [
            torch.cat([as_tensor(obj_logit, device), as_tensor(anch_delta, device)], dim=1)
            for obj_logit, anch_delta in zip(latent_sample[0][0], latent_sample[0][1])
        ]
    if architecture == "owlv2":
        first = latent_sample[0]
        tokens = as_tensor(first[0] if isinstance(first, (tuple, list)) else first, device)
        if tokens.ndim == 2:
            tokens = tokens[None]
        hidden = owlv2_hidden_size or tokens.shape[-1]
        grid = owlv2_patch_grid or int(math.isqrt(tokens.shape[1] - 1))
        latent_sample = [tokens[:, 1:, :].permute(0, 2, 1).reshape(1, hidden, grid, grid)]
    if architecture == "dino":
        latent_sample = [as_tensor(latent_sample[0][1][2], device)]
    if architecture == "rtdetr-encoder":
        first = latent_sample[0][0] if isinstance(latent_sample[0], (tuple, list)) else latent_sample[0]
        first = as_tensor(first, device)
        if first.ndim == 2:
            first = first[None]
        latent_sample = [first.permute(0, 2, 1).reshape(-1, 256, 20, 20)]
    return [as_tensor(t, device) for t in latent_sample]
