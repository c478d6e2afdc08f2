"""Batched, padded object-level feature extraction and scoring.

Counterpart of ``runia_core_tpu/extraction/object_level_batched.py``, the
production object path: detections are padded to a fixed ``max_det`` with
a validity mask, ROIAlign runs over the whole image batch in one kernel
launch per tapped map (``ops/roi_align.py``, channel means only), and the
per-detection Mahalanobis scores come out as a (B, M) tensor with ``-inf``
in the padded rows. An image with no detection scores its whole-image box,
the reference's fallback, as an ordinary valid row.

On the card :func:`build_object_scorer` replays one CUDA graph per input
shape, as ``inference/image_level.py::build_larex_scorer`` does: the JAX
package's one jitted program. The taps stay NHWC, as the forward leaves
them: the kernel reads them in place, and the NCHW copy JAX makes before
its ROIAlign is not made.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

import runia_core_tpu_torch
from runia_core_tpu_torch.ops.linalg import mahalanobis_quadform
from runia_core_tpu_torch.ops.roi_align import roi_align_nhwc
from runia_core_tpu_torch.reduction import pca_transform
from runia_core_tpu_torch.utils.graphs import CudaGraph, ProgramCache, upload

__all__ = ["PaddedDetections", "batched_roi_features", "build_object_scorer", "pad_detections"]


@dataclass
class PaddedDetections:
    """A fixed-shape detection batch: (B, MAX_DET, ...) tensors and the
    validity mask."""

    boxes: torch.Tensor  # (B, M, 4) xyxy
    valid: torch.Tensor  # (B, M) bool
    scores: Optional[torch.Tensor] = None  # (B, M)
    classes: Optional[torch.Tensor] = None  # (B, M)
    logits: Optional[torch.Tensor] = None  # (B, M, C)


def pad_detections(
    per_image: Sequence[Dict[str, np.ndarray]],
    max_det: int,
    img_shape: Tuple[int, int],
    num_classes: Optional[int] = None,
    device=None,
) -> PaddedDetections:
    """Pad ragged per-image detections to (B, MAX_DET, ...) tensors on
    ``device`` (None: the GPU; copied through pinned memory, without waiting).

    An image with no detection gets the whole-image box in slot 0 with
    ``valid=True`` (the reference's fallback) and score 0. Beyond
    ``max_det`` the highest scores are kept where there are scores, else
    the first detections.
    """
    b = len(per_image)
    boxes = np.zeros((b, max_det, 4), np.float32)
    valid = np.zeros((b, max_det), bool)
    scores = np.zeros((b, max_det), np.float32)
    classes = np.zeros((b, max_det), np.int32)
    c = num_classes
    logits = None
    for i, det in enumerate(per_image):
        det_boxes = np.asarray(det.get("boxes", np.zeros((0, 4)))).reshape(-1, 4)
        n = det_boxes.shape[0]
        order = np.arange(n)
        if n > max_det and "scores" in det:
            order = np.argsort(-np.asarray(det["scores"]))[:max_det]
        elif n > max_det:
            order = order[:max_det]
        n_keep = len(order) if n > 0 else 0
        if n_keep == 0:
            boxes[i, 0] = [0.0, 0.0, img_shape[1], img_shape[0]]
            valid[i, 0] = True
            continue
        boxes[i, :n_keep] = det_boxes[order]
        valid[i, :n_keep] = True
        if "scores" in det:
            scores[i, :n_keep] = np.asarray(det["scores"])[order]
        if "classes" in det:
            classes[i, :n_keep] = np.asarray(det["classes"])[order]
        if "logits" in det:
            det_logits = np.asarray(det["logits"])
            if logits is None:
                c = c or det_logits.shape[-1]
                logits = np.zeros((b, max_det, c), np.float32)
            logits[i, :n_keep] = det_logits[order]
    device = runia_core_tpu_torch.default_device() if device is None else torch.device(device)
    return PaddedDetections(
        boxes=upload(boxes, device),
        valid=upload(valid, device),
        scores=upload(scores, device),
        classes=upload(classes, device),
        logits=upload(logits, device) if logits is not None else None,
    )


def batched_roi_features(
    fmaps: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    img_shape: Tuple[int, int],
    output_sizes: Sequence[int],
    sampling_ratio: int = -1,
) -> torch.Tensor:
    """Per-detection channel-mean ROI features of a whole image batch.

    Args:
        fmaps: per level, (B, C_l, H_l, W_l) maps (the NCHW view of an NHWC
            tap is read in place).
        boxes: (B, M, 4) padded boxes.

    Returns:
        (B, M, sum_l C_l) features in the maps' dtype (padded rows hold the
        features of their zero boxes: mask them downstream).
    """
    b, m, _ = boxes.shape
    flat = boxes.reshape(b * m, 4)
    outs = []
    for fmap, out_size in zip(fmaps, output_sizes):
        scale = fmap.shape[3] / img_shape[1]
        means = roi_align_nhwc(fmap.permute(0, 2, 3, 1), flat, int(out_size), scale, sampling_ratio, True, mean=True)
        outs.append(means.reshape(b, m, -1))
    return torch.cat(outs, dim=-1)


_SCORER_PROGRAMS = 8  # graphs a scorer keeps (input shapes), least recently used dropped


def build_object_scorer(
    apply_fn: Callable,
    detector_state: Dict[str, torch.Tensor],
    output_sizes: Tuple[int, ...],
    img_shape: Tuple[int, int],
    pca_state=None,
    fmap_taps: Tuple[str, ...] = ("pre_pool",),
    sampling_ratio: int = -1,
    use_graph: bool = True,
) -> Callable:
    """Backbone forward -> batched ROIAlign (channel means) -> Mahalanobis
    scores over padded detections.

    Args:
        apply_fn: images -> (outputs, taps) tapped forward whose taps are
            NHWC maps (``models.build_tapped_forward``).
        detector_state: {"feats_mean", "precision"} (LaREM), on the model's
            device.
        use_graph: on a GPU, capture each (image shape and dtype, box shape)
            once into a CUDA graph and replay it; False runs every call
            eagerly. A capture that fails raises.

    Returns:
        ``score(images, dets: PaddedDetections) -> (B, M)`` f32 scores with
        ``-inf`` in padded rows. The results of a replay are copies.
    """

    def run(images: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        _, taps = apply_fn(images)
        feats = batched_roi_features(
            [taps[name].permute(0, 3, 1, 2) for name in fmap_taps], boxes, img_shape, output_sizes, sampling_ratio
        )  # (B, M, D)
        b, m, d = feats.shape
        flat = feats.reshape(b * m, d).to(torch.float32)
        if pca_state is not None:
            flat = pca_transform(pca_state, flat)
        s = -mahalanobis_quadform(flat, detector_state["feats_mean"], detector_state["precision"]).reshape(b, m)
        return torch.where(valid, s, torch.full_like(s, -torch.inf))

    programs = ProgramCache(_SCORER_PROGRAMS)

    @torch.inference_mode()
    def score(images: torch.Tensor, dets: PaddedDetections) -> torch.Tensor:
        if not (use_graph and images.is_cuda):
            return run(images, dets.boxes, dets.valid)
        inputs = {"images": images, "boxes": dets.boxes, "valid": dets.valid}
        key = (tuple(images.shape), images.dtype, tuple(dets.boxes.shape))
        graph = programs.get_or_build(key, lambda: CudaGraph(run, inputs, device=images.device))
        graph.load(**inputs)
        return graph.replay()[0].clone()

    return score
