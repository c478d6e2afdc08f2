"""Adapters wrapping HuggingFace detection models into the DetectionResult
protocol.

Counterpart of ``runia_core_tpu/extraction/hf_adapters.py``. The HF DETR
family's ``*ForObjectDetection`` runs as it is, on ``device`` (the card
unless the caller names another); its outputs are postprocessed into a
:class:`DetectionResult`, and the backbone map captured by a forward hook
stays a tensor on that device, where the ROIAlign kernel reads it.

Works for any DETR-family model whose outputs carry ``logits`` (B, Q,
num_labels [+ 1]) and ``pred_boxes`` (B, Q, 4) normalized cxcywh, with the
conv backbone at ``model.model.backbone`` (DETR, ConditionalDETR,
DeformableDETR). The hook reads both layouts of that module's output:
transformers 4.x's ``(feature maps and masks, position embeddings)`` and
5.x's list of ``(feature map, mask)``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.extraction.adapters import DetectionResult
from runia_core_tpu_torch.utils.graphs import copy_to_host

__all__ = ["HFDetrAdapter", "cxcywh_to_xyxy"]


def cxcywh_to_xyxy(boxes: np.ndarray, img_h: int, img_w: int) -> np.ndarray:
    """Normalized (cx, cy, w, h) -> absolute (x1, y1, x2, y2)."""
    cx, cy, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    out = np.stack([(cx - w / 2) * img_w, (cy - h / 2) * img_h, (cx + w / 2) * img_w, (cy + h / 2) * img_h],
                   axis=-1)
    return out.astype(np.float32)


def _feature_maps(backbone_out):
    """The (feature map, mask) pairs of a DETR backbone's output."""
    return backbone_out if torch.is_tensor(backbone_out[0][0]) else backbone_out[0]


class HFDetrAdapter:
    """``model(image, predict_conf) -> DetectionResult`` over an HF
    DETR-family detector, put in eval mode on ``device`` (None: the GPU).

    Args:
        model: a ``transformers`` ``*ForObjectDetection``.
        backbone_level: which backbone level to expose as the fmap for
            ROIAlign (-1: the deepest, the reference's hooked layer).
    """

    def __init__(self, model: Any, backbone_level: int = -1, device=None):
        self.device = default_device() if device is None else torch.device(device)
        self.model = model.eval().to(self.device)
        self.backbone_level = backbone_level
        self.num_labels = model.config.num_labels  # no-object is the trailing column in classic DETR

    @staticmethod
    def _to_tensor(image) -> torch.Tensor:
        """An (H, W, 3) array (the loader convention), a (3, H, W) tensor
        (torch's) or a (1, 3, H, W) tensor -> (1, 3, H, W)."""
        was_tensor = torch.is_tensor(image)
        x = image if was_tensor else torch.from_numpy(np.asarray(image, np.float32))
        if x.ndim == 3:
            x = x[None] if was_tensor and x.shape[0] == 3 else x.permute(2, 0, 1)[None]
        return x

    @torch.inference_mode()
    def __call__(self, image, predict_conf: float = 0.25, **kw) -> DetectionResult:
        x = self._to_tensor(image).to(self.device, torch.float32)
        img_h, img_w = int(x.shape[2]), int(x.shape[3])
        captured = {}
        hook = self.model.model.backbone.register_forward_hook(
            lambda _mod, _inp, out: captured.__setitem__("backbone", out))
        try:
            out = self.model(pixel_values=x)
        finally:
            hook.remove()

        # Classic DETR carries a trailing no-object column and scores by
        # softmax; ConditionalDETR / DeformableDETR drop it and score by
        # sigmoid (focal loss). The logits' width tells them apart.
        logits = out.logits[0]  # (Q, num_labels [+ 1])
        if logits.shape[-1] == self.num_labels + 1:
            probs = logits.softmax(-1)[:, :-1]
        else:
            probs = logits.sigmoid()
        scores, classes = probs.max(-1)
        scores, classes, logits_np, pred_boxes, queries = copy_to_host(
            scores, classes, logits, out.pred_boxes[0], out.last_hidden_state[0])
        keep = scores > predict_conf
        fmap = _feature_maps(captured["backbone"])[self.backbone_level][0]  # (1, C, H', W'), beside its mask
        return DetectionResult(
            boxes=cxcywh_to_xyxy(pred_boxes, img_h, img_w)[keep],
            img_shape=(img_h, img_w),
            scores=scores[keep],
            classes=classes[keep].astype(np.int64),
            logits=logits_np[keep, : self.num_labels],
            features=queries[keep],
            fmaps=[fmap],
        )
