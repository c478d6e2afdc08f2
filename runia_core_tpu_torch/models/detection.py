"""A built-in single-stage detector and its adapter, in PyTorch.

Counterpart of ``runia_core_tpu/models/detection.py``: a small
convolutional backbone over NHWC images and a dense per-cell head
predicting (cx, cy, w, h, class scores) at one stride, whose raw head
output (B, 4 + num_classes, cells) is what ``yolo_get_logits`` reads. Module
names follow the flax tree (``down{i}``, ``neck``, ``head``), so
``models/convert.py::simple_detector_from_flax`` carries a JAX detector's
weights across.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.extraction.adapters import DetectionResult
from runia_core_tpu_torch.models.resnet import same_padding
from runia_core_tpu_torch.ops.nms import nms_indices
from runia_core_tpu_torch.utils.placement import as_tensor, to_numpy

__all__ = ["JaxDetectorAdapter", "SameConv", "SimpleDetector"]


class SameConv(nn.Conv2d):
    """flax's ``nn.Conv`` with bias and XLA "SAME" padding (``kernel_dilation``
    as ``dilation``), over NCHW."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int = 1, dilation: int = 1):
        super().__init__(in_features, features, kernel, stride, padding=0, dilation=dilation, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (h_lo, h_hi), (w_lo, w_hi) = (same_padding(size, self.kernel_size[0], self.stride[0], self.dilation[0])
                                      for size in x.shape[2:])
        return F.conv2d(F.pad(x, (w_lo, w_hi, h_lo, h_hi)), self.weight, self.bias, self.stride, 0, self.dilation)


class SimpleDetector(nn.Module):
    """Single-scale anchor-free detector with a ``pre_pool`` tap, made on
    ``device`` (None: the GPU)."""

    def __init__(self, num_classes: int = 4, features: int = 32, stride: int = 8, in_channels: int = 3, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.stride = stride
        chans, cin = features, in_channels
        self.n_down = int(np.log2(stride))
        with torch.device(default_device() if device is None else device):
            for i in range(self.n_down):
                self.add_module(f"down{i}", SameConv(cin, chans, 3, 2))
                cin, chans = chans, chans * 2
            self.neck = SameConv(cin, chans, 3)
            self.head = SameConv(chans, 4 + num_classes + 1, 1)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(B, H, W, 3) -> (raw head (B, 4 + nc, cells), taps {"pre_pool": NHWC})."""
        x = images.to(torch.float32).permute(0, 3, 1, 2)
        for i in range(self.n_down):
            x = torch.relu(getattr(self, f"down{i}")(x))
        x = torch.relu(self.neck(x))
        taps = {"pre_pool": x.permute(0, 2, 3, 1)}
        head = self.head(x).permute(0, 2, 3, 1)  # (B, gh, gw, 4 + nc + 1)
        b, gh, gw, _ = head.shape
        cy, cx = torch.meshgrid(torch.arange(gh, device=x.device), torch.arange(gw, device=x.device), indexing="ij")
        centers = torch.stack([cx, cy], dim=-1).reshape(-1, 2) * self.stride + self.stride / 2
        flat = head.reshape(b, gh * gw, -1)
        offsets = torch.tanh(flat[..., :2]) * self.stride
        sizes = F.softplus(flat[..., 2:4]) * self.stride + 2.0
        obj = torch.sigmoid(flat[..., 4])
        cls_scores = torch.softmax(flat[..., 5:], dim=-1) * obj[..., None]
        ctr = centers[None] + offsets
        boxes = torch.cat([ctr - sizes / 2, ctr + sizes / 2], dim=-1)  # (B, cells, 4)
        raw = torch.cat([boxes.permute(0, 2, 1), cls_scores.permute(0, 2, 1)], dim=1)
        return raw, taps


class JaxDetectorAdapter:
    """The detection protocol around :class:`SimpleDetector`:
    ``adapter(image, predict_conf) -> DetectionResult`` with boxes from
    class-aware NMS (``ops/nms.py``, the kernel on the card), the survivors'
    log class scores, and the ``pre_pool`` map as an NCHW tensor on the
    model's device. The name is the JAX package's."""

    def __init__(self, model: SimpleDetector, iou_threshold: float = 0.5, max_det: int = 100):
        self.model = model
        self.iou_threshold = iou_threshold
        self.max_det = max_det

    @torch.inference_mode()
    def __call__(self, image, predict_conf: float = 0.25, **kwargs) -> DetectionResult:
        device = next(self.model.parameters()).device
        imgs = as_tensor(image, device, torch.float32)
        if imgs.ndim == 3:
            imgs = imgs[None]
        raw, taps = self.model(imgs.to(device))
        raw_np = to_numpy(raw)  # (1, 4 + nc, cells)
        img_shape = (imgs.shape[1], imgs.shape[2])

        boxes = raw_np[0, :4].T
        cls = raw_np[0, 4:].T
        conf = cls.max(axis=1)
        labels = cls.argmax(axis=1)
        keep_conf = conf > predict_conf
        boxes, cls, conf, labels = boxes[keep_conf], cls[keep_conf], conf[keep_conf], labels[keep_conf]
        if boxes.shape[0] > 0:
            offset_boxes = boxes + labels[:, None] * 7680  # class-aware NMS
            keep = nms_indices(offset_boxes, conf, self.iou_threshold, max_det=self.max_det, device=device)
        else:
            keep = np.zeros((0,), np.int64)
        return DetectionResult(
            boxes=boxes[keep],
            img_shape=img_shape,
            scores=conf[keep],
            classes=labels[keep],
            logits=np.log(np.clip(cls[keep], 1e-10, None)),
            fmaps=[taps["pre_pool"].permute(0, 3, 1, 2)],
            raw_prediction=raw_np,
            extra={"names": {i: f"class{i}" for i in range(self.model.num_classes)}},
        )
