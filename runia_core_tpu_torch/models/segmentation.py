"""A small semantic-segmentation model with feature taps, in PyTorch.

Counterpart of ``runia_core_tpu/models/segmentation.py``: an encoder of two
stride-2 convolutions, a dilated context conv at the bottleneck (the LaREx
tap point) and a decoder that upsamples by repetition with a skip. Module
names follow the flax tree (``enc1``, ``enc2``, ``aspp``, ``dec1``,
``head``), so ``models/convert.py::segmenter_from_flax`` carries a JAX
model's parameters across.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.models.detection import SameConv

__all__ = ["SimpleSegmenter"]


def _repeat2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of an NCHW map: ``jnp.repeat`` on H, then on W."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class SimpleSegmenter(nn.Module):
    """Encoder-decoder segmenter, made on ``device`` (None: the GPU).

    ``model(images) -> (per-pixel logits (B, H, W, num_classes), taps)``
    with the ``bottleneck`` / ``pre_pool`` tap (B, H/4, W/4, 4 * features).
    """

    def __init__(self, num_classes: int = 8, features: int = 16, in_channels: int = 3, device=None):
        super().__init__()
        f = features
        with torch.device(default_device() if device is None else device):
            self.enc1 = SameConv(in_channels, f, 3, 2)
            self.enc2 = SameConv(f, 2 * f, 3, 2)
            self.aspp = SameConv(2 * f, 4 * f, 3, dilation=2)
            self.dec1 = SameConv(4 * f + f, 2 * f, 3)
            self.head = SameConv(2 * f, num_classes, 1)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x = images.to(torch.float32).permute(0, 3, 1, 2)
        e1 = torch.relu(self.enc1(x))
        b = torch.relu(self.aspp(torch.relu(self.enc2(e1))))
        bottleneck = b.permute(0, 2, 3, 1)
        taps = {"bottleneck": bottleneck, "pre_pool": bottleneck}
        up1 = torch.relu(self.dec1(torch.cat([_repeat2(b), e1], dim=1)))
        logits = self.head(_repeat2(up1))
        return logits.permute(0, 2, 3, 1), taps
