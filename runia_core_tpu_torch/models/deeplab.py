"""DeepLabv3+ semantic segmentation with feature taps, in PyTorch.

Counterpart of ``runia_core_tpu/models/deeplab.py``: a dilated ResNet
backbone (``ResNet(output_stride=..., include_head=False)``), the ASPP
context head with image-level pooling, and the v3+ decoder with a low-level
skip. Images are NHWC; inside, tensors are NCHW views as in
``models/resnet.py``. The forward returns ``(logits (B, H, W, classes),
taps)`` with the JAX package's NHWC taps:

  - ``stem``, ``block1..N``: the backbone's stages
  - ``aspp`` and its alias ``pre_pool``: the ASPP projection, the
    MC-DropBlock insertion point
  - ``penultimate``: the ASPP projection's global mean (B, C)
  - ``decoder``: the decoder's features at 1/4 resolution

Module names follow the flax tree (``backbone``, ``aspp.Conv_i`` /
``BatchNorm_i`` / ``image_pool`` / ``proj`` / ``proj_bn``, ``low_proj``,
``low_bn``, ``dec1``, ``dec_bn1``, ``dec2``, ``dec_bn2``, ``head``), so
``models/convert.py::deeplab_from_flax`` carries a JAX model's variables
across.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.models.resnet import BatchNorm, BottleneckResNetBlock, Conv, ResNet

__all__ = ["ASPP", "DeepLabV3Plus"]


def _resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NCHW maps in f32, half-pixel centres and no
    antialiasing: ``jax.image.resize(..., "bilinear", antialias=False)``."""
    return F.interpolate(x.to(torch.float32), size=hw, mode="bilinear", align_corners=False)


def _conv_bn_relu(conv: nn.Module, norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return torch.relu(norm(conv(x)))


class ASPP(nn.Module):
    """Atrous Spatial Pyramid Pooling over NCHW: a 1x1 branch, one dilated
    3x3 branch per rate and image-level pooling, concatenated and projected
    to ``features``. The pooled branch is broadcast back over the map (the
    bilinear upsample of a 1x1 map, without the gather)."""

    def __init__(self, in_features: int, features: int = 256, rates: Sequence[int] = (6, 12, 18)):
        super().__init__()
        self.rates = tuple(rates)
        self.Conv_0 = Conv(in_features, features, 1)
        self.BatchNorm_0 = BatchNorm(features)
        for i, rate in enumerate(self.rates, start=1):
            self.add_module(f"Conv_{i}", Conv(in_features, features, 3, dilation=rate))
            self.add_module(f"BatchNorm_{i}", BatchNorm(features))
        self.image_pool = Conv(in_features, features, 1)
        self.add_module(f"BatchNorm_{len(self.rates) + 1}", BatchNorm(features))
        self.proj = Conv(features * (len(self.rates) + 2), features, 1)
        self.proj_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.rates) + 1
        branches = [_conv_bn_relu(getattr(self, f"Conv_{i}"), getattr(self, f"BatchNorm_{i}"), x) for i in range(n)]
        pooled = _conv_bn_relu(self.image_pool, getattr(self, f"BatchNorm_{n}"), x.mean(dim=(2, 3), keepdim=True))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        return _conv_bn_relu(self.proj, self.proj_bn, torch.cat(branches, dim=1))


class DeepLabV3Plus(nn.Module):
    """DeepLabv3+ with a dilated ResNet backbone and taps, made on ``device``
    (None: the GPU) and in ``eval()`` mode (BatchNorm on running statistics).

    ``model(images, generator=None) -> (logits (B, H, W, num_classes) f32,
    taps)``. The decoder's dropout (``dropout_rate``) is active only when a
    ``generator`` is given, which it draws its keep mask from: the JAX
    model's ``has_rng("dropout")``. The defaults are the JAX package's, the
    paper's VOC setting (ResNet-50, output stride 16, ASPP 256 at rates 6 /
    12 / 18, low-level 48, 21 classes)."""

    def __init__(
        self,
        num_classes: int = 21,
        backbone_stages: Sequence[int] = (3, 4, 6, 3),
        backbone_block: type = BottleneckResNetBlock,
        num_filters: int = 64,
        output_stride: int = 16,
        aspp_features: int = 256,
        low_level_features: int = 48,
        aspp_rates: Sequence[int] = (6, 12, 18),
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        if len(backbone_stages) < 2:
            raise ValueError(
                "DeepLabV3Plus needs a backbone with >= 2 stages (the "
                "decoder skips from block1; ASPP reads the last stage)"
            )
        self.n_stages = len(backbone_stages)
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        device = default_device() if device is None else device
        self.backbone = ResNet(tuple(backbone_stages), backbone_block, 0, num_filters=num_filters, dtype=dtype,
                               output_stride=output_stride, include_head=False, device=device)
        expansion = backbone_block.expansion
        last = num_filters * 2 ** (self.n_stages - 1) * expansion
        with torch.device(device):
            self.aspp = ASPP(last, aspp_features, aspp_rates)
            self.low_proj = Conv(num_filters * expansion, low_level_features, 1)
            self.low_bn = BatchNorm(low_level_features)
            self.dec1 = Conv(aspp_features + low_level_features, aspp_features, 3)
            self.dec_bn1 = BatchNorm(aspp_features)
            self.dec2 = Conv(aspp_features, aspp_features, 3)
            self.dec_bn2 = BatchNorm(aspp_features)
            self.head = nn.Conv2d(aspp_features, num_classes, 1)
        self.eval()

    def forward(self, images: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        in_hw = (images.shape[1], images.shape[2])
        _, bb_taps = self.backbone(images)
        taps: Dict[str, torch.Tensor] = {}
        for k in ["stem"] + [f"block{i + 1}" for i in range(self.n_stages)]:
            taps[k] = bb_taps[k]

        a = self.aspp(bb_taps[f"block{self.n_stages}"].permute(0, 3, 1, 2))
        taps["aspp"] = taps["pre_pool"] = a.permute(0, 2, 3, 1)
        taps["penultimate"] = a.mean(dim=(2, 3))

        low = _conv_bn_relu(self.low_proj, self.low_bn, bb_taps["block1"].permute(0, 3, 1, 2))
        up = _resize(a, (low.shape[2], low.shape[3])).to(low.dtype)
        y = _conv_bn_relu(self.dec1, self.dec_bn1, torch.cat([up, low], dim=1))
        y = _conv_bn_relu(self.dec2, self.dec_bn2, y)
        taps["decoder"] = y.permute(0, 2, 3, 1)
        if self.dropout_rate > 0.0 and generator is not None:
            keep_prob = 1.0 - self.dropout_rate
            keep = torch.rand(y.shape, generator=generator, device=y.device) < keep_prob
            y = torch.where(keep, y / keep_prob, torch.zeros((), dtype=y.dtype, device=y.device))
        logits = F.conv2d(y, self.head.weight.to(y.dtype), self.head.bias.to(y.dtype))
        return _resize(logits, in_hw).permute(0, 2, 3, 1), taps
