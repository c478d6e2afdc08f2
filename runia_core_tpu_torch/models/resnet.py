"""ResNet family with built-in feature taps, in PyTorch.

Counterpart of ``runia_core_tpu/models/resnet.py``. Every model returns
``(logits, taps)``, where the taps are NHWC as in the JAX package:

  - ``stem``, ``block1..block4``: post-stage feature maps (B, H, W, C)
  - ``pre_pool``: the last feature map (the LaREx hook point)
  - ``penultimate``: pooled features (B, C) feeding the head

Inputs are NHWC images. Inside, tensors are NCHW views; an NHWC input is
already ``channels_last`` in memory, so on the GPU the convolutions run
channels-last and the NHWC taps are contiguous views that cost no copy.

Padding follows XLA's "SAME" rule, as flax does: for a stride-2 3x3 conv or
max-pool on an even input it pads (0, 1), not (1, 1). ``torch_padding=True``
keeps the symmetric k//2 padding of torchvision checkpoints.

Module and parameter names match the flax tree (``conv_init``, ``bn_init``,
``stage{i}_block{j}.Conv_c`` / ``BatchNorm_c`` / ``conv_proj`` /
``norm_proj``, ``head``), so ``models/convert.py`` maps one onto the other.
``s2d_stem``, ``output_stride`` and ``remat`` are not ported yet.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from runia_core_tpu_torch import default_device

__all__ = [
    "BatchNorm",
    "BottleneckResNetBlock",
    "Conv",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNetBlock",
    "build_tapped_forward",
    "same_padding",
]


def same_padding(size: int, kernel: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """(low, high) padding of XLA "SAME" along one spatial dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """Bias-free convolution with XLA "SAME" padding (``padding="SAME"``) or
    a fixed symmetric padding (an int). Computes in the input's dtype."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int = 1,
                 dilation: int = 1, padding="SAME"):
        super().__init__(in_features, features, kernel, stride, padding=0, dilation=dilation, bias=False)
        self.same = padding == "SAME"
        self.fixed_padding = 0 if self.same else int(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        padding = self.fixed_padding
        if self.same:
            (h_lo, h_hi), (w_lo, w_hi) = (
                same_padding(size, self.kernel_size[0], self.stride[0], self.dilation[0])
                for size in x.shape[2:]
            )
            if (h_lo, w_lo) == (h_hi, w_hi):
                padding = (h_lo, w_lo)
            else:
                x = F.pad(x, (w_lo, w_hi, h_lo, h_hi))
                padding = 0
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride, padding, self.dilation)


def _padding_rule(torch_padding: bool) -> Callable[[int], object]:
    """kernel size -> the ``padding`` argument of :class:`Conv`."""
    return (lambda k: k // 2) if torch_padding else (lambda k: "SAME")


class BatchNorm(nn.Module):
    """Inference-mode batch norm, ``x * s + (bias - mean * s)`` with
    ``s = scale * rsqrt(var + eps)`` folded in f32: one elementwise pass."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * scale
        return torch.addcmul(shift.to(x.dtype)[:, None, None], x, scale.to(x.dtype)[:, None, None])


class ResNetBlock(nn.Module):
    """Basic residual block (two 3x3 convs)."""

    expansion = 1

    def __init__(self, in_features: int, filters: int, stride: int = 1, torch_padding: bool = False):
        super().__init__()
        pad = _padding_rule(torch_padding)
        self.Conv_0 = Conv(in_features, filters, 3, stride, padding=pad(3))
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, padding=pad(3))
        self.BatchNorm_1 = BatchNorm(filters)
        self.has_proj = stride != 1 or in_features != filters
        if self.has_proj:
            self.conv_proj = Conv(in_features, filters, 1, stride, padding=pad(1))
            self.norm_proj = BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.has_proj else x
        return torch.relu(residual + y)


class BottleneckResNetBlock(nn.Module):
    """Bottleneck residual block (1x1 -> 3x3 -> 1x1), stride on the 3x3."""

    expansion = 4

    def __init__(self, in_features: int, filters: int, stride: int = 1, torch_padding: bool = False):
        super().__init__()
        pad = _padding_rule(torch_padding)
        self.Conv_0 = Conv(in_features, filters, 1, padding=pad(1))
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, stride, padding=pad(3))
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, filters * 4, 1, padding=pad(1))
        self.BatchNorm_2 = BatchNorm(filters * 4)
        self.has_proj = stride != 1 or in_features != filters * 4
        if self.has_proj:
            self.conv_proj = Conv(in_features, filters * 4, 1, stride, padding=pad(1))
            self.norm_proj = BatchNorm(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.has_proj else x
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """ResNet with taps; NHWC in and out; computes in ``dtype`` while the
    parameters stay f32 (as flax's ``dtype`` / ``param_dtype``). They are
    made on ``device``: None is ``runia_core_tpu_torch.default_device()``,
    the GPU. ``ResNet18``, ``ResNet34`` and ``ResNet50`` pass it through."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls: type,
        num_classes: int,
        num_filters: int = 64,
        cifar_stem: bool = False,
        dtype: torch.dtype = torch.float32,
        include_head: bool = True,
        torch_padding: bool = False,
        in_channels: int = 3,
        device=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.cifar_stem = cifar_stem
        self.include_head = include_head
        self.torch_padding = torch_padding
        self.stage_sizes = tuple(stage_sizes)
        # Every parameter and buffer is made on ``device`` (None: the GPU).
        with torch.device(default_device() if device is None else device):
            if cifar_stem:
                self.conv_init = Conv(in_channels, num_filters, 3, padding=_padding_rule(torch_padding)(3))
            else:
                self.conv_init = Conv(in_channels, num_filters, 7, 2, padding=3)
            self.bn_init = BatchNorm(num_filters)
            features = num_filters
            for i, size in enumerate(self.stage_sizes):
                for j in range(size):
                    stride = 2 if i > 0 and j == 0 else 1
                    filters = num_filters * 2**i
                    block = block_cls(features, filters, stride, torch_padding)
                    self.add_module(f"stage{i + 1}_block{j}", block)
                    features = filters * block_cls.expansion
            if include_head:
                self.head = nn.Linear(features, num_classes)

    def _max_pool(self, x: torch.Tensor) -> torch.Tensor:
        if self.torch_padding:
            return F.max_pool2d(x, 3, 2, padding=1)
        (h_lo, h_hi), (w_lo, w_hi) = (same_padding(size, 3, 2) for size in x.shape[2:])
        return F.max_pool2d(F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=-math.inf), 3, 2)

    def forward(self, images: torch.Tensor) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
        x = images.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW view
        taps: Dict[str, torch.Tensor] = {}
        x = torch.relu(self.bn_init(self.conv_init(x)))
        if not self.cifar_stem:
            x = self._max_pool(x)
        taps["stem"] = x.permute(0, 2, 3, 1)
        for i, size in enumerate(self.stage_sizes):
            for j in range(size):
                x = getattr(self, f"stage{i + 1}_block{j}")(x)
            taps[f"block{i + 1}"] = x.permute(0, 2, 3, 1)
        taps["pre_pool"] = taps[f"block{len(self.stage_sizes)}"]
        x = x.mean(dim=(2, 3))
        taps["penultimate"] = x
        if not self.include_head:
            return None, taps
        logits = F.linear(x, self.head.weight.to(x.dtype), self.head.bias.to(x.dtype))
        return logits, taps

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "ResNet":
        """Seeded init mirroring flax's: lecun-normal conv and dense kernels
        (std 1/sqrt(fan_in); flax truncates at 2 std, this does not), batch
        norms at (scale 1, bias 0, mean 0, var 1), the last norm of every
        block at scale 0, the head bias at 0."""
        def normal(p: torch.Tensor, fan_in: int) -> None:
            noise = torch.randn(p.shape, generator=generator, device=p.device, dtype=p.dtype)
            p.copy_(noise / math.sqrt(fan_in))

        for module in self.modules():
            if isinstance(module, Conv):
                normal(module.weight, module.weight[0].numel())
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        for name, module in self.named_children():
            if name.startswith("stage"):
                last = module.BatchNorm_2 if hasattr(module, "BatchNorm_2") else module.BatchNorm_1
                last.weight.zero_()
        if self.include_head:
            normal(self.head.weight, self.head.weight.shape[1])
            self.head.bias.zero_()
        return self


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=ResNetBlock)
ResNet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=ResNetBlock)
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BottleneckResNetBlock)


def build_tapped_forward(
    model: nn.Module, taps: Sequence[str] = ("pre_pool",), channel_first_taps: bool = False
) -> Callable:
    """Forward returning (logits, {tap: tensor}) for the requested taps only,
    under ``torch.inference_mode``. With ``channel_first_taps`` the 4-D taps
    come out NCHW."""
    wanted = tuple(taps)

    @torch.inference_mode()
    def forward(images: torch.Tensor):
        logits, all_taps = model(images)
        out = {}
        for name in wanted:
            t = all_taps[name]
            out[name] = t.permute(0, 3, 1, 2) if channel_first_taps and t.ndim == 4 else t
        return logits, out

    return forward
