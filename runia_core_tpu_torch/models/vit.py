"""Vision Transformer classifier with feature taps, in PyTorch.

Counterpart of ``runia_core_tpu/models/vit.py``: patch embedding, pre-LN
encoder blocks, a pooled head. NHWC images in; taps ``encoder_tokens``, the
final patch tokens on their (B, h, w, D) grid (the LaREx hook point, so
``build_larex_scorer(tap="encoder_tokens", channel_axis=3)`` runs on a
transformer unchanged), and ``pre_head``, the pooled (B, D) feature.

The attention is flax's ``MultiHeadDotProductAttention`` (per-head
query / key / value / out projections with biases, softmax of q.k /
sqrt(head_dim)), here through ``F.scaled_dot_product_attention``. The GELU is
flax's tanh approximation unless ``exact_gelu`` (HF and timm use the erf
form). Weights are f32 and made on ``device`` (None: the GPU);
``models/convert.py::vit_from_flax`` carries a flax ViT's parameters across,
``models/torch_convert.py::convert_hf_vit`` a ``transformers`` one.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from runia_core_tpu_torch import default_device

__all__ = ["EncoderBlock", "ViT"]


class _Attention(nn.Module):
    """Self-attention with flax ``MultiHeadDotProductAttention``'s projections."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape

        def heads(y):
            return y.reshape(b, t, self.num_heads, d // self.num_heads).transpose(1, 2)

        y = F.scaled_dot_product_attention(heads(self.query(x)), heads(self.key(x)), heads(self.value(x)))
        return self.out(y.transpose(1, 2).reshape(b, t, d))


class EncoderBlock(nn.Module):
    """Pre-LN block: x + attn(LN(x)), then x + MLP(LN(x)) with a 4x GELU MLP."""

    def __init__(self, num_heads: int, d_model: int, exact_gelu: bool = False, ln_eps: float = 1e-6):
        super().__init__()
        self.approximate = "none" if exact_gelu else "tanh"
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=ln_eps)
        self.attn = _Attention(d_model, num_heads)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=ln_eps)
        self.Dense_0 = nn.Linear(d_model, 4 * d_model)
        self.Dense_1 = nn.Linear(4 * d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.LayerNorm_0(x))
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate=self.approximate)
        return x + self.Dense_1(h)


class ViT(nn.Module):
    """Patch-embed -> pre-LN encoder stack -> pooled head.

    The default is mean pooling with no CLS token, so every token is a patch;
    ``use_cls_token=True`` with ``pool="cls"`` is the HF / timm layout. The
    CLS token is never part of the ``encoder_tokens`` grid. Images must tile
    into patches, and the position embedding fixes the grid: its length is
    ``(image_size / patch_size)^2`` (+1 with the CLS token)."""

    def __init__(self, num_classes: int, patch_size: int = 4, d_model: int = 64, num_layers: int = 4,
                 num_heads: int = 4, use_cls_token: bool = False, pool: str = "mean", exact_gelu: bool = False,
                 ln_eps: float = 1e-6, image_size: int = 32, in_channels: int = 3, device=None):
        super().__init__()
        if pool not in ("mean", "cls"):
            raise ValueError(f"pool must be 'mean' or 'cls', got {pool!r}")
        if pool == "cls" and not use_cls_token:
            raise ValueError("pool='cls' needs use_cls_token=True")
        if image_size % patch_size:
            raise ValueError(f"image size {image_size} does not tile into patches of {patch_size}")
        self.patch_size, self.d_model, self.pool = patch_size, d_model, pool
        self.use_cls_token = use_cls_token
        tokens = (image_size // patch_size) ** 2 + int(use_cls_token)
        with torch.device(default_device() if device is None else device):
            self.patch_embed = nn.Conv2d(in_channels, d_model, patch_size, patch_size)
            if use_cls_token:
                self.cls_token = nn.Parameter(torch.zeros(1, 1, d_model))
            self.pos_embed = nn.Parameter(torch.zeros(1, tokens, d_model))
            for i in range(num_layers):
                self.add_module(f"block_{i}", EncoderBlock(num_heads, d_model, exact_gelu, ln_eps))
            self.encoder_norm = nn.LayerNorm(d_model, eps=ln_eps)
            self.head = nn.Linear(d_model, num_classes)
        self.num_layers = num_layers

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        b, height, width, _ = images.shape
        p = self.patch_size
        if height % p or width % p:
            raise ValueError("image must tile into patches")
        h, w = height // p, width // p
        x = self.patch_embed(images.to(torch.float32).permute(0, 3, 1, 2))  # (B, D, h, w)
        x = x.flatten(2).transpose(1, 2)  # (B, h*w, D), tokens in row-major (h, w) order
        if self.use_cls_token:
            x = torch.cat([self.cls_token.expand(b, 1, self.d_model), x], dim=1)
        x = x + self.pos_embed
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x)
        x = self.encoder_norm(x)
        patch_tokens = x[:, int(self.use_cls_token):]
        pooled = x[:, 0] if self.pool == "cls" else patch_tokens.mean(dim=1)
        taps = {"encoder_tokens": patch_tokens.reshape(b, h, w, self.d_model), "pre_head": pooled}
        return self.head(pooled), taps

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "ViT":
        """Seeded init after flax's: lecun-normal kernels (std 1/sqrt(fan_in),
        untruncated), zero biases, LayerNorms at (1, 0), CLS token and
        position embedding N(0, 0.02^2)."""
        def normal(p: torch.Tensor, std: float) -> None:
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device, dtype=p.dtype) * std)

        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                normal(module.weight, 1.0 / math.sqrt(module.weight[0].numel()))
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        normal(self.pos_embed, 0.02)
        if self.use_cls_token:
            normal(self.cls_token, 0.02)
        return self
