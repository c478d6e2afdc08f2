"""Functional DropBlock2D and Dropout with the JAX package's semantics, in PyTorch.

Counterpart of ``runia_core_tpu/ops/dropblock.py``. The operation is split in
two so that tests can feed both frameworks the same random draw:

* :func:`dropblock_seed` draws the Bernoulli(gamma) seed mask from an
  explicit ``torch.Generator`` (gamma = drop_prob / block_size**2);
* :func:`dropblock_keep_weights` turns a seed mask into the per-image
  ``keep * scale`` weights: max-pool with ``block_size // 2`` padding, the
  even-``block_size`` trim, ``keep = 1 - pooled`` and the PER-IMAGE scale
  ``H*W / max(sum(keep), 1)`` (not the upstream package's global scalar,
  which couples an image's scores to its batchmates' masks).

Given the same seed mask, the weights equal the JAX ones to within one ulp:
the same f32 operations run in the same order. :func:`dropout` likewise takes
an injected keep mask in place of its Bernoulli draw.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["dropblock2d", "dropblock_keep_weights", "dropblock_seed", "dropout"]


def dropblock_seed(
    shape: Sequence[int],
    drop_prob: float,
    block_size: int,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Bernoulli(drop_prob / block_size**2) seed mask of ``shape`` as f32 0/1."""
    gamma = drop_prob / (block_size**2)
    uniform = torch.rand(tuple(shape), generator=generator, device=device)
    return (uniform < gamma).to(torch.float32)


def dropblock_keep_weights(seed: torch.Tensor, block_size: int) -> torch.Tensor:
    """(..., H, W) seed mask -> (..., H, W) keep * scale, scaled per image."""
    *lead, h, w = seed.shape
    pad = block_size // 2
    pooled = F.max_pool2d(
        seed.reshape(-1, 1, h, w), block_size, stride=1, padding=pad
    )[:, 0]
    if block_size % 2 == 0:
        pooled = pooled[:, :-1, :-1]
    keep = 1.0 - pooled
    scale = (h * w) / torch.clamp_min(keep.sum(dim=(1, 2), keepdim=True), 1.0)
    return (keep * scale).reshape(*lead, h, w)


def dropblock2d(
    x: torch.Tensor,
    drop_prob: float,
    block_size: int,
    channel_axis: int = 1,
    generator: Optional[torch.Generator] = None,
    seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DropBlock2D over a (B, C, H, W) (default) or (B, H, W, C) tensor.

    ``seed`` (B, H, W) replaces the Bernoulli draw when given; otherwise it
    is drawn from ``generator`` on ``x``'s device. ``drop_prob == 0`` is the
    identity.
    """
    if drop_prob == 0.0:
        return x
    if x.ndim != 4:
        raise ValueError(f"dropblock2d expects a 4-D tensor, got shape {tuple(x.shape)}")
    if channel_axis == 1:
        b, _, h, w = x.shape
    elif channel_axis in (3, -1):
        b, h, w, _ = x.shape
    else:
        raise ValueError("channel_axis must be 1 or 3/-1")
    if seed is None:
        seed = dropblock_seed((b, h, w), drop_prob, block_size, generator, x.device)
    weights = dropblock_keep_weights(seed.to(torch.float32), block_size).to(x.dtype)
    if channel_axis == 1:
        return x * weights[:, None, :, :]
    return x * weights[:, :, :, None]


def dropout(
    x: torch.Tensor,
    rate: float,
    generator: Optional[torch.Generator] = None,
    keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverted dropout as ``torch.nn.Dropout`` in train mode: each element
    kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``.
    ``keep`` (boolean, ``x``'s shape) replaces the Bernoulli draw from
    ``generator``. ``rate == 0`` is the identity."""
    if rate == 0.0:
        return x
    if keep is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep.to(torch.bool), x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
