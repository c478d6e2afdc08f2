"""Monte-Carlo DropBlock sampling of latent activations, in PyTorch.

Counterpart of ``runia_core_tpu/sampling.py`` for the path LaREx scoring
takes: a Conv layer reduced to per-channel means ("fullmean"). DropBlock's
keep-weights do not depend on the channel, so the S masked channel means of
an image are one (S, HW) @ (HW, C) product divided by HW, and the latent map
is read once instead of S times. The other layer types and reductions are
not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from runia_core_tpu_torch.ops.mc_entropy_cuda import mc_dropblock_weights

__all__ = ["MCSamplerModule", "mc_dropblock_samples"]


def mc_dropblock_samples(
    latent_rep: torch.Tensor,
    mc_samples: int,
    block_size: int,
    drop_prob: float,
    layer_type: str = "Conv",
    reduction: str = "fullmean",
    channel_axis: int = 1,
    generator: Optional[torch.Generator] = None,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """S DropBlock-noised channel means of one latent map: (B, S, C).

    ``latent_rep`` is (B, C, H, W) for ``channel_axis=1`` or (B, H, W, C) for
    ``channel_axis=3``. ``weights`` (B, S, H*W) replaces the keep-weights
    drawn from ``generator`` (tests inject the JAX package's weights).
    """
    if layer_type != "Conv" or reduction != "fullmean":
        raise NotImplementedError(
            f"only layer_type='Conv' with reduction='fullmean' is ported; got {layer_type!r}, {reduction!r}"
        )
    if channel_axis == 1:
        b, c, h, w = latent_rep.shape
        flat = latent_rep.permute(0, 2, 3, 1).reshape(b, h * w, c)
    elif channel_axis in (3, -1):
        b, h, w, c = latent_rep.shape
        flat = latent_rep.reshape(b, h * w, c)
    else:
        raise ValueError("channel_axis must be 1 or 3/-1")
    if weights is None:
        weights = mc_dropblock_weights(
            b, h, w, mc_samples, block_size, drop_prob, generator, latent_rep.device
        )
    return torch.bmm(weights.to(flat.dtype), flat) / (h * w)


class MCSamplerModule:
    """Callable MC-DropBlock sampler with the reference's constructor API.

    ``sampler(latent_rep)`` gives (S, d) for a (1, C, H, W) input and
    (B, S, d) otherwise; the masks come from the sampler's ``generator``
    (PyTorch's default generator when None).
    """

    def __init__(
        self,
        mc_samples: int,
        block_size: int,
        drop_prob: float,
        layer_type: str = "Conv",
        generator: Optional[torch.Generator] = None,
    ):
        if layer_type not in ("Conv", "FC", "RPN"):
            raise ValueError(f"unknown layer_type {layer_type!r}")
        self.layer_type = layer_type
        self.mc_samples = mc_samples
        self.block_size = block_size
        self.drop_prob = drop_prob
        self.generator = generator

    def __call__(self, latent_rep: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = mc_dropblock_samples(
            latent_rep, self.mc_samples, self.block_size, self.drop_prob, self.layer_type,
            generator=self.generator, weights=weights,
        )
        return out[0] if latent_rep.shape[0] == 1 else out
