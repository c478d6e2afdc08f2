"""Monte-Carlo DropBlock sampling of latent activations, in PyTorch.

Counterpart of ``runia_core_tpu/sampling.py``. DropBlock's keep-weights do
not depend on the channel, so every layer type starts from the same
(B, S, H*W) keep-weights (``ops/mc_entropy_cuda.py::mc_dropblock_weights``,
or injected ones): S DropBlock-noised copies of the map are the map times
each sample's weights.

* Conv / "fullmean", the LaREx path: the S masked channel means of an image
  are one (S, HW) @ (HW, C) product divided by HW, and the latent map is
  read once instead of S times;
* Conv / "mean": the mean over W of each noised copy, one product per image
  row, flattened C-major (C, H) for either layout;
* FC / RPN: the noised map flattened, (C, H, W) for ``channel_axis=1`` and
  (H, W, C) for ``channel_axis=3``, as the JAX package flattens it.
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
    """S DropBlock-noised samples of one latent map: (B, S, d).

    ``latent_rep`` is (B, C, H, W) for ``channel_axis=1`` or (B, H, W, C) for
    ``channel_axis=3``. d is C for Conv / "fullmean", C * H for Conv /
    "mean" and C * H * W for the other layer types. ``weights`` (B, S, H*W)
    replaces the keep-weights drawn from ``generator`` (tests inject the JAX
    package's weights).
    """
    if channel_axis == 1:
        b, c, h, w = latent_rep.shape
    elif channel_axis in (3, -1):
        b, h, w, c = latent_rep.shape
    else:
        raise ValueError("channel_axis must be 1 or 3/-1")
    if layer_type == "Conv" and reduction not in ("mean", "fullmean"):
        raise ValueError(f"Unsupported reduction {reduction!r}: 'mean'/'fullmean'")
    if weights is None:
        weights = mc_dropblock_weights(
            b, h, w, mc_samples, block_size, drop_prob, generator, latent_rep.device
        )
    weights = weights.to(latent_rep.dtype)
    if layer_type == "Conv" and reduction == "fullmean":
        if channel_axis == 1:
            flat = latent_rep.permute(0, 2, 3, 1).reshape(b, h * w, c)
        else:
            flat = latent_rep.reshape(b, h * w, c)
        return torch.bmm(weights, flat) / (h * w)
    grid = weights.reshape(b, mc_samples, h, w)
    if layer_type == "Conv":  # "mean": over W, C-major (C, H) columns
        spec = "bshw,bchw->bsch" if channel_axis == 1 else "bshw,bhwc->bsch"
        return (torch.einsum(spec, grid, latent_rep) / w).reshape(b, mc_samples, c * h)
    if channel_axis == 1:
        noised = latent_rep[:, None] * grid[:, :, None]
    else:
        noised = latent_rep[:, None] * grid[..., None]
    return noised.reshape(b, mc_samples, -1)


class MCSamplerModule:
    """Callable MC-DropBlock sampler with the reference's constructor API.

    ``sampler(latent_rep)`` gives (S, d) for a (1, C, H, W) input and
    (B, S, d) otherwise; the masks come from the sampler's ``generator``
    (PyTorch's default generator when None) unless ``weights`` are given.
    ``channel_axis=3`` takes (B, H, W, C) maps.
    """

    def __init__(
        self,
        mc_samples: int,
        block_size: int,
        drop_prob: float,
        layer_type: str = "Conv",
        generator: Optional[torch.Generator] = None,
        channel_axis: int = 1,
    ):
        if layer_type not in ("Conv", "FC", "RPN"):
            raise ValueError(f"unknown layer_type {layer_type!r}")
        self.layer_type = layer_type
        self.mc_samples = mc_samples
        self.block_size = block_size
        self.drop_prob = drop_prob
        self.generator = generator
        self.channel_axis = channel_axis

    def __call__(self, latent_rep: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = mc_dropblock_samples(
            latent_rep, self.mc_samples, self.block_size, self.drop_prob, self.layer_type,
            channel_axis=self.channel_axis, generator=self.generator, weights=weights,
        )
        return out[0] if latent_rep.shape[0] == 1 else out

    # PyTorch-module shims, so reference-style code that moves or switches
    # the sampler keeps working; the sampler holds no tensors.
    def to(self, device) -> "MCSamplerModule":
        return self

    def train(self, mode: bool = True) -> "MCSamplerModule":
        return self

    def eval(self) -> "MCSamplerModule":
        return self
