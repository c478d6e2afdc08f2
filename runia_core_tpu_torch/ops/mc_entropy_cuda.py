"""Fused MC-DropBlock channel means + KL entropy: the wrapper of
``csrc/fused_mc_entropy.cu``.

Counterpart of ``runia_core_tpu/ops/mc_entropy_pallas.py``. The pipeline is
split by cost as on the TPU:

* :func:`mc_dropblock_weights` makes the small (B, S, H*W) DropBlock
  keep-weights with PyTorch operations, from an explicit generator;
* :func:`fused_mc_entropy` forms each image's (S, HW) @ (HW, C) / HW samples
  and their marginal entropies in one kernel that reads the feature map
  once. A CPU tensor goes to :func:`fused_mc_entropy_plain` instead.

:func:`fused_mc_entropy_supported` states the kernel's contract; the
scorer's fused route takes the plain version for a shape outside it, before
any launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.evaluation.entropy import neighbors_for
from runia_core_tpu_torch.ops.dropblock import dropblock_keep_weights, dropblock_seed
from runia_core_tpu_torch.ops.entropy import _digamma_const, _marginal_entropy_sorted
from runia_core_tpu_torch.ops.entropy_cuda import MAX_K, MAX_N, block_width

__all__ = [
    "fused_mc_entropy", "fused_mc_entropy_plain", "fused_mc_entropy_supported", "mc_dropblock_weights",
]


def mc_dropblock_weights(
    batch: int,
    height: int,
    width: int,
    mc_samples: int,
    block_size: int,
    drop_prob: float,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """(B, S, H*W) DropBlock keep-weights (keep * per-image scale).

    One Bernoulli draw covers all B*S masks; ``generator`` must live on
    ``device``. ``drop_prob == 0`` gives all-ones weights.
    """
    if drop_prob == 0.0:
        return torch.ones((batch, mc_samples, height * width), device=device)
    seed = dropblock_seed(
        (batch, mc_samples, height, width), drop_prob, block_size, generator, device
    )
    return dropblock_keep_weights(seed, block_size).reshape(batch, mc_samples, height * width)


def fused_mc_entropy_plain(
    weights: torch.Tensor, fmap: torch.Tensor, k: Optional[int] = None, min_dist: float = 1e-5
) -> torch.Tensor:
    """The kernel's plain version: samples = bmm(weights, fmap)/HW, then the
    sorted-window marginal entropy over the S samples."""
    b, h, w, c = fmap.shape
    samples = torch.bmm(weights.to(torch.float32), fmap.reshape(b, h * w, c).to(torch.float32))
    samples = samples / (h * w)
    return _marginal_entropy_sorted(samples, neighbors_for(weights.shape[1]) if k is None else k, min_dist)


def fused_mc_entropy_supported(s: int, hw: int, k: int) -> bool:
    """True if the kernel takes S samples of an H*W = hw tap with k
    neighbours: the entropy's limits, and the S x hw keep-weights plus S
    samples per channel for some block width within one block's shared
    memory."""
    return 1 <= k <= MAX_K and k < s <= MAX_N and block_width(s, s * hw * 4) > 0


def fused_mc_entropy(
    weights: torch.Tensor, fmap: torch.Tensor, k: Optional[int] = None, min_dist: float = 1e-5
) -> torch.Tensor:
    """Keep-weights (B, S, H*W) f32 + feature map (B, H, W, C) f32 -> (B, C)
    marginal KL entropies of the MC channel-mean clouds.

    ``k`` defaults to min(5, S - 1). ``fused_mc_entropy.launches`` counts the
    kernel's launches.
    """
    if not fmap.is_cuda:
        return fused_mc_entropy_plain(weights, fmap, k, min_dist)
    b, h, w, c = fmap.shape
    s = weights.shape[1]
    k = neighbors_for(s) if k is None else k
    for name, t in (("weights", weights), ("fmap", fmap)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != fmap.device:
            raise ValueError(
                f"fused_mc_entropy takes contiguous float32 tensors on one device; {name} is "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
    if weights.shape != (b, s, h * w):
        raise ValueError(f"weights {tuple(weights.shape)} do not match fmap {tuple(fmap.shape)}")
    if not fused_mc_entropy_supported(s, h * w, k):
        raise ValueError(
            f"need 1 <= k <= {MAX_K}, k < S <= {MAX_N} and S x (HW + 32) floats in one "
            f"block's shared memory; got k={k}, S={s}, HW={h * w}"
        )
    out = torch.empty((b, c), dtype=torch.float32, device=fmap.device)
    if out.numel() == 0:
        return out
    lib = _kernels.library()
    with torch.cuda.device(fmap.device):
        code = lib.runia_fused_mc_entropy(
            weights.data_ptr(), fmap.data_ptr(), out.data_ptr(), b, s, h * w, c, k,
            block_width(s, s * h * w * 4), float(min_dist), _digamma_const(k, s),
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(code, "fused_mc_entropy")
    fused_mc_entropy.launches += 1
    return out


fused_mc_entropy.launches = 0
