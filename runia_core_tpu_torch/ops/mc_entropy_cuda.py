"""Fused MC-DropBlock channel means + KL entropy: the wrapper of
``csrc/fused_mc_entropy.cu``.

Counterpart of ``runia_core_tpu/ops/mc_entropy_pallas.py``. The pipeline is
split by cost as on the TPU:

* :func:`mc_dropblock_weights` makes the small (B, S, H*W) DropBlock
  keep-weights with PyTorch operations, from an explicit generator;
* :func:`fused_mc_entropy` forms each image's (S, HW) @ (HW, C) / HW samples
  and their marginal entropies in one kernel that reads the feature map
  once, in f32 or as the bf16 a bf16 forward left it (widening is exact, so
  both give the same result). A CPU tensor goes to
  :func:`fused_mc_entropy_plain` instead.

:func:`fused_mc_entropy_supported` states the kernel's contract and
:func:`fused_plan` how a launch is laid out; the scorer's fused route takes
the plain version for a shape outside the contract, before any launch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.evaluation.entropy import neighbors_for
from runia_core_tpu_torch.ops.dropblock import dropblock_keep_weights, dropblock_seed
from runia_core_tpu_torch.ops.entropy import _digamma_const, _marginal_entropy_sorted
from runia_core_tpu_torch.ops.entropy_cuda import CHUNK, MAX_N, REGISTER_WIDTHS, STATIC_K, resident_width
from runia_core_tpu_torch.utils.graphs import count_launch

__all__ = [
    "MAP_DTYPES", "FusedPlan", "fused_mc_entropy", "fused_mc_entropy_plain", "fused_mc_entropy_supported",
    "fused_plan", "mc_dropblock_weights",
]

MAP_DTYPES = (torch.float32, torch.bfloat16)  # feature-map element types the kernel reads


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


class FusedPlan(NamedTuple):
    """How one launch of kernel 2 is laid out."""

    register_width: int  # 8, 16, 32 or 64: samples formed and sorted in registers at a time
    sample_minor: bool  # keep-weights staged (HW, register width): one 16-byte read per 4 FMAs
    static_k: bool  # k = 5 with sample-minor weights: k compiled in, the samples never leave registers
    width: int  # threads per block, one channel each; 0: no width fits
    smem_bytes: int  # dynamic shared memory: the staged weights (+ S sorted samples per thread)


@functools.lru_cache(maxsize=128)
def fused_plan(s: int, hw: int, k: int) -> FusedPlan:
    """The launch plan for S samples of an H*W = hw tap with k neighbours.
    Up to 64 samples take the sample-minor weights where their rows, padded
    to the register width, fit one block's shared memory (beside the samples of a 32-wide block,
    unless k = 5 keeps them in registers); any other shape keeps the
    (S, hw) layout and forms the samples 64 at a time."""
    if s <= CHUNK:
        register_width = next(w for w in REGISTER_WIDTHS if s <= w)
        weight_bytes = hw * register_width * 4
        static_k = k == STATIC_K
        width = resident_width(0 if static_k else s, weight_bytes)
        if width > 0:
            return FusedPlan(register_width, True, static_k, width,
                             weight_bytes + (0 if static_k else s * width * 4))
    width = resident_width(s, s * hw * 4)
    return FusedPlan(CHUNK, False, False, width, s * hw * 4 + s * width * 4)


def fused_mc_entropy_supported(s: int, hw: int, k: int) -> bool:
    """True if the kernel takes S samples of an H*W = hw tap with k
    neighbours: the entropy's limits, and the S x hw keep-weights plus S
    samples per channel for some block width within one block's shared
    memory."""
    return 1 <= k < s <= MAX_N and fused_plan(s, hw, k).width > 0


def fused_mc_entropy(
    weights: torch.Tensor, fmap: torch.Tensor, k: Optional[int] = None, min_dist: float = 1e-5
) -> torch.Tensor:
    """Keep-weights (B, S, H*W) f32 + feature map (B, H, W, C) f32 or bf16
    -> (B, C) f32 marginal KL entropies of the MC channel-mean clouds.

    ``k`` defaults to min(5, S - 1). ``fused_mc_entropy.launches`` counts the
    kernel's launches.
    """
    if not fmap.is_cuda:
        return fused_mc_entropy_plain(weights, fmap, k, min_dist)
    b, h, w, c = fmap.shape
    s = weights.shape[1]
    k = neighbors_for(s) if k is None else k
    for name, t, dtypes in (("weights", weights, MAP_DTYPES[:1]), ("fmap", fmap, MAP_DTYPES)):
        if t.dtype not in dtypes or not t.is_contiguous() or t.device != fmap.device:
            raise ValueError(
                "fused_mc_entropy takes contiguous float32 weights and a contiguous float32 or "
                f"bfloat16 map on one device; {name} is {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()}"
            )
    if weights.shape != (b, s, h * w):
        raise ValueError(f"weights {tuple(weights.shape)} do not match fmap {tuple(fmap.shape)}")
    if not fused_mc_entropy_supported(s, h * w, k):
        raise ValueError(
            f"need 1 <= k < S <= {MAX_N} and S x (HW + 32) floats in one block's shared memory; "
            f"got k={k}, S={s}, HW={h * w}"
        )
    out = torch.empty((b, c), dtype=torch.float32, device=fmap.device)
    if out.numel() == 0:
        return out
    plan = fused_plan(s, h * w, k)
    lib = _kernels.library()
    with _kernels.device_guard(fmap.device):
        code = lib.runia_fused_mc_entropy(
            weights.data_ptr(), fmap.data_ptr(), out.data_ptr(), b, s, h * w, c, k,
            plan.register_width, int(plan.sample_minor), int(plan.static_k), plan.width,
            int(fmap.dtype == torch.bfloat16),
            float(min_dist), _digamma_const(k, s), torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(code, "fused_mc_entropy")
    count_launch(fused_mc_entropy)
    return out


fused_mc_entropy.launches = 0
