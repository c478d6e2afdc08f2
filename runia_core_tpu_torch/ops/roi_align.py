"""ROIAlign in PyTorch, with a CUDA kernel for the card.

Counterpart of ``runia_core_tpu/ops/roi_align.py``, with torchvision's
semantics as the JAX package keeps them: continuous coordinates, the
half-pixel ``aligned`` offset, the adaptive ``ceil(roi / out)`` sampling
grid capped at ``max_samples``, zero outside [-1, size], edge clamping and
``count = max(grid, 1)``. Sample positions and interpolation weights are
f32 whatever the map's dtype.

* The plain version (:func:`roi_align_nhwc_plain`) is the JAX form:
  per-ROI separable interpolation matrices Ay (N, out_h, H) and Ax (N,
  out_w, W) built from one-hot sums (:func:`_axis_weights`) and two
  contractions against each ROI's map. For a bf16 map Ay and Ax are cast
  to bf16, each contraction sums in f32 and its result is rounded to bf16,
  as JAX's two bf16 einsums do.
* The kernel (``csrc/roi_align.cu``, :func:`roi_align_nhwc_cuda`) takes a
  whole batch of NHWC maps and ``B * M`` boxes in one launch, reads the
  channels of each map tap as one coalesced row, 16 bytes a thread, and
  sums in f32. It writes the pooled bins, or with ``mean=True`` only each
  ROI's channel means (the bins summed in registers), which is all the
  object-level scorers keep. :func:`_plan` chooses its launch: the channel
  tile a block covers and the thread groups the bins (pooled) or the
  footprint's rows (means) are split over.

:func:`roi_align` keeps the JAX function's contract (one (C, H, W) map,
(N, C, oh, ow) out) through :func:`roi_align_nhwc`, the batched entry point
the extractors use, which takes the kernel for a CUDA tensor and the plain
version for a CPU one.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.utils.graphs import count_launch

__all__ = [
    "MAP_DTYPES", "roi_align", "roi_align_nhwc", "roi_align_nhwc_cuda", "roi_align_nhwc_plain",
]

MAP_DTYPES = (torch.float32, torch.bfloat16)  # the maps the kernel reads
_MAX_THREADS = 512  # csrc/roi_align.cu kRoiMaxThreads
_MAX_SMEM = 227 * 1024
_POOLED_GROUPS, _POOLED_TILE = 8, 32  # bin groups, channel vectors of a pooled block
_MEAN_GROUPS = 32  # footprint-row groups of a means block, at most
_MIN_BLOCKS = 264  # two blocks an SM of the H100's 132, where the channels allow


def _out_hw(output_size: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    if isinstance(output_size, int):
        return output_size, output_size
    out_h, out_w = output_size
    return int(out_h), int(out_w)


def _axis_weights(start, bin_size, grid_n, out_size: int, size: int, max_samples: int) -> torch.Tensor:
    """(N, out_size, size) interpolation-weight matrix of one axis."""
    dtype, device = start.dtype, start.device
    ph = torch.arange(out_size, dtype=dtype, device=device)
    iy = torch.arange(max_samples, dtype=dtype, device=device)
    grid_f = grid_n.to(dtype)[:, None, None]
    grid_div = torch.clamp(grid_f, min=1.0)  # count = max(grid, 1): a degenerate ROI weighs nothing
    pos = (
        start[:, None, None]
        + ph[None, :, None] * bin_size[:, None, None]
        + bin_size[:, None, None] * (iy[None, None, :] + 0.5) / grid_div
    )  # (N, out, S)
    valid = (iy[None, None, :] < grid_f) & torch.isfinite(pos)
    outside = (pos < -1.0) | (pos > size)
    p = torch.clamp(pos, min=0.0)
    low = torch.floor(p).to(torch.int32)
    at_edge = low >= size - 1
    low = torch.where(at_edge, size - 1, low)
    p = torch.where(at_edge, low.to(dtype), p)
    high = torch.clamp(low + 1, 0, size - 1)
    frac = p - low.to(dtype)
    w = torch.where(valid & ~outside, 1.0, 0.0) / grid_div
    w_low = w * (1.0 - frac)
    w_high = w * frac
    cols = torch.arange(size, dtype=torch.int32, device=device)
    onehot_low = (low[..., None] == cols).to(dtype)
    onehot_high = (high[..., None] == cols).to(dtype)
    return torch.einsum("nos,nosz->noz", w_low, onehot_low) + torch.einsum("nos,nosz->noz", w_high, onehot_high)


def _interpolation(boxes, out_h, out_w, h, w, spatial_scale, sampling_ratio, aligned, max_samples):
    """Ay (N, out_h, H) and Ax (N, out_w, W) of f32 boxes."""
    boxes = boxes.to(torch.float32)
    offset = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - offset
    y1 = boxes[:, 1] * spatial_scale - offset
    x2 = boxes[:, 2] * spatial_scale - offset
    y2 = boxes[:, 3] * spatial_scale - offset
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    bin_w = roi_w / out_w
    bin_h = roi_h / out_h
    if sampling_ratio > 0:
        grid_h = torch.full(boxes.shape[:1], sampling_ratio, dtype=torch.int32, device=boxes.device)
        grid_w = grid_h
        cap = sampling_ratio
    else:
        grid_h = torch.clamp(torch.ceil(roi_h / out_h).to(torch.int32), 0, max_samples)
        grid_w = torch.clamp(torch.ceil(roi_w / out_w).to(torch.int32), 0, max_samples)
        cap = max_samples
    return (_axis_weights(y1, bin_h, grid_h, out_h, h, cap), _axis_weights(x1, bin_w, grid_w, out_w, w, cap))


def roi_align_nhwc_plain(
    fmap: torch.Tensor,
    boxes: torch.Tensor,
    output_size,
    spatial_scale: float,
    sampling_ratio: int = -1,
    aligned: bool = True,
    max_samples: int = 16,
    mean: bool = False,
) -> torch.Tensor:
    """The JAX form over a batch: (B, H, W, C) maps and (B * M, 4) boxes, ROI
    k on image k // M -> (B * M, C, oh, ow), or with ``mean`` the channel
    means (B * M, C) of the pooled bins, in the map's dtype."""
    b, h, w, _ = fmap.shape
    k = boxes.shape[0]
    if k % b:
        raise ValueError(f"{k} boxes do not split evenly over {b} images")
    out_h, out_w = _out_hw(output_size)
    ay, ax = _interpolation(boxes, out_h, out_w, h, w, spatial_scale, sampling_ratio, aligned, max_samples)
    m = k // b
    # Both contractions in the map's dtype (bf16: f32 sums, each result
    # rounded to bf16, as JAX's preferred_element_type=f32 then astype).
    ay, ax = ay.to(fmap.dtype).reshape(b, m, out_h, h), ax.to(fmap.dtype).reshape(b, m, out_w, w)
    tmp = torch.einsum("bmph,bhwc->bmcpw", ay, fmap)
    pooled = torch.einsum("bmcpw,bmqw->bmcpq", tmp, ax).reshape(k, -1, out_h, out_w)
    if mean:
        return pooled.to(torch.float32).mean(dim=(2, 3)).to(fmap.dtype)
    return pooled


class _Plan(NamedTuple):
    """A launch of the ROIAlign kernel: ``width`` channels a load (16 bytes,
    or 1), ``tile`` channel vectors a block over ``tiles`` blocks a ROI,
    ``groups`` thread groups (bins or footprint rows), ``threads`` a block,
    ``smem`` dynamic shared bytes a block."""

    width: int
    tile: int
    tiles: int
    groups: int
    threads: int
    smem: int


def _plan(k: int, c: int, h: int, w: int, out_h: int, out_w: int, elem: int, mean: bool, vec: bool) -> _Plan:
    """The kernel's launch for K ROIs on (., h, w, c) maps of ``elem``-byte
    values: 16-byte loads where ``vec`` (the wrapper checked C and the
    map's alignment); means blocks split the footprint's rows over one
    group for every 64 map cells (a large map has large footprints), at
    most ``_MEAN_GROUPS``; pooled blocks split the bins over
    ``_POOLED_GROUPS`` groups (more for a narrow tile); the channel vectors
    cut into equal tiles, narrower where K alone would leave the card with
    fewer than ``_MIN_BLOCKS`` blocks or the shared memory would not fit."""
    width = 16 // elem if vec else 1
    vectors = -(-c // width)
    bins = out_h * out_w
    groups = min(max(1, h * w // 64), _MEAN_GROUPS) if mean else min(bins, _POOLED_GROUPS)
    widest = _MAX_THREADS // groups if mean else _POOLED_TILE
    tiles = max(-(-vectors // widest), min(-(-_MIN_BLOCKS // k), -(-vectors // 4)))
    weights = 4 * (out_h * h + out_w * w + h + w + 2 * (out_h + out_w))
    while True:
        tile = -(-vectors // tiles)
        smem = weights + (4 * groups * tile * width if mean else elem * tile * width * bins)
        if smem <= _MAX_SMEM or tile == 1:
            break
        tiles += 1
    if not mean:  # a narrow tile takes more bin groups, up to 256 threads
        groups = min(bins, max(groups, 256 // tile))
    return _Plan(width, tile, -(-vectors // tile), groups, -(-tile * groups // 32) * 32, smem)


def roi_align_nhwc_cuda(
    fmap: torch.Tensor,
    boxes: torch.Tensor,
    output_size,
    spatial_scale: float,
    sampling_ratio: int = -1,
    aligned: bool = True,
    max_samples: int = 16,
    mean: bool = False,
) -> torch.Tensor:
    """:func:`roi_align_nhwc_plain` on the card: a contiguous (B, H, W, C)
    f32 or bf16 CUDA map and (B * M, 4) f32 boxes.

    ``roi_align_nhwc_cuda.launches`` counts the kernel's launches."""
    if fmap.ndim != 4 or fmap.dtype not in MAP_DTYPES or not fmap.is_contiguous():
        raise ValueError(f"roi_align_nhwc_cuda takes a contiguous (B, H, W, C) float32 or bfloat16 map; got "
                         f"{fmap.dtype} of shape {tuple(fmap.shape)}, contiguous={fmap.is_contiguous()}")
    if boxes.ndim != 2 or boxes.shape[1] != 4 or boxes.dtype != torch.float32 or boxes.device != fmap.device:
        raise ValueError(f"roi_align_nhwc_cuda takes (K, 4) float32 boxes on the map's device; got {boxes.dtype} "
                         f"of shape {tuple(boxes.shape)} on {boxes.device}")
    b, h, w, c = fmap.shape
    k = boxes.shape[0]
    if k % b:
        raise ValueError(f"{k} boxes do not split evenly over {b} images")
    out_h, out_w = _out_hw(output_size)
    out = torch.empty((k, c) if mean else (k, c, out_h, out_w), dtype=fmap.dtype, device=fmap.device)
    if out.numel() == 0:
        return out
    elem = fmap.element_size()
    vec = c % (16 // elem) == 0 and fmap.data_ptr() % 16 == 0
    plan = _plan(k, c, h, w, out_h, out_w, elem, mean, vec)
    if plan.smem > _MAX_SMEM:
        raise ValueError(f"roi_align_nhwc_cuda: a ({h}, {w}) map with {out_h} x {out_w} bins needs {plan.smem} "
                         f"bytes of shared memory a block, more than {_MAX_SMEM}")
    lib = _kernels.library()
    boxes = boxes.contiguous()
    with _kernels.device_guard(fmap.device):
        code = lib.runia_roi_align(
            fmap.data_ptr(), boxes.data_ptr(), out.data_ptr(), k, k // b, h, w, c, out_h, out_w, float(spatial_scale),
            int(aligned), int(sampling_ratio), int(max_samples), int(fmap.dtype == torch.bfloat16), int(mean),
            int(vec), plan.tile, plan.groups, plan.threads, plan.smem, torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(code, "roi_align")
    count_launch(roi_align_nhwc_cuda)
    return out


roi_align_nhwc_cuda.launches = 0


def roi_align_nhwc(
    fmap: torch.Tensor,
    boxes: torch.Tensor,
    output_size,
    spatial_scale: float,
    sampling_ratio: int = -1,
    aligned: bool = True,
    max_samples: int = 16,
    mean: bool = False,
) -> torch.Tensor:
    """ROIAlign of (B * M, 4) boxes over (B, H, W, C) maps, ROI k on image
    k // M: the kernel for a CUDA map (f32 or bf16; another dtype is read
    as f32), the plain version for a CPU one."""
    boxes = boxes.to(device=fmap.device, dtype=torch.float32)
    if not fmap.is_cuda:
        return roi_align_nhwc_plain(fmap, boxes, output_size, spatial_scale, sampling_ratio, aligned, max_samples, mean)
    if fmap.dtype not in MAP_DTYPES:
        fmap = fmap.to(torch.float32)
    return roi_align_nhwc_cuda(fmap.contiguous(), boxes, output_size, spatial_scale, sampling_ratio, aligned,
                               max_samples, mean)


def roi_align(
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size,
    spatial_scale: float = 1.0,
    sampling_ratio: int = -1,
    aligned: bool = True,
    max_samples: int = 16,
) -> torch.Tensor:
    """ROIAlign over one feature map, the JAX function's contract.

    Args:
        features: (C, H, W) or (1, C, H, W) map.
        boxes: (N, 4) ROIs in image coordinates, xyxy.
        output_size: int or (out_h, out_w).
        spatial_scale: feature-map / image scale.
        sampling_ratio: points per bin and axis; -1: adaptive ceil(bin
            size), capped at ``max_samples``.
        aligned: the half-pixel offset (torchvision ``aligned=True``).

    Returns:
        (N, C, out_h, out_w), in the map's dtype.
    """
    if features.ndim == 4:
        if features.shape[0] != 1:
            raise ValueError("roi_align expects a single feature map")
        features = features[0]
    # The NHWC view of a channels-last map is contiguous: no copy.
    return roi_align_nhwc(features.permute(1, 2, 0)[None], boxes, output_size, spatial_scale, sampling_ratio,
                          aligned, max_samples)
