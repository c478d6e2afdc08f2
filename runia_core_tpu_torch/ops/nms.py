"""Non-maximum suppression, in PyTorch, with a CUDA kernel for the card.

Counterpart of ``runia_core_tpu/ops/nms.py``. Greedy NMS in score order is
the recurrence "``keep[i]`` iff no kept higher-scoring box overlaps box i
by IoU > threshold", whose fixed point is unique.

* :func:`nms_keep_plain` is the JAX package's program in PyTorch: the
  (N, N) suppression matrix, iterated to the fixed point. Each round tests
  convergence on the host, so it is the CPU's route and the reference the
  kernel is held to, nothing on the card's main path.
* :func:`nms_keep_cuda` wraps ``csrc/nms.cu``: one pass writes the IoU
  bitmask, one block scans it greedily (one warp decides each 64-box
  column block, the recurrence's fixed point found by ballots, while
  groups of the other warps OR earlier blocks' kept rows into the removed
  set), on the current stream and with no host sync, so a CUDA graph can
  capture it. The kernel computes each IoU with the plain version's
  operation order, rounded step by step, and decides every pair as the
  plain version does.

:func:`nms_mask` keeps the JAX contract: ``(order, keep)`` of fixed shape,
``order`` a stable descending sort of the scores (ties: the lower index
first, as ``jnp.argsort(-scores)``), ``keep[i]`` whether ``order[i]``
survives. :func:`nms_indices` is the one place that reads back to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.utils.graphs import copy_to_host, count_launch
from runia_core_tpu_torch.utils.placement import as_tensor

__all__ = [
    "MAX_NMS_BOXES", "batched_class_nms_mask", "nms_indices", "nms_keep", "nms_keep_cuda", "nms_keep_plain",
    "nms_mask", "pairwise_iou",
]

# The most boxes the kernel takes: its bitmask is N * ceil(N / 64) u64 words
# (537 MB here; 113 MB at ultralytics' max_nms of 30,000), and the scan's
# bit vector must fit one block's shared memory.
MAX_NMS_BOXES = 65536
_SCAN_MAX_THREADS = 1024  # csrc/nms.cu kScanMaxThreads
_WORD_THREADS = 8  # OR threads wanted for each later word
_MIN_OR_WARPS = 8  # two for each of the kernel's four groups of OR warps


def _scan_plan(n: int) -> Tuple[int, int, int]:
    """(column blocks, threads, dynamic shared bytes) of the scan over n
    boxes: warp 0 decides; the OR warps are those with warp % 4 != 0 (off
    warp 0's scheduler), enough for ``_WORD_THREADS`` a later word and at
    least ``_MIN_OR_WARPS``, at most ``_SCAN_MAX_THREADS`` threads in all;
    the removed and kept words, a u64 each a 64-box column block."""
    col_blocks = -(-n // 64)
    warps = 1
    if col_blocks > 1:
        per_word = -(-(col_blocks - 1) * _WORD_THREADS // 32)
        want = min(max(per_word, _MIN_OR_WARPS), _SCAN_MAX_THREADS // 32 * 3 // 4)
        while warps - -(-warps // 4) < want:
            warps += 1
    return col_blocks, 32 * warps, 16 * col_blocks


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) IoU between two xyxy box sets (torchvision ``box_iou``)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def nms_keep_plain(sorted_boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The keep mask of score-sorted boxes: JAX's fixed-point iteration of
    the (N, N) suppression matrix, one host read a round."""
    n = sorted_boxes.shape[0]
    ious = pairwise_iou(sorted_boxes, sorted_boxes)
    index = torch.arange(n, device=sorted_boxes.device)
    later = index[None, :] > index[:, None]
    suppress = (ious > iou_threshold) & later  # [j, i]: j suppresses i if j is kept
    keep = torch.ones(n, dtype=torch.bool, device=sorted_boxes.device)
    while True:
        new = ~torch.any(suppress & keep[:, None], dim=0)
        if torch.equal(new, keep):
            return keep
        keep = new


def nms_keep_cuda(sorted_boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The keep mask of score-sorted boxes on the card: contiguous (N, 4)
    float32 CUDA boxes -> (N,) bool, N <= ``MAX_NMS_BOXES``.

    ``nms_keep_cuda.launches`` counts the kernel pair's launches."""
    if sorted_boxes.ndim != 2 or sorted_boxes.shape[1] != 4 or sorted_boxes.dtype != torch.float32:
        raise ValueError(f"nms_keep_cuda takes (N, 4) float32 boxes; got {sorted_boxes.dtype} "
                         f"of shape {tuple(sorted_boxes.shape)}")
    n = sorted_boxes.shape[0]
    if n > MAX_NMS_BOXES:
        raise ValueError(f"the NMS kernel takes at most {MAX_NMS_BOXES} boxes; got {n}")
    keep = torch.empty(n, dtype=torch.bool, device=sorted_boxes.device)
    if n == 0:
        return keep
    boxes = sorted_boxes.contiguous()
    if boxes.data_ptr() % 16:  # float4 loads
        boxes = boxes.clone()
    col_blocks, threads, smem = _scan_plan(n)
    mask = torch.empty(n * col_blocks, dtype=torch.int64, device=boxes.device)
    lib = _kernels.library()
    with _kernels.device_guard(boxes.device):
        code = lib.runia_nms(boxes.data_ptr(), mask.data_ptr(), keep.data_ptr(), n, float(iou_threshold), threads,
                             smem, torch.cuda.current_stream().cuda_stream)
    _kernels.check(code, "nms")
    count_launch(nms_keep_cuda)
    return keep


nms_keep_cuda.launches = 0


def nms_keep(sorted_boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The keep mask of score-sorted boxes: the kernel for a CUDA tensor,
    the plain version for a CPU one."""
    if sorted_boxes.is_cuda:
        return nms_keep_cuda(sorted_boxes, iou_threshold)
    return nms_keep_plain(sorted_boxes, iou_threshold)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS: ``(order, keep)``, ``order`` sorting the boxes by
    descending score (stable), ``keep[i]`` whether ``order[i]`` survives.
    A box whose IoU with a kept higher-scoring box is strictly greater than
    the threshold is suppressed (torchvision's rule)."""
    order = torch.sort(scores, descending=True, stable=True).indices
    return order, nms_keep(boxes.to(torch.float32)[order], iou_threshold)


def nms_indices(boxes, scores, iou_threshold: float, max_det: Optional[int] = None, device=None) -> np.ndarray:
    """torchvision-style indices of the kept boxes, by descending score, as
    an int64 numpy array. Arrays go to ``device`` (None: the GPU); tensors
    stay where they are. The one read back to the host."""
    boxes = as_tensor(boxes, device, torch.float32)
    scores = as_tensor(scores, boxes.device, torch.float32)
    if boxes.shape[0] == 0:
        return np.zeros((0,), dtype=np.int64)
    order, keep = copy_to_host(*nms_mask(boxes, scores, iou_threshold))
    kept = order[keep]
    if max_det is not None:
        kept = kept[:max_det]
    return kept.astype(np.int64)


def batched_class_nms_mask(
    boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, iou_threshold: float, max_wh: int = 7680
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS by the coordinate offset: each class's boxes move by
    ``class_id * max_wh``, so boxes of two classes never overlap."""
    offset = classes.to(boxes.dtype)[:, None] * max_wh
    return nms_mask(boxes + offset, scores, iou_threshold)
