"""YOLOv8 adapter: fast-MCD latent extraction with a BGR -> RGB loader shim.

Counterpart of ``runia_core_tpu/yolov8.py``: loaders may yield PyTorch-style
(C, H, W) BGR images (one, or a batch), which are turned into the NHWC RGB
layout the tapped model takes before ``FastMCDSamplesExtractor`` runs. The
``return_variances`` flag exists and defaults to False (the reference reads
it without defining it).
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from runia_core_tpu_torch.extraction.image_level import FastMCDSamplesExtractor
from runia_core_tpu_torch.utils.placement import as_tensor

__all__ = ["FastMCDSamplesExtractorYolov8"]


def _bgr_to_rgb_nhwc(image: torch.Tensor) -> torch.Tensor:
    """(C, H, W) BGR -> contiguous (H, W, C) RGB."""
    return image.permute(1, 2, 0).flip(-1).contiguous()


class FastMCDSamplesExtractorYolov8(FastMCDSamplesExtractor):
    """Fast-MCD extractor for YOLOv8-style tapped models whose loaders yield
    (C, H, W) BGR images; arrays go to the extractor's ``device`` (None:
    the GPU), tensors stay where they are."""

    def __init__(self, *args, return_variances: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.return_variances = return_variances

    def get_ls_samples(self, data_loader: Iterable, **kwargs) -> Dict[str, torch.Tensor]:
        def adapted():
            for image, label in data_loader:
                arr = as_tensor(image, self.device)
                if arr.ndim == 4 and arr.shape[1] in (1, 3) and arr.shape[-1] not in (1, 3):
                    arr = torch.stack([_bgr_to_rgb_nhwc(im) for im in arr])
                elif arr.ndim == 3 and arr.shape[0] in (1, 3):
                    arr = _bgr_to_rgb_nhwc(arr)[None]
                yield arr, label

        return super().get_ls_samples(adapted(), **kwargs)
