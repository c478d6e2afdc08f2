"""Plain bilinear resize, the benchmark's reference for a loader that resizes.

Half-pixel centres, no antialiasing: output pixel (y, x) of an (h, w) image
made from an (H, W) one reads the source at sy = (y + 0.5) H / h - 0.5,
clamped to [0, H - 1] (and alike for x), interpolates along x between the
columns floor(sx) and floor(sx) + 1 (the last column where that runs past
it), then along y between the two rows so made. The values are uint8
scaled by 1/255, as the service's loader scales them. Computed in float64,
handed on in float32.

The module imports nothing of the program.
"""

from __future__ import annotations

from typing import Tuple

import torch

F64 = torch.float64


def _taps(n_out: int, n_in: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The lower and upper source index of each output position along one
    axis, and the weight of the upper one."""
    s = ((torch.arange(n_out, dtype=F64, device=device) + 0.5) * (n_in / n_out) - 0.5).clamp(0.0, n_in - 1.0)
    lower = s.floor().to(torch.long)
    return lower, (lower + 1).clamp_max(n_in - 1), s - lower.to(F64)


def bilinear(images_u8: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, h, w, C) float32 in [0, 1], ``size`` = (h, w)."""
    _, h_in, w_in, _ = images_u8.shape
    y0, y1, fy = _taps(size[0], h_in, images_u8.device)
    x0, x1, fx = _taps(size[1], w_in, images_u8.device)
    x = images_u8.to(F64)
    fx = fx[None, None, :, None]

    def along_x(rows: torch.Tensor) -> torch.Tensor:
        left, right = rows[:, :, x0], rows[:, :, x1]
        return left + fx * (right - left)

    top, bottom = along_x(x[:, y0]), along_x(x[:, y1])
    return ((top + fy[None, :, None, None] * (bottom - top)) / 255.0).to(torch.float32)
