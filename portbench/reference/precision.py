"""Lower-precision roundings for the benchmark's control.

The configurations state a bf16 forward; the next step down, the one a
later change would be tempted by, is fp8. :func:`fp8_e4m3` rounds a tensor
to float8 e4m3 with a scale that maps its largest magnitude to the format's
largest value (448): one scale per output channel for a weight, one for the
whole tensor for an activation, the usual fp8 inference recipe. The values come back as
float32, so the reference's forward runs unchanged around them.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_e4m3(t: torch.Tensor, is_weight: bool) -> torch.Tensor:
    t = t.to(torch.float32)
    if is_weight:
        amax = t.abs().reshape(t.shape[0], -1).amax(dim=1).reshape((-1,) + (1,) * (t.ndim - 1))
    else:
        amax = t.abs().amax()
    scale = amax.clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


CONTROLS = {"fp8_e4m3": fp8_e4m3}
CONTROL = "fp8_e4m3"
