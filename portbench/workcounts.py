"""The benchmark's own work counts and the card's published peaks.

Operations and bytes are counted from the published shapes of a
configuration, never from what a kernel happens to do, so a later change
that folds a norm or fuses two kernels leaves them as they are.
"""

from __future__ import annotations

import importlib
from typing import Dict

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates without sparsity.
# They assume the full 700 W power limit; the harness reports the card's
# limit beside every share.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores; an FMA counts as two operations
PEAK_HBM_BYTES = 3.35e12

BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def reference_module(cfg: dict):
    """The plain reference of the configuration's family (``reference/<family>.py``)."""
    return importlib.import_module(f"portbench.reference.{cfg['family']}")


def model_macs(cfg: dict) -> int:
    """Multiply-adds of one image's forward: the convolutions and the head,
    from the published shapes."""
    return sum(layer["cin"] * layer["cout"] * layer["k"] ** 2 * layer["h"] * layer["w"]
               for layer in reference_module(cfg).layer_shapes(cfg))


def model_flops(cfg: dict) -> int:
    """Operations of one image's forward, 2 per multiply-add."""
    return 2 * model_macs(cfg)


def roofline_s(bytes_moved: float, flops: float, flops_per_s: float) -> Dict[str, float]:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the peak
    rate, whichever is larger."""
    by_bytes = bytes_moved / PEAK_HBM_BYTES
    by_flops = flops / flops_per_s
    return {"bound_s": max(by_bytes, by_flops), "bound_by": "bytes" if by_bytes >= by_flops else "flops",
            "bytes": bytes_moved, "flops": flops}


def entropy_stage(cfg: dict, batch: int) -> Dict[str, float]:
    """The MC entropy stage of one batch, from the tap to the entropies,
    whichever route runs it: the tap (in the forward's dtype) and the f32
    keep-weights read once, the f32 entropies written once; the
    keep-weights product's operations at the f32 peak."""
    lx = cfg["larex"]
    h, w, c = lx["tap_shape"]
    s = lx["mc_samples"]
    tap = batch * h * w * c * BYTES[cfg["dtype"]]
    weights = batch * s * h * w * 4
    out = batch * c * 4
    return roofline_s(tap + weights + out, 2.0 * batch * s * h * w * c, PEAK_F32_FLOPS)


def kde_flops(support: int, dims: int, batch: int) -> float:
    """The LaRED score of a batch: the distance product against the support
    and the exponentials of the log-sum-exp (each counted as one)."""
    return 2.0 * batch * support * dims + batch * support
