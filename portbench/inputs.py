"""What the benchmark makes from ``--seed``: weights, images and the seeds of
the keep-weight draws. The same seed gives the same inputs; every kind of
input draws from a stream of its own (``TAGS``), so one kind's size never
shifts another's values. Everything is made on the device, in a few large
calls, and handed alike to the program and to the reference.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

TAGS = {"weights": 1, "fit": 2, "fit_draw": 3, "support": 4, "support_draw": 5, "data": 6, "service": 7,
        "pool": 8, "frames": 9, "request": 10, "sample": 11}

# Random weights: each element is a * normal + b * uniform + c, by kind.
# Convolutions are He-normal; the norms sit near the identity with running
# statistics that differ from (0, 1), so folding them is exercised; the norm
# that closes a residual branch is scaled down (0.2-0.4) so that the
# activations stay of order one through the depth; the head is
# lecun-normal. ``fan_in`` is put in for "conv" and "head_weight".
INIT = {
    "conv": ("he", 0.0, 0.0),
    "norm_scale": (0.0, 0.4, 0.8),
    "norm_scale_last": (0.0, 0.2, 0.2),
    "norm_bias": (0.05, 0.0, 0.0),
    "norm_mean": (0.1, 0.0, 0.0),
    "norm_var": (0.0, 0.5, 0.75),
    "head_weight": ("lecun", 0.0, 0.0),
    "head_bias": (0.0, 0.0, 0.0),
}


def seed_word(*parts: int) -> int:
    """The first 64-bit word of ``numpy.random.SeedSequence(parts)``."""
    return int(np.random.SeedSequence(tuple(int(p) for p in parts)).generate_state(1, np.uint64)[0])


def generator(device, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_word(*parts))


def make_weights(specs: Sequence[Tuple[str, Tuple[int, ...], str]], seed: int, device,
                 dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Named tensors for ``specs`` ((name, shape, kind) triples), views of
    one buffer made by one normal and one uniform draw."""
    sizes = [int(np.prod(shape)) for _, shape, _ in specs]
    coefficients: List[Tuple[float, float, float]] = []
    for (_, shape, kind), size in zip(specs, sizes):
        a, b, c = INIT[kind]
        if a in ("he", "lecun"):
            fan_in = size // shape[0]
            a = (2.0 / fan_in) ** 0.5 if a == "he" else (1.0 / fan_in) ** 0.5
        coefficients.append((a, b, c))
    g = generator(device, seed, TAGS["weights"])
    total = sum(sizes)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    coef = torch.tensor(coefficients, dtype=torch.float32, device=device).repeat_interleave(
        torch.tensor(sizes, device=device), dim=0)
    flat = (coef[:, 0] * normal + coef[:, 1] * uniform + coef[:, 2]).to(dtype)
    out, start = {}, 0
    for (name, shape, _), size in zip(specs, sizes):
        out[name] = flat[start:start + size].view(shape)
        start += size
    return out


def images_u8(n: int, height: int, width: int, device, *parts: int) -> torch.Tensor:
    """(n, height, width, 3) uint8 images, uniform over 0-255, on ``device``."""
    return torch.randint(0, 256, (n, height, width, 3), dtype=torch.uint8, generator=generator(device, *parts),
                         device=device)


def to_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1], as the service's loader scales them."""
    return images.to(torch.float32) * (1.0 / 255.0)


def uniforms(batch: int, larex: dict, tap_hw: Tuple[int, int], device, *parts: int) -> torch.Tensor:
    """The (batch, S, H, W) uniforms that a keep-weight draw of ``batch``
    images takes from a fresh generator seeded with ``parts``: the program
    draws them itself from such a generator, the reference from this."""
    return torch.rand((batch, larex["mc_samples"], *tap_hw), generator=generator(device, *parts), device=device)
