"""Dataset-level entropy API: ``get_dl_h_z`` with the reference's signature.

Counterpart of ``runia_core_tpu/evaluation/entropy.py``: the joint h(Z) and
the per-dimension h(z_i) of every image are each one batched call. The
marginal entropies go through kernel 1 (``ops/entropy_cuda.py``) for a
tensor on the GPU, and the results stay on the samples' device; an array
goes to ``device`` (None: the GPU) first.
"""

from __future__ import annotations

from typing import Tuple

import torch

from runia_core_tpu_torch.ops.entropy import joint_entropy, marginal_entropy
from runia_core_tpu_torch.utils.placement import as_tensor

__all__ = ["get_dl_h_z", "neighbors_for", "single_image_entropy_calculation"]


def neighbors_for(mcd_samples_nro: int) -> int:
    """k = 5 if n > 5 else n - 1 (reference entropy.py:66)."""
    return 5 if mcd_samples_nro > 5 else mcd_samples_nro - 1


def single_image_entropy_calculation(sample, neighbors: int, device=None) -> torch.Tensor:
    """Per-dimension KL entropies (d,) of one (n, d) cloud."""
    return marginal_entropy(as_tensor(sample, device)[None], neighbors)[0]


def get_dl_h_z(
    dl_z_samples, mcd_samples_nro: int = 32, parallel_run: bool = False, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint h(Z) (n_images, 1) and marginal h(z_i) (n_images, d) per image.

    ``dl_z_samples`` is (n_images * mcd_samples_nro, d), images contiguous,
    as a tensor or an array. ``parallel_run`` is accepted for API parity.
    """
    del parallel_run
    samples = as_tensor(dl_z_samples, device)
    total, d = samples.shape
    if total % mcd_samples_nro:
        raise ValueError("Sample count must be divisible by mcd_samples_nro")
    clouds = samples.reshape(-1, mcd_samples_nro, d).contiguous()
    k = neighbors_for(mcd_samples_nro)
    return joint_entropy(clouds, k)[:, None], marginal_entropy(clouds, k)
