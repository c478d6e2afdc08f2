"""Activation-map reductions (channel means, stds, variances), in PyTorch.

Counterpart of ``runia_core_tpu/ops/reductions.py``. Every function takes a
(B, C, H, W) activation and keeps the batch axis. The reference reduces with
``torch.std`` / ``torch.var``, which apply Bessel's correction (ddof=1), and
composes them twice ("std of stds"); both are kept.
"""

from __future__ import annotations

import torch

__all__ = ["get_mean_or_fullmean_ls_sample", "get_std_ls_sample", "get_variance_ls_sample"]


def get_mean_or_fullmean_ls_sample(latent_sample: torch.Tensor, method: str = "fullmean") -> torch.Tensor:
    """'mean': mean over W -> (B, C, H); 'fullmean': mean over H, W -> (B, C)."""
    if method not in ("mean", "fullmean"):
        raise ValueError(f"method must be 'mean' or 'fullmean'; got {method!r}")
    if method == "mean":
        return latent_sample.mean(dim=3)
    return latent_sample.mean(dim=(2, 3))


def get_variance_ls_sample(latent_sample: torch.Tensor) -> torch.Tensor:
    """Variance over W, then the variance of those over H -> (B, C), ddof=1 each."""
    return latent_sample.var(dim=3, correction=1).var(dim=2, correction=1)


def get_std_ls_sample(latent_sample: torch.Tensor) -> torch.Tensor:
    """Std over W, then the std of those over H -> (B, C), ddof=1 each."""
    return latent_sample.std(dim=3, correction=1).std(dim=2, correction=1)
