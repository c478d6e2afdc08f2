"""Squared L2 distances as one matmul (counterpart of
``runia_core_tpu/ops/knn.py::squared_l2_distances``; the kNN search itself is
not ported yet)."""

from __future__ import annotations

import torch

__all__ = ["squared_l2_distances"]


def squared_l2_distances(test: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """(N_test, N_train) squared euclidean distances, clamped at 0."""
    x_sq = (test * test).sum(dim=1, keepdim=True)
    t_sq = (train * train).sum(dim=1)
    cross = test @ train.T
    return torch.clamp_min(x_sq - 2.0 * cross + t_sq[None, :], 0.0)
