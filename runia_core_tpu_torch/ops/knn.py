"""Brute-force k-nearest-neighbour search, in PyTorch.

Counterpart of ``runia_core_tpu/ops/knn.py`` (which replaces faiss's
IndexFlatL2): a matmul squared-distance matrix and ``torch.topk`` of the
smallest entries. faiss reports *squared* L2 distances, and so does this.
Test rows go through in chunks, so the distance matrix never exceeds
(row_chunk, N_train). ``sharded_kth_neighbor``, the search over a bank
sharded across devices, comes with the port's multi-device layer.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["knn_search", "squared_l2_distances", "squared_l2_kth_neighbor"]


def squared_l2_distances(test: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """(N_test, N_train) squared euclidean distances, clamped at 0."""
    x_sq = (test * test).sum(dim=1, keepdim=True)
    t_sq = (train * train).sum(dim=1)
    cross = test @ train.T
    return torch.clamp_min(x_sq - 2.0 * cross + t_sq[None, :], 0.0)


def knn_search(
    test: torch.Tensor, train: torch.Tensor, k: int, row_chunk: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest neighbours: (squared distances (N, k) ascending, indices (N, k))."""
    dists, idx = [], []
    for chunk in torch.split(test, row_chunk):
        d, i = torch.topk(squared_l2_distances(chunk, train), k, dim=1, largest=False, sorted=True)
        dists.append(d)
        idx.append(i)
    return torch.cat(dists), torch.cat(idx)


def squared_l2_kth_neighbor(
    test: torch.Tensor, train: torch.Tensor, k: int, row_chunk: int = 1024
) -> torch.Tensor:
    """Squared distance to the k-th nearest neighbour (1-indexed), per test row."""
    return knn_search(test, train, k, row_chunk=row_chunk)[0][:, -1]
