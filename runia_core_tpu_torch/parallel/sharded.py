"""Sharded detector fitting and scoring on ``torch.distributed``.

Counterpart of ``runia_core_tpu/parallel/sharded.py``:

* ``sharded_mean_and_covariance``: moment accumulation over a train set
  sharded across the ``data`` dimension: local partial sums and one
  ``all_reduce``, so fitting LaREM / Mahalanobis never gathers the raw
  features;
* ``fit_md_sharded`` / ``fit_pca_sharded``: LaREM and PCA fits from
  sharded data (the numerics of ``MDLatentSpace.setup`` and of
  ``reduction.pca_from_covariance``);
* ``sharded_kde_log_density`` / ``sharded_knn_score``: scoring against a
  train bank sharded over the ranks; each rank scans its shard and a cheap
  O(N) / O(N k) collective merges the results;
* ``data_parallel_scorer``: a LaREx scorer whose batch is split over the
  ``data`` dimension, with the single-device scorer's random draws.

Where the JAX functions run inside ``shard_map`` and name its axis, these
take that mesh dimension's process group (``group=mesh.get_group("data")``;
None is the world's).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from runia_core_tpu_torch.ops.knn import squared_l2_distances
from runia_core_tpu_torch.ops.linalg import pinvh
from runia_core_tpu_torch.parallel.mesh import local_rows

__all__ = [
    "sharded_mean_and_covariance",
    "fit_md_sharded",
    "fit_pca_sharded",
    "sharded_kde_log_density",
    "sharded_knn_score",
    "data_parallel_scorer",
]


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 products at full precision (TF32 off), the JAX package's
    ``Precision.HIGHEST``."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _moments(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """(mean, ML covariance, row count) over the ranks of ``axis``."""
    xs = local_rows(x, mesh, axis).to(torch.float32)
    d = xs.shape[1]
    with _full_f32_matmul():
        s2 = xs.T @ xs
    stats = torch.cat([xs.sum(dim=0), s2.reshape(-1), xs.new_tensor([xs.shape[0]])])
    dist.all_reduce(stats, group=mesh.get_group(axis))  # one collective: (d,), (d, d) and the count
    n = stats[-1]
    mean = stats[:d] / n
    cov = stats[d:-1].reshape(d, d) / n - torch.outer(mean, mean)
    return mean, cov, float(n)


def sharded_mean_and_covariance(
    x: torch.Tensor, mesh: DeviceMesh, axis: str = "data"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, ML covariance) of a (N, d) set sharded over ``axis`` (a
    :func:`~runia_core_tpu_torch.parallel.shard_batch` DTensor, or the whole
    set, of which each rank takes its chunk).

    Communication: one ``all_reduce`` of (d,), (d, d) and the count, never
    the data. Matches sklearn EmpiricalCovariance(assume_centered=False):
    cov = E[x x^T] - mean mean^T, divided by N.
    """
    mean, cov, _ = _moments(x, mesh, axis)
    return mean, cov


def fit_md_sharded(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> dict:
    """LaREM fit over a sharded train set: {"feats_mean", "precision"}."""
    mean, cov, _ = _moments(x, mesh, axis)
    return {"feats_mean": mean[None, :], "precision": pinvh(cov)}


def fit_pca_sharded(
    x: torch.Tensor,
    mesh: DeviceMesh,
    n_components: int,
    whiten: bool = True,
    axis: str = "data",
):
    """Fit PCA over a sharded train set without gathering it: the leading
    eigenvectors of the all-reduced (d, d) covariance
    (``reduction.pca_from_covariance``, with ``pca_fit``'s svd_flip signs)
    instead of the SVD of the centered data, O(d^2) communication instead
    of O(N d). Returns a :class:`runia_core_tpu_torch.reduction.PCAState`.
    """
    from runia_core_tpu_torch.reduction import pca_from_covariance

    mean, cov, n = _moments(x, mesh, axis)
    return pca_from_covariance(mean, cov, int(n), n_components, whiten)


def sharded_kde_log_density(
    test: torch.Tensor,
    train_shard: torch.Tensor,
    n_total: int,
    group: Optional[dist.ProcessGroup] = None,
    bandwidth: float = 1.0,
) -> torch.Tensor:
    """Gaussian-KDE log density against a train bank sharded over the ranks
    of ``group``: each rank passes its own ``train_shard`` and the same
    ``test``. A per-shard log-sum-exp, stable across shards: the global max
    (``all_reduce`` MAX), then the shifted sums (``all_reduce`` SUM)."""
    d = train_shard.shape[1]
    log_kernel = -0.5 * squared_l2_distances(test, train_shard) / (bandwidth**2)
    global_max = log_kernel.max(dim=1).values
    dist.all_reduce(global_max, op=dist.ReduceOp.MAX, group=group)
    global_sum = torch.exp(log_kernel - global_max[:, None]).sum(dim=1)
    dist.all_reduce(global_sum, group=group)
    norm = math.log(n_total * 1.0) + 0.5 * d * math.log(2.0 * math.pi * bandwidth**2)
    return global_max + torch.log(global_sum) - norm


def sharded_knn_score(
    test: torch.Tensor, train_shard: torch.Tensor, k: int, group: Optional[dist.ProcessGroup] = None
) -> torch.Tensor:
    """-squared distance to the global k-th nearest neighbour over a bank
    sharded over the ranks of ``group``: a local top-k per shard, an
    ``all_gather`` of the (N, k) candidates, a final merge; O(N k) bytes
    instead of O(N N_train)."""
    from runia_core_tpu_torch.ops.knn import sharded_kth_neighbor

    return -sharded_kth_neighbor(test, train_shard, k, group)


def data_parallel_scorer(scorer: Callable, mesh: DeviceMesh, axis: str = "data") -> Callable:
    """Split the batch of a ``build_larex_scorer`` scorer over ``axis``.

    ``sharded(images, generator=None) -> (logits, scores)`` for the whole
    batch, on every rank. ``images`` is the whole batch (every rank holds
    it) or a :func:`~runia_core_tpu_torch.parallel.shard_batch` DTensor, its
    size a multiple of the dimension's. The JAX package's keep-weights do
    not depend on how the batch is sharded; PyTorch's Philox stream cannot
    be split by rows, so every rank draws the whole batch's keep-weights
    from ``generator`` (the same state on every rank, as the single-device
    scorer draws them; the tap's H x W read once per image shape), scores
    its own rows with its rows of them (``weights=``), and the logits and
    scores are all-gathered back into batch order. A dimension of one rank
    runs the same split path, with one part.
    """
    group = mesh.get_group(axis)
    ranks = mesh.size(mesh.mesh_dim_names.index(axis))
    tap_sizes = {}

    def sharded(images: torch.Tensor, generator: Optional[torch.Generator] = None):
        batch = images.shape[0]
        if batch % ranks:
            raise ValueError(f"a batch of {batch} does not split over {ranks} ranks")
        mine = local_rows(images, mesh, axis)
        shape = tuple(mine.shape[1:])
        if shape not in tap_sizes:
            tap_sizes[shape] = scorer.tap_size(mine[:1])
        h, w = tap_sizes[shape]
        weights = scorer.draw_weights(batch, h, w, generator, mine.device)
        logits, scores = scorer(mine, weights=torch.chunk(weights, ranks)[mesh.get_local_rank(axis)])
        gathered = []
        for local in (logits, scores):
            parts = [torch.empty_like(local) for _ in range(ranks)]
            dist.all_gather(parts, local.contiguous(), group=group)
            gathered.append(torch.cat(parts))
        return tuple(gathered)

    return sharded
