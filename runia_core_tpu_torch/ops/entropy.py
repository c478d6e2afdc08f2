"""Kozachenko-Leonenko kNN differential entropy, batched, in PyTorch.

Counterpart of ``runia_core_tpu/ops/entropy.py``. The estimator (max-norm,
as the reference always requests)::

    h = -digamma(k) + digamma(n) + (d / n) * sum_i log(2 * eps_i)

where eps_i is the Chebyshev distance from sample i to its k-th nearest
neighbour within the cloud, clamped below by ``min_dist`` (1e-5), with
k = min(5, n - 1) chosen by the callers.

Everything here is the plain version. :func:`marginal_entropy` hands its
clouds to ``ops/entropy_cuda.py``, whose wrapper launches the CUDA kernel
for a tensor on the GPU and calls :func:`_marginal_entropy_sorted` for one
on the CPU.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

__all__ = ["batched_cloud_entropies", "joint_entropy", "kl_entropy", "marginal_entropy"]

_BIG = 1e30


def _kth_nn_distance(pairwise: torch.Tensor, k: int) -> torch.Tensor:
    """(..., n, n) distances -> (..., n) (k+1)-th smallest per row; the
    self-distance 0 is the smallest, so this is the k-th neighbour."""
    return torch.kthvalue(pairwise, k + 1, dim=-1).values


@functools.lru_cache(maxsize=128)
def _digamma_const(k: int, n: int) -> float:
    """-psi(k) + psi(n) in float64 on the host (k and n are Python ints).

    The single source of the estimator's constant for every path, the CUDA
    kernels included; an f32 digamma on the device would differ from it.
    Cached: a scorer asks for the same (k, n) on every call.
    """
    from scipy.special import digamma

    return float(-digamma(float(k)) + digamma(float(n)))


def kl_entropy(cloud: torch.Tensor, k: int, min_dist: float = 1e-5) -> torch.Tensor:
    """KL entropy of one (n, d) sample cloud under the Chebyshev norm (0-d)."""
    n, d = cloud.shape
    pairwise = (cloud[:, None, :] - cloud[None, :, :]).abs().amax(dim=-1)
    eps = torch.clamp_min(_kth_nn_distance(pairwise, k), min_dist)
    return _digamma_const(k, n) + (d / n) * torch.log(2.0 * eps).sum()


def joint_entropy(
    clouds: torch.Tensor, k: int, min_dist: float = 1e-5, chunk: int = 256
) -> torch.Tensor:
    """Joint h(Z) per cloud: (B, n, d) -> (B,).

    The Chebyshev distance accumulates over feature chunks, so the
    (B, n, n, d) tensor is never made whole.
    """
    b, n, d = clouds.shape
    pairwise = torch.zeros((b, n, n), dtype=clouds.dtype, device=clouds.device)
    for start in range(0, d, chunk):
        xc = clouds[:, :, start : start + chunk]
        pairwise = torch.maximum(pairwise, (xc[:, :, None, :] - xc[:, None, :, :]).abs().amax(-1))
    eps = torch.clamp_min(_kth_nn_distance(pairwise, k), min_dist)
    return _digamma_const(k, n) + (d / n) * torch.log(2.0 * eps).sum(dim=-1)


def marginal_entropy(clouds: torch.Tensor, k: int, min_dist: float = 1e-5) -> torch.Tensor:
    """Marginal h(z_i) per cloud and dimension: (B, n, d) -> (B, d).

    The route is chosen by shape, before any launch: where the CUDA kernel
    takes (n, k) (``marginal_entropy_supported``: k < n <= 512), the
    kernel's wrapper runs, which launches it on a CUDA tensor and takes the
    sorted-window plain version on a CPU tensor; any other shape takes the
    sorted-window form on either device. All routes select the same f32
    distances.
    """
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda, marginal_entropy_supported

    if not marginal_entropy_supported(clouds.shape[1], k):
        return _marginal_entropy_sorted(clouds, k, min_dist)
    return marginal_entropy_cuda(clouds, k, min_dist)


def _sorted_kth_distances(clouds: torch.Tensor, k: int) -> torch.Tensor:
    """(B, n, d) -> (B, n, d): per column, in ascending order of its points,
    each point's distance to its k-th nearest neighbour (unclamped).

    The clouds are scalar per dimension, so after sorting each column the k
    nearest neighbours of point i form a contiguous window around it:
    kth_nn(i) = min over a + t = k of max(x[i] - x[i-a], x[i+t] - x[i]),
    with out-of-range terms pushed to +/-1e30. The selected distances are the
    same f32 differences the pairwise form picks.
    """
    b, n, d = clouds.shape
    xs = torch.sort(clouds.to(torch.float32), dim=1).values
    pad = torch.full((b, k, d), _BIG, dtype=torch.float32, device=clouds.device)
    xp = torch.cat([-pad, xs, pad], dim=1)
    center = xp[:, k : k + n]
    kth = None
    for a in range(k + 1):
        left = center - xp[:, k - a : k - a + n]
        right = xp[:, 2 * k - a : 2 * k - a + n] - center
        cand = torch.maximum(left, right)
        kth = cand if kth is None else torch.minimum(kth, cand)
    return kth


def _marginal_entropy_sorted(clouds: torch.Tensor, k: int, min_dist: float = 1e-5) -> torch.Tensor:
    """Sorted-window form: (B, n, d) -> (B, d), from :func:`_sorted_kth_distances`."""
    n = clouds.shape[1]
    eps = torch.clamp_min(_sorted_kth_distances(clouds, k), min_dist)
    return _digamma_const(k, n) + torch.log(2.0 * eps).sum(dim=1) / n


def _marginal_entropy_xla(
    clouds: torch.Tensor, k: int, min_dist: float = 1e-5, image_chunk: int = 64
) -> torch.Tensor:
    """Pairwise form (the JAX package's XLA reference path), image-chunked:
    sort all |x_i - x_j| of each column and take order statistic k."""
    n = clouds.shape[1]
    const = _digamma_const(k, n)
    out = []
    for xc in torch.split(clouds.to(torch.float32), image_chunk, dim=0):
        diffs = (xc[:, :, None, :] - xc[:, None, :, :]).abs()  # (chunk, n, n, d)
        eps = torch.clamp_min(torch.sort(diffs, dim=2).values[:, :, k, :], min_dist)
        out.append(const + torch.log(2.0 * eps).sum(dim=1) / n)
    return torch.cat(out, dim=0)


def batched_cloud_entropies(
    clouds: torch.Tensor, k: int, min_dist: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(joint (B,), marginal (B, d)) entropies of a batch of MC clouds."""
    return joint_entropy(clouds, k, min_dist), marginal_entropy(clouds, k, min_dist)
