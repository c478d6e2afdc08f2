"""Linear algebra of the OoD scorers, in PyTorch.

Counterpart of ``runia_core_tpu/ops/linalg.py``: covariances, class means
and quadratic forms as matmuls, the MVN log-density as a batched triangular
solve. The JAX matmuls ask for ``Precision.HIGHEST``; here they are plain
f32 matmuls, which are true f32 on the GPU as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's default;
``chip_smoke.py`` sets it explicitly).
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from runia_core_tpu_torch import default_device

__all__ = [
    "StreamingMoments",
    "class_means",
    "classwise_center",
    "classwise_mahalanobis_max",
    "empirical_covariance",
    "empirical_precision",
    "mahalanobis_quadform",
    "mvn_fit_cholesky",
    "mvn_log_prob",
    "pinvh",
    "shared_class_precision",
]


class StreamingMoments:
    """Out-of-core first and second moments, one rank-``b`` matmul a batch.

    The sums are shifted by the first batch's mean: the one-pass
    E[xx^T] - mu mu^T cancels catastrophically in f32 when |mu| >> sigma
    (post-ReLU activations), and in shifted coordinates it does not.
    ``mean`` and ``covariance`` agree with :func:`empirical_covariance` over
    the concatenated batches to f32 rounding. The sums live on ``device``
    (None: the GPU).
    """

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, device=None):
        device = default_device() if device is None else device
        self.s1 = torch.zeros((dim,), dtype=dtype, device=device)
        self.s2 = torch.zeros((dim, dim), dtype=dtype, device=device)
        self.shift: Optional[torch.Tensor] = None  # the first batch's mean
        self.n = 0

    def update(self, batch) -> "StreamingMoments":
        batch = torch.as_tensor(batch, device=self.s1.device).to(self.s1.dtype)
        if self.shift is None:
            self.shift = batch.mean(dim=0)
        centred = batch - self.shift[None, :]
        self.s1 = self.s1 + centred.sum(dim=0)
        self.s2 = self.s2 + centred.T @ centred
        self.n += int(batch.shape[0])
        return self

    @property
    def mean(self) -> torch.Tensor:
        return self.shift + self.s1 / self.n

    @property
    def covariance(self) -> torch.Tensor:
        """ML covariance (1/n), as sklearn's EmpiricalCovariance."""
        m = self.s1 / self.n  # the mean in shifted coordinates (about 0)
        return self.s2 / self.n - torch.outer(m, m)

    @property
    def precision(self) -> torch.Tensor:
        return pinvh(self.covariance)

    def md_state(self) -> dict:
        """The LaREM state ({"feats_mean", "precision"}) that
        ``detectors.MDLatentSpace.setup`` fits on the whole data."""
        return {"feats_mean": self.mean[None, :], "precision": self.precision}


def empirical_covariance(x: torch.Tensor, assume_centered: bool = False) -> torch.Tensor:
    """Maximum-likelihood (1/n) covariance, as sklearn's EmpiricalCovariance."""
    n = x.shape[0]
    if not assume_centered:
        x = x - x.mean(dim=0, keepdim=True)
    return (x.T @ x) / n


def pinvh(a: torch.Tensor) -> torch.Tensor:
    """Hermitian pseudo-inverse with JAX's cutoff, 10 * max(m, n) * eps."""
    rtol = 10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
    return torch.linalg.pinv(a, rtol=rtol, hermitian=True)


def empirical_precision(x: torch.Tensor, assume_centered: bool = False) -> torch.Tensor:
    """Precision (pseudo-inverse covariance), as EmpiricalCovariance.precision_."""
    return pinvh(empirical_covariance(x, assume_centered=assume_centered))


def mahalanobis_quadform(x: torch.Tensor, mean: torch.Tensor, precision: torch.Tensor) -> torch.Tensor:
    """diag((x - mean) P (x - mean)^T) as one matmul and a row reduction."""
    diff = x - mean
    return ((diff @ precision) * diff).sum(dim=-1)


def class_means(x: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, d) per-class feature means; a class with no samples is a NaN row."""
    one_hot = F.one_hot(labels.to(torch.int64), num_classes).to(x.dtype)  # (n, C)
    counts = one_hot.sum(dim=0)
    means = (one_hot.T @ x) / counts[:, None]
    return torch.where(counts[:, None] > 0, means, torch.full_like(means, math.nan))


def classwise_center(x: torch.Tensor, labels: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """Each sample minus its class mean, rows in dataset order."""
    return x - means[labels.to(torch.int64)]


def shared_class_precision(
    x: torch.Tensor, labels, num_classes: int, warn_label: str = "class"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(class means, shared precision of the class-centred data): the
    Mahalanobis / cMD fit. Per-class means, then the ML covariance of the
    pooled class-centred rows (f32) and its pseudo-inverse. A class with no
    samples gets a warning and a NaN mean row."""
    labels_np = np.asarray(torch.as_tensor(labels).cpu()).astype(np.int64)
    counts = np.bincount(labels_np, minlength=num_classes)
    for c in np.nonzero(counts == 0)[0]:
        warnings.warn(f"No examples for {warn_label} {c}")
    labels = torch.as_tensor(labels_np, device=x.device)
    means = class_means(x, labels, num_classes)
    centred = classwise_center(x, labels, means)
    return means, empirical_precision(centred.to(torch.float32), assume_centered=False)


def classwise_mahalanobis_max(x: torch.Tensor, means: torch.Tensor, precision: torch.Tensor) -> torch.Tensor:
    """max over classes of -(x - mu_c) P (x - mu_c)^T, a NaN class (no
    samples) counting as -inf: xPx - 2 xPm + mPm with one (N, C) product."""
    xp = x @ precision
    x_quad = (xp * x).sum(dim=-1, keepdim=True)
    cross = xp @ means.T
    m_quad = ((means @ precision) * means).sum(dim=-1)
    scores = -(x_quad - 2.0 * cross + m_quad[None, :])
    scores = torch.where(torch.isnan(scores), torch.full_like(scores, -math.inf), scores)
    return scores.amax(dim=1)


def mvn_fit_cholesky(
    covariances: torch.Tensor, jitters: Optional[Sequence[float]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Cholesky with the reference's jitter ladder: (chols (C, d, d),
    jitter used (C,)).

    One shared jitter: the first rung at which EVERY class covariance is
    positive definite is added to all of them (per-class rungs would move
    the healthy classes' log-probs off the reference's). A factorisation
    fails where ``cholesky_ex`` reports it or leaves a non-finite entry.
    Raises ValueError when no rung makes the stack positive definite.
    """
    if jitters is None:
        jitters = [0.0] + [10.0**e for e in range(-20, 0)]
    d = covariances.shape[-1]
    eye = torch.eye(d, dtype=covariances.dtype, device=covariances.device)
    for jitter in jitters:
        chol, info = torch.linalg.cholesky_ex(covariances + jitter * eye)
        if bool((info == 0).all()) and bool(torch.isfinite(chol).all()):
            return chol, torch.full((covariances.shape[0],), jitter, dtype=covariances.dtype,
                                    device=covariances.device)
    raise ValueError(
        "mvn_fit_cholesky: covariances not positive-definite for any jitter "
        f"in the ladder (max tried {jitters[-1]:g})"
    )


def mvn_log_prob(x: torch.Tensor, means: torch.Tensor, chols: torch.Tensor) -> torch.Tensor:
    """(N, C) multivariate-normal log-densities, as
    ``torch.distributions.MultivariateNormal(loc, covariance).log_prob``:
    -0.5 (d log 2 pi + 2 sum log diag L + ||L^-1 (x - mu)||^2)."""
    d = x.shape[-1]
    diff = (x[:, None, :] - means[None, :, :]).permute(1, 2, 0)  # (C, d, N)
    z = torch.linalg.solve_triangular(chols, diff, upper=False)
    maha = (z * z).sum(dim=1).T  # (N, C)
    log_det = 2.0 * torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(dim=-1)
    return -0.5 * (d * math.log(2.0 * math.pi) + log_det[None, :] + maha)
