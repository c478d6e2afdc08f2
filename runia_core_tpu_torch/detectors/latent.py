"""Latent-space postprocessors KDE (LaRED) and MD (LaREM), in PyTorch.

Counterpart of the LaRED and LaREM parts of
``runia_core_tpu/detectors/latent.py``: the KDE log-density is a matmul
distance program with a row-chunked logsumexp, the Mahalanobis score one
quadratic form. cMD, KNN and GMM are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from runia_core_tpu_torch.detectors.base import Postprocessor, register_postprocessor
from runia_core_tpu_torch.ops.knn import squared_l2_distances
from runia_core_tpu_torch.ops.linalg import empirical_precision, mahalanobis_quadform

__all__ = [
    "DetectorKDE",
    "KDELatentSpace",
    "LaREDPostprocessor",
    "LaREMPostprocessor",
    "MDLatentSpace",
    "kde_log_density",
    "md_score",
]


def kde_log_density(
    test: torch.Tensor, train: torch.Tensor, bandwidth: float = 1.0, row_chunk: int = 1024
) -> torch.Tensor:
    """Gaussian-KDE log density, as sklearn's KernelDensity.score_samples:

    log p(x) = logsumexp_i(-||x - t_i||^2 / (2 h^2)) - log n - (d/2) log(2 pi h^2)

    Test rows go through in chunks of ``row_chunk``, so the distance matrix
    never exceeds (row_chunk, N_train).
    """
    n, d = train.shape
    bandwidth = float(bandwidth)
    norm = math.log(n) + 0.5 * d * math.log(2.0 * math.pi * bandwidth**2)
    out = [
        torch.logsumexp(-0.5 * squared_l2_distances(chunk, train) / bandwidth**2, dim=1)
        for chunk in torch.split(test, row_chunk)
    ]
    return torch.cat(out) - norm


def md_score(test: torch.Tensor, mean: torch.Tensor, precision: torch.Tensor) -> torch.Tensor:
    """-(x - mu) P (x - mu)^T, the LaREM score."""
    return -mahalanobis_quadform(test, mean, precision)


class DetectorKDE:
    """Gaussian KDE density estimator over fixed train embeddings."""

    def __init__(self, train_embeddings, save_path=None, kernel="gaussian", bandwidth=1.0):
        if kernel != "gaussian":
            raise ValueError("Only the gaussian kernel is supported")
        self.kernel = kernel
        self.bandwidth = bandwidth
        self.train_embeddings = torch.as_tensor(train_embeddings)
        self.save_path = save_path

    def get_density_scores(self, test_embeddings) -> torch.Tensor:
        test = torch.as_tensor(test_embeddings, device=self.train_embeddings.device)
        return kde_log_density(test, self.train_embeddings, self.bandwidth)


def _check_2d(data, what: str) -> None:
    if torch.as_tensor(data).ndim != 2:
        raise ValueError(f"{what} must be 2 dimensional")


@register_postprocessor(["KDE", "LaRED"], postprocessor_input=["latent_space_means"])
class KDELatentSpace(Postprocessor):
    """LaRED: KDE log-density over latent entropies."""

    def __init__(self, cfg=None):
        super().__init__(cfg)
        self.detector: Optional[DetectorKDE] = None

    def setup(self, ind_train_data, **kwargs) -> None:
        _check_2d(ind_train_data, "ind_feats")
        if self._warn_if_fitted("KDEPostprocessor"):
            return
        self.detector = DetectorKDE(train_embeddings=ind_train_data)
        self._state = {
            "train_embeddings": self.detector.train_embeddings,
            "bandwidth": self.detector.bandwidth,
        }
        self._setup_flag = True

    def postprocess(self, test_data, **kwargs) -> torch.Tensor:
        _check_2d(test_data, "ood_feats")
        return self.detector.get_density_scores(test_data)

    def _rehydrate(self) -> None:
        self.detector = DetectorKDE(
            train_embeddings=self._state["train_embeddings"],
            bandwidth=float(self._state.get("bandwidth", 1.0)),
        )


@register_postprocessor(["MD", "LaREM"], postprocessor_input=["latent_space_means"])
class MDLatentSpace(Postprocessor):
    """LaREM: Mahalanobis distance to the InD mean.

    The reference centres the data and then lets EmpiricalCovariance subtract
    the (near-zero) residual mean again; the double centring is kept.
    """

    def __init__(self, cfg=None):
        super().__init__(cfg)
        self.feats_mean: Optional[torch.Tensor] = None
        self.precision: Optional[torch.Tensor] = None

    def setup(self, ind_train_data, **kwargs) -> None:
        _check_2d(ind_train_data, "ind_feats")
        if self._warn_if_fitted("MDPostprocessor"):
            return
        x = torch.as_tensor(ind_train_data)
        self.feats_mean = x.mean(dim=0, keepdim=True)
        # assume_centered=False: the residual mean is subtracted again.
        self.precision = empirical_precision(x - self.feats_mean, assume_centered=False)
        self._state = {"feats_mean": self.feats_mean, "precision": self.precision}
        self._setup_flag = True

    def postprocess(self, test_data, **kwargs) -> torch.Tensor:
        _check_2d(test_data, "test_feats")
        test = torch.as_tensor(test_data, device=self.feats_mean.device)
        return md_score(test, self.feats_mean, self.precision)


LaREDPostprocessor = KDELatentSpace
LaREMPostprocessor = MDLatentSpace
