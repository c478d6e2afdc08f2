"""Latent-space postprocessors KDE (LaRED), MD (LaREM), cMD, KNN (LaREK) and
GMM (LaREG), in PyTorch.

Counterpart of ``runia_core_tpu/detectors/latent.py``: the KDE log-density
is a matmul distance program with a row-chunked logsumexp, the Mahalanobis
scores quadratic forms, the kNN score the negated squared distance to the
K-th neighbour (faiss's IndexFlatL2 convention) and the GMM score the
logsumexp of the per-class MVN log-densities. Each is registered under the
JAX package's names. ``setup`` takes an array to the GPU (a tensor stays on
its device); scores come back as tensors on the fitted state's device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from runia_core_tpu_torch.detectors.base import Postprocessor, register_postprocessor
from runia_core_tpu_torch.detectors.funcs import GMMState, gmm_fit, normalizer
from runia_core_tpu_torch.ops.knn import squared_l2_distances, squared_l2_kth_neighbor
from runia_core_tpu_torch.ops.linalg import (
    classwise_mahalanobis_max,
    empirical_precision,
    mahalanobis_quadform,
    shared_class_precision,
)
from runia_core_tpu_torch.utils.placement import as_tensor

__all__ = [
    "DetectorKDE",
    "GMMLatentSpace",
    "KDELatentSpace",
    "KNNLatentSpace",
    "LaREDPostprocessor",
    "LaREGPostprocessor",
    "LaREKPostprocessor",
    "LaREMPostprocessor",
    "MDLatentSpace",
    "cMDLatentSpace",
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
        self.train_embeddings = as_tensor(train_embeddings)
        self.save_path = save_path

    def get_density_scores(self, test_embeddings) -> torch.Tensor:
        test = torch.as_tensor(test_embeddings, device=self.train_embeddings.device)
        return kde_log_density(test, self.train_embeddings, self.bandwidth)


def _check_2d(data, what: str) -> None:
    if np.ndim(data) != 2:
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
        x = as_tensor(ind_train_data)
        self.feats_mean = x.mean(dim=0, keepdim=True)
        # assume_centered=False: the residual mean is subtracted again.
        self.precision = empirical_precision(x - self.feats_mean, assume_centered=False)
        self._state = {"feats_mean": self.feats_mean, "precision": self.precision}
        self._setup_flag = True

    def postprocess(self, test_data, **kwargs) -> torch.Tensor:
        _check_2d(test_data, "test_feats")
        test = torch.as_tensor(test_data, device=self.feats_mean.device)
        return md_score(test, self.feats_mean, self.precision)


@register_postprocessor("cMD", postprocessor_input=["latent_space_means"])
class cMDLatentSpace(Postprocessor):
    """Class-conditional LaREM: per-class means, one shared precision of the
    class-centred data, the max-over-classes score (an empty class: -inf)."""

    def __init__(self, cfg=None):
        super().__init__(cfg)
        self.num_classes = getattr(cfg, "num_classes", 10)
        self.class_mean: Optional[torch.Tensor] = None
        self.precision: Optional[torch.Tensor] = None

    def setup(self, ind_train_data, **kwargs) -> None:
        if "ind_train_labels" not in kwargs:
            raise ValueError("id_labels not provided. Pass ID train labels as 'ind_train_labels' argument.")
        _check_2d(ind_train_data, "ind_feats")
        if self._warn_if_fitted("cMDPostprocessor"):
            return
        self.class_mean, self.precision = shared_class_precision(
            as_tensor(ind_train_data), kwargs["ind_train_labels"], self.num_classes,
            warn_label="class (class-wise Mahalanobis)",
        )
        self._state = {"class_mean": self.class_mean, "precision": self.precision}
        self._setup_flag = True

    def postprocess(self, test_data, **kwargs) -> torch.Tensor:
        if "pred_labels" not in kwargs:
            raise ValueError("pred_logits not provided")
        _check_2d(test_data, "test_feats")
        test = torch.as_tensor(test_data, device=self.class_mean.device)
        return classwise_mahalanobis_max(test, self.class_mean, self.precision)


@register_postprocessor(["KNN", "LaREK"], postprocessor_input=["latent_space_means"])
class KNNLatentSpace(Postprocessor):
    """kNN in L2-normalised latent space: the score is the negated squared
    distance to the K-th neighbour (K = 50 unless ``cfg.k_neighbors``)."""

    def __init__(self, cfg=None):
        super().__init__(cfg)
        self.K = getattr(cfg, "k_neighbors", 50)
        self.activation_log: Optional[torch.Tensor] = None

    def setup(self, ind_train_data, **kwargs) -> None:
        _check_2d(ind_train_data, "ind_train_feats")
        if self._warn_if_fitted("KNNPostprocessor"):
            return
        self.activation_log = normalizer(as_tensor(ind_train_data))
        self._state = {"activation_log": self.activation_log, "K": self.K}
        self._setup_flag = True

    def postprocess(self, test_data, **kwargs) -> torch.Tensor:
        _check_2d(test_data, "test_feats")
        test = normalizer(torch.as_tensor(test_data, device=self.activation_log.device))
        return -squared_l2_kth_neighbor(test, self.activation_log, self.K)


@register_postprocessor(["GMM", "LaREG"], postprocessor_input=["latent_space_means"])
class GMMLatentSpace(Postprocessor):
    """LaREG: one MVN per class with the shared jitter ladder; the score is
    the logsumexp of the per-class log-densities."""

    def __init__(self, cfg=None):
        super().__init__(cfg)
        self.num_classes = getattr(cfg, "num_classes", 10)
        self.gmm: Optional[GMMState] = None

    def setup(self, ind_train_data, **kwargs) -> None:
        _check_2d(ind_train_data, "ind_train_feats")
        if self._warn_if_fitted("GMMPostprocessor"):
            return
        if "ind_train_labels" not in kwargs:
            raise ValueError("id_labels not provided")
        self.gmm, _ = gmm_fit(ind_train_data, kwargs["ind_train_labels"], self.num_classes)
        self._state = {"means": self.gmm.means, "chols": self.gmm.chols}
        self._setup_flag = True

    def postprocess(self, test_data, **kwargs) -> torch.Tensor:
        _check_2d(test_data, "test_feats")
        return torch.logsumexp(self.gmm.log_prob(test_data), dim=1)

    def _rehydrate(self) -> None:
        means = as_tensor(self._state["means"])
        self.gmm = GMMState(means=means, chols=torch.as_tensor(self._state["chols"], device=means.device),
                            jitter=torch.zeros(means.shape[0], device=means.device))


LaREDPostprocessor = KDELatentSpace
LaREMPostprocessor = MDLatentSpace
LaREKPostprocessor = KNNLatentSpace
LaREGPostprocessor = GMMLatentSpace
