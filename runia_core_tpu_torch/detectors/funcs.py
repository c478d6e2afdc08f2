"""Score math of the post-hoc OoD detectors, in PyTorch: the part the latent
scorers need.

Counterpart of ``runia_core_tpu/detectors/funcs.py`` as far as
``detectors/latent.py`` reaches: ``normalizer`` (KNN / LaREK) and the
per-class Gaussian mixture (``GMMState``, ``gmm_fit``, ``gmm_log_prob``;
GMM / LaREG). The rest of that module (Mahalanobis pre/postprocess, DICE,
ASH, ReAct, GEN and the predictive-uncertainty scores) serves the feature
and logit scorers and is ported with them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from runia_core_tpu_torch.ops.linalg import class_means, mvn_fit_cholesky, mvn_log_prob

__all__ = ["GMMState", "gmm_fit", "gmm_log_prob", "normalizer"]


def normalizer(x):
    """Row-wise L2 normalisation with the reference's 1e-10 guard; an array
    stays an array, a tensor a tensor."""
    if isinstance(x, np.ndarray):
        return x / (np.linalg.norm(x, ord=2, axis=-1, keepdims=True) + 1e-10)
    return x / (torch.linalg.vector_norm(x, ord=2, dim=-1, keepdim=True) + 1e-10)


class GMMState:
    """Per-class Gaussian mixture: means (C, d), Cholesky factors (C, d, d)
    and the jitter each factor took. Classes without training samples are
    left out, as the reference drops their NaN rows."""

    def __init__(self, means: torch.Tensor, chols: torch.Tensor, jitter: torch.Tensor):
        self.means = means
        self.chols = chols
        self.jitter = jitter

    def log_prob(self, x) -> torch.Tensor:
        """(N, C) per-class log-densities (``MultivariateNormal.log_prob``)."""
        x = torch.as_tensor(x, device=self.means.device)
        if x.ndim == 3:  # the reference passes (N, 1, d)
            x = x[:, 0, :]
        return mvn_log_prob(x, self.means, self.chols)


def gmm_fit(embeddings, labels, num_classes: int) -> Tuple[GMMState, float]:
    """Per-class MVNs with the reference's shared jitter ladder: (state, the
    jitter used). A class covariance divides by n - 1, by 1 for a class of
    one sample."""
    x = torch.as_tensor(embeddings).to(torch.float32)
    labels_np = np.asarray(torch.as_tensor(labels).cpu()).astype(np.int64)
    labels_t = torch.as_tensor(labels_np, device=x.device)
    means = class_means(x, labels_t, num_classes)  # NaN rows for empty classes
    counts = np.bincount(labels_np, minlength=num_classes)
    one_hot = F.one_hot(labels_t, num_classes).to(x.dtype)  # (n, C)
    # (C, n, d): each class's rows centred, other classes' rows exactly zero.
    xc = (x[None] - torch.nan_to_num(means, nan=0.0)[:, None]) * one_hot.T[:, :, None]
    denom = torch.as_tensor(np.maximum(counts - 1.0, 1.0), dtype=x.dtype, device=x.device)
    covs = (xc.transpose(1, 2) @ xc) / denom[:, None, None]
    if not counts.all():
        keep = torch.as_tensor(counts > 0, device=x.device)
        means, covs = means[keep], covs[keep]
    chols, jitters = mvn_fit_cholesky(covs)
    return GMMState(means=means, chols=chols, jitter=jitters), float(jitters.max()) if jitters.numel() else 0.0


def gmm_log_prob(state: GMMState, x) -> torch.Tensor:
    return state.log_prob(x)
