"""PCA (whitened) as a plain state of tensors, in PyTorch.

Counterpart of ``runia_core_tpu/reduction.py`` for the exact-SVD fit: the
state is (mean, components, explained_variance), ``pca_transform`` is one
matmul, and the sign of each component follows sklearn's svd_flip (its
largest-magnitude loading is positive), so fits agree with the JAX package
component by component. The randomized SVD that the JAX package switches to
for inputs wider than 4096, and PaCMAP, are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

__all__ = ["PCAState", "apply_pca_ds_split", "apply_pca_transform", "pca_fit", "pca_transform"]


@dataclass
class PCAState:
    """Fitted PCA: mean (d,), components (k, d), explained_variance (k,)."""

    mean: torch.Tensor
    components: torch.Tensor
    explained_variance: torch.Tensor
    whiten: bool = True

    def transform(self, samples) -> torch.Tensor:
        return pca_transform(self, torch.as_tensor(samples))

    def to(self, device) -> "PCAState":
        return PCAState(
            self.mean.to(device), self.components.to(device),
            self.explained_variance.to(device), self.whiten,
        )

    @property
    def n_components_(self) -> int:
        return int(self.components.shape[0])


def pca_fit(
    samples, n_components: int, whiten: bool = True, svd_solver: str = "auto"
) -> Tuple[torch.Tensor, PCAState]:
    """Fit PCA and return (transformed samples, state), with sklearn's
    fit_transform semantics: explained_variance = S^2 / (n - 1), and whitened
    outputs have unit variance per component."""
    x = torch.as_tensor(samples)
    n, d = x.shape
    if svd_solver == "randomized" or (svd_solver == "auto" and d > 4096 and n_components < 0.2 * d):
        raise NotImplementedError("the randomized SVD (d > 4096) is not ported yet")
    mean = x.mean(dim=0)
    u, s, vt = torch.linalg.svd(x - mean, full_matrices=False)
    u, s, vt = u[:, :n_components], s[:n_components], vt[:n_components]
    rows = torch.arange(vt.shape[0], device=vt.device)
    signs = torch.sign(vt[rows, vt.abs().argmax(dim=1)])
    vt = vt * signs[:, None]
    u = u * signs[None, :]
    state = PCAState(mean=mean, components=vt, explained_variance=s**2 / (n - 1), whiten=whiten)
    transformed = u * (n - 1.0) ** 0.5 if whiten else u * s
    return transformed, state


def pca_transform(state: PCAState, samples: torch.Tensor) -> torch.Tensor:
    """Project samples with a fitted PCA (one matmul)."""
    proj = (samples - state.mean) @ state.components.T
    if state.whiten:
        proj = proj / torch.sqrt(state.explained_variance)
    return proj


def apply_pca_ds_split(
    samples, nro_components: int = 16, svd_solver: str = "auto", whiten: bool = True
) -> Tuple[torch.Tensor, PCAState]:
    """Fit and transform one split (reference dimensionality_reduction.py:52-72)."""
    return pca_fit(samples, nro_components, whiten, svd_solver=svd_solver)


def apply_pca_transform(samples, pca_transform_state) -> torch.Tensor:
    """Transform new samples with a PCAState or any object with ``.transform``."""
    if isinstance(pca_transform_state, PCAState):
        return pca_transform(pca_transform_state, torch.as_tensor(samples))
    return pca_transform_state.transform(samples)
