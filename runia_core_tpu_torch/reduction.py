"""PCA (whitened) as a plain state of tensors, in PyTorch.

Counterpart of ``runia_core_tpu/reduction.py``: the state is (mean,
components, explained_variance), ``pca_transform`` is one matmul, and the
sign of each component follows sklearn's svd_flip (its largest-magnitude
loading is positive), so fits agree with the JAX package component by
component. Inputs wider than 4096 take a randomized SVD (a Halko range
finder) whose Gaussian test matrix comes from an explicit generator or is
injected. PaCMAP (2-D visualisation) needs the optional ``pacmap`` package,
as in the JAX package. A fit takes an array to ``device`` (None: the GPU); a
transform takes its input to the fitted state's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from runia_core_tpu_torch.utils.placement import as_tensor

__all__ = [
    "PCAState",
    "apply_pacmap_transform",
    "apply_pca_ds",
    "apply_pca_ds_split",
    "apply_pca_transform",
    "fit_pacmap",
    "pca_fit",
    "pca_from_covariance",
    "pca_transform",
    "plot_samples_pacmap",
]


@dataclass
class PCAState:
    """Fitted PCA: mean (d,), components (k, d), explained_variance (k,)."""

    mean: torch.Tensor
    components: torch.Tensor
    explained_variance: torch.Tensor
    whiten: bool = True

    def transform(self, samples) -> torch.Tensor:
        return pca_transform(self, torch.as_tensor(samples, device=self.mean.device))

    def to(self, device) -> "PCAState":
        return PCAState(
            self.mean.to(device), self.components.to(device),
            self.explained_variance.to(device), self.whiten,
        )

    @property
    def n_components_(self) -> int:
        return int(self.components.shape[0])


def _randomized_svd(
    x: torch.Tensor, k: int, generator: Optional[torch.Generator] = None, omega: Optional[torch.Tensor] = None,
    oversample: int = 10, iters: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Halko-style randomized range finder and a small SVD, for wide x.
    ``omega`` (d, min(d, k + oversample)) replaces the Gaussian test matrix
    drawn from ``generator``."""
    d = x.shape[1]
    if omega is None:
        omega = torch.randn((d, min(d, k + oversample)), generator=generator, dtype=x.dtype, device=x.device)
    y = x @ omega.to(device=x.device, dtype=x.dtype)
    for _ in range(iters):
        y = x @ (x.T @ y)
        y, _ = torch.linalg.qr(y)
    q, _ = torch.linalg.qr(y)
    u_b, s, vt = torch.linalg.svd(q.T @ x, full_matrices=False)
    return (q @ u_b)[:, :k], s[:k], vt[:k]


def _svd_flip(components: torch.Tensor) -> torch.Tensor:
    """+1 / -1 per row: the sign that makes its largest-magnitude entry positive."""
    rows = torch.arange(components.shape[0], device=components.device)
    return torch.sign(components[rows, components.abs().argmax(dim=1)])


def pca_fit(
    samples, n_components: int, whiten: bool = True, svd_solver: str = "auto",
    generator: Optional[torch.Generator] = None, omega: Optional[torch.Tensor] = None, device=None,
) -> Tuple[torch.Tensor, PCAState]:
    """Fit PCA and return (transformed samples, state), with sklearn's
    fit_transform semantics: explained_variance = S^2 / (n - 1), and whitened
    outputs have unit variance per component. ``svd_solver="randomized"``,
    or "auto" on inputs wider than 4096 with fewer than a fifth as many
    components, takes the randomized SVD (``generator``, ``omega``)."""
    x = as_tensor(samples, device)
    n, d = x.shape
    mean = x.mean(dim=0)
    if svd_solver == "randomized" or (svd_solver == "auto" and d > 4096 and n_components < 0.2 * d):
        u, s, vt = _randomized_svd(x - mean, n_components, generator, omega)
    else:
        u, s, vt = torch.linalg.svd(x - mean, full_matrices=False)
        u, s, vt = u[:, :n_components], s[:n_components], vt[:n_components]
    signs = _svd_flip(vt)
    vt = vt * signs[:, None]
    u = u * signs[None, :]
    state = PCAState(mean=mean, components=vt, explained_variance=s**2 / (n - 1), whiten=whiten)
    transformed = u * (n - 1.0) ** 0.5 if whiten else u * s
    return transformed, state


def pca_from_covariance(
    mean: torch.Tensor, covariance: torch.Tensor, n_samples: int, n_components: int, whiten: bool = True
) -> PCAState:
    """A PCAState from first and second moments (``ops.linalg.StreamingMoments``)
    instead of the data matrix: the covariance's leading eigenvectors with
    the svd_flip signs. ``covariance`` is the ML (1/n) one; the explained
    variance converts to sklearn's 1/(n-1)."""
    eigvals, eigvecs = torch.linalg.eigh(covariance)  # ascending
    order = torch.argsort(-eigvals)[:n_components]
    components = eigvecs[:, order].T
    return PCAState(
        mean=mean,
        components=components * _svd_flip(components)[:, None],
        explained_variance=eigvals[order] * (n_samples / (n_samples - 1.0)),
        whiten=whiten,
    )


def pca_transform(state: PCAState, samples: torch.Tensor) -> torch.Tensor:
    """Project samples with a fitted PCA (one matmul)."""
    proj = (samples - state.mean) @ state.components.T
    if state.whiten:
        proj = proj / torch.sqrt(state.explained_variance)
    return proj


def apply_pca_ds(
    train_samples, test_samples, nro_components: int = 16, svd_solver: str = "auto", whiten: bool = True,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, PCAState]:
    """Fit on train, transform train and test (the reference's signature)."""
    train_t, state = pca_fit(train_samples, nro_components, whiten, svd_solver=svd_solver, device=device)
    return train_t, state.transform(test_samples), state


def apply_pca_ds_split(
    samples, nro_components: int = 16, svd_solver: str = "auto", whiten: bool = True, device=None
) -> Tuple[torch.Tensor, PCAState]:
    """Fit and transform one split (reference dimensionality_reduction.py:52-72)."""
    return pca_fit(samples, nro_components, whiten, svd_solver=svd_solver, device=device)


def apply_pca_transform(samples, pca_transform_state) -> torch.Tensor:
    """Transform new samples with a PCAState (an array goes to the state's
    device) or any object with ``.transform``."""
    return pca_transform_state.transform(samples)


def _require_pacmap():
    try:
        import pacmap
    except ImportError as exc:
        raise ImportError(
            "pacmap is an optional dependency used only for 2-D visualization; "
            "install it to use fit_pacmap/apply_pacmap_transform."
        ) from exc
    return pacmap


def fit_pacmap(samples_ind, neighbors: int = 25, components: int = 2):
    """2-D PaCMAP embedding of numpy samples: (embedding, the fitted PaCMAP)."""
    pacmap = _require_pacmap()
    embedding = pacmap.PaCMAP(n_components=components, n_neighbors=neighbors, MN_ratio=0.5, FP_ratio=2.0)
    return embedding.fit_transform(samples_ind, init="pca"), embedding


def apply_pacmap_transform(new_samples, original_samples, pm_instance):
    """Transform new samples with a fitted PaCMAP."""
    return pm_instance.transform(X=new_samples, basis=original_samples)


def plot_samples_pacmap(
    samples_ind, samples_ood, neighbors: int = 25, components: int = 2, title: str = "Plot Title",
    return_figure: bool = False,
):
    """In-distribution against out-of-distribution samples in 2-D PaCMAP."""
    pacmap = _require_pacmap()
    import matplotlib.pyplot as plt

    samples_concat = np.concatenate((samples_ind, samples_ood))
    labels = np.concatenate((np.zeros((samples_ind.shape[0], 1)), np.ones((samples_ood.shape[0], 1))))
    embedding = pacmap.PaCMAP(n_components=components, n_neighbors=neighbors, MN_ratio=0.5, FP_ratio=2.0)
    transformed = embedding.fit_transform(samples_concat, init="pca")
    fig, axes = plt.subplots()
    scatter = axes.scatter(transformed[:, 0], transformed[:, 1], cmap="brg", c=labels, s=1.5)
    axes.set_title(title)
    axes.set_xlabel("PACMAP dimension 1")
    axes.set_ylabel("PACMAP dimension 2")
    axes.legend(handles=scatter.legend_elements()[0], labels=["In-Distribution", "Out-of-Distribution"])
    if return_figure:
        return fig
    plt.show()
