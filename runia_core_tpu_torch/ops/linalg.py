"""Linear algebra of the OoD scorers, in PyTorch.

Counterpart of the parts of ``runia_core_tpu/ops/linalg.py`` that LaREM
needs. The JAX matmuls ask for ``Precision.HIGHEST``; here they are plain
f32 matmuls, which are true f32 on the GPU as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's default;
``chip_smoke.py`` sets it explicitly).
"""

from __future__ import annotations

import torch

__all__ = ["empirical_covariance", "empirical_precision", "mahalanobis_quadform", "pinvh"]


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
