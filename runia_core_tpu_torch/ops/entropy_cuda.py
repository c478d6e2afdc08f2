"""Marginal KL entropy on the GPU: the wrapper of ``csrc/marginal_entropy.cu``.

Counterpart of ``runia_core_tpu/ops/entropy_pallas.py`` (the TPU kernel
``marginal_entropy_pallas``). :func:`marginal_entropy_cuda` routes by where
its tensor lies: a CPU tensor goes to :func:`marginal_entropy_plain`, a CUDA
tensor to the kernel, which either launches or raises.
"""

from __future__ import annotations

import torch

from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.ops.entropy import _digamma_const, _marginal_entropy_sorted

__all__ = ["MAX_K", "MAX_N", "marginal_entropy_cuda", "marginal_entropy_plain"]

MAX_K = 15  # csrc/kl_entropy.cuh kMaxK: k is a template parameter
MAX_N = 64  # a column of n floats per thread is staged in 48 KB of shared memory

# The plain version of the kernel: the sorted-window form of ops/entropy.py.
marginal_entropy_plain = _marginal_entropy_sorted


def marginal_entropy_cuda(clouds: torch.Tensor, k: int, min_dist: float = 1e-5) -> torch.Tensor:
    """Marginal h(z_i) per cloud and dimension: (B, n, d) f32 -> (B, d) f32.

    ``marginal_entropy_cuda.launches`` counts the kernel's launches.
    """
    if not clouds.is_cuda:
        return marginal_entropy_plain(clouds, k, min_dist)
    if clouds.ndim != 3 or clouds.dtype != torch.float32 or not clouds.is_contiguous():
        raise ValueError(
            "marginal_entropy_cuda takes a contiguous (B, n, d) float32 tensor; got "
            f"{clouds.dtype} of shape {tuple(clouds.shape)}, contiguous={clouds.is_contiguous()}"
        )
    b, n, d = clouds.shape
    if not 1 <= k <= MAX_K or k >= n or n > MAX_N:
        raise ValueError(f"need 1 <= k <= {MAX_K}, k < n and n <= {MAX_N}; got k={k}, n={n}")
    out = torch.empty((b, d), dtype=torch.float32, device=clouds.device)
    if out.numel() == 0:
        return out
    lib = _kernels.library()
    with torch.cuda.device(clouds.device):
        code = lib.runia_marginal_entropy(
            clouds.data_ptr(), out.data_ptr(), b, n, d, k, float(min_dist),
            _digamma_const(k, n), torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(code, "marginal_entropy")
    marginal_entropy_cuda.launches += 1
    return out


marginal_entropy_cuda.launches = 0
