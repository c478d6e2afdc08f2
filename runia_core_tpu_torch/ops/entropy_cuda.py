"""Marginal KL entropy on the GPU: the wrapper of ``csrc/marginal_entropy.cu``.

Counterpart of ``runia_core_tpu/ops/entropy_pallas.py`` (the TPU kernel
``marginal_entropy_pallas``). :func:`marginal_entropy_cuda` routes by where
its tensor lies: a CPU tensor goes to :func:`marginal_entropy_plain`, a CUDA
tensor to the kernel, which either launches or raises. A shape outside the
kernel's contract is the caller's to route elsewhere, before any launch:
:func:`marginal_entropy_supported` states the contract, and the public
``ops/entropy.py::marginal_entropy`` takes the sorted-window form where it
says no, as the JAX function picks between its own routes.
"""

from __future__ import annotations

import torch

from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.ops.entropy import _digamma_const, _marginal_entropy_sorted

__all__ = [
    "MAX_K", "MAX_N", "block_width", "marginal_entropy_cuda", "marginal_entropy_plain",
    "marginal_entropy_supported",
]

# The limits of both entropy kernels (this file and mc_entropy_cuda.py) are
# decided here alone; the C++ side takes the block width it is given.
MAX_K = 15  # k is a template parameter: csrc/kl_entropy.cuh's RUNIA_DISPATCH_K covers 1..15
MAX_N = 512  # the largest cloud (n, or S) the kernels are held to
MAX_SMEM = 227 * 1024  # dynamic shared memory one block may opt into on sm_90
_WIDTHS = (128, 64, 32)  # block widths the kernels take (csrc/kl_entropy.cuh valid_width)

# The plain version of the kernel: the sorted-window form of ops/entropy.py.
marginal_entropy_plain = _marginal_entropy_sorted


def block_width(rows: int, extra_bytes: int = 0) -> int:
    """Threads (one column each) per block of an entropy kernel: the widest
    of 128, 64, 32 whose ``rows`` staged floats per column plus
    ``extra_bytes`` fit one block's shared memory; 0 if none does."""
    return next((w for w in _WIDTHS if rows * w * 4 + extra_bytes <= MAX_SMEM), 0)


def marginal_entropy_supported(n: int, k: int) -> bool:
    """True if the kernel takes clouds of n samples with k neighbours."""
    return 1 <= k <= MAX_K and k < n <= MAX_N and block_width(n) > 0


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
    if not marginal_entropy_supported(n, k):
        raise ValueError(f"need 1 <= k <= {MAX_K}, k < n and n <= {MAX_N}; got k={k}, n={n}")
    out = torch.empty((b, d), dtype=torch.float32, device=clouds.device)
    if out.numel() == 0:
        return out
    lib = _kernels.library()
    with torch.cuda.device(clouds.device):
        code = lib.runia_marginal_entropy(
            clouds.data_ptr(), out.data_ptr(), b, n, d, k, block_width(n), float(min_dist),
            _digamma_const(k, n), torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(code, "marginal_entropy")
    marginal_entropy_cuda.launches += 1
    return out


marginal_entropy_cuda.launches = 0
