"""Pieces the port's transformer models share: frozen parameters, the
flax-layout ``Dense`` and the copies of ``transformers`` weights into it."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Dense", "hf_kernel", "hf_vector", "param"]


def param(shape, dtype, fill: float = 0.0) -> nn.Parameter:
    """A frozen parameter of ``shape`` filled with ``fill``."""
    return nn.Parameter(torch.full(shape, fill, dtype=dtype), requires_grad=False)


class Dense(nn.Module):
    """flax ``nn.Dense`` with a compute dtype: kernel (in, out), f32 bias."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, use_bias: bool = False):
        super().__init__()
        self.dtype = dtype
        self.kernel = param((d_in, d_out), dtype)
        self.bias = param((d_out,), torch.float32) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return out if self.bias is None else out + self.bias.to(self.dtype)


def hf_kernel(w: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """A torch (out, in) weight as an (in, out) kernel in ``dtype``."""
    return w.detach().to(device=device, dtype=dtype).T.contiguous()


def hf_vector(w: torch.Tensor, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A torch weight as it is (embeddings, norms, biases), in ``dtype``."""
    return w.detach().to(device=device, dtype=dtype).contiguous()
