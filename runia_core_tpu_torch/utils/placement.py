"""Where the port's entry points put what they are given.

JAX's ``jnp.asarray`` puts a host array on the default device, the
accelerator; :func:`as_tensor` is its counterpart here. A tensor stays on
its device, so a caller who hands CPU tensors computes on the CPU; anything
else (a numpy array, a list, a scalar) goes to ``device``, or to
:func:`runia_core_tpu_torch.default_device` (the GPU) when ``device`` is
None. :func:`to_numpy` is the way back to the host, for the numpy layers
(metrics, tables, plots): ``np.asarray`` of a CUDA tensor raises.
"""

from __future__ import annotations

import numpy as np
import torch

import runia_core_tpu_torch

__all__ = ["as_tensor", "to_numpy"]


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor keeps its device (and its dtype unless
    ``dtype`` is given); anything else goes to ``device``, None meaning
    ``default_device()``."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    device = runia_core_tpu_torch.default_device() if device is None else device
    return torch.as_tensor(x, dtype=dtype, device=device)


def to_numpy(x) -> np.ndarray:
    """A host numpy array of ``x`` (a tensor on any device, an array, a list
    or a scalar); bfloat16 and float16 tensors come back as float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)
