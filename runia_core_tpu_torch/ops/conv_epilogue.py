"""The conv-norm epilogue: inference batch norm, the residual and ReLU in one
pass over a convolution's output. The wrapper of ``csrc/conv_epilogue.cu``.

For a (N, C, H, W) conv output ``y``, per channel::

    relu(y * scale + shift [+ residual | + residual * scale_p + shift_p])

with f32 ``scale`` and ``shift`` (a norm's running statistics folded,
``models/resnet.py::BatchNorm.affine``), the residual either added as it is
or through its own norm's ``scale_p`` and ``shift_p`` (a projection conv's
output), all in f32, rounded once to ``y``'s dtype.

:func:`conv_epilogue` routes by where ``y`` lies: a CPU tensor goes to
:func:`conv_epilogue_plain`, the twin with the same arithmetic; a CUDA
tensor to the kernel, which writes the result into ``y`` itself and either
launches or raises. The kernel reads a channels_last bf16 or f32 map whose
channels are a multiple of :func:`width` (one 16-byte load); :func:`serves`
says whether a layer's maps are such. The JAX package has no such op: XLA
fuses the same passes of its ResNet into one loop.
"""

from __future__ import annotations

from typing import Optional

import torch

from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.utils.graphs import count_launch

__all__ = ["MAP_DTYPES", "conv_epilogue", "conv_epilogue_plain", "serves", "width"]

MAP_DTYPES = (torch.float32, torch.bfloat16)  # the maps the kernel reads


def width(dtype: torch.dtype) -> int:
    """Channels a thread of the kernel takes with one 16-byte load."""
    return 16 // dtype.itemsize


def serves(x: torch.Tensor, channels=()) -> bool:
    """True if a layer whose input is ``x`` and whose convs give ``channels``
    channels has its epilogue on the card: ``x`` a CUDA channels_last bf16 or
    f32 map, every count of channels a multiple of :func:`width`."""
    return (x.is_cuda and x.dtype in MAP_DTYPES and x.ndim == 4
            and x.is_contiguous(memory_format=torch.channels_last)
            and all(c % width(x.dtype) == 0 for c in channels))


def _readable(t: torch.Tensor) -> bool:
    return t.ndim == 4 and serves(t, (t.shape[1],)) and t.data_ptr() % 16 == 0


def _channels(t: torch.Tensor) -> torch.Tensor:
    return t[:, None, None]  # (C,) against the channel dim of (N, C, H, W)


def conv_epilogue_plain(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                        residual: Optional[torch.Tensor] = None, scale_p: Optional[torch.Tensor] = None,
                        shift_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, any layout, a new tensor:
    ``y * scale + shift``, plus the residual (``residual * scale_p +
    shift_p`` where those are given), then ReLU, in f32, one rounding to
    ``y``'s dtype."""
    out = torch.addcmul(_channels(shift), y.to(torch.float32), _channels(scale))
    if residual is not None:
        r = residual.to(torch.float32)
        if scale_p is not None:
            r = torch.addcmul(_channels(shift_p), r, _channels(scale_p))
        out = out + r
    return torch.relu(out).to(y.dtype)


def conv_epilogue(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  residual: Optional[torch.Tensor] = None, scale_p: Optional[torch.Tensor] = None,
                  shift_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`conv_epilogue_plain` on the card, written into ``y`` (a conv's
    fresh output: the residual is only read) and returned; ``scale`` and
    ``shift`` (``scale_p`` and ``shift_p``) f32 of C values on ``y``'s
    device. A CPU ``y`` takes the plain version.

    ``conv_epilogue.launches`` counts the kernel's launches."""
    if not y.is_cuda:
        return conv_epilogue_plain(y, scale, shift, residual, scale_p, shift_p)
    if not (_readable(y) and (residual is None or (
            _readable(residual) and residual.shape == y.shape and residual.dtype == y.dtype
            and residual.device == y.device and residual.data_ptr() != y.data_ptr()))):
        raise ValueError(
            f"conv_epilogue takes a channels_last (N, C, H, W) bfloat16 or float32 CUDA map, 16-byte aligned, C a "
            f"multiple of 8 (bfloat16) or 4 (float32), and a residual of its shape, dtype and layout that is not "
            f"the map; got {y.dtype} {tuple(y.shape)} strides {y.stride()}"
            + ("" if residual is None else f", residual {residual.dtype} {tuple(residual.shape)} "
                                           f"strides {residual.stride()}"))
    if (scale_p is None) != (shift_p is None) or (scale_p is not None and residual is None):
        raise ValueError("conv_epilogue: scale_p and shift_p come together, and with a residual")
    c = y.shape[1]
    for t in (scale, shift) + (() if scale_p is None else (scale_p, shift_p)):
        if t.dtype != torch.float32 or t.shape != (c,) or t.device != y.device or not t.is_contiguous():
            raise ValueError(f"conv_epilogue takes contiguous float32 ({c},) scales and shifts on {y.device}; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if y.numel() == 0:
        return y
    mode = 0 if residual is None else (1 if scale_p is None else 2)
    lib = _kernels.library()
    with _kernels.device_guard(y.device):
        code = lib.runia_conv_epilogue(
            y.data_ptr(), None if residual is None else residual.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            None if scale_p is None else scale_p.data_ptr(), None if shift_p is None else shift_p.data_ptr(),
            y.numel() // c, c, int(y.dtype == torch.bfloat16), mode,
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(code, "conv_epilogue")
    count_launch(conv_epilogue)
    return y


conv_epilogue.launches = 0
