"""Weight-only int8 matrix product: the wrapper of ``csrc/quant_matmul.cu``.

Counterpart of ``runia_core_tpu/ops/quant_matmul.py`` (the TPU kernel
``quant_matmul``). Contract, as ``models/llama.py::QDense`` stores its
weights::

    x     (..., K)  bfloat16 / float32   activations (decode: rows = batch)
    wq    (K, N)    int8                 per-output-channel symmetric weights
    scale (N,)      float32              dequant scale per output channel
    out   (..., N)  x.dtype              (x @ wq) summed in f32, * scale, rounded once

:func:`quant_matmul` routes by where its tensor lies: a CPU tensor goes to
:func:`quant_matmul_plain`, a CUDA tensor to the kernel, which launches or
raises. :func:`quant_matmul_supported` states the kernel's contract; a caller
takes another route for a shape outside it, before any launch, as
``models/llama.py::QDense`` does above 1024 rows.
"""

from __future__ import annotations

import torch

from runia_core_tpu_torch import _kernels

__all__ = ["MAX_ROWS", "quant_matmul", "quant_matmul_plain", "quant_matmul_supported"]

# Decode, speculative verify and lane-chunk prefill stay under it; above it a
# product is compute-bound and one dequantized weight serves all the rows.
MAX_ROWS = 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quant_matmul_supported(rows: int) -> bool:
    """True if a product of ``rows`` rows is in the kernel's contract. The
    kernel masks ragged K and N itself, so only the row count limits it
    (the TPU version's K % 128 and VMEM budget do not apply)."""
    return 0 < rows <= MAX_ROWS


def quant_matmul_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: ``(x.float() @ wq.float()) * scale``,
    cast to x.dtype."""
    out = (x.to(torch.float32) @ wq.to(torch.float32)) * scale.to(torch.float32)
    return out.to(x.dtype)


def quant_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ (wq * scale)`` with wq kept int8 in device memory.

    ``x`` may carry leading batch dimensions; they are flattened to rows.
    ``quant_matmul.launches`` counts the kernel's launches.
    """
    if not x.is_cuda:
        return quant_matmul_plain(x, wq, scale)
    *lead, k = x.shape
    rows = x.numel() // k if k else 0
    if x.dtype not in _DTYPE_CODES or wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(
            f"quant_matmul takes float32/bfloat16 x, int8 wq and float32 scale; got {x.dtype}, "
            f"{wq.dtype}, {scale.dtype}"
        )
    if wq.ndim != 2 or wq.shape[0] != k or scale.shape != (wq.shape[1],):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, wq {tuple(wq.shape)}, scale {tuple(scale.shape)}")
    if not quant_matmul_supported(rows):
        raise ValueError(f"quant_matmul takes 1..{MAX_ROWS} rows; got {rows}")
    x2 = x.reshape(rows, k)
    for name, t in (("x", x2), ("wq", wq), ("scale", scale)):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"quant_matmul: {name} must be contiguous on {x.device}")
    n = wq.shape[1]
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if n == 0 or k == 0:
        return out.zero_().reshape(*lead, n)
    lib = _kernels.library()
    with torch.cuda.device(x.device):
        code = lib.runia_quant_matmul(
            x2.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, k, n,
            _DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(code, "quant_matmul")
    quant_matmul.launches += 1
    return out.reshape(*lead, n)


quant_matmul.launches = 0
