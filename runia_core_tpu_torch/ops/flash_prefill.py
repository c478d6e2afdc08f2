"""Flash attention of a query chunk over a KV cache prefix: the wrapper of
``csrc/flash_prefill.cu``.

Counterpart of ``runia_core_tpu/ops/flash_prefill.py``. Query i of batch row
b sits at position ``q_start[b] + i`` and attends the cache keys
``kv_start[b] <= j <= q_start[b] + i``; GQA maps query head h to kv group
``h // (Hq // G)``; a KV8 cache passes int8 k/v with per-key scales, applied
on the logits (k) and on the probabilities (v); a row with an empty window
comes back as zeros. With ``q_start = 0`` over the call's own keys it is the
plain causal prefill.

:func:`flash_prefix_attention` keeps the JAX function's signature and layout
(q (B, Hq, Tq, D), k/v (B, G, K, D), scales (B, K, G)). A CPU tensor goes to
:func:`reference_prefix_attention`, a CUDA tensor to the kernel, which
launches or raises. k, v and q may be strided views (the last dimension
contiguous): the model hands over its (B, K, G, D) cache transposed, with no
copy. The kernel's output is a (B, Hq, Tq, D) view of a (B, Tq, Hq, D)
buffer, so the model's move back to (B, Tq, Hq * D) costs no copy either.

bf16 queries (with a bf16 or an int8 cache) run both products on the tensor
cores; f32 queries keep an f32 CUDA-core kernel. Views whose address or
strides are not 16-byte aligned are taken too: the kernel stages them
element by element instead of with 16-byte copies.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.utils.graphs import count_launch

__all__ = ["flash_prefix_attention", "reference_prefix_attention"]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)  # the kernel's D template instances: the head sizes of the port's models


def reference_prefix_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_start: torch.Tensor,
    kv_start: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's plain version: dense masked attention in f32.

    Mask ``kv_start[b] <= j <= q_start[b] + i``; softmax in f32; masked
    probabilities zeroed, so an empty window gives zeros. Keys outside every
    row's window are zeroed first, so garbage in the cache past the written
    prefix never reaches a product (as in the kernel).
    """
    b, hq, tq, d = q.shape
    g, kk = k.shape[1], k.shape[2]
    rep = hq // g
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if kv_start is None:
        kv_start = torch.zeros((b,), dtype=torch.int32, device=q.device)
    keys = torch.arange(kk, device=q.device)
    rows = q_start.to(torch.int64)[:, None, None] + torch.arange(tq, device=q.device)[None, :, None]
    mask = (keys[None, None, :] <= rows) & (keys[None, None, :] >= kv_start.to(torch.int64)[:, None, None])
    live = mask.any(dim=1)  # (B, K): keys some row attends
    k = torch.where(live[:, None, :, None], k.to(torch.float32), 0.0)
    v = torch.where(live[:, None, :, None], v.to(torch.float32), 0.0)
    mask = mask[:, None, None, :, :]  # (B, 1, 1, Tq, K)
    qg = q.reshape(b, g, rep, tq, d).to(torch.float32)
    logits = torch.einsum("bgrtd,bgkd->bgrtk", qg, k) * sm_scale
    if k_scale is not None:
        k_scale = torch.where(live[:, :, None], k_scale.to(torch.float32), 0.0)
        logits = logits * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.where(mask, torch.softmax(logits, dim=-1), torch.zeros_like(logits))
    if v_scale is not None:
        v_scale = torch.where(live[:, :, None], v_scale.to(torch.float32), 0.0)
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bgrtk,bgkd->bgrtd", probs, v)
    return out.reshape(b, hq, tq, d).to(q.dtype)


def flash_prefix_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_start: torch.Tensor,
    kv_start: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention over a cache prefix with per-row windows.

    Args:
        q: (B, Hq, Tq, D) chunk queries, bf16 or f32.
        k, v: (B, G, K, D) cache keys/values in q's dtype, or int8 with
            ``k_scale``/``v_scale`` (B, K, G) f32 (KV8).
        q_start: (B,) int32 position of each row's first query.
        kv_start: (B,) int32 first attendable key per row (None = zeros).
        sm_scale: logit scale (default 1/sqrt(D)).

    Returns (B, Hq, Tq, D) in q's dtype. ``flash_prefix_attention.launches``
    counts the kernel's launches, ``flash_prefix_attention.kv8_launches``
    those of its KV8 variant among them.
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    b, hq, tq, d = q.shape
    g, kk = k.shape[1], k.shape[2]
    if g == 0 or hq % g:
        raise ValueError(f"Hq={hq} not a multiple of G={g}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if not q.is_cuda:
        return reference_prefix_attention(q, k, v, q_start, kv_start, sm_scale, k_scale, v_scale)

    kv8 = k_scale is not None
    if kv_start is None:
        kv_start = torch.zeros((b,), dtype=torch.int32, device=q.device)
    if q.dtype not in _DTYPE_CODES or d not in _HEAD_DIMS:
        raise ValueError(f"flash_prefix_attention takes float32/bfloat16 q with D in {_HEAD_DIMS}; got {q.dtype}, D={d}")
    kv_dtype = torch.int8 if kv8 else q.dtype
    if k.dtype != kv_dtype or v.dtype != kv_dtype or k.shape != v.shape or k.shape[::3] != (b, d):
        raise ValueError(f"k, v must be (B, G, K, D) {kv_dtype}; got {k.dtype} {tuple(k.shape)}, {v.dtype} {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.device != q.device:
            raise ValueError(f"flash_prefix_attention: {name} needs a contiguous last dimension on {q.device}")
    for name, t in (("q_start", q_start), ("kv_start", kv_start)):
        if t.dtype != torch.int32 or t.shape != (b,) or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_prefix_attention: {name} must be a contiguous ({b},) int32 tensor on {q.device}")
    if kv8:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or t.shape != (b, kk, g) or t.device != q.device:
                raise ValueError(f"flash_prefix_attention: {name} must be ({b}, {kk}, {g}) float32 on {q.device}")
        if k_scale.stride() != v_scale.stride():
            raise ValueError("k_scale and v_scale must share strides")
    out = torch.empty((b, tq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    s_strides = k_scale.stride() if kv8 else (0, 0, 0)
    dims = (ctypes.c_longlong * 21)(
        b, hq, g, tq, kk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], *s_strides,
    )
    lib = _kernels.library()
    with _kernels.device_guard(q.device):
        code = lib.runia_flash_prefix_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q_start.data_ptr(),
            kv_start.data_ptr(), k_scale.data_ptr() if kv8 else None, v_scale.data_ptr() if kv8 else None,
            ctypes.addressof(dims), float(sm_scale), _DTYPE_CODES[q.dtype], int(kv8),
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(code, "flash_prefix_attention")
    count_launch(flash_prefix_attention)
    if kv8:
        count_launch(flash_prefix_attention, "kv8_launches")
    return out


flash_prefix_attention.launches = 0
flash_prefix_attention.kv8_launches = 0
