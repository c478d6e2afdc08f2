"""KV cache allocation for the port's decoder LMs.

Counterpart of ``runia_core_tpu/models/transformer.py::init_cache``; the
GPT-2 ``CausalLM`` of that module is not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Dict

import torch

from runia_core_tpu_torch import default_device

__all__ = ["init_cache"]


def init_cache(model, batch: int, max_len: int, device=None) -> Dict:
    """An all-zero KV cache ``{"layers": [{"k", "v"[, "k_scale", "v_scale"]}]}``.

    k and v are (batch, max_len, kv_heads, head_dim) in the model's dtype; a
    KV8 model (``quantized_kv``) stores them int8 with (batch, max_len,
    kv_heads) f32 scales. ``device`` is where the model lives: None is
    ``runia_core_tpu_torch.default_device()``, the GPU, as for the model
    itself. The model writes into these tensors in place.
    """
    if device is None:
        device = default_device()
    shape = (batch, max_len, model.num_kv_heads, model.head_dim)

    def layer():
        if model.quantized_kv:
            return {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            }
        return {
            "k": torch.zeros(shape, dtype=model.dtype, device=device),
            "v": torch.zeros(shape, dtype=model.dtype, device=device),
        }

    return {"layers": [layer() for _ in range(model.num_layers)]}
