"""GPT-NeoX / Pythia decoder LM with taps and KV cache, in PyTorch.

Counterpart of ``runia_core_tpu/models/neox.py``: fused per-head-interleaved
q|k|v with biases (each head's (3 * head_dim) columns are [q | k | v]),
partial rotary embeddings (the first ``rotary_pct`` of each head's dims
rotate, the rest pass through; RoPE from ``models/llama.py``, as in JAX),
LayerNorm with bias, exact-erf GELU and, by default, the parallel residual
``x + attn(ln1(x)) + mlp(ln2(x))``. The module tree follows the flax tree
(``block_{i}.qkv.kernel`` (in, out), ``input_norm``, ``post_attn_norm``,
``mlp_in``, ``mlp_out``, ``norm_f``, ``lm_head``), so
``models/convert.py::neox_from_flax`` carries a JAX ``NeoXLM``'s weights
across by name; the forward keeps the contract of ``models/transformer.py::
CausalLM`` (per-row ``cache_index``, the three output flags), in f32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.models.layers import Dense, param
from runia_core_tpu_torch.models.llama import _apply_rope, _rope_cos_sin
from runia_core_tpu_torch.models.transformer import (
    LayerNorm,
    attention_mask,
    dense_attention,
    init_float_weights,
    outputs,
    run_blocks,
    write_kv,
)

__all__ = ["NeoXLM", "convert_hf_gpt_neox"]


class _NeoXBlock(nn.Module):
    def __init__(self, num_heads: int, d_model: int, hidden_dim: int, ln_eps: float, rotary_ndims: int,
                 rope_theta: float, parallel_residual: bool = True):
        super().__init__()
        self.num_heads, self.d_model = num_heads, d_model
        self.rotary_ndims, self.rope_theta, self.parallel_residual = rotary_ndims, rope_theta, parallel_residual
        f32 = torch.float32
        self.input_norm = LayerNorm(d_model, ln_eps)
        self.qkv = Dense(d_model, 3 * d_model, f32, True)
        self.attn_out = Dense(d_model, d_model, f32, True)
        self.post_attn_norm = LayerNorm(d_model, ln_eps)
        self.mlp_in = Dense(d_model, hidden_dim, f32, True)
        self.mlp_out = Dense(hidden_dim, d_model, f32, True)

    def forward(self, x, mask, positions, cache=None, cache_index=None):
        b, t, _ = x.shape
        hd, nr = self.d_model // self.num_heads, self.rotary_ndims
        qkv = self.qkv(self.input_norm(x)).reshape(b, t, self.num_heads, 3 * hd)
        q, k, v = torch.split(qkv, hd, dim=-1)
        cos, sin = _rope_cos_sin(positions, nr, self.rope_theta)

        def rope(u):
            return torch.cat([_apply_rope(u[..., :nr], cos, sin), u[..., nr:]], dim=-1)

        q, k = rope(q), rope(k)
        k_all, v_all = write_kv(cache, k, v, cache_index)
        out, attn = dense_attention(q, k_all, v_all, mask)
        attn_out = self.attn_out(out)
        # Parallel residual: both branches read x; sequential: the attention
        # residual is in before the MLP's LayerNorm.
        mlp_input = x if self.parallel_residual else x + attn_out
        mlp_out = self.mlp_out(nn.functional.gelu(self.mlp_in(self.post_attn_norm(mlp_input))))
        if self.parallel_residual:
            return x + attn_out + mlp_out, attn
        return mlp_input + mlp_out, attn


class NeoXLM(nn.Module):
    """The JAX ``NeoXLM`` (Pythia), f32; ``hidden_dim`` None is 4 x
    ``d_model``. ``device`` None is the GPU. The cache contract as
    ``CausalLM``'s (MHA, f32)."""

    quantized_kv = False
    dtype = torch.float32

    def __init__(self, vocab_size: int, num_layers: int = 2, num_heads: int = 4, d_model: int = 64,
                 hidden_dim: Optional[int] = None, max_len: int = 256, ln_eps: float = 1e-5, rotary_pct: float = 0.25,
                 rope_theta: float = 10000.0, parallel_residual: bool = True, device=None):
        super().__init__()
        self.vocab_size, self.num_layers, self.num_heads, self.d_model = vocab_size, num_layers, num_heads, d_model
        self.num_kv_heads, self.head_dim = num_heads, d_model // num_heads
        self.hidden_dim, self.max_len, self.ln_eps = hidden_dim, max_len, ln_eps
        self.rotary_pct, self.rope_theta, self.parallel_residual = rotary_pct, rope_theta, parallel_residual
        rotary_ndims = int(self.head_dim * rotary_pct)
        with torch.device(default_device() if device is None else device):
            self.embed = nn.Module()
            self.embed.embedding = param((vocab_size, d_model), torch.float32)
            for i in range(num_layers):
                self.add_module(f"block_{i}", _NeoXBlock(num_heads, d_model, hidden_dim or 4 * d_model, ln_eps,
                                                         rotary_ndims, rope_theta, parallel_residual))
            self.norm_f = LayerNorm(d_model, ln_eps)
            self.lm_head = Dense(d_model, vocab_size, torch.float32)

    def init_weights(self, generator: torch.Generator) -> "NeoXLM":
        """Seeded random weights (``models/transformer.py::init_float_weights``)."""
        return init_float_weights(self, generator)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, cache: Optional[Dict] = None, cache_index=None,
                token_valid: Optional[torch.Tensor] = None, positions: Optional[torch.Tensor] = None, *,
                need_attentions: bool = True, need_hiddens: bool = True, last_logits_only: bool = False):
        """(B, T) tokens -> (logits, attentions, hiddens, cache), as
        ``CausalLM``."""
        b, t = tokens.shape
        mask, positions = attention_mask(b, t, tokens.device, cache, cache_index, token_valid, positions)
        x = self.embed.embedding[tokens]
        x, hiddens, attns = run_blocks(self, x, mask, cache, cache_index, need_attentions, need_hiddens,
                                       (positions,))
        x = self.norm_f(x)
        logits = self.lm_head(x[:, -1:] if last_logits_only else x)
        return outputs(logits, attns, hiddens, cache)


def _rope_setting(cfg, name: str, legacy: str, default: float) -> float:
    """A rotary setting of a GPT-NeoX config: the legacy attribute
    (``rotary_pct``, ``rotary_emb_base``) or its newer name, at the top
    level or in ``rope_parameters`` / ``rope_scaling``."""
    for source in (cfg, getattr(cfg, "rope_parameters", None) or {}, getattr(cfg, "rope_scaling", None) or {}):
        get = source.get if isinstance(source, dict) else (lambda key, src=source: getattr(src, key, None))
        for key in (legacy, name):
            if get(key) is not None:
                return float(get(key))
    return default


def convert_hf_gpt_neox(hf_model, device=None):
    """A ``transformers.GPTNeoXForCausalLM`` (Pythia) -> (NeoXLM,
    state_dict), the model holding the state (``assign=True``).

    The fused ``query_key_value`` rows are head-major [h0: q k v | h1: ...],
    the layout NeoXLM's (B, T, H, 3 hd) split wants, so it transposes
    straight in. A model without attention biases raises, as in JAX, and so
    does rope scaling other than the plain base. ``device`` None is the
    GPU."""
    cfg = hf_model.config
    if getattr(cfg, "attention_bias", True) is False:
        raise NotImplementedError("GPT-NeoX without attention biases")
    scaling = getattr(cfg, "rope_scaling", None) or {}
    if scaling.get("rope_type", scaling.get("type")) not in (None, "default"):
        raise NotImplementedError(f"rope_scaling {scaling!r} not supported")
    model = NeoXLM(
        vocab_size=cfg.vocab_size, num_layers=cfg.num_hidden_layers, num_heads=cfg.num_attention_heads,
        d_model=cfg.hidden_size, hidden_dim=cfg.intermediate_size, max_len=cfg.max_position_embeddings,
        ln_eps=float(cfg.layer_norm_eps),
        rotary_pct=_rope_setting(cfg, "partial_rotary_factor", "rotary_pct", 0.25),
        rope_theta=_rope_setting(cfg, "rope_theta", "rotary_emb_base", 10000.0),
        parallel_residual=bool(cfg.use_parallel_residual), device=device,
    )
    dev = model.embed.embedding.device

    def vec(t):
        return t.detach().to(device=dev, dtype=torch.float32).contiguous()

    def kernel(t):
        return vec(t).T.contiguous()

    hf = hf_model.gpt_neox
    state = {"embed.embedding": vec(hf.embed_in.weight), "norm_f.scale": vec(hf.final_layer_norm.weight),
             "norm_f.bias": vec(hf.final_layer_norm.bias), "lm_head.kernel": kernel(hf_model.embed_out.weight)}
    for i, layer in enumerate(hf.layers):
        att = layer.attention
        block = {"input_norm.scale": vec(layer.input_layernorm.weight),
                 "input_norm.bias": vec(layer.input_layernorm.bias),
                 "post_attn_norm.scale": vec(layer.post_attention_layernorm.weight),
                 "post_attn_norm.bias": vec(layer.post_attention_layernorm.bias)}
        for ours, linear in (("qkv", att.query_key_value), ("attn_out", att.dense),
                             ("mlp_in", layer.mlp.dense_h_to_4h), ("mlp_out", layer.mlp.dense_4h_to_h)):
            block[f"{ours}.kernel"], block[f"{ours}.bias"] = kernel(linear.weight), vec(linear.bias)
        state.update({f"block_{i}.{name}": value for name, value in block.items()})
    model.load_state_dict(state, assign=True)
    return model.eval(), state
