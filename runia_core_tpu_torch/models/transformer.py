"""GPT-2-style decoder LM (``CausalLM``) with attention / hidden-state taps,
and the KV cache of the port's decoder LMs.

Counterpart of ``runia_core_tpu/models/transformer.py``. The module tree
follows the flax parameter tree (``embed.embedding``, ``pos_embed.embedding``,
``block_{i}.LayerNorm_0.scale``, ``block_{i}.q.kernel`` stored (in, out),
``block_{i}.Dense_0`` for the MLP's first projection, ``ln_f``...), so
``models/convert.py::causal_lm_from_flax`` carries a JAX ``CausalLM``'s
weights across by name. The forward keeps the contract of the port's
``LlamaLM``::

    model(tokens, cache, cache_index, token_valid=..., positions=...,
          need_attentions=..., need_hiddens=..., last_logits_only=...)
        -> (logits, attentions, hiddens, cache)

with ``cache_index`` an int for a shared offset or a (B,) tensor of per-row
offsets, the cache updated in place, and outputs not asked for returned as
None. As in JAX, the hidden states are the embedding output and each block's
output (the last one before ``ln_f``), and the model computes in f32.

The learned position table has ``max_len`` rows. JAX's ``jnp.take`` (flax
``nn.Embed``) returns NaN for a position at or past it; an index past the
table in a CUDA gather is a device-side assert that kills the context. The
port computes JAX's value: it gathers at the position clamped into the
table and puts NaN where the position is out of range, so no out-of-range
gather is ever launched and the decode step stays capturable (the host does
not know the positions of a replayed step). ``TorchGenerator`` and
``SpeculativeGenerator`` warn, as JAX does, when a generation runs past
``max_len``.

``num_experts > 0`` swaps every block's MLP for JAX's top-2 MoE FFN with
capacity routing (a copy of ``runia_core_tpu/parallel/moe.py::
_dispatch_combine``: ranks in token order, tokens past an expert's capacity
dropped into a spill column, the top-k weights renormalised). Capacity is
computed per forward call, so prefill and decode agree only where nothing
overflows, as in JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.models.layers import Dense, param
from runia_core_tpu_torch.models.llama import _cache_write

__all__ = ["Block", "CausalLM", "convert_hf_gpt2", "init_cache"]

_NEG_INF = -1e30


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: the variance as mean(x^2) - mean(x)^2 (flax's
    fast variance, floored at 0), f32 ``scale`` and ``bias``."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = param((dim,), torch.float32, 1.0)
        self.bias = param((dim,), torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = (x.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


def attention_mask(b: int, t: int, dev, cache, cache_index, token_valid, positions):
    """The JAX ``CausalLM`` mask and positions, with the port's per-row
    cache path: (mask (B or 1, 1, t, K) bool, positions (B, t)).

    No cache: causal over the call's tokens, positions from the valid count
    when ``token_valid`` (B, t) is given. With a cache: key slot s is
    visible to the query at slot ``cache_index + i`` when s <= that slot and
    ``token_valid`` (B, K) marks it."""
    arange_t = torch.arange(t, device=dev)
    if cache is None:
        if positions is None:
            if token_valid is not None:
                positions = torch.clamp_min(torch.cumsum(token_valid.to(torch.int64), dim=1) - 1, 0)
            else:
                positions = arange_t[None, :].expand(b, t)
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))[None, None]
    else:
        kv_len = cache["layers"][0]["k"].shape[1]
        if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
            q_phys = cache_index.to(device=dev, dtype=torch.int64)[:, None] + arange_t[None, :]
        else:
            q_phys = (int(cache_index) + arange_t)[None, :]
        mask = torch.arange(kv_len, device=dev)[None, None, None, :] <= q_phys[:, None, :, None]
        if positions is None:
            positions = q_phys.expand(b, t)
    if token_valid is not None:
        mask = mask & token_valid[:, None, None, :]
    return mask, positions


def write_kv(cache: Optional[Dict], k: torch.Tensor, v: torch.Tensor, cache_index):
    """Write this call's k/v (B, t, H, d) into the layer cache in place and
    return what to attend over: the cache, or the call's own k/v."""
    if cache is None:
        return k, v
    _cache_write(cache["k"], k, cache_index)
    _cache_write(cache["v"], v, cache_index)
    return cache["k"], cache["v"]


def dense_attention(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor, mask: torch.Tensor):
    """softmax(q k^T / sqrt(d)) v over q (B, t, H, d) and k/v (B, K, H, d),
    masked logits at -1e30 and masked probabilities exactly 0 (JAX's
    ``jnp.where`` pair); returns the (B, t, H*d) context and the (B, H, t, K)
    probabilities."""
    b, t, h, d = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_all) / math.sqrt(d)
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    attn = torch.where(mask, torch.softmax(logits, dim=-1), torch.zeros_like(logits))
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v_all).reshape(b, t, h * d)
    return out, attn


def position_embed(table: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, positions, axis=0)``: NaN rows where a position is
    at or past the table (see the module doc), with no out-of-range gather."""
    n = table.shape[0]
    rows = table[positions.clamp(0, n - 1)]
    return torch.where((positions < n)[..., None], rows, torch.full_like(rows, float("nan")))


def _dispatch_combine(gate_logits: torch.Tensor, capacity: int, top_k: int):
    """(T, E, C) dispatch mask and combine weights from (T, E) gate logits:
    a copy of the JAX ``parallel/moe.py::_dispatch_combine``. A token's slot
    in an expert is its rank among the tokens routed there, in token order,
    the first choices of all tokens before the second; a rank at or past
    ``capacity`` lands in the spill column and is dropped."""
    t, e = gate_logits.shape
    dtype, dev = gate_logits.dtype, gate_logits.device
    probs = torch.softmax(gate_logits, dim=-1)
    top_p, top_idx = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    dispatch = torch.zeros((t, e, capacity), dtype=dtype, device=dev)
    combine = torch.zeros((t, e, capacity), dtype=dtype, device=dev)
    used = torch.zeros((e,), dtype=torch.int64, device=dev)
    experts, slots = torch.arange(e, device=dev), torch.arange(capacity + 1, device=dev)
    for choice in range(top_k):
        idx = top_idx[:, choice]
        onehot = (idx[:, None] == experts).to(torch.int64)  # (T, E); no host check, unlike F.one_hot
        pos = torch.cumsum(onehot, dim=0) - 1 + used[None, :]
        my_pos = pos.gather(1, idx[:, None])[:, 0]
        spill = torch.where(my_pos < capacity, my_pos, torch.full_like(my_pos, capacity))
        slot = (spill[:, None] == slots).to(dtype)[:, :capacity]
        sel = onehot.to(dtype)[:, :, None] * slot[:, None, :]
        dispatch = dispatch + sel
        combine = combine + sel * top_p[:, choice][:, None, None]
        used = used + onehot.sum(dim=0)
    return dispatch, combine


class Block(nn.Module):
    """The JAX pre-LN ``Block``: LayerNorm, q/k/v/attn_out with biases,
    LayerNorm, then the tanh-GELU MLP (``Dense_0``, ``mlp_out``) or the
    top-2 MoE FFN."""

    def __init__(self, num_heads: int, d_model: int, num_experts: int = 0, moe_capacity_factor: float = 2.0,
                 ln_eps: float = 1e-6):
        super().__init__()
        self.num_heads, self.d_model = num_heads, d_model
        self.num_experts, self.moe_capacity_factor = num_experts, moe_capacity_factor
        f32 = torch.float32
        self.LayerNorm_0 = LayerNorm(d_model, ln_eps)
        self.q, self.k, self.v = (Dense(d_model, d_model, f32, True) for _ in range(3))
        self.attn_out = Dense(d_model, d_model, f32, True)
        self.LayerNorm_1 = LayerNorm(d_model, ln_eps)
        if num_experts:
            self.moe_gate = Dense(d_model, num_experts, f32)
            self.moe_w_in = param((num_experts, d_model, 4 * d_model), f32)
            self.moe_w_out = param((num_experts, 4 * d_model, d_model), f32)
        else:
            self.Dense_0 = Dense(d_model, 4 * d_model, f32, True)
            self.mlp_out = Dense(4 * d_model, d_model, f32, True)

    def forward(self, x, mask, cache=None, cache_index=None):
        b, t, _ = x.shape
        hd = self.d_model // self.num_heads
        h = self.LayerNorm_0(x)
        q, k, v = (proj(h).reshape(b, t, self.num_heads, hd) for proj in (self.q, self.k, self.v))
        k_all, v_all = write_kv(cache, k, v, cache_index)
        out, attn = dense_attention(q, k_all, v_all, mask)
        x = x + self.attn_out(out)
        h2 = self.LayerNorm_1(x)
        if self.num_experts:
            return x + self._moe_ffn(h2), attn
        return x + self.mlp_out(nn.functional.gelu(self.Dense_0(h2), approximate="tanh")), attn

    def _moe_ffn(self, h: torch.Tensor) -> torch.Tensor:
        b, t, d = h.shape
        e = self.num_experts
        flat = h.reshape(b * t, d)
        capacity = max(1, int(self.moe_capacity_factor * flat.shape[0] / e))
        dispatch, combine = _dispatch_combine(self.moe_gate(flat), capacity, min(2, e))
        expert_in = torch.einsum("td,tec->ecd", flat, dispatch)
        act = nn.functional.gelu(torch.einsum("ecd,edh->ech", expert_in, self.moe_w_in), approximate="tanh")
        expert_out = torch.einsum("ech,ehd->ecd", act, self.moe_w_out)
        return torch.einsum("ecd,tec->td", expert_out, combine).reshape(b, t, d)


def run_blocks(model, x, mask, cache, cache_index, need_attentions, need_hiddens, block_args=()):
    """Every block of ``model`` over x: (x, hiddens list or None, attentions
    list or None); the hiddens hold the embedding output and each block's."""
    hiddens = [x] if need_hiddens else None
    attns = [] if need_attentions else None
    for i in range(model.num_layers):
        layer_cache = cache["layers"][i] if cache is not None else None
        x, attn = getattr(model, f"block_{i}")(x, mask, *block_args, layer_cache, cache_index)
        if need_hiddens:
            hiddens.append(x)
        if need_attentions:
            attns.append(attn)
    return x, hiddens, attns


def outputs(logits, attns, hiddens, cache):
    """The forward's (logits, attentions, hiddens, cache), f32, None where
    not asked for."""
    return (
        logits.to(torch.float32),
        torch.stack(attns) if attns is not None else None,
        torch.stack(hiddens).to(torch.float32) if hiddens is not None else None,
        cache,
    )


@torch.no_grad()
def init_float_weights(model: nn.Module, generator: torch.Generator, stacks=()) -> nn.Module:
    """Seeded random weights for a float model: kernels and the (E, in, out)
    ``stacks`` N(0, 1/fan_in) (flax's lecun-normal scale), embeddings
    N(0, 1), LayerNorm scales 1 and biases 0. ``generator`` lives on the
    parameters' device."""
    for name, p in model.named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf == "kernel" or leaf in stacks:
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) / math.sqrt(p.shape[-2]))
        elif leaf == "embedding":
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device))
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        else:
            raise ValueError(f"init_float_weights: unexpected parameter {name}")
    return model


class CausalLM(nn.Module):
    """The JAX ``CausalLM`` (GPT-2 layout: learned positions, pre-LN
    blocks, tanh GELU), f32. ``tie_embeddings`` takes the logits from the
    token embedding (no ``lm_head``). ``device`` is where the parameters
    are made: None is ``runia_core_tpu_torch.default_device()``, the GPU.
    The attributes ``num_kv_heads`` (= ``num_heads``), ``head_dim``,
    ``dtype`` and ``quantized_kv`` are the cache contract of
    :func:`init_cache`."""

    quantized_kv = False
    dtype = torch.float32

    def __init__(self, vocab_size: int, num_layers: int = 4, num_heads: int = 4, d_model: int = 64,
                 max_len: int = 256, num_experts: int = 0, moe_capacity_factor: float = 2.0, ln_eps: float = 1e-6,
                 tie_embeddings: bool = False, device=None):
        super().__init__()
        self.vocab_size, self.num_layers, self.num_heads, self.d_model = vocab_size, num_layers, num_heads, d_model
        self.num_kv_heads, self.head_dim = num_heads, d_model // num_heads
        self.max_len, self.num_experts, self.moe_capacity_factor = max_len, num_experts, moe_capacity_factor
        self.ln_eps, self.tie_embeddings = ln_eps, tie_embeddings
        with torch.device(default_device() if device is None else device):
            self.embed = nn.Module()
            self.embed.embedding = param((vocab_size, d_model), torch.float32)
            self.pos_embed = nn.Module()
            self.pos_embed.embedding = param((max_len, d_model), torch.float32)
            for i in range(num_layers):
                self.add_module(f"block_{i}", Block(num_heads, d_model, num_experts, moe_capacity_factor, ln_eps))
            self.ln_f = LayerNorm(d_model, ln_eps)
            if not tie_embeddings:
                self.lm_head = Dense(d_model, vocab_size, torch.float32, True)

    def init_weights(self, generator: torch.Generator) -> "CausalLM":
        """Seeded random weights (:func:`init_float_weights`)."""
        return init_float_weights(self, generator, ("moe_w_in", "moe_w_out"))

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, cache: Optional[Dict] = None, cache_index=None,
                token_valid: Optional[torch.Tensor] = None, positions: Optional[torch.Tensor] = None, *,
                need_attentions: bool = True, need_hiddens: bool = True, last_logits_only: bool = False):
        """(B, T) tokens -> (logits (B, T, V), attentions (L, B, H, T, K),
        hiddens (L+1, B, T, D), cache), all f32; see the module doc."""
        b, t = tokens.shape
        mask, positions = attention_mask(b, t, tokens.device, cache, cache_index, token_valid, positions)
        x = self.embed.embedding[tokens] + position_embed(self.pos_embed.embedding, positions)
        x, hiddens, attns = run_blocks(self, x, mask, cache, cache_index, need_attentions, need_hiddens)
        x = self.ln_f(x)
        head_in = x[:, -1:] if last_logits_only else x
        logits = head_in @ self.embed.embedding.T if self.tie_embeddings else self.lm_head(head_in)
        return outputs(logits, attns, hiddens, cache)


def init_cache(model, batch: int, max_len: int, device=None) -> Dict:
    """An all-zero KV cache ``{"layers": [{"k", "v"[, "k_scale", "v_scale"]}]}``.

    k and v are (batch, max_len, kv_heads, head_dim) in the model's dtype; a
    KV8 model (``quantized_kv``) stores them int8 with (batch, max_len,
    kv_heads) f32 scales. As in JAX, a model without ``num_kv_heads`` /
    ``head_dim`` / ``dtype`` has MHA heads of ``d_model // num_heads`` in
    f32. ``device`` is where the model lives: None is
    ``runia_core_tpu_torch.default_device()``, the GPU, as for the model
    itself. The model writes into these tensors in place.
    """
    if device is None:
        device = default_device()
    head_dim = getattr(model, "head_dim", None) or model.d_model // model.num_heads
    kv_heads = getattr(model, "num_kv_heads", None) or model.num_heads
    shape = (batch, max_len, kv_heads, head_dim)

    def layer():
        if getattr(model, "quantized_kv", False):
            return {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            }
        dtype = getattr(model, "dtype", torch.float32)
        return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"layers": [layer() for _ in range(model.num_layers)]}


def convert_hf_gpt2(hf_model, device=None):
    """A ``transformers.GPT2LMHeadModel`` -> (CausalLM, state_dict), the
    model holding the state (loaded with ``assign=True``, no second copy).

    The JAX ``convert_hf_gpt2``'s mapping and refusals: HF ``Conv1D``
    weights are already (in, out), so the fused ``c_attn`` splits into q/k/v
    with no transpose; the embedding is tied; ``ln_eps`` is
    ``layer_norm_epsilon``. An activation other than tanh-GELU,
    ``scale_attn_by_inverse_layer_idx`` and ``reorder_and_upcast_attn``
    raise (they change the forward without changing a shape). ``device``
    None is the GPU."""
    cfg = hf_model.config
    act = getattr(cfg, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise NotImplementedError(f"GPT-2 activation_function={act!r}")
    if getattr(cfg, "scale_attn_by_inverse_layer_idx", False):
        raise NotImplementedError("GPT-2 scale_attn_by_inverse_layer_idx=True")
    if getattr(cfg, "reorder_and_upcast_attn", False):
        raise NotImplementedError("GPT-2 reorder_and_upcast_attn=True")
    model = CausalLM(vocab_size=cfg.vocab_size, num_layers=cfg.n_layer, num_heads=cfg.n_head, d_model=cfg.n_embd,
                     max_len=cfg.n_positions, ln_eps=float(cfg.layer_norm_epsilon), tie_embeddings=True,
                     device=device)
    dev = model.embed.embedding.device
    sd = hf_model.state_dict()

    def w(name):
        return sd[name].detach().to(device=dev, dtype=torch.float32).contiguous()

    state = {"embed.embedding": w("transformer.wte.weight"), "pos_embed.embedding": w("transformer.wpe.weight"),
             "ln_f.scale": w("transformer.ln_f.weight"), "ln_f.bias": w("transformer.ln_f.bias")}
    for i in range(cfg.n_layer):
        pre = f"transformer.h.{i}"
        qkv_w = torch.split(w(f"{pre}.attn.c_attn.weight"), cfg.n_embd, dim=1)
        qkv_b = torch.split(w(f"{pre}.attn.c_attn.bias"), cfg.n_embd)
        for name, kernel, bias in zip("qkv", qkv_w, qkv_b):
            state[f"block_{i}.{name}.kernel"] = kernel.contiguous()
            state[f"block_{i}.{name}.bias"] = bias.contiguous()
        for ours, theirs in (("LayerNorm_0", "ln_1"), ("LayerNorm_1", "ln_2")):
            state[f"block_{i}.{ours}.scale"] = w(f"{pre}.{theirs}.weight")
            state[f"block_{i}.{ours}.bias"] = w(f"{pre}.{theirs}.bias")
        for ours, theirs in (("attn_out", "attn.c_proj"), ("Dense_0", "mlp.c_fc"), ("mlp_out", "mlp.c_proj")):
            state[f"block_{i}.{ours}.kernel"] = w(f"{pre}.{theirs}.weight")
            state[f"block_{i}.{ours}.bias"] = w(f"{pre}.{theirs}.bias")
    model.load_state_dict(state, assign=True)
    return model.eval(), state
