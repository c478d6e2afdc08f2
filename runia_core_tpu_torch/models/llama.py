"""Llama-family decoder LM (RMSNorm + RoPE + GQA + SwiGLU), in PyTorch.

Counterpart of ``runia_core_tpu/models/llama.py``. The module tree follows
the flax parameter tree (``embed.embedding``, ``block_{i}.q.kernel`` stored
(in, out), ``block_{i}.input_norm.scale``, ``lm_head.kernel``...), so
``models/convert.py::llama_from_flax`` carries a JAX ``LlamaLM``'s weights
across by name, and the forward keeps the JAX contract::

    model(tokens, cache, cache_index, token_valid=..., positions=...)
        -> (logits, attentions, hiddens, cache)

with three keyword flags the JAX version does not need: eager PyTorch has
no dead-code elimination, so ``need_attentions``, ``need_hiddens`` and
``last_logits_only`` say which outputs the caller reads (an output not
asked for comes back as None, and is never computed). The cache is updated
in place; the JAX version returns a new one.

Routes, chosen by shape alone on any device (a kernel's wrapper launches
its CUDA kernel for a CUDA tensor and runs its plain twin for a CPU one):

* projections of a quantized model (``QDense``) go through
  ``ops/quant_matmul.py`` for up to 1024 rows; above that the int8 weight is
  dequantized into the compute dtype and multiplied by ``torch.matmul``,
  as the JAX version does off the kernel;
* attention of a ``use_flash`` model goes through
  ``ops/flash_prefill.py`` when the call has at least 128 tokens, the plain
  causal case (no padding mask, no custom positions, no sliding window) and
  no attention probabilities are asked for. The kernel is built for heads of
  32, 64, 128 and 256 (the port's models); a ``use_flash`` model made on a
  GPU with another head size raises when it is built. Prefill into an empty cache and
  chunked prefill over a live one are one route: the chunk's K/V are written
  into the cache first and the kernel attends the cache with ``q_start =
  cache_index``; a KV8 cache is attended in int8 with its scales (the JAX
  dense path's numbers; the JAX TPU branch attends the call's unquantized
  k/v instead). Everything else, decode steps included, takes the dense
  path with the -1e30 mask and an f32 softmax;
* a sparse-MoE block (``num_experts > 0``, Mixtral) computes what the JAX
  ``_moe_ffn`` computes (router in the compute dtype, softmax in f32 over
  all experts, top-k renormalised, no token dropped) as a loop over the
  experts: each expert's SwiGLU on every token, weighted by its gate (zero
  where the token did not pick it), summed. The shapes are static, so the
  decode step stays capturable (a routed form gathers each expert's tokens,
  whose counts live on the host), the work is that of JAX's dense einsum,
  and the working memory is (tokens, hidden), not (tokens, experts,
  hidden). Quantized expert slices follow ``QDense``'s rule.

``convert_hf_llama``, ``convert_hf_gemma`` and ``convert_hf_mixtral`` map a
``transformers`` checkpoint onto (LlamaLM, state_dict) without JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.models.layers import Dense, hf_kernel, hf_vector, param
from runia_core_tpu_torch.ops.flash_prefill import _HEAD_DIMS as _FLASH_HEAD_DIMS
from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention
from runia_core_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_supported

__all__ = [
    "LlamaLM",
    "QDense",
    "convert_hf_gemma",
    "convert_hf_llama",
    "convert_hf_mixtral",
    "fuse_quantized_llama_params",
    "quantize_llama_params",
]

_FLASH_MIN_TOKENS = 128
_NEG_INF = -1e30


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: x * rsqrt(mean(x^2) + eps) * scale, on f32 input."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = param((dim,), torch.float32, 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * self.scale


class QDense(nn.Module):
    """Weight-only int8 linear: ``kernel_q`` (in, out) int8 with a
    per-output-channel f32 ``scale``. Up to 1024 rows the int8 weight goes
    to ``ops/quant_matmul.py`` as it is (decode is weight-bound: the int8
    stream is half the bf16 bytes); above, it is dequantized into the
    compute dtype for one ``torch.matmul``, the JAX version's off-kernel
    path. The fused ``qkv``/``gateup`` projections of a ``fused_qkv`` model
    are QDense modules over the stored concatenation: the counterpart of
    the JAX ``_fused_quant_matmul``."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, use_bias: bool = False):
        super().__init__()
        self.dtype = dtype
        self.kernel_q = param((d_in, d_out), torch.int8)
        self.scale = param((d_out,), torch.float32, 1.0)
        self.bias = param((d_out,), torch.float32) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _int8_matmul(x.to(self.dtype), self.kernel_q, self.scale)
        return out if self.bias is None else out + self.bias.to(self.dtype)


def _int8_matmul(x: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x @ (kernel_q * scale) in x's dtype: kernel 3 up to 1024 rows, else
    the weight dequantized into x's dtype for one ``torch.matmul``."""
    if quant_matmul_supported(x.numel() // x.shape[-1]):
        return quant_matmul(x.contiguous(), kernel_q, scale)
    return x @ (kernel_q.to(x.dtype) * scale.to(x.dtype)[None, :])


def _rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables (B, T, head_dim) in f32 for the rotate-half convention."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions[..., None].to(torch.float32) * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, d); cos/sin (B, T, d) broadcast over heads."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None, :] + rotated * sin[:, :, None, :]


def _cache_write(buf: torch.Tensor, val: torch.Tensor, cache_index) -> None:
    """Write val (B, t, ...) into buf (B, K, ...) in place: at one shared
    offset for a scalar ``cache_index`` (clamped so the slice fits, as
    ``dynamic_update_slice`` does), or at each row's own offset for a (B,)
    tensor."""
    t = val.shape[1]
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        cols = cache_index.to(device=buf.device, dtype=torch.int64)[:, None] + torch.arange(t, device=buf.device)
        buf[rows, cols] = val.to(buf.dtype)
        return
    start = min(max(int(cache_index), 0), buf.shape[1] - t)
    buf[:, start : start + t] = val.to(buf.dtype)


def _quantize_kv(x: torch.Tensor):
    """KV8: int8 values and one f32 scale = max|x| / 127 per (B, pos, head);
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    scale = x.abs().amax(dim=-1).clamp_min(1e-8).to(torch.float32) / 127.0
    xq = torch.clamp(torch.round(x.to(torch.float32) / scale[..., None]), -127, 127).to(torch.int8)
    return xq, scale


class _LlamaBlock(nn.Module):
    def __init__(self, cfg: "LlamaLM"):
        super().__init__()
        self.num_heads, self.num_kv_heads, self.head_dim = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.dtype = cfg.dtype
        self.use_flash = cfg.use_flash
        self.mlp_act = cfg.mlp_act
        self.fused = cfg.quantized and cfg.fused_qkv
        self.quantized = cfg.quantized
        self.num_experts, self.top_k = cfg.num_experts, cfg.num_experts_per_tok
        d, hidden = cfg.d_model, cfg.hidden_dim
        nq, nkv = self.num_heads * self.head_dim, self.num_kv_heads * self.head_dim
        dense = QDense if cfg.quantized else Dense
        self.input_norm = RMSNorm(d, cfg.rms_eps)
        self.post_attn_norm = RMSNorm(d, cfg.rms_eps)
        if self.fused:
            self.qkv = QDense(d, nq + 2 * nkv, self.dtype, cfg.attn_bias)
        else:
            self.q = dense(d, nq, self.dtype, cfg.attn_bias)
            self.k = dense(d, nkv, self.dtype, cfg.attn_bias)
            self.v = dense(d, nkv, self.dtype, cfg.attn_bias)
        self.o = dense(nq, d, self.dtype)
        if self.num_experts:
            # Expert stacks (E, in, out), named as the JAX parameters; the
            # router stays in the compute dtype when the experts are int8.
            self.router = Dense(d, self.num_experts, self.dtype)
            e = self.num_experts
            for name, shape in (("w_gate", (e, d, hidden)), ("w_up", (e, d, hidden)), ("w_down", (e, hidden, d))):
                if cfg.quantized:
                    setattr(self, f"{name}_q", param(shape, torch.int8))
                    setattr(self, f"{name}_scale", param((shape[0], shape[2]), torch.float32, 1.0))
                else:
                    setattr(self, name, param(shape, self.dtype))
        elif self.fused:
            self.gateup = QDense(d, 2 * hidden, self.dtype)
            self.down = QDense(hidden, d, self.dtype)
        else:
            self.gate = dense(d, hidden, self.dtype)
            self.up = dense(d, hidden, self.dtype)
            self.down = dense(hidden, d, self.dtype)

    def forward(self, x, mask, cos, sin, cache=None, cache_index=None, flash_ok=False, need_attn=True):
        b, t, _ = x.shape
        hd, nh, ng = self.head_dim, self.num_heads, self.num_kv_heads
        h = self.input_norm(x.to(torch.float32)).to(self.dtype)
        if self.fused:
            q, k, v = torch.split(self.qkv(h), [nh * hd, ng * hd, ng * hd], dim=-1)
        else:
            q, k, v = self.q(h), self.k(h), self.v(h)
        q = _apply_rope(q.reshape(b, t, nh, hd), cos, sin).to(self.dtype)
        k = _apply_rope(k.reshape(b, t, ng, hd), cos, sin).to(self.dtype)
        v = v.reshape(b, t, ng, hd)

        kv_scales = None
        if cache is not None and "k_scale" in cache:
            # KV8: the int8 values feed the products (int8 -> dtype is exact)
            # and the per-key scales go on the logits and the probabilities.
            k_q, k_s = _quantize_kv(k)
            v_q, v_s = _quantize_kv(v)
            for name, val in (("k", k_q), ("v", v_q), ("k_scale", k_s), ("v_scale", v_s)):
                _cache_write(cache[name], val, cache_index)
            k_src, v_src = cache["k"], cache["v"]
            kv_scales = (cache["k_scale"], cache["v_scale"])
        elif cache is not None:
            _cache_write(cache["k"], k, cache_index)
            _cache_write(cache["v"], v, cache_index)
            k_src, v_src = cache["k"], cache["v"]
        else:
            k_src, v_src = k, v

        attn = None
        if self.use_flash and flash_ok and t >= _FLASH_MIN_TOKENS and not need_attn:
            if cache is None:
                start = torch.zeros((b,), dtype=torch.int32, device=x.device)
            elif isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
                start = cache_index.to(device=x.device, dtype=torch.int32)
            else:
                start = torch.full((b,), int(cache_index), dtype=torch.int32, device=x.device)
            ctx = flash_prefix_attention(
                q.transpose(1, 2), k_src.transpose(1, 2), v_src.transpose(1, 2), start, None,
                *(kv_scales or (None, None)), sm_scale=1.0 / math.sqrt(hd),
            )
            out = ctx.transpose(1, 2).reshape(b, t, nh * hd)
        else:
            out, attn = self._dense_attention(q, k_src, v_src, kv_scales, mask)
        x = x + self.o(out)

        h2 = self.post_attn_norm(x.to(torch.float32)).to(self.dtype)
        if self.num_experts:
            return x + self._moe_ffn(h2), (attn if need_attn else None)
        if self.fused:
            gate, up = torch.chunk(self.gateup(h2), 2, dim=-1)
        else:
            gate, up = self.gate(h2), self.up(h2)
        return x + self.down(self._act(gate) * up), (attn if need_attn else None)

    def _act(self, gate: torch.Tensor) -> torch.Tensor:
        if self.mlp_act == "silu":
            return nn.functional.silu(gate)
        return nn.functional.gelu(gate, approximate="tanh")  # "gelu_tanh", the Gemma family's GeGLU

    def _expert(self, name: str, e: int, x: torch.Tensor) -> torch.Tensor:
        """x @ expert ``e``'s slice of the ``name`` stack, in the compute dtype."""
        if self.quantized:
            return _int8_matmul(x, getattr(self, f"{name}_q")[e], getattr(self, f"{name}_scale")[e])
        return x @ getattr(self, name)[e]

    def _moe_ffn(self, h: torch.Tensor) -> torch.Tensor:
        """Mixtral's sparse-MoE SwiGLU (``MixtralSparseMoeBlock``): the
        router softmax in f32 over all experts, the top-k weights
        renormalised and cast to the compute dtype, every token through
        every expert with the gates of the experts it did not pick zero
        (the JAX einsum's arithmetic, expert by expert). The gated expert
        outputs are summed in f32."""
        b, t, d = h.shape
        flat = h.reshape(b * t, d)
        probs = torch.softmax(self.router(flat).to(torch.float32), dim=-1)
        top_v, top_i = torch.topk(probs, self.top_k, dim=-1)
        top_v = top_v / top_v.sum(dim=-1, keepdim=True)
        gates = torch.zeros_like(probs).scatter_(1, top_i, top_v).to(self.dtype)
        out = torch.zeros((b * t, d), dtype=torch.float32, device=h.device)
        for e in range(self.num_experts):
            y = self._expert("w_down", e, self._act(self._expert("w_gate", e, flat)) * self._expert("w_up", e, flat))
            out += y.to(torch.float32) * gates[:, e, None].to(torch.float32)
        return out.to(self.dtype).reshape(b, t, d)

    def _dense_attention(self, q, k_src, v_src, kv_scales, mask):
        """Masked softmax attention of q (B, t, H, d) over k/v (B, K, G, d);
        returns the (B, t, H*d) context and the (B, H, t, K) f32 probabilities."""
        b, t, nh, hd = q.shape
        ng, kk = self.num_kv_heads, k_src.shape[1]
        rep = nh // ng
        qg = q.reshape(b, t, ng, rep, hd).permute(0, 2, 3, 1, 4)  # (B, G, rep, t, d)
        k_all = k_src.to(self.dtype).permute(0, 2, 3, 1)[:, :, None]  # (B, G, 1, d, K)
        logits = (qg @ k_all) / math.sqrt(hd)
        if kv_scales is not None:
            logits = logits * kv_scales[0].permute(0, 2, 1)[:, :, None, None, :]
        logits = logits.reshape(b, nh, t, kk).to(torch.float32)
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
        attn = torch.where(mask, torch.softmax(logits, dim=-1), torch.zeros_like(logits))
        ag = attn.reshape(b, ng, rep, t, kk)
        if kv_scales is not None:
            ag = ag * kv_scales[1].permute(0, 2, 1)[:, :, None, None, :]
        v_all = v_src.to(self.dtype).permute(0, 2, 1, 3)[:, :, None]  # (B, G, 1, K, d)
        out = (ag.to(self.dtype) @ v_all).permute(0, 3, 1, 2, 4).reshape(b, t, nh * hd)
        return out, attn


class LlamaLM(nn.Module):
    """Llama-family causal LM; the configuration fields are the JAX
    ``LlamaLM``'s (``dtype`` is the compute dtype: norms, softmax, RoPE
    tables and the returned logits, attentions and hiddens stay f32), and
    ``device``, where the parameters are made: None is
    ``runia_core_tpu_torch.default_device()``, the GPU."""

    def __init__(
        self,
        vocab_size: int,
        num_layers: int = 2,
        num_heads: int = 4,
        num_kv_heads: int = 4,
        d_model: int = 64,
        hidden_dim: int = 128,
        max_len: int = 256,
        head_dim: Optional[int] = None,
        rope_theta: float = 10000.0,
        rms_eps: float = 1e-6,
        tie_embeddings: bool = False,
        dtype: torch.dtype = torch.float32,
        use_flash: bool = False,
        quantized: bool = False,
        quantized_kv: bool = False,
        fused_qkv: bool = False,
        attn_bias: bool = False,
        sliding_window: Optional[int] = None,
        embed_scale: bool = False,
        mlp_act: str = "silu",
        num_experts: int = 0,
        num_experts_per_tok: int = 2,
        device=None,
    ):
        super().__init__()
        if fused_qkv and not quantized:
            raise ValueError("fused_qkv needs quantized=True")
        if mlp_act not in ("silu", "gelu_tanh"):
            raise ValueError(f"mlp_act {mlp_act!r}")
        self.vocab_size, self.num_layers, self.d_model = vocab_size, num_layers, d_model
        self.num_heads, self.num_kv_heads, self.hidden_dim = num_heads, num_kv_heads, hidden_dim
        self.head_dim = head_dim or d_model // num_heads
        self.max_len, self.rope_theta, self.rms_eps = max_len, rope_theta, rms_eps
        self.tie_embeddings, self.dtype, self.use_flash = tie_embeddings, dtype, use_flash
        self.quantized, self.quantized_kv, self.fused_qkv = quantized, quantized_kv, fused_qkv
        self.attn_bias, self.sliding_window = attn_bias, sliding_window
        self.embed_scale, self.mlp_act = embed_scale, mlp_act
        self.num_experts, self.num_experts_per_tok = num_experts, num_experts_per_tok
        device = default_device() if device is None else torch.device(device)
        if use_flash and device.type == "cuda" and self.head_dim not in _FLASH_HEAD_DIMS:
            raise ValueError(f"use_flash on {device}: the flash kernel takes heads of {_FLASH_HEAD_DIMS}, "
                             f"got {self.head_dim}")

        # Every parameter is made on ``device`` (None: the GPU).
        with device:
            self.embed = nn.Module()
            self.embed.embedding = param((vocab_size, d_model), dtype)
            for i in range(num_layers):
                self.add_module(f"block_{i}", _LlamaBlock(self))
            self.norm_f = RMSNorm(d_model, rms_eps)
            if not tie_embeddings:
                self.lm_head = (QDense if quantized else Dense)(d_model, vocab_size, dtype)
            # sqrt(d_model) rounded to the compute dtype, made once: a tensor
            # made per call would be a host-to-device copy in every step.
            self.register_buffer("embed_multiplier", torch.tensor(d_model**0.5, dtype=dtype), persistent=False)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LlamaLM":
        """Seeded random weights for a float model: kernels and expert
        stacks N(0, 1/fan_in) (flax's lecun-normal scale over the input
        axis), the embedding N(0, 1), norm scales 1 and biases 0.
        ``generator`` lives on the parameters' device."""
        for name, p in self.named_parameters():
            if name.endswith("kernel") or name.rpartition(".")[2] in _EXPERT_STACKS:
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device) / math.sqrt(p.shape[-2]))
            elif name.endswith("embedding"):
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device))
            elif name.endswith("scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                raise ValueError(f"init_weights is for float models; found {name}")
        return self

    @torch.no_grad()
    def forward(
        self,
        tokens: torch.Tensor,
        cache: Optional[Dict] = None,
        cache_index=None,
        token_valid: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        *,
        need_attentions: bool = True,
        need_hiddens: bool = True,
        last_logits_only: bool = False,
    ):
        """The JAX contract: (B, T) tokens -> (logits (B, T, V) f32, attentions
        (L, B, H, T, K) f32, hiddens (L+1, B, T, D) f32, cache).

        ``cache_index`` is an int (or 0-d tensor) for a shared offset, or a
        (B,) tensor of per-row offsets. The JAX ``assume_prefill`` flag has
        no counterpart: the flash route attends the cache with per-row
        windows, which covers an empty and a live cache alike. Outputs not
        asked for by the three flags come back as None (``last_logits_only``
        gives (B, 1, V) logits of the last position).
        """
        b, t = tokens.shape
        dev = tokens.device
        flash_ok = token_valid is None and positions is None and self.sliding_window is None
        per_row = isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1
        arange_t = torch.arange(t, device=dev)
        if cache is None:
            if positions is None:
                if token_valid is not None:
                    positions = torch.clamp_min(torch.cumsum(token_valid.to(torch.int64), dim=1) - 1, 0)
                else:
                    positions = arange_t[None, :].expand(b, t)
            mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))[None, None]
            if token_valid is not None:
                mask = mask & token_valid[:, None, None, :]
            kv_len = t
        else:
            kv_len = cache["layers"][0]["k"].shape[1]
            if per_row:
                q_phys = cache_index.to(device=dev, dtype=torch.int64)[:, None] + arange_t[None, :]
                mask = torch.arange(kv_len, device=dev)[None, None, None, :] <= q_phys[:, None, :, None]
            else:
                q_phys = int(cache_index) + arange_t
                mask = torch.arange(kv_len, device=dev)[None, None, None, :] <= q_phys[None, None, :, None]
                q_phys = q_phys[None, :]
            if positions is None:
                positions = q_phys.expand(b, t)
            if token_valid is not None:
                mask = mask & token_valid[:, None, None, :]
        if self.sliding_window is not None:
            if cache is None:
                delta = positions[:, None, :, None] - positions[:, None, None, :]
            else:
                delta = q_phys[:, None, :, None] - torch.arange(kv_len, device=dev)[None, None, None, :]
            mask = mask & (delta < int(self.sliding_window))

        cos, sin = _rope_cos_sin(positions, self.head_dim, self.rope_theta)
        x = self.embed.embedding[tokens].to(self.dtype)
        if self.embed_scale:
            x = x * self.embed_multiplier
        hiddens = [x] if need_hiddens else None
        attns = [] if need_attentions else None
        for i, block in enumerate(self.blocks()):
            layer_cache = cache["layers"][i] if cache is not None else None
            x, attn = block(x, mask, cos, sin, layer_cache, cache_index, flash_ok, need_attentions)
            if need_hiddens:
                hiddens.append(x)
            if need_attentions:
                attns.append(attn)
        x = self.norm_f(x.to(torch.float32)).to(self.dtype)
        if need_hiddens:
            # HF convention: the last hidden state is the post-final-norm output.
            hiddens[-1] = x
        head_in = x[:, -1:] if last_logits_only else x
        if self.tie_embeddings:
            logits = head_in @ self.embed.embedding.to(self.dtype).T
        else:
            logits = self.lm_head(head_in)
        return (
            logits.to(torch.float32),
            torch.stack(attns) if need_attentions else None,
            torch.stack(hiddens).to(torch.float32) if need_hiddens else None,
            cache,
        )


_QUANT_KERNELS = ("q", "k", "v", "o", "gate", "up", "down", "lm_head")
_EXPERT_STACKS = ("w_gate", "w_up", "w_down")


def _quantize(w: torch.Tensor, axis: int):
    """int8 values and scale = max|w| / 127 (at least 1e-12 / 127) over
    ``axis``, in f32; ``torch.round`` rounds half to even, as ``np.round``."""
    w = w.to(torch.float32)
    scale = w.abs().amax(dim=axis).clamp_min(1e-12) / 127.0
    return torch.clamp(torch.round(w / scale.unsqueeze(axis)), -127, 127).to(torch.int8), scale


def quantize_llama_params(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a float LlamaLM
    ``state_dict``: for each projection kernel (in, out), scale = max|w| / 127
    per column (at least 1e-12 / 127) and kernel_q = round(w / scale),
    clipped to +-127, in f32 on the tensors' device; each (E, in, out)
    expert stack likewise with one scale per (expert, out-channel), stored
    as ``<stack>_q`` and ``<stack>_scale``. Embeddings, norms, biases and
    the MoE router pass through. The result loads into
    ``LlamaLM(quantized=True)`` of the same configuration."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in state.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "kernel" and module.rpartition(".")[2] in _QUANT_KERNELS:
            out[f"{module}.kernel_q"], out[f"{module}.scale"] = _quantize(value, 0)
        elif leaf in _EXPERT_STACKS:
            out[f"{name}_q"], out[f"{name}_scale"] = _quantize(value, 1)
        else:
            out[name] = value
    return out


def fuse_quantized_llama_params(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fuse a quantized state_dict's q|k|v and gate|up projections into
    ``qkv`` and ``gateup`` entries, for ``LlamaLM(quantized=True,
    fused_qkv=True)``: concatenation along the output columns, no
    requantization. o, down and lm_head stay single; an MoE block has no
    gate|up, so only its q|k|v fuse."""
    out: Dict[str, torch.Tensor] = {}
    groups = {("q", "k", "v"): "qkv", ("gate", "up"): "gateup"}
    members = {part: (parts, fused) for parts, fused in groups.items() for part in parts}
    for name, value in state.items():
        module, _, leaf = name.rpartition(".")
        prefix, _, proj = module.rpartition(".")
        if not prefix.startswith("block_") or proj not in members:
            out[name] = value
            continue
        parts, fused = members[proj]
        if proj != parts[0]:
            continue  # concatenated with the first part
        pieces = [state[f"{prefix}.{part}.{leaf}"] for part in parts]
        out[f"{prefix}.{fused}.{leaf}"] = torch.cat(pieces, dim=pieces[0].ndim - 1)
    return out


def _head_dim(cfg) -> int:
    return getattr(cfg, "head_dim", None) or cfg.hidden_size // cfg.num_attention_heads


def _attention_state(layer, dtype, device, attn_bias: bool = False) -> Dict[str, torch.Tensor]:
    att = layer.self_attn
    state = {f"{p}.kernel": hf_kernel(getattr(att, f"{p}_proj").weight, dtype, device) for p in ("q", "k", "v", "o")}
    if attn_bias:
        state.update({f"{p}.bias": hf_vector(getattr(att, f"{p}_proj").bias, device) for p in ("q", "k", "v")})
    return state


def _finish(model: LlamaLM, state: Dict[str, torch.Tensor], quantize: bool):
    """Quantize if asked, and load the state into the model as its
    parameters (the same tensors)."""
    if quantize:
        state = quantize_llama_params(state)
    model.load_state_dict(state, assign=True)
    return model.eval(), state


def convert_hf_llama(hf_model, max_len: Optional[int] = None, dtype: torch.dtype = torch.float32,
                     use_flash: bool = False, quantize: bool = False, quantize_kv: bool = False, device=None):
    """A ``transformers`` Llama-family causal LM (``LlamaForCausalLM``, and
    the Mistral and Qwen2 layouts) -> (LlamaLM, state_dict), the model
    holding the state.

    The JAX ``convert_hf_llama``'s mapping and refusals: rope scaling other
    than plain ``rope_theta`` raises; a sliding window is taken when it is
    uniform (Mistral: always; Qwen2: when ``use_sliding_window`` and no
    ``max_window_layers`` split the stack, which raises) and refuses
    ``use_flash``; q/k/v biases (Qwen2) are found in the checkpoint.
    Kernels and the embedding are stored in ``dtype``, norm scales and
    biases in f32; ``quantize`` makes the int8 form of
    :func:`quantize_llama_params`. ``device`` None is the GPU."""
    cfg = hf_model.config
    scaling = getattr(cfg, "rope_scaling", None)
    if scaling not in (None, {}) and scaling.get("rope_type", scaling.get("type")) not in (None, "default"):
        raise NotImplementedError(f"rope_scaling {scaling!r} not supported")
    window = None
    sw = getattr(cfg, "sliding_window", None)
    if sw:
        if hasattr(cfg, "use_sliding_window"):  # Qwen2's switch
            if cfg.use_sliding_window:
                mwl = getattr(cfg, "max_window_layers", 0) or 0
                if 0 < mwl < cfg.num_hidden_layers:
                    raise NotImplementedError(
                        f"mixed per-layer sliding windows (max_window_layers={mwl} of {cfg.num_hidden_layers})"
                    )
                if mwl < cfg.num_hidden_layers:
                    window = int(sw)
        else:  # Mistral: the window is always on
            window = int(sw)
    if window is not None and use_flash:
        raise NotImplementedError(
            "use_flash with sliding-window attention (the flash kernel is plain-causal); convert with use_flash=False"
        )
    hf = hf_model.model
    attn_bias = hf.layers[0].self_attn.q_proj.bias is not None
    model = LlamaLM(
        vocab_size=cfg.vocab_size, num_layers=cfg.num_hidden_layers, num_heads=cfg.num_attention_heads,
        num_kv_heads=cfg.num_key_value_heads, d_model=cfg.hidden_size, hidden_dim=cfg.intermediate_size,
        max_len=max_len or cfg.max_position_embeddings, head_dim=_head_dim(cfg),
        rope_theta=float(getattr(cfg, "rope_theta", 10000.0)), rms_eps=float(cfg.rms_norm_eps),
        tie_embeddings=bool(cfg.tie_word_embeddings), dtype=dtype, use_flash=use_flash, quantized=quantize,
        quantized_kv=quantize_kv, attn_bias=attn_bias, sliding_window=window, device=device,
    )
    dev = model.embed.embedding.device
    state = {"embed.embedding": hf_vector(hf.embed_tokens.weight, dev, dtype),
             "norm_f.scale": hf_vector(hf.norm.weight, dev)}
    for i, layer in enumerate(hf.layers):
        block = {
            "input_norm.scale": hf_vector(layer.input_layernorm.weight, dev),
            "post_attn_norm.scale": hf_vector(layer.post_attention_layernorm.weight, dev),
            **_attention_state(layer, dtype, dev, attn_bias),
            **{f"{p}.kernel": hf_kernel(getattr(layer.mlp, f"{p}_proj").weight, dtype, dev)
               for p in ("gate", "up", "down")},
        }
        state.update({f"block_{i}.{name}": value for name, value in block.items()})
    if not model.tie_embeddings:
        state["lm_head.kernel"] = hf_kernel(hf_model.lm_head.weight, dtype, dev)
    return _finish(model, state, quantize)


def convert_hf_gemma(hf_model, max_len: Optional[int] = None, dtype: torch.dtype = torch.float32,
                     use_flash: bool = False, quantize: bool = False, quantize_kv: bool = False, device=None):
    """A ``transformers.GemmaForCausalLM`` -> (LlamaLM, state_dict), the
    model holding the state.

    Gemma is the Llama layout with the embedding scaled by sqrt(d_model)
    (``embed_scale``), GeGLU (gelu-tanh) and an RMSNorm that multiplies by
    1 + weight, folded into the scales here; it always ties the embedding.
    As the JAX converter: Gemma-2's soft-capping and sliding windows raise,
    and so does a config whose legacy ``hidden_activation`` disagrees with
    the ``hidden_act`` the torch forward runs."""
    cfg = hf_model.config
    if getattr(cfg, "attn_logit_softcapping", None) or getattr(cfg, "final_logit_softcapping", None) or (
        getattr(cfg, "sliding_window", None) and getattr(cfg, "use_sliding_window", True)
    ):
        raise NotImplementedError(
            "Gemma-2-style soft-capping / sliding-window attention is not implemented; "
            "Gemma-1-style full-attention checkpoints only"
        )
    act = getattr(cfg, "hidden_act", None) or "gelu_pytorch_tanh"
    legacy = getattr(cfg, "hidden_activation", None)
    if legacy is not None and legacy != act:
        raise ValueError(
            f"Gemma config disagrees with itself: hidden_act={act!r} (what the torch forward runs) vs "
            f"hidden_activation={legacy!r}; fix the checkpoint config before converting"
        )
    if act not in ("gelu_pytorch_tanh", "gelu_new"):
        raise NotImplementedError(f"Gemma hidden activation {act!r}")
    model = LlamaLM(
        vocab_size=cfg.vocab_size, num_layers=cfg.num_hidden_layers, num_heads=cfg.num_attention_heads,
        num_kv_heads=cfg.num_key_value_heads, d_model=cfg.hidden_size, hidden_dim=cfg.intermediate_size,
        max_len=max_len or cfg.max_position_embeddings, head_dim=_head_dim(cfg),
        rope_theta=float(getattr(cfg, "rope_theta", 10000.0)), rms_eps=float(cfg.rms_norm_eps),
        tie_embeddings=True, dtype=dtype, use_flash=use_flash, quantized=quantize, quantized_kv=quantize_kv,
        embed_scale=True, mlp_act="gelu_tanh", device=device,
    )
    hf = hf_model.model
    dev = model.embed.embedding.device

    def norm(w):  # Gemma's x_hat * (1 + w): the scale is 1 + w
        return hf_vector(w, dev) + 1.0

    state = {"embed.embedding": hf_vector(hf.embed_tokens.weight, dev, dtype), "norm_f.scale": norm(hf.norm.weight)}
    for i, layer in enumerate(hf.layers):
        block = {
            "input_norm.scale": norm(layer.input_layernorm.weight),
            "post_attn_norm.scale": norm(layer.post_attention_layernorm.weight),
            **_attention_state(layer, dtype, dev),
            **{f"{p}.kernel": hf_kernel(getattr(layer.mlp, f"{p}_proj").weight, dtype, dev)
               for p in ("gate", "up", "down")},
        }
        state.update({f"block_{i}.{name}": value for name, value in block.items()})
    return _finish(model, state, quantize)


def convert_hf_mixtral(hf_model, max_len: Optional[int] = None, dtype: torch.dtype = torch.float32,
                       use_flash: bool = False, quantize: bool = False, quantize_kv: bool = False, device=None):
    """A ``transformers.MixtralForCausalLM`` -> (LlamaLM, state_dict), the
    model holding the state.

    Mistral attention with every MLP a sparse-MoE block: the bias-free
    router (``block_sparse_moe.gate``) and the experts' w1 / w3 / w2 stacked
    into (E, d, h) / (E, d, h) / (E, h, d) ``w_gate`` / ``w_up`` /
    ``w_down``. ``quantize`` stores the attention projections, lm_head and
    the expert stacks int8 (one scale per expert and out-channel); the
    router stays in ``dtype``. A non-SiLU activation raises, and so does
    ``use_flash`` with a sliding window."""
    cfg = hf_model.config
    if getattr(cfg, "hidden_act", "silu") != "silu":
        raise NotImplementedError(f"Mixtral hidden_act {cfg.hidden_act!r}")
    window = int(cfg.sliding_window) if getattr(cfg, "sliding_window", None) else None
    if window is not None and use_flash:
        raise NotImplementedError(
            "use_flash with sliding-window attention (the flash kernel is plain-causal); convert with use_flash=False"
        )
    model = LlamaLM(
        vocab_size=cfg.vocab_size, num_layers=cfg.num_hidden_layers, num_heads=cfg.num_attention_heads,
        num_kv_heads=cfg.num_key_value_heads, d_model=cfg.hidden_size, hidden_dim=cfg.intermediate_size,
        max_len=max_len or cfg.max_position_embeddings, head_dim=_head_dim(cfg),
        rope_theta=float(getattr(cfg, "rope_theta", 1e6)), rms_eps=float(cfg.rms_norm_eps),
        tie_embeddings=bool(cfg.tie_word_embeddings), dtype=dtype, use_flash=use_flash, quantized=quantize,
        quantized_kv=quantize_kv, sliding_window=window, num_experts=int(cfg.num_local_experts),
        num_experts_per_tok=int(cfg.num_experts_per_tok), device=device,
    )
    hf = hf_model.model
    dev = model.embed.embedding.device
    state = {"embed.embedding": hf_vector(hf.embed_tokens.weight, dev, dtype),
             "norm_f.scale": hf_vector(hf.norm.weight, dev)}
    for i, layer in enumerate(hf.layers):
        moe = layer.block_sparse_moe
        block = {
            "input_norm.scale": hf_vector(layer.input_layernorm.weight, dev),
            "post_attn_norm.scale": hf_vector(layer.post_attention_layernorm.weight, dev),
            **_attention_state(layer, dtype, dev),
            "router.kernel": hf_kernel(moe.gate.weight, dtype, dev),
            **{stack: torch.stack([hf_kernel(getattr(ex, w).weight, dtype, dev) for ex in moe.experts])
               for stack, w in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2"))},
        }
        state.update({f"block_{i}.{name}": value for name, value in block.items()})
    if not model.tie_embeddings:
        state["lm_head.kernel"] = hf_kernel(hf_model.lm_head.weight, dtype, dev)
    return _finish(model, state, quantize)
