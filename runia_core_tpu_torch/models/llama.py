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
  no attention probabilities are asked for. Prefill into an empty cache and
  chunked prefill over a live one are one route: the chunk's K/V are written
  into the cache first and the kernel attends the cache with ``q_start =
  cache_index``; a KV8 cache is attended in int8 with its scales (the JAX
  dense path's numbers; the JAX TPU branch attends the call's unquantized
  k/v instead). Everything else, decode steps included, takes the dense
  path with the -1e30 mask and an f32 softmax.

MoE (``num_experts > 0``) is not ported yet and raises.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention
from runia_core_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_supported

__all__ = ["LlamaLM", "QDense", "fuse_quantized_llama_params", "quantize_llama_params"]

_FLASH_MIN_TOKENS = 128
_NEG_INF = -1e30


def _param(shape, dtype, fill: float = 0.0) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, dtype=dtype), requires_grad=False)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: x * rsqrt(mean(x^2) + eps) * scale, on f32 input."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), torch.float32, 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * self.scale


class Dense(nn.Module):
    """flax ``nn.Dense`` with a compute dtype: kernel (in, out), f32 bias."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, use_bias: bool = False):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((d_in, d_out), dtype)
        self.bias = _param((d_out,), torch.float32) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return out if self.bias is None else out + self.bias.to(self.dtype)


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
        self.kernel_q = _param((d_in, d_out), torch.int8)
        self.scale = _param((d_out,), torch.float32, 1.0)
        self.bias = _param((d_out,), torch.float32) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xd = x.to(self.dtype)
        rows = xd.numel() // xd.shape[-1]
        if quant_matmul_supported(rows):
            out = quant_matmul(xd.contiguous(), self.kernel_q, self.scale)
        else:
            out = xd @ (self.kernel_q.to(self.dtype) * self.scale.to(self.dtype)[None, :])
        return out if self.bias is None else out + self.bias.to(self.dtype)


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
        d, hidden = cfg.d_model, cfg.hidden_dim
        nq, nkv = self.num_heads * self.head_dim, self.num_kv_heads * self.head_dim
        dense = QDense if cfg.quantized else Dense
        self.input_norm = RMSNorm(d, cfg.rms_eps)
        self.post_attn_norm = RMSNorm(d, cfg.rms_eps)
        if self.fused:
            self.qkv = QDense(d, nq + 2 * nkv, self.dtype, cfg.attn_bias)
            self.gateup = QDense(d, 2 * hidden, self.dtype)
        else:
            self.q = dense(d, nq, self.dtype, cfg.attn_bias)
            self.k = dense(d, nkv, self.dtype, cfg.attn_bias)
            self.v = dense(d, nkv, self.dtype, cfg.attn_bias)
            self.gate = dense(d, hidden, self.dtype)
            self.up = dense(d, hidden, self.dtype)
        self.o = dense(nq, d, self.dtype)
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
        if self.fused:
            gate, up = torch.chunk(self.gateup(h2), 2, dim=-1)
        else:
            gate, up = self.gate(h2), self.up(h2)
        if self.mlp_act == "silu":
            act = nn.functional.silu(gate)
        else:  # "gelu_tanh", the Gemma family's GeGLU
            act = nn.functional.gelu(gate, approximate="tanh")
        return x + self.down(act * up), (attn if need_attn else None)

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
        device=None,
    ):
        super().__init__()
        if num_experts:
            raise NotImplementedError(
                "the MoE FFN (num_experts > 0) is not ported yet; see ROADMAP.md Queue 1, LLM core"
            )
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

        # Every parameter is made on ``device`` (None: the GPU).
        with torch.device(default_device() if device is None else device):
            self.embed = nn.Module()
            self.embed.embedding = _param((vocab_size, d_model), dtype)
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
        """Seeded random weights for a float model: kernels N(0, 1/fan_in)
        (flax's lecun-normal scale), the embedding N(0, 1), norm scales 1 and
        biases 0. ``generator`` lives on the parameters' device."""
        for name, p in self.named_parameters():
            if name.endswith("kernel"):
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device) / math.sqrt(p.shape[0]))
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


def quantize_llama_params(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a float LlamaLM
    ``state_dict``: for each projection kernel (in, out), scale = max|w| / 127
    per column (at least 1e-12 / 127) and kernel_q = round(w / scale),
    clipped to +-127, in f32 on the tensors' device. Embeddings, norms and
    biases pass through. The result loads into ``LlamaLM(quantized=True)``
    of the same configuration."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in state.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "kernel" and module.rpartition(".")[2] in _QUANT_KERNELS:
            w = value.to(torch.float32)
            scale = w.abs().amax(dim=0).clamp_min(1e-12) / 127.0
            out[f"{module}.kernel_q"] = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
            out[f"{module}.scale"] = scale
        else:
            out[name] = value
    return out


def fuse_quantized_llama_params(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fuse a quantized state_dict's q|k|v and gate|up projections into
    ``qkv`` and ``gateup`` entries, for ``LlamaLM(quantized=True,
    fused_qkv=True)``: concatenation along the output columns, no
    requantization. o, down and lm_head stay single."""
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
