"""DeBERTa-v2 sequence classifier (disentangled attention), the port's NLI
judge for semantic entropy.

Counterpart of ``runia_core_tpu/models/deberta.py``: the reference loads
``microsoft/deberta-v2-xxlarge-mnli`` for ``semantic_entropy`` and this
module runs that geometry on the card. The module tree follows the flax
parameter tree (``word_embeddings.embedding``, ``layer_{i}_attn.query_proj
.kernel`` stored (in, out), ``emb_LayerNorm.scale``, ``rel_embeddings``,
``conv.kernel`` stored (K, in/groups, out)...), so
``models/convert.py::deberta_from_flax`` carries a JAX model's weights
across by name, and :func:`convert_hf_deberta` maps a ``transformers``
checkpoint without JAX. Inference semantics of HF ``modeling_deberta_v2``,
dropout off:

* embeddings: word (+ absolute position iff ``position_biased_input``, +
  token type iff ``type_vocab_size > 0``), an optional width projection,
  LayerNorm, zeroed at padded positions;
* relative positions through the log-bucket map when ``position_buckets >
  0``; content->content scores plus the c2p and/or p2c terms, each divided
  by sqrt(head_dim * (1 + len(pos_att_type))); with ``share_att_key`` the
  position keys and queries come from the content projections of the
  (LayerNormed) relative table. JAX selects the c2p / p2c buckets with
  one-hot matmuls (gathers are slow on the TPU); here they are
  ``torch.gather`` over the 2 x span bucket axis, the same function;
* scores masked to the f32 minimum over the pair mask, softmax in f32;
  LayerNorms in f32 (eps 1e-7 by default) with the compute dtype cast
  around them; ``"gelu"`` is the exact erf form, ``"gelu_new"`` the tanh one;
* an optional ConvLayer after layer 0 that reads the embedding output;
* pooler (first token -> dense -> activation) -> classifier.

:func:`wrap_torch_nli` is ``wrap_jax_nli``'s counterpart: a batched
``(premises, hypotheses) -> labels`` callable that pads each call to a
(batch, length) bucket and, on the card, replays one CUDA graph per bucket
(``utils/graphs.py``), the port's ``jax.jit`` per shape.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.models.layers import Dense, hf_kernel, hf_vector, param
from runia_core_tpu_torch.utils.graphs import CudaGraph, ProgramCache, copy_to_host, upload

__all__ = ["DebertaV2Classifier", "convert_hf_deberta", "wrap_torch_nli"]

_NLI_PROGRAMS = 32  # (batch, length) buckets kept captured per wrapped judge


def _log_bucket_position(rel_pos: torch.Tensor, bucket_size: int, max_position: int) -> torch.Tensor:
    """HF ``make_log_bucket_position``: the identity inside +-bucket/2,
    log-spaced buckets out to ``max_position`` beyond it, computed in f32
    (``ceil`` and ``sign``) as the JAX version does."""
    sign = torch.sign(rel_pos)
    mid = bucket_size // 2
    inside = (rel_pos < mid) & (rel_pos > -mid)
    abs_pos = torch.where(inside, torch.full_like(rel_pos, mid - 1), rel_pos.abs()).to(torch.float32)
    # A Python float divides an f32 tensor in f32, as JAX's f32 canonicalisation of the numpy scalar.
    log_pos = torch.ceil(torch.log(abs_pos / mid) / math.log((max_position - 1) / mid) * (mid - 1)) + mid
    return torch.where(abs_pos <= mid, rel_pos.to(torch.float32), log_pos * sign).to(torch.int64)


def _relative_position(t: int, bucket_size: int, max_position: int, device) -> torch.Tensor:
    """(t, t) bucketed relative positions rel[i, j] = bucket(i - j)."""
    ids = torch.arange(t, device=device)
    rel = ids[:, None] - ids[None, :]
    if bucket_size > 0 and max_position > 0:
        rel = _log_bucket_position(rel, bucket_size, max_position)
    return rel


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` with f32 parameters, on f32 input."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = param((dim,), torch.float32, 1.0)
        self.bias = param((dim,), torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.layer_norm(x.to(torch.float32), self.scale.shape, self.scale, self.bias, self.eps)


def _activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"gelu": nn.functional.gelu, "tanh": torch.tanh, "relu": torch.relu,
            "gelu_new": lambda x: nn.functional.gelu(x, approximate="tanh")}[name]


class _DisentangledAttention(nn.Module):
    def __init__(self, cfg: "DebertaV2Classifier"):
        super().__init__()
        self.num_heads, self.head_dim = cfg.num_heads, cfg.d_model // cfg.num_heads
        # Every score is divided by sqrt(head_dim * (1 + len(pos_att_type))),
        # with or without relative attention, as in the JAX module.
        self.scale = math.sqrt(self.head_dim * (1 + len(cfg.pos_att_type)))
        self.pos_att_type = cfg.pos_att_type if cfg.relative_attention else ()
        self.share_att_key, self.dtype = cfg.share_att_key, cfg.dtype
        d = cfg.d_model
        self.query_proj = Dense(d, d, cfg.dtype, use_bias=True)
        self.key_proj = Dense(d, d, cfg.dtype, use_bias=True)
        self.value_proj = Dense(d, d, cfg.dtype, use_bias=True)
        if not cfg.share_att_key:
            if "c2p" in self.pos_att_type:
                self.pos_key_proj = Dense(d, d, cfg.dtype, use_bias=True)
            if "p2c" in self.pos_att_type:
                self.pos_query_proj = Dense(d, d, cfg.dtype, use_bias=True)

    def _heads(self, y: torch.Tensor) -> torch.Tensor:
        """(..., T, H * hd) -> (..., H, T, hd)."""
        return y.reshape(*y.shape[:-1], self.num_heads, self.head_dim).transpose(-3, -2)

    def forward(self, x, pair_mask, c2p_pos, p2c_pos, rel_embeddings):
        """x (B, T, D); pair_mask (B, T, T) bool; c2p_pos / p2c_pos (T, T)
        bucket indices into the (2K, D) relative table; returns (B, T, D)."""
        b, t, d = x.shape
        q, k, v = self._heads(self.query_proj(x)), self._heads(self.key_proj(x)), self._heads(self.value_proj(x))
        scores = q @ (k / self.scale).transpose(-1, -2)
        index = (b, self.num_heads, t, t)
        if "c2p" in self.pos_att_type:
            proj = self.key_proj if self.share_att_key else self.pos_key_proj
            c2p = q @ self._heads(proj(rel_embeddings)).transpose(-1, -2)  # (B, H, Tq, 2K)
            # q . pos_key at bucket(q - k)
            scores = scores + torch.gather(c2p, -1, c2p_pos.expand(index)) / self.scale
        if "p2c" in self.pos_att_type:
            proj = self.query_proj if self.share_att_key else self.pos_query_proj
            p2c = k @ self._heads(proj(rel_embeddings)).transpose(-1, -2)  # (B, H, Tk, 2K)
            # k . pos_query at p2c_pos[k, q], transposed into (q, k)
            scores = scores + torch.gather(p2c, -1, p2c_pos.expand(index)).transpose(-1, -2) / self.scale
        scores = scores.to(torch.float32).masked_fill(~pair_mask[:, None], torch.finfo(torch.float32).min)
        attn = torch.softmax(scores, dim=-1).to(self.dtype)
        return (attn @ v).transpose(1, 2).reshape(b, t, d)


class DebertaV2Classifier(nn.Module):
    """DeBERTa-v2 for sequence classification (the MNLI entailment shape).

    The configuration fields and defaults are the JAX
    ``DebertaV2Classifier``'s; ``dtype`` is the compute dtype (LayerNorms
    and the softmax stay f32, the logits come back f32) and ``device`` is
    where the parameters are made (None: ``default_device()``, the GPU).
    ``forward(input_ids, attention_mask, token_type_ids=None) -> (B,
    num_labels) f32 logits``. Inference only.
    """

    def __init__(
        self,
        vocab_size: int,
        num_labels: int = 3,
        num_layers: int = 2,
        num_heads: int = 4,
        d_model: int = 64,
        intermediate_size: int = 128,
        max_position_embeddings: int = 512,
        embedding_size: Optional[int] = None,
        type_vocab_size: int = 0,
        position_biased_input: bool = False,
        relative_attention: bool = True,
        position_buckets: int = 256,
        max_relative_positions: int = -1,
        norm_rel_ebd: str = "layer_norm",
        share_att_key: bool = True,
        pos_att_type: tuple = ("p2c", "c2p"),
        conv_kernel_size: int = 0,
        conv_groups: int = 1,
        conv_act: str = "gelu",
        hidden_act: str = "gelu",
        pooler_hidden_act: str = "gelu",
        layer_norm_eps: float = 1e-7,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.vocab_size, self.num_labels, self.num_layers = vocab_size, num_labels, num_layers
        self.num_heads, self.d_model, self.intermediate_size = num_heads, d_model, intermediate_size
        self.max_position_embeddings, self.type_vocab_size = max_position_embeddings, type_vocab_size
        self.position_biased_input, self.relative_attention = position_biased_input, relative_attention
        self.position_buckets = position_buckets
        self.norm_rel_ebd, self.share_att_key, self.pos_att_type = norm_rel_ebd, share_att_key, tuple(pos_att_type)
        self.conv_kernel_size, self.conv_groups, self.dtype = conv_kernel_size, conv_groups, dtype
        self.conv_act, self.hidden_act, self.pooler_hidden_act = conv_act, hidden_act, pooler_hidden_act
        self.max_relative = max_relative_positions if max_relative_positions >= 1 else max_position_embeddings
        self.span = position_buckets if position_buckets > 0 else self.max_relative
        emb, d, eps = embedding_size or d_model, d_model, layer_norm_eps

        with torch.device(default_device() if device is None else device):
            self.word_embeddings = nn.Module()
            self.word_embeddings.embedding = param((vocab_size, emb), dtype)
            if position_biased_input:
                self.position_embeddings = nn.Module()
                self.position_embeddings.embedding = param((max_position_embeddings, emb), dtype)
            if type_vocab_size > 0:
                self.token_type_embeddings = nn.Module()
                self.token_type_embeddings.embedding = param((type_vocab_size, emb), dtype)
            if emb != d:
                self.embed_proj = Dense(emb, d, dtype)
            self.emb_LayerNorm = LayerNorm(d, eps)
            if relative_attention:
                self.rel_embeddings = param((2 * self.span, d), torch.float32)
                if "layer_norm" in norm_rel_ebd:
                    self.rel_LayerNorm = LayerNorm(d, eps)
            if conv_kernel_size > 0:
                self.conv = nn.Module()
                self.conv.kernel = param((conv_kernel_size, d // conv_groups, d), dtype)
                self.conv.bias = param((d,), torch.float32)
                self.conv_ln = LayerNorm(d, eps)
            for i in range(num_layers):
                self.add_module(f"layer_{i}_attn", _DisentangledAttention(self))
                self.add_module(f"layer_{i}_attn_out", Dense(d, d, dtype, use_bias=True))
                self.add_module(f"layer_{i}_attn_ln", LayerNorm(d, eps))
                self.add_module(f"layer_{i}_ffn_in", Dense(d, intermediate_size, dtype, use_bias=True))
                self.add_module(f"layer_{i}_ffn_out", Dense(intermediate_size, d, dtype, use_bias=True))
                self.add_module(f"layer_{i}_ffn_ln", LayerNorm(d, eps))
            self.pooler = Dense(d, d, dtype, use_bias=True)
            self.classifier = Dense(d, num_labels, dtype, use_bias=True)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DebertaV2Classifier":
        """Seeded random weights: kernels N(0, 1/fan_in) (a conv kernel's
        fan-in is K x in/groups), embeddings N(0, 1), the relative table
        N(0, 0.02^2) (the JAX initializer), LayerNorm scales 1 and biases 0.
        ``generator`` lives on the parameters' device."""
        for name, p in self.named_parameters():
            leaf = name.rpartition(".")[2]
            if leaf == "kernel":
                fan_in = math.prod(p.shape[:-1])
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device) / math.sqrt(fan_in))
            elif leaf == "embedding":
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device))
            elif leaf == "rel_embeddings":
                p.copy_(0.02 * torch.randn(p.shape, generator=generator, device=p.device))
            elif leaf == "scale":
                p.fill_(1.0)
            else:
                p.zero_()
        return self

    def _layer(self, name: str, i: int) -> nn.Module:
        return getattr(self, f"layer_{i}_{name}")

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        t = input_ids.shape[1]
        mask = attention_mask.to(torch.bool)
        keep = mask[:, :, None]
        dtype, dev = self.dtype, input_ids.device
        act = _activation(self.hidden_act)

        x = self.word_embeddings.embedding[input_ids].to(dtype)
        if self.position_biased_input:
            x = x + self.position_embeddings.embedding[:t].to(dtype)[None]
        if self.type_vocab_size > 0:
            types = token_type_ids if token_type_ids is not None else torch.zeros_like(input_ids)
            x = x + self.token_type_embeddings.embedding[types].to(dtype)
        if hasattr(self, "embed_proj"):
            x = self.embed_proj(x)
        x = self.emb_LayerNorm(x).to(dtype) * keep.to(dtype)
        embeddings = x

        c2p_pos = p2c_pos = rel_embeddings = None
        if self.relative_attention:
            rel_pos = _relative_position(t, self.position_buckets, self.max_relative, dev)
            c2p_pos = torch.clamp(rel_pos + self.span, 0, 2 * self.span - 1)
            p2c_pos = torch.clamp(-rel_pos + self.span, 0, 2 * self.span - 1)
            if "layer_norm" in self.norm_rel_ebd:
                rel_embeddings = self.rel_LayerNorm(self.rel_embeddings).to(dtype)
            else:
                rel_embeddings = self.rel_embeddings.to(dtype)

        pair_mask = mask[:, :, None] & mask[:, None, :]
        for i in range(self.num_layers):
            ctx = self._layer("attn", i)(x, pair_mask, c2p_pos, p2c_pos, rel_embeddings)
            x = self._layer("attn_ln", i)(self._layer("attn_out", i)(ctx) + x).to(dtype)
            if i == 0 and self.conv_kernel_size > 0:
                # ConvLayer: over the embedding output, zeroed at pads,
                # activated, added to layer 0's output, normed, masked again.
                weight = self.conv.kernel.to(dtype).permute(2, 1, 0)  # (out, in/groups, K)
                conv = nn.functional.conv1d(
                    embeddings.transpose(1, 2), weight, self.conv.bias.to(dtype),
                    padding=(self.conv_kernel_size - 1) // 2, groups=self.conv_groups,
                ).transpose(1, 2)
                conv = _activation(self.conv_act)(conv.masked_fill(~keep, 0.0))
                x = self.conv_ln(x + conv).to(dtype) * keep.to(dtype)
            h = self._layer("ffn_out", i)(act(self._layer("ffn_in", i)(x)))
            x = self._layer("ffn_ln", i)(h + x).to(dtype)

        pooled = _activation(self.pooler_hidden_act)(self.pooler(x[:, 0]))
        return self.classifier(pooled).to(torch.float32)


def convert_hf_deberta(hf_model, dtype: torch.dtype = torch.float32, device=None):
    """A ``transformers.DebertaV2ForSequenceClassification`` ->
    (DebertaV2Classifier, state_dict), the model holding the state: the JAX
    ``convert_hf_deberta``'s mapping, with kernels and embeddings in
    ``dtype`` and LayerNorms, biases and the relative table in f32. The
    production judge is ``microsoft/deberta-v2-xxlarge-mnli`` (48 layers, d
    1,536, buckets 256, ``share_att_key``, conv kernel 3). ``device`` None
    is the GPU."""
    cfg = hf_model.config
    pos_att = tuple(cfg.pos_att_type or ())
    model = DebertaV2Classifier(
        vocab_size=cfg.vocab_size,
        num_labels=int(getattr(cfg, "num_labels", 2)),
        num_layers=cfg.num_hidden_layers,
        num_heads=cfg.num_attention_heads,
        d_model=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings,
        embedding_size=getattr(cfg, "embedding_size", None),
        type_vocab_size=int(cfg.type_vocab_size),
        position_biased_input=bool(getattr(cfg, "position_biased_input", True)),
        relative_attention=bool(getattr(cfg, "relative_attention", False)),
        position_buckets=int(getattr(cfg, "position_buckets", -1)),
        max_relative_positions=int(getattr(cfg, "max_relative_positions", -1)),
        norm_rel_ebd=str(getattr(cfg, "norm_rel_ebd", "none")).lower(),
        share_att_key=bool(getattr(cfg, "share_att_key", False)),
        pos_att_type=pos_att,
        conv_kernel_size=int(getattr(cfg, "conv_kernel_size", 0)),
        conv_groups=int(getattr(cfg, "conv_groups", 1)),
        conv_act=str(getattr(cfg, "conv_act", "tanh")),
        hidden_act=str(cfg.hidden_act),
        pooler_hidden_act=str(getattr(cfg, "pooler_hidden_act", "gelu")),
        layer_norm_eps=float(cfg.layer_norm_eps),
        dtype=dtype,
        device=device,
    )
    dev = model.emb_LayerNorm.scale.device
    emb, enc = hf_model.deberta.embeddings, hf_model.deberta.encoder

    def dense(name, linear):
        state[f"{name}.kernel"] = hf_kernel(linear.weight, dtype, dev)
        if linear.bias is not None:
            state[f"{name}.bias"] = hf_vector(linear.bias, dev)

    def norm(name, ln):
        state[f"{name}.scale"], state[f"{name}.bias"] = hf_vector(ln.weight, dev), hf_vector(ln.bias, dev)

    state: Dict[str, torch.Tensor] = {"word_embeddings.embedding": hf_vector(emb.word_embeddings.weight, dev, dtype)}
    norm("emb_LayerNorm", emb.LayerNorm)
    dense("pooler", hf_model.pooler.dense)
    dense("classifier", hf_model.classifier)
    if model.position_biased_input:
        state["position_embeddings.embedding"] = hf_vector(emb.position_embeddings.weight, dev, dtype)
    if model.type_vocab_size > 0:
        state["token_type_embeddings.embedding"] = hf_vector(emb.token_type_embeddings.weight, dev, dtype)
    if emb.embed_proj is not None:
        dense("embed_proj", emb.embed_proj)
    if model.relative_attention:
        state["rel_embeddings"] = hf_vector(enc.rel_embeddings.weight, dev)
        if "layer_norm" in model.norm_rel_ebd:
            norm("rel_LayerNorm", enc.LayerNorm)
    if model.conv_kernel_size > 0:
        # torch Conv1d weight (out, in/groups, K) -> flax (K, in/groups, out)
        state["conv.kernel"] = enc.conv.conv.weight.detach().to(device=dev, dtype=dtype).permute(2, 1, 0).contiguous()
        state["conv.bias"] = hf_vector(enc.conv.conv.bias, dev)
        norm("conv_ln", enc.conv.LayerNorm)
    for i, layer in enumerate(enc.layer):
        att = layer.attention.self
        for proj in ("query_proj", "key_proj", "value_proj"):
            dense(f"layer_{i}_attn.{proj}", getattr(att, proj))
        if model.relative_attention and not model.share_att_key:
            if "c2p" in pos_att:
                dense(f"layer_{i}_attn.pos_key_proj", att.pos_key_proj)
            if "p2c" in pos_att:
                dense(f"layer_{i}_attn.pos_query_proj", att.pos_query_proj)
        dense(f"layer_{i}_attn_out", layer.attention.output.dense)
        norm(f"layer_{i}_attn_ln", layer.attention.output.LayerNorm)
        dense(f"layer_{i}_ffn_in", layer.intermediate.dense)
        dense(f"layer_{i}_ffn_out", layer.output.dense)
        norm(f"layer_{i}_ffn_ln", layer.output.LayerNorm)
    model.load_state_dict(state, assign=True)
    return model.eval(), state


def wrap_torch_nli(
    model: DebertaV2Classifier,
    tokenizer,
    max_len: int = 256,
    len_buckets: Sequence[int] = (32, 64, 128, 256),
    batch_bucket: int = 16,
    use_graph: bool = True,
) -> Callable[..., np.ndarray]:
    """A batched NLI label callable on the model's device, the counterpart
    of ``wrap_jax_nli``: ``(premises, hypotheses) -> (n,) argmax labels``
    from one padded forward.

    ``tokenizer`` is an HF-style pair tokenizer, called on the host with
    padding, truncation to ``max_len`` and numpy tensors. The call is padded
    to the smallest length bucket that holds it (``len_buckets`` and
    ``max_len``) and to a multiple of ``batch_bucket`` rows; a padded row
    gets one valid token at position 0 (an all-masked row would softmax over
    nothing). On a GPU each (rows, length) bucket is captured once into a
    CUDA graph and replayed (``use_graph=False`` runs eagerly); the one wait
    is the copy of the logits to the host. The callable carries
    ``is_batch_labels = True``, which routes it through the batched
    clustering of ``llm.scores.semantic_entropy``, and ``logits``, the same
    call returning the (n, num_labels) f32 logits.
    """
    buckets = sorted({int(b) for b in len_buckets} | {int(max_len)})
    device = next(model.parameters()).device
    programs = ProgramCache(_NLI_PROGRAMS)

    def logits(premises, hypotheses) -> np.ndarray:
        enc = tokenizer(list(premises), list(hypotheses), padding=True, truncation=True, max_length=max_len,
                        return_tensors="np")
        ids = np.asarray(enc["input_ids"], np.int64)
        mask = np.asarray(enc["attention_mask"], np.int64)
        types = np.asarray(enc.get("token_type_ids", np.zeros_like(ids)), np.int64)
        n, t = ids.shape
        t_pad = next((b for b in buckets if b >= t), int(max_len))
        n_pad = -(-max(n, 1) // batch_bucket) * batch_bucket
        full = {name: np.zeros((n_pad, t_pad), np.int64) for name in ("input_ids", "attention_mask", "token_type_ids")}
        for name, value in (("input_ids", ids), ("attention_mask", mask), ("token_type_ids", types)):
            full[name][:n, :t] = value[:, :t_pad]
        full["attention_mask"][n:, 0] = 1
        inputs = {name: upload(value, device) for name, value in full.items()}
        if use_graph and device.type == "cuda":
            graph = programs.get_or_build((n_pad, t_pad), lambda: CudaGraph(model, inputs, device=device))
            graph.load(**inputs)
            (out,) = graph.replay()
        else:
            out = model(**inputs)
        return copy_to_host(out)[0][:n]

    def batch_labels(premises, hypotheses) -> np.ndarray:
        return np.argmax(logits(premises, hypotheses), axis=1)

    batch_labels.is_batch_labels = True
    batch_labels.logits = logits
    return batch_labels
