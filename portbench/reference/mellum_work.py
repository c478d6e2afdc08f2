"""The Mellum cell's work counts, from the published shapes: the model's
operations a token, and each new kernel's operations and bytes from what a
run counted (pairs, experts, keys, queries), never from what a kernel
happens to do. Divided by the card's peaks in the per-layer readers
(``metrics/*.complete.py``)."""

from __future__ import annotations

from typing import Dict


def active_parameters(cfg: dict) -> int:
    """The weights a token multiplies by: each layer's attention projections,
    router and ``num_experts_per_tok`` experts, and the head (the embedding
    is a lookup)."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    nq, nkv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    layer = 2 * d * nq + 2 * d * nkv + d * cfg["num_experts"] + cfg["num_experts_per_tok"] * 3 * d * cfg["moe_intermediate_size"]
    return cfg["num_hidden_layers"] * layer + d * cfg["vocab_size"]


def attended_keys(cfg: dict, tokens: int) -> int:
    """Keys attended by ``tokens`` consecutive positions from 0, summed over
    the layers: causal on full layers, within the window on sliding ones."""
    full = tokens * (tokens + 1) // 2
    w = cfg["sliding_window"]
    sliding = full if tokens <= w else w * (w + 1) // 2 + (tokens - w) * w
    return sum(full if kind == "full_attention" else sliding for kind in cfg["layer_types"])


def sequence_flops(cfg: dict, tokens: int) -> float:
    """A sequence of ``tokens`` through the model: 2 operations a weight a
    token, and 4 a (query, key) pair a head dimension a query head."""
    heads = cfg["num_attention_heads"] * cfg["head_dim"]
    return 2.0 * active_parameters(cfg) * tokens + 4.0 * heads * attended_keys(cfg, tokens)


def experts_work(cfg: dict, pairs: int, touched: int) -> Dict[str, float]:
    """The grouped expert kernel's work: 2 x 3 products of d x I a (token,
    expert) pair; bytes of the experts that got a pair (bf16), each pair's
    row read (bf16) and its output written (f32) once."""
    d, width = cfg["hidden_size"], cfg["moe_intermediate_size"]
    return {"flops": 6.0 * d * width * pairs, "bytes": 6.0 * d * width * touched + 6.0 * d * pairs}


def attention_work(cfg: dict, pairs: int, keys: int, queries: int) -> Dict[str, float]:
    """Kernel 4's work: 4 operations a (query, key) pair a head dimension of
    each query head (``pairs`` counts one head's); q and the output (bf16)
    of every query head, k and v of the keys a row attends, once."""
    hd, hq, g = cfg["head_dim"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return {"flops": 4.0 * pairs * hq * hd, "bytes": 4.0 * queries * hq * hd + 4.0 * keys * g * hd}
