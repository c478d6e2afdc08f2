"""The plain reference of configuration family ``mellum`` (Mellum 2): its
forward in plain torch, f32, no cache, no batching, no kernel.

The block, from the published ``config.json`` (the configuration file
holds it): RMSNorm, GQA attention without biases or q/k norms, RoPE by
layer kind (YaRN on ``full_attention`` layers, plain on
``sliding_attention`` ones, which attend keys less than ``sliding_window``
positions back), a residual, RMSNorm, then a sparse-MoE SwiGLU over every
layer: a router softmax over all experts, the top ``num_experts_per_tok``
renormalised (``norm_topk_prob``), no shared expert; a final RMSNorm and an
untied head. The multi-token-prediction head is not on the serving forward
and is left out.

Weights are made here from the benchmark's seed, each tensor from a
generator of its own seeded with (seed, the tensor's name)
(:func:`make_weight`), so that the program's family and this reference
draw the same values, one layer at a time. Norm scales are 1. The
reference keeps them in f32; the program rounds them to its dtype.

:func:`teacher_forced` runs a set of sequences through the model layer by
layer (each layer's weights made once for all of them), attention in
blocks of queries, and returns, at each answer position, the
full-vocabulary log-softmax's value at the given token, its entropy, its
argmax and top-2 margin, and each consumed answer token's attention to the
position before it (RAUQ's signal). With ``quantize`` every weight (per
output channel) and every product's input (per tensor) is rounded by it:
the benchmark's control.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Quantize = Optional[Callable[[torch.Tensor, bool], torch.Tensor]]


def seed_of(seed: int, name: str) -> int:
    """A 64-bit seed for tensor ``name`` under the run's ``seed``: FNV-1a
    over ``"<seed>/<name>"``."""
    h = 0xCBF29CE484222325
    for byte in f"{int(seed)}/{name}".encode():
        h = ((h ^ byte) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def layer_specs(cfg: dict, i: int) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, standard deviation) of layer ``i``'s random tensors:
    kernels stored (in, out) and drawn N(0, 1 / fan_in)."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    nq, nkv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    e, w = cfg["num_experts"], cfg["moe_intermediate_size"]
    p = f"layers.{i}."
    return [(p + "q", (d, nq), d ** -0.5), (p + "k", (d, nkv), d ** -0.5), (p + "v", (d, nkv), d ** -0.5),
            (p + "o", (nq, d), nq ** -0.5), (p + "router", (d, e), d ** -0.5),
            (p + "w_gate", (e, d, w), d ** -0.5), (p + "w_up", (e, d, w), d ** -0.5),
            (p + "w_down", (e, w, d), w ** -0.5)]


def outer_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """The embedding, N(0, 1), and the head, N(0, 1 / d)."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    return [("embed", (v, d), 1.0), ("head", (d, v), d ** -0.5)]


def make_weight(seed: int, name: str, shape: Sequence[int], std: float, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed_of(seed, name))
    return torch.randn(tuple(shape), generator=g, device=device) * std


def parameter_count(cfg: dict) -> int:
    """Every parameter of the published model: the random tensors and the
    norm scales (two a layer and the final one)."""
    specs = outer_specs(cfg) + [s for i in range(cfg["num_hidden_layers"]) for s in layer_specs(cfg, i)]
    return sum(math.prod(shape) for _, shape, _ in specs) + (2 * cfg["num_hidden_layers"] + 1) * cfg["hidden_size"]


def inv_freq(cfg: dict, kind: str) -> Tuple[torch.Tensor, float]:
    """(inverse frequencies (head_dim / 2,) f32, scale of cos and sin) of a
    layer kind's RoPE. YaRN (arXiv:2309.00071, as Hugging Face computes it):
    the correction dimension of r rotations over the original positions is
    d ln(orig / (2 pi r)) / (2 ln theta); between floor(dim(beta_fast)) and
    ceil(dim(beta_slow)) a linear ramp takes each frequency from theta^(-2i/d)
    (below) to theta^(-2i/d) / factor (above); the tables are scaled by the
    attention factor."""
    spec = cfg["rope_parameters"][kind]
    d, theta = cfg["head_dim"], float(spec["rope_theta"])
    pos_freqs = theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    if spec.get("rope_type", "default") == "default":
        return 1.0 / pos_freqs, 1.0
    factor, orig = float(spec["factor"]), float(spec["original_max_position_embeddings"])

    def dim(rotations: float) -> float:
        return d * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low, high = max(math.floor(dim(spec["beta_fast"])), 0), min(math.ceil(dim(spec["beta_slow"])), d - 1)
    ramp = ((torch.arange(d // 2, dtype=torch.float32) - low) / max(high - low, 0.001)).clamp(0.0, 1.0)
    freqs = (1.0 / (factor * pos_freqs)) * ramp + (1.0 / pos_freqs) * (1.0 - ramp)
    scale = spec.get("attention_factor") or 0.1 * math.log(factor) + 1.0
    return freqs, float(scale)


def rope(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor, scale: float) -> torch.Tensor:
    """x (T, heads, d) rotated (rotate-half convention) at ``positions``."""
    angles = positions[:, None].to(torch.float32) * freqs.to(x.device)[None, :]
    cos, sin = (torch.cat([f(angles)] * 2, dim=-1)[:, None, :] * scale for f in (torch.cos, torch.sin))
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def _weight(w: torch.Tensor, quantize: Quantize) -> torch.Tensor:
    """``w`` (..., in, out) rounded per output channel by ``quantize``."""
    if quantize is None:
        return w
    t = w.transpose(-1, -2)
    return quantize(t.reshape(-1, t.shape[-1]), True).reshape(t.shape).transpose(-1, -2)


def _act(x: torch.Tensor, quantize: Quantize) -> torch.Tensor:
    return x if quantize is None else quantize(x, False)


def attention(cfg: dict, kind: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block: int,
              prev_rows: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal GQA attention of one sequence, q (T, H, d), k / v (T, G, d),
    queries in blocks of ``block``; a sliding layer attends keys less than
    ``sliding_window`` back. Returns the (T, H * d) context and, for query
    rows ``prev_rows[0] <= r < prev_rows[1]``, each head's probability on
    key r - 1: (H, rows)."""
    t, h, d = q.shape
    g = k.shape[1]
    window = cfg["sliding_window"] if kind == "sliding_attention" else None
    out = torch.empty((t, h, d), dtype=torch.float32, device=q.device)
    prev = torch.zeros((h, max(prev_rows[1] - prev_rows[0], 0)), dtype=torch.float32, device=q.device)
    for q0 in range(0, t, block):
        q1 = min(q0 + block, t)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        keys = torch.arange(k0, q1, device=q.device)[None, :]
        allowed = keys <= rows
        if window is not None:
            allowed = allowed & (rows - keys < window)
        qb = q[q0:q1].reshape(q1 - q0, g, h // g, d).permute(1, 2, 0, 3)  # (G, rep, Tq, d)
        kb, vb = k[k0:q1].permute(1, 0, 2), v[k0:q1].permute(1, 0, 2)  # (G, Tk, d)
        logits = torch.einsum("grqd,gkd->grqk", qb, kb) / math.sqrt(d)
        probs = torch.softmax(logits.masked_fill(~allowed, float("-inf")), dim=-1)
        out[q0:q1] = torch.einsum("grqk,gkd->qgrd", probs, vb).reshape(q1 - q0, h, d)
        lo, hi = max(q0, prev_rows[0]), min(q1, prev_rows[1])
        if hi > lo:
            r = torch.arange(lo, hi, device=q.device)
            prev[:, lo - prev_rows[0]:hi - prev_rows[0]] = probs[:, :, r - q0, r - 1 - k0].reshape(h, hi - lo)
    return out.reshape(t, h * d), prev


def experts(cfg: dict, x: torch.Tensor, w: Dict[str, torch.Tensor], quantize: Quantize) -> torch.Tensor:
    """The sparse-MoE SwiGLU of rows ``x`` (T, d): an f32 router, softmax
    over all experts, top-k renormalised, each expert over its own rows."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(_act(x, quantize) @ _weight(w["router"], quantize), dim=-1)
    top_v, top_i = torch.topk(probs, k, dim=-1)
    if cfg["norm_topk_prob"]:
        top_v = top_v / top_v.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    xq = _act(x, quantize)
    for e in range(cfg["num_experts"]):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = xq[rows]
        hidden = torch.nn.functional.silu(xe @ _weight(w["w_gate"][e], quantize)) * (xe @ _weight(w["w_up"][e], quantize))
        y = _act(hidden, quantize) @ _weight(w["w_down"][e], quantize)
        out.index_add_(0, rows, y * top_v[rows, slot, None])
    return out


@torch.no_grad()
def teacher_forced(cfg: dict, seed: int, prompts: Sequence[torch.Tensor], answers: Sequence[torch.Tensor], device,
                   quantize: Quantize = None, block: int = 512) -> List[Dict[str, torch.Tensor]]:
    """Each prompt followed by its answer, teacher-forced. Per sequence:
    ``log_prob`` (n,) of each answer token under the reference,
    ``entropy`` (n,) of each answer position's distribution over the
    vocabulary divided by ln(vocab), ``argmax`` (n,) and ``margin`` (n,) (top
    logit minus the second), and ``att_prev`` (L, H, n - 1): answer token j's
    attention, as the query that consumes it, to the position before it."""
    matmul_tf32, cudnn_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _teacher_forced(cfg, seed, prompts, answers, device, quantize, block)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul_tf32, cudnn_tf32


def _teacher_forced(cfg, seed, prompts, answers, device, quantize, block):
    seqs = [torch.cat([torch.as_tensor(p, device=device), torch.as_tensor(a, device=device)[:-1]]).long()
            for p, a in zip(prompts, answers)]
    hidden, att_prev, head = forward(cfg, seed, seqs, device, quantize, block, [len(p) for p in prompts])
    out = []
    for j, (p, x) in enumerate(zip(prompts, hidden)):
        logits = _act(x[len(p) - 1:], quantize) @ _weight(head, quantize)  # rows whose next token is an answer's
        logp = torch.log_softmax(logits, dim=-1)
        answer = torch.as_tensor(answers[j], device=device).long()
        top2 = torch.topk(logits, 2, dim=-1).values
        out.append({
            "log_prob": logp.gather(1, answer[:, None])[:, 0],
            "entropy": -(logp.exp() * logp).sum(-1) / math.log(cfg["vocab_size"]),
            "argmax": logits.argmax(-1),
            "margin": top2[:, 0] - top2[:, 1],
            "att_prev": att_prev[j],
        })
    return out


@torch.no_grad()
def logits(cfg: dict, seed: int, tokens: torch.Tensor, device) -> torch.Tensor:
    """(T, vocab) f32 logits of one sequence of tokens."""
    hidden, _, head = forward(cfg, seed, [torch.as_tensor(tokens, device=device).long()], device, None, 512, [0])
    return hidden[0] @ head


def forward(cfg: dict, seed: int, seqs: Sequence[torch.Tensor], device, quantize: Quantize, block: int,
            prev_from: Sequence[int]) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """The sequences through every layer and the final norm: (each one's
    (T, d) final hidden states, each one's (L, H, T - prev_from) attention
    of query r >= prev_from to key r - 1, the head (d, vocab))."""
    d, hd, eps = cfg["hidden_size"], cfg["head_dim"], cfg["rms_norm_eps"]
    h, g = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    lengths = [s.numel() for s in seqs]
    starts = [sum(lengths[:i]) for i in range(len(seqs))]
    outer = {name: make_weight(seed, name, shape, std, device) for name, shape, std in outer_specs(cfg)}
    embed = outer.pop("embed")
    x = torch.cat([embed[s] for s in seqs])  # (N, d): every sequence, end to end
    del embed
    positions = torch.cat([torch.arange(n, device=device) for n in lengths])
    att_prev = [[] for _ in seqs]
    for i in range(cfg["num_hidden_layers"]):
        w = {name.rsplit(".", 1)[1]: make_weight(seed, name, shape, std, device)
             for name, shape, std in layer_specs(cfg, i)}
        kind = cfg["layer_types"][i]
        freqs, scale = inv_freq(cfg, kind)
        hn = _act(rms_norm(x, eps), quantize)
        q = rope((hn @ _weight(w["q"], quantize)).reshape(-1, h, hd), positions, freqs, scale)
        k = rope((hn @ _weight(w["k"], quantize)).reshape(-1, g, hd), positions, freqs, scale)
        v = (hn @ _weight(w["v"], quantize)).reshape(-1, g, hd)
        ctx = torch.empty((x.shape[0], h * hd), dtype=torch.float32, device=device)
        for j, (start, n) in enumerate(zip(starts, lengths)):
            ctx[start:start + n], prev = attention(cfg, kind, q[start:start + n], k[start:start + n],
                                                   v[start:start + n], block, (prev_from[j], n))
            att_prev[j].append(prev)
        del q, k, v
        x = x + _act(ctx, quantize) @ _weight(w["o"], quantize)
        x = x + experts(cfg, rms_norm(x, eps), w, quantize)
        del w, ctx
    x = rms_norm(x, eps)
    return ([x[start:start + n] for start, n in zip(starts, lengths)], [torch.stack(a) for a in att_prev],
            outer["head"])


def rauq(log_prob: torch.Tensor, att_prev: torch.Tensor, alpha: float) -> float:
    """RAUQ (Vazhentsev et al. 2025), token aggregation "original", head
    aggregation "original": in each layer the head whose mean attention to
    the previous token over steps 1.. is largest; confidence c_0 = p_0, c_j =
    alpha p_j + (1 - alpha) a_j c_(j-1); the score is the largest over layers
    of the mean -log c over the steps."""
    n = att_prev.shape[-1]
    if n < 1:
        return float("nan")
    heads = att_prev[:, :, 1:].mean(-1).argmax(-1) if n > 1 else torch.zeros(att_prev.shape[0], dtype=torch.long)
    a = att_prev[torch.arange(att_prev.shape[0]), heads.to(att_prev.device)].double()  # (L, n)
    probs = log_prob.double().exp()
    conf = [probs[0].expand(a.shape[0])]
    for j in range(1, n):
        conf.append(alpha * probs[j] + (1 - alpha) * a[:, j] * conf[-1])
    return float((-torch.log(torch.stack(conf))).mean(0).max())


def scores(answer: Dict[str, torch.Tensor], alpha: float) -> Dict[str, float]:
    """The three scores of one answer: perplexity (mean -log p),
    generation entropy (the mean normalised entropy) and RAUQ."""
    return {"perplexity": float(-answer["log_prob"].double().mean()),
            "generation_entropy": float(answer["entropy"].double().mean()),
            "RAUQ_original_original": rauq(answer["log_prob"], answer["att_prev"], alpha)}
