"""Routed sparse-MoE experts: the (token, expert) pairs sorted by expert on
the device, each expert's SwiGLU over its own rows only in one grouped
kernel (``csrc/moe_grouped.cu``), and the gated outputs gathered back.

:func:`routed_experts` is what ``models/llama.py::_moe_ffn`` calls with a
token's top-k experts and their weights. It sorts the pairs by expert with
a counting sort (a fixed-length count over the experts, a cumulative sum
and each pair's rank among its expert's pairs), so the per-expert offsets,
the pairs' tokens and the inverse permutation are device tensors and
nothing is read back to the host: a CUDA graph captures it. The combine is
deterministic: each token's k expert outputs are gathered back by the
inverse permutation and summed in f32, with no atomics.

:func:`moe_grouped` computes, for every sorted pair p of expert e,
``silu(x[tok[p]] @ w_gate[e]) * (x[tok[p]] @ w_up[e]) @ w_down[e]`` in f32:
the kernel for a CUDA tensor (bf16), :func:`reference_moe_grouped`, its
plain twin, for a CPU tensor. The hidden product is rounded to x's dtype
before the down projection in both, as the kernel feeds it to the tensor
cores.

``moe_grouped.launches`` counts the kernel's launches. ``moe_grouped.work``
holds, per CUDA device, an int64 tensor of the pairs and of the experts that
got at least one pair, summed over every launch (the kernel adds them
itself, so a replayed graph counts too): a reader takes its rise over a
stretch.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import torch

from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.utils.graphs import count_launch

__all__ = ["moe_grouped", "plan", "reference_moe_grouped", "routed_experts"]

CHUNK = 64  # hidden columns a tile computes at a time
SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM holds; a block takes 1,024 more
SMEM_PER_BLOCK = 232448
CHUNK_S = 75e-6  # a full wave's seconds a 64-column chunk of the slice (the card, both phases)
HBM_BYTES_S = 3.35e12
STAGES = {64: 2, 128: 3}  # pairs a tile -> ring stages: the kernel's two instances


def routed_experts(x: torch.Tensor, top_i: torch.Tensor, top_w: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Each token's experts' SwiGLU, weighed and summed: (T, d) f32.

    Args:
        x: (T, d) tokens in the experts' dtype.
        top_i: (T, k) int64 experts of each token.
        top_w: (T, k) f32 weights of those experts.
        w_gate, w_up: (E, d, I) expert stacks; w_down: (E, I, d).
    """
    t, k = top_i.shape
    e = w_gate.shape[0]
    flat = top_i.reshape(-1)
    # (E, P): each expert's pairs along the inner dimension, which a scan runs along fast.
    onehot = (torch.arange(e, device=x.device)[:, None] == flat[None, :]).to(torch.int32)
    ranks = onehot.cumsum(1, dtype=torch.int32)
    counts = ranks[:, -1]
    rank = ranks.gather(0, flat[None, :])[0] - 1  # each pair's place among its expert's pairs
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0, dtype=torch.int32)])
    pos = (offsets[flat] + rank).long()  # pair t * k + j -> its sorted row: the inverse permutation
    pairs = torch.arange(t * k, device=x.device, dtype=torch.int32)
    tok = torch.empty_like(pairs).scatter_(0, pos, pairs // k)
    y = moe_grouped(x.contiguous(), tok, offsets, w_gate, w_up, w_down)
    return (y[pos].view(t, k, -1) * top_w[:, :, None]).sum(1)


def reference_moe_grouped(x: torch.Tensor, tok: torch.Tensor, offsets: torch.Tensor, w_gate: torch.Tensor,
                          w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: (P, d) f32, expert by expert over its
    rows ``offsets[e] <= p < offsets[e + 1]`` (the bounds read on the host)."""
    out = torch.zeros((tok.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    bounds = offsets.tolist()
    for e in range(w_gate.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            rows = x[tok[lo:hi].long()].to(torch.float32)
            h = torch.nn.functional.silu(rows @ w_gate[e].to(torch.float32)) * (rows @ w_up[e].to(torch.float32))
            out[lo:hi] = h.to(x.dtype).to(torch.float32) @ w_down[e].to(torch.float32)
    return out


def smem_bytes(bm: int, stages: int, width: int) -> int:
    return 2 * (stages * (bm + 2 * CHUNK) * (CHUNK + 8) + bm * (width + 8)) + 4 * bm


def plan(pairs: int, experts: int, hidden: int, d: int, sms: int = 132):
    """(pairs a tile, ring stages, slices of the hidden width) of a launch.
    Tiles of 128 pairs where experts see 128 or more on average (a weight
    tile then serves twice the rows), else 64. Among the slice counts whose
    blocks fit, the one with the least modelled time:
    the waves of blocks (the tiles being about one a touched expert, the
    expected number, and one more each tile of pairs; as many blocks an SM
    as its shared memory holds) times each block's chunks, plus the partial
    rows (``d`` wide, f32) each slice writes and the sum reads back."""
    bm = 128 if pairs >= 128 * experts else 64
    chunks = hidden // CHUNK
    tiles = experts * (1.0 - (1.0 - 1.0 / experts) ** pairs) + pairs / bm
    stages, best = STAGES[bm], None
    for splits in (s for s in range(1, chunks + 1) if chunks % s == 0):
        smem = smem_bytes(bm, stages, hidden // splits)
        if smem > SMEM_PER_BLOCK:
            continue
        per_sm = min(SMEM_PER_SM // (smem + 1024), 8 // (bm // 64))
        waves = math.ceil(tiles * splits / (sms * per_sm))
        cost = waves * (chunks // splits) * CHUNK_S + 8.0 * splits * pairs * d / HBM_BYTES_S
        if best is None or cost < best[0]:
            best = (cost, splits)
    return bm, stages, best[1]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _work(device: torch.device) -> torch.Tensor:
    work = moe_grouped.work.get(device)
    if work is None:
        work = moe_grouped.work[device] = torch.zeros((2,), dtype=torch.int64, device=device)
    return work


def moe_grouped(x: torch.Tensor, tok: torch.Tensor, offsets: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Every sorted pair's expert output, (P, d) f32.

    Args:
        x: (T, d) contiguous tokens.
        tok: (P,) int32 token of each pair, the pairs sorted by expert.
        offsets: (E + 1,) int32 first pair of each expert, and P.
        w_gate, w_up: (E, d, I) contiguous; w_down: (E, I, d) contiguous,
            in x's dtype.
    """
    p, d = tok.shape[0], x.shape[1]
    e, hidden = w_gate.shape[0], w_gate.shape[2]
    if not x.is_cuda:
        return reference_moe_grouped(x, tok, offsets, w_gate, w_up, w_down)
    if x.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16 for w in (w_gate, w_up, w_down)):
        raise ValueError(f"moe_grouped runs bf16 experts on the card; got {x.dtype}, {w_gate.dtype}")
    if (tuple(w_gate.shape) != (e, d, hidden) or tuple(w_up.shape) != (e, d, hidden)
            or tuple(w_down.shape) != (e, hidden, d)):
        raise ValueError(f"expert stacks (E, d, I), (E, d, I), (E, I, d); got {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)}")
    if d % CHUNK or hidden % CHUNK:
        raise ValueError(f"moe_grouped takes widths in multiples of {CHUNK}; got d={d}, I={hidden}")
    for name, t in (("x", x), ("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if not t.is_contiguous() or t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"moe_grouped: {name} must be contiguous and 16-byte aligned on {x.device}")
    for name, t, n in (("tok", tok, p), ("offsets", offsets, e + 1)):
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"moe_grouped: {name} must be a contiguous ({n},) int32 tensor on {x.device}")
    bm, stages, splits = plan(p, e, hidden, d, _sm_count(x.device.index if x.device.index is not None else 0))
    partial = torch.empty((splits, p, d), dtype=torch.float32, device=x.device)
    if p == 0:
        return partial.sum(0)
    tiles = -(-p // bm) + e  # a static bound: each expert's last tile may be partial
    lib = _kernels.library()
    with _kernels.device_guard(x.device):
        code = lib.runia_moe_grouped(
            x.data_ptr(), tok.data_ptr(), offsets.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), partial.data_ptr(), _work(x.device).data_ptr(), p, d, hidden, e, splits, bm, stages,
            tiles,
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(code, "moe_grouped")
    count_launch(moe_grouped)
    return partial[0] if splits == 1 else partial.sum(0)


moe_grouped.launches = 0
moe_grouped.work: Dict[torch.device, torch.Tensor] = {}
