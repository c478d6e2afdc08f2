"""Routed sparse-MoE experts: the (token, expert) pairs sorted by expert on
the device, each expert's SwiGLU over its own rows only in grouped kernels
(``csrc/moe_grouped.cu``), and the gated outputs gathered back.

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
two warp-specialised ``wgmma`` kernels fed by TMA for a CUDA tensor (bf16;
gate|up with the SwiGLU into bf16 hidden rows, then the down projection
into the f32 output rows), :func:`reference_moe_grouped`, their plain twin,
for a CPU tensor. The hidden product is rounded to x's dtype before the down
projection in both, as the kernels feed it to the tensor cores. One design
serves every shape, a decode step's pair or two an expert as a prefill
lane's hundreds: ``chip_smoke.py`` (``kernel_moe_grouped``) times it against
the bytes bound at both.

``moe_grouped.launches`` counts the calls that launched the kernels.
``moe_grouped.work`` holds, per CUDA device, an int64 tensor of the pairs
and of the experts that got at least one pair, summed over every call (the
kernels add them themselves, once a call, so a replayed graph counts too):
a reader takes its rise over a stretch.
"""

from __future__ import annotations

from typing import Dict

import torch

from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.utils.graphs import count_launch

__all__ = ["moe_grouped", "reference_moe_grouped", "routed_experts"]

WIDTH_STEP = 64  # d and I in multiples of this: the kernels' 64-column boxes


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


def _work(device: torch.device) -> torch.Tensor:
    work = moe_grouped.work.get(device)
    if work is None:
        work = moe_grouped.work[device] = torch.zeros((2,), dtype=torch.int64, device=device)
    return work


def moe_grouped(x: torch.Tensor, tok: torch.Tensor, offsets: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Every sorted pair's expert output, (P, d) f32: the twin on the CPU,
    the kernels on the card: the hidden rows (P, I) in bf16, then the output
    rows, each written once.

    Args:
        x: (T, d) contiguous tokens.
        tok: (P,) int32 token of each pair, the pairs sorted by expert.
        offsets: (E + 1,) int32 first pair of each expert, and P.
        w_gate, w_up: (E, d, I) contiguous; w_down: (E, I, d) contiguous,
            in x's dtype.
    """
    if not x.is_cuda:
        return reference_moe_grouped(x, tok, offsets, w_gate, w_up, w_down)
    _check(x, tok, offsets, w_gate, w_up, w_down)
    p, d = tok.shape[0], x.shape[1]
    e, hidden = w_gate.shape[0], w_gate.shape[2]
    out = torch.empty((p, d), dtype=torch.float32, device=x.device)
    if p == 0:
        return out
    h = torch.empty((p, hidden), dtype=torch.bfloat16, device=x.device)
    lib = _kernels.library()
    with _kernels.device_guard(x.device):
        code = lib.runia_moe_grouped(
            x.data_ptr(), tok.data_ptr(), offsets.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), h.data_ptr(), out.data_ptr(), _work(x.device).data_ptr(), p, d, hidden, e,
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(code, "moe_grouped")
    count_launch(moe_grouped)
    return out


def _check(x, tok, offsets, w_gate, w_up, w_down) -> None:
    p, d = tok.shape[0], x.shape[1]
    e, hidden = w_gate.shape[0], w_gate.shape[2]
    if x.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16 for w in (w_gate, w_up, w_down)):
        raise ValueError(f"moe_grouped runs bf16 experts on the card; got {x.dtype}, {w_gate.dtype}")
    if (tuple(w_gate.shape) != (e, d, hidden) or tuple(w_up.shape) != (e, d, hidden)
            or tuple(w_down.shape) != (e, hidden, d)):
        raise ValueError(f"expert stacks (E, d, I), (E, d, I), (E, I, d); got {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)}")
    if d % WIDTH_STEP or hidden % WIDTH_STEP:
        raise ValueError(f"moe_grouped takes widths in multiples of {WIDTH_STEP}; got d={d}, I={hidden}")
    for name, t in (("x", x), ("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if not t.is_contiguous() or t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"moe_grouped: {name} must be contiguous and 16-byte aligned on {x.device}")
    for name, t, n in (("tok", tok, p), ("offsets", offsets, e + 1)):
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"moe_grouped: {name} must be a contiguous ({n},) int32 tensor on {x.device}")


moe_grouped.launches = 0
moe_grouped.work: Dict[torch.device, torch.Tensor] = {}
