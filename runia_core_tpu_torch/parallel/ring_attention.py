"""Ring attention: sequence-parallel exact attention over a mesh axis.

Counterpart of ``runia_core_tpu/parallel/ring_attention.py``. The sequence
is split over the ranks of one mesh axis; each rank keeps its query block
and the key/value blocks travel around the ring (``batch_isend_irecv`` to
the next rank, JAX's ``ppermute``) while an online softmax in f32 (running
max, denominator and numerator, JAX's finite ``_NEG`` fill) accumulates
exact attention, causal masking by global positions. Point-to-point sends
are not differentiable, so the layer is a ``torch.autograd.Function`` with
its own ring backward (the flash-attention backward, the key/value blocks
travelling with their gradients and arriving home after n hops).

For long-context scoring or training; for short sequences plain attention
is faster (the ring takes n sequential steps).
"""

from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from runia_core_tpu_torch.parallel.mesh import _ring_shift

__all__ = ["ring_attention", "ring_self_attention"]

_NEG = -0.5 * torch.finfo(torch.float32).max  # finite mask fill; keeps exp() sane


def _block_logits(q32, k_blk, scale, q_pos, src, causal):
    """f32 logits of the resident queries against one key block, and the
    causal mask by global positions (None when not causal)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k_blk.to(torch.float32)) * scale
    if not causal:
        return s, None
    lk = k_blk.shape[2]
    k_pos = src * lk + torch.arange(lk, device=s.device)
    mask = q_pos[:, None] >= k_pos[None, :]
    return torch.where(mask, s, torch.full_like(s, _NEG)), mask


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, me, n, causal):
        b, h, lq, d = q.shape
        scale = 1.0 / math.sqrt(d)
        q32 = q.to(torch.float32)
        q_pos = me * lq + torch.arange(lq, device=q.device)
        m = torch.full((b, h, lq), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
        o = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        for step in range(n):
            # After ``step`` hops the block we hold started at rank me - step.
            s, mask = _block_logits(q32, k_blk, scale, q_pos, (me - step) % n, causal)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            if mask is not None:
                p = p * mask
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_blk.to(torch.float32))
            m = m_new
            if step < n - 1:
                k_blk, v_blk = _ring_shift((k_blk, v_blk), group)
        l = torch.clamp_min(l, torch.finfo(torch.float32).tiny)
        out = (o / l[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.group, ctx.me, ctx.n, ctx.causal = group, me, n, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, me, n, causal = ctx.group, ctx.me, ctx.n, ctx.causal
        lq, d = q.shape[2], q.shape[3]
        scale = 1.0 / math.sqrt(d)
        q32, do32 = q.to(torch.float32), dout.to(torch.float32)
        q_pos = me * lq + torch.arange(lq, device=q.device)
        delta = (do32 * out.to(torch.float32)).sum(dim=-1)  # rowsum(dO * O)
        dq = torch.zeros_like(q32)
        k_blk, v_blk = k, v
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step in range(n):
            s, mask = _block_logits(q32, k_blk, scale, q_pos, (me - step) % n, causal)
            p = torch.exp(s - lse[..., None])
            if mask is not None:
                p = p * mask
            dv_blk = dv_blk + torch.einsum("bhqk,bhqd->bhkd", p, do32)
            dp = torch.einsum("bhqd,bhkd->bhqk", do32, v_blk.to(torch.float32))
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, k_blk.to(torch.float32))
            dk_blk = dk_blk + torch.einsum("bhqk,bhqd->bhkd", ds, q32)
            # The gradients travel with their block; after n hops it is home.
            if step < n - 1:
                k_blk, v_blk, dk_blk, dv_blk = _ring_shift((k_blk, v_blk, dk_blk, dv_blk), group)
            else:
                dk_blk, dv_blk = _ring_shift((dk_blk, dv_blk), group)
        return dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype), None, None, None, None


def _local_seq(t: torch.Tensor, mesh: DeviceMesh, seq_axis: str, dim: int) -> torch.Tensor:
    """This rank's sequence block: a DTensor's local shard (it must be
    sharded on ``dim`` over ``seq_axis``), or its chunk of a whole tensor."""
    axis = mesh.mesh_dim_names.index(seq_axis)
    if isinstance(t, DTensor):
        if t.placements[axis] != Shard(dim):
            raise ValueError(f"a DTensor input must be Shard({dim}) over {seq_axis}, not {t.placements[axis]!r}")
        return t.to_local()
    return torch.chunk(t, mesh.size(axis), dim=dim)[mesh.get_local_rank(seq_axis)]


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: DeviceMesh,
    seq_axis: str = "data",
    causal: bool = True,
) -> DTensor:
    """Exact attention with the sequence dim sharded over ``seq_axis``.

    Args:
        q, k, v: (batch, heads, seq, head_dim); ``seq`` must divide by the
            axis's size. Each is a whole tensor that every rank holds, or a
            DTensor sharded on the sequence dim (``Shard(2)`` on
            ``seq_axis``).
        mesh: a ``DeviceMesh`` with a ``seq_axis`` dimension.
        causal: mask by *global* positions (exact across blocks).

    Returns:
        The (batch, heads, seq, head_dim) output in q's dtype, a DTensor
        sharded on the sequence dim over ``seq_axis``. Differentiable: a
        rank's gradients are those of its blocks (their sum over the axis is
        the whole gradient).
    """
    dim = mesh.mesh_dim_names.index(seq_axis)
    n, me = mesh.size(dim), mesh.get_local_rank(seq_axis)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"sequence of {q.shape[2]} not divisible by the {seq_axis} axis ({n})")
    q_l, k_l, v_l = (_local_seq(t, mesh, seq_axis, 2) for t in (q, k, v))
    out = _RingAttention.apply(q_l, k_l, v_l, mesh.get_group(seq_axis), me, n, causal)
    placements = [Shard(2) if name == seq_axis else Replicate() for name in mesh.mesh_dim_names]
    return DTensor.from_local(out, mesh, placements, run_check=False)


def ring_self_attention(
    x: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    wo: torch.Tensor,
    mesh: DeviceMesh,
    num_heads: int,
    seq_axis: str = "data",
    causal: bool = True,
) -> DTensor:
    """A self-attention layer on a sequence-sharded residual stream: ``x``
    (batch, seq, model), whole or a DTensor sharded on dim 1; the
    projections (kernels (in, out)) run on the rank's positions with no
    communication, and only the attention core pays the ring. Returns
    (batch, seq, model) as a DTensor sharded on dim 1 over ``seq_axis``."""
    dim = mesh.mesh_dim_names.index(seq_axis)
    n, me = mesh.size(dim), mesh.get_local_rank(seq_axis)
    x_l = _local_seq(x, mesh, seq_axis, 1)
    b, s, dm = x_l.shape
    dh = dm // num_heads

    def to_heads(t):
        return t.reshape(b, s, num_heads, dh).transpose(1, 2)

    q, k, v = (to_heads(x_l @ w) for w in (wq, wk, wv))
    o = _RingAttention.apply(q, k, v, mesh.get_group(seq_axis), me, n, causal)
    out = o.transpose(1, 2).reshape(b, s, dm) @ wo
    placements = [Shard(1) if name == seq_axis else Replicate() for name in mesh.mesh_dim_names]
    return DTensor.from_local(out, mesh, placements, run_check=False)
