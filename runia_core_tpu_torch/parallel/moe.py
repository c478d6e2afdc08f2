"""Expert parallelism: a mixture-of-experts FFN sharded over a mesh.

Counterpart of ``runia_core_tpu/parallel/moe.py``. Experts are sharded over
the ``model`` axis and tokens over ``data``; dispatch and combine are
einsums against one-hot capacity assignments (the GShard / Switch
formulation: static shapes, no data-dependent gather), and the only
communication is one all-reduce of the combined output over the expert
axis.

Routing: top-k gating with the weights renormalised over the selected
experts, a token's slot in an expert its rank among the tokens routed
there (token order), tokens past an expert's capacity dropped (they
contribute zero; the residual stream carries them, as in Switch).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from runia_core_tpu_torch.parallel.mesh import _SumReplicated, local_rows

__all__ = ["MoEParams", "init_moe", "moe_ffn", "sharded_moe_ffn"]


class MoEParams(NamedTuple):
    """Gate and per-expert FFN weights; ``w_in`` / ``w_out`` lead with the
    expert axis, which the sharded layer splits over the mesh."""

    w_gate: torch.Tensor  # (D, E)
    w_in: torch.Tensor  # (E, D, H)
    w_out: torch.Tensor  # (E, H, D)


def init_moe(generator: torch.Generator, d_model: int, d_hidden: int, num_experts: int) -> MoEParams:
    """N(0, 1) weights scaled by 1/sqrt(fan_in), f32, drawn from
    ``generator`` on its device (gate, then w_in, then w_out)."""

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator, device=generator.device) / fan_in**0.5

    return MoEParams(
        w_gate=normal((d_model, num_experts), d_model),
        w_in=normal((num_experts, d_model, d_hidden), d_model),
        w_out=normal((num_experts, d_hidden, d_model), d_hidden),
    )


def _dispatch_combine(gate_logits: torch.Tensor, capacity: int, top_k: int):
    """(T, E, C) dispatch mask and combine weights from (T, E) gate logits.
    A token's slot in an expert is its rank among the tokens routed there,
    in token order, the first choices of all tokens before the second; a
    rank at or past ``capacity`` lands in the spill column and is dropped.
    The combine weights carry the gate's gradient."""
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


def _experts(x, dispatch, combine, w_in, w_out):
    """The experts' ReLU FFN on their dispatched tokens, combined per token."""
    expert_in = torch.einsum("td,tec->ecd", x, dispatch)
    hidden = torch.relu(torch.einsum("ecd,edh->ech", expert_in, w_in))
    expert_out = torch.einsum("ech,ehd->ecd", hidden, w_out)
    return torch.einsum("ecd,tec->td", expert_out, combine)


def moe_ffn(params: MoEParams, x: torch.Tensor, capacity_factor: float = 2.0, top_k: int = 1) -> torch.Tensor:
    """Single-device MoE FFN on (T, D) tokens: the sharded layer's
    reference semantics, with ``max(1, int(capacity_factor * T / E))``
    slots per expert."""
    t = x.shape[0]
    e = params.w_gate.shape[1]
    capacity = max(1, int(capacity_factor * t / e))
    dispatch, combine = _dispatch_combine(x @ params.w_gate, capacity, top_k)
    return _experts(x, dispatch, combine, params.w_in, params.w_out)


def sharded_moe_ffn(
    params: MoEParams,
    x: torch.Tensor,
    mesh: DeviceMesh,
    capacity_factor: float = 2.0,
    top_k: int = 1,
    data_axis: str = "data",
    expert_axis: str = "model",
) -> DTensor:
    """MoE FFN with tokens sharded over ``data_axis`` and experts over
    ``expert_axis``.

    Each rank routes its tokens (a :func:`shard_batch` DTensor's local rows,
    or its ``data`` chunk of a whole batch) with the whole gate, keeps its
    block of experts (the ``expert_axis`` chunk of ``w_in`` / ``w_out``,
    which every rank holds whole) and the matching columns of the global
    assignment, and one all-reduce over ``expert_axis`` sums the experts'
    parts. Routing is the unsharded layer's per token; capacity is ranked
    within each data shard (GShard's grouped routing: ``capacity_factor *
    T_local / E`` slots), so without overflow the result is
    :func:`moe_ffn`'s, and under overflow which tokens drop is decided per
    group.

    Returns the (T, D) output as a DTensor sharded over ``data_axis``
    (JAX's ``P(data, None)``). It is differentiable: the all-reduce's
    backward is the identity (what follows is computed alike on each
    expert rank), so a rank's parameter gradients are its share, and their
    sum over the world is the gradient of the data shards' summed loss.
    """
    names = mesh.mesh_dim_names
    n_exp, n_data = mesh.size(names.index(expert_axis)), mesh.size(names.index(data_axis))
    e = params.w_gate.shape[1]
    if e % n_exp:
        raise ValueError(f"{e} experts not divisible by the {expert_axis} axis ({n_exp})")
    if x.shape[0] % n_data:
        raise ValueError(f"{x.shape[0]} tokens not divisible by the {data_axis} axis ({n_data})")
    x_local = local_rows(x, mesh, data_axis)
    capacity = max(1, int(capacity_factor * x_local.shape[0] / e))
    e_local = e // n_exp
    block = slice(mesh.get_local_rank(expert_axis) * e_local, (mesh.get_local_rank(expert_axis) + 1) * e_local)
    dispatch, combine = _dispatch_combine(x_local @ params.w_gate, capacity, top_k)
    partial = _experts(x_local, dispatch[:, block], combine[:, block], params.w_in[block], params.w_out[block])
    out = _SumReplicated.apply(partial, mesh.get_group(expert_axis))
    placements = [Shard(0) if name == data_axis else Replicate() for name in names]
    return DTensor.from_local(out, mesh, placements, run_check=False)
