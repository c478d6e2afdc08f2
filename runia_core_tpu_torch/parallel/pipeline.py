"""Pipeline parallelism: GPipe-style stage execution over a mesh axis.

Counterpart of ``runia_core_tpu/parallel/pipeline.py``. A stack of
identically shaped blocks runs with block ``s`` on stage ``s`` of a mesh
axis: microbatches enter stage 0 one a step, and activations hop to the
next stage by ``batch_isend_irecv`` (JAX's ``ppermute``). M microbatches
on S stages take M + S - 1 steps, every stage working on a different
microbatch in each (the bubble is (S - 1) / (M + S - 1)); the last stage's
outputs are then summed over the axis, which hands every stage a copy.

Each hop is an autograd Function whose backward sends the gradient one
stage back, so ``backward`` of a pipelined forward is the pipelined
backward; every stage builds the same graph (stage 0 selects its feed with
``torch.where`` and every stage keeps its outputs, masked), so the
backward's sends pair up across the ranks.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from runia_core_tpu_torch.parallel.mesh import _ring_shift, _SumReplicated
from runia_core_tpu_torch.utils.tree import tree_map

__all__ = ["pipeline_apply"]


class _NextStage(torch.autograd.Function):
    """Send an activation to the next stage and take the previous one's;
    the backward sends the gradient the other way."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _ring_shift((y,), group, 1)[0]

    @staticmethod
    def backward(ctx, grad):
        return _ring_shift((grad,), ctx.group, -1)[0], None


def _stage_params(stacked, mesh: DeviceMesh, stage_axis: str):
    """This stage's block parameters: a DTensor leaf's local slice (it must
    be ``Shard(0)`` over the stage axis) or row ``stage`` of a whole
    stacked leaf."""
    axis, stage = mesh.mesh_dim_names.index(stage_axis), mesh.get_local_rank(stage_axis)

    def mine(p):
        if not isinstance(p, DTensor):
            return p[stage]
        if p.placements[axis] != Shard(0):
            raise ValueError(f"stacked DTensor parameters must be Shard(0) over {stage_axis}, "
                             f"not {p.placements[axis]!r}")
        return p.to_local()[0]

    return tree_map(mine, stacked)


def pipeline_apply(
    block_fn: Callable,
    stacked_params,
    x: torch.Tensor,
    mesh: DeviceMesh,
    num_microbatches: int,
    stage_axis: str = "model",
) -> torch.Tensor:
    """Apply the S = size of ``stage_axis`` blocks to ``x``, block ``s`` on
    stage ``s``.

    Args:
        block_fn: ``(params_one_block, activation) -> activation`` of the
            same shape (residual blocks, transformer layers).
        stacked_params: a dict / list / tuple of tensors that lead with the
            stage axis (S, ...), whole on every rank or DTensors sharded
            over ``stage_axis``; stage ``s`` uses row ``s``.
        x: the (B, ...) batch, which every rank holds; B must divide by
            ``num_microbatches``.
        num_microbatches: GPipe's M.

    Returns:
        The (B, ...) output of the S blocks applied in sequence, on every
        rank. Differentiable: a stage's gradients are those of its block
        (and on stage 0 the input's); their sum over the axis is the whole
        gradient.
    """
    n_stages = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    b = x.shape[0]
    assert b % num_microbatches == 0, f"batch {b} not divisible by {num_microbatches} microbatches"
    m = num_microbatches
    stage = mesh.get_local_rank(stage_axis)
    group = mesh.get_group(stage_axis)
    params = _stage_params(stacked_params, mesh, stage_axis)
    micro = x.reshape((m, b // m) + tuple(x.shape[1:]))
    first = torch.tensor(stage == 0, device=x.device)
    buf = torch.zeros_like(micro[0])
    outputs = []
    steps = m + n_stages - 1
    for t in range(steps):
        # Stage 0 takes microbatch t while there is one; the others work
        # on what arrived from the stage before.
        y = block_fn(params, torch.where(first, micro[min(t, m - 1)], buf))
        if t >= n_stages - 1:  # the last stage finishes microbatch t - (S - 1)
            outputs.append(y)
        if t < steps - 1:
            buf = _NextStage.apply(y, group)
    acc = torch.stack(outputs)
    acc = torch.where(torch.tensor(stage == n_stages - 1, device=x.device), acc, torch.zeros_like(acc))
    return _SumReplicated.apply(acc, group).reshape(x.shape)
