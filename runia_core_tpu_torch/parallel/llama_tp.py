"""Tensor-parallel sharding of the port's ``LlamaLM`` over a mesh axis.

Counterpart of ``runia_core_tpu/parallel/llama_tp.py``, with JAX's
placement rules (Megatron's):

  - q/k/v and gate/up kernels column-sharded over the ``model`` axis
    (head- and hidden-parallel), with their int8 ``kernel_q``, per-column
    ``scale`` and q/k/v biases;
  - o and down kernels row-sharded (their product contracts the sharded
    dim: one all-reduce after each, the two Megatron f/g points);
  - lm_head column-sharded over the vocabulary, the embedding table
    vocab-sharded;
  - Mixtral expert stacks sharded over their hidden dim (w_gate / w_up
    column-, w_down row-parallel, the scales with their output columns),
    the router replicated;
  - everything else replicated, the fused int8 ``qkv`` / ``gateup``
    included (the rules name neither).

JAX places the parameters and GSPMD inserts the collectives. The port's
``Dense`` / ``QDense`` are not ``nn.Linear`` and the embedding and tied head
index the table directly, so DTensor's parallel plans cannot reach them:
:func:`shard_llama_params` cuts each parameter to the rank's share in place
and hands the model a :class:`TensorParallel`, through which its forward
runs the collectives (``models/llama.py``). Heads stay whole on a rank (JAX
can split one across devices; the port cannot), so the head counts, the
hidden dim and the vocabulary must divide by the axis.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard

__all__ = ["llama_tp_specs", "shard_llama_params"]

_COLUMN = {"q", "k", "v", "gate", "up", "lm_head"}  # kernel (in, out): shard out
_ROW = {"o", "down"}  # kernel (in, out): shard in (contraction -> all-reduce)


def _placement(name: str) -> Placement:
    """JAX's rule for the flax path of the same name (``llama_tp.py:38-80``)."""
    parts = name.split(".")
    leaf, parent = parts[-1], (parts[-2] if len(parts) >= 2 else None)
    if leaf in ("kernel", "kernel_q") and parent in _COLUMN:
        return Shard(1)
    if leaf in ("kernel", "kernel_q") and parent in _ROW:
        return Shard(0)
    if leaf in ("scale", "bias") and parent in _COLUMN:
        return Shard(0)
    if leaf in ("w_gate", "w_up", "w_gate_q", "w_up_q"):
        return Shard(2)
    if leaf in ("w_down", "w_down_q", "w_gate_scale", "w_up_scale"):
        return Shard(1)
    if leaf == "embedding" and parent == "embed":
        return Shard(0)
    return Replicate()


def llama_tp_specs(model_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, Placement]:
    """{parameter name: its placement on the ``model`` axis} for a LlamaLM
    or its state_dict: ``Shard(dim)`` where JAX's spec names the axis on
    that dim, ``Replicate()`` where its spec is ``P()``."""
    names = (model_or_state_dict.state_dict() if isinstance(model_or_state_dict, nn.Module)
             else model_or_state_dict).keys()
    return {name: _placement(name) for name in names}


class TensorParallel:
    """A rank's place on the model axis of a tensor-parallel LlamaLM, and
    the collectives its forward runs over that axis's group (NCCL on the
    GPU, gloo on the CPU). Every call is collective: each rank of the group
    makes it with the same shapes."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def reduce(self, partial: torch.Tensor) -> torch.Tensor:
        """The sum over the axis of each rank's partial product, in place."""
        dist.all_reduce(partial, group=self.group)
        return partial

    def columns(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's share of the last dim of a tensor every rank holds whole."""
        width = whole.shape[-1] // self.size
        return whole[..., self.rank * width:(self.rank + 1) * width]

    def gather(self, part: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``part`` concatenated along ``dim``, in rank order."""
        parts = [torch.empty_like(part) for _ in range(self.size)]
        dist.all_gather(parts, part.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The rows of a vocab-sharded table: each rank looks up the tokens
        in its range (zeros elsewhere), and the ranks' rows are summed."""
        rows = table.shape[0]
        local = tokens - self.rank * rows
        inside = (local >= 0) & (local < rows)
        x = table[torch.where(inside, local, torch.zeros_like(local))]
        return self.reduce(torch.where(inside[..., None], x, torch.zeros_like(x)))


def shard_llama_params(model: nn.Module, mesh: DeviceMesh, axis: str = "model") -> nn.Module:
    """Make ``model`` (a ``LlamaLM``) compute tensor-parallel over ``mesh``'s
    ``axis``, in place, and return it.

    JAX returns a sharded parameter tree for ``model.apply``; the port's
    models carry their weights (the serving engine takes a model and no
    params), so here each parameter of :func:`llama_tp_specs` ``Shard(d)``
    is replaced by this rank's chunk of dim ``d``, the blocks take their
    rank's head counts, and the model's forward gathers the logits (and
    any attentions asked for) whole. A KV cache made after this
    (``init_cache``) holds the rank's heads. Every rank of the axis must
    run the same calls. The numbers of heads and KV heads, the hidden dim
    and the vocabulary must divide by the axis's size: otherwise a
    ``ValueError`` names the dimension.
    """
    if getattr(model, "tp", None) is not None:
        raise ValueError("the model is tensor-parallel already")
    n, rank = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
    for what in ("num_heads", "num_kv_heads", "hidden_dim", "vocab_size"):
        if getattr(model, what) % n:
            raise ValueError(f"{what}={getattr(model, what)} does not divide by the {axis} axis ({n})")
    for name, placement in llama_tp_specs(model).items():
        if isinstance(placement, Shard):
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner)
            whole = getattr(module, leaf)
            part = torch.chunk(whole.detach(), n, dim=placement.dim)[rank]
            setattr(module, leaf, nn.Parameter(part.clone(memory_format=torch.contiguous_format),
                                               requires_grad=False))
    tp = TensorParallel(mesh.get_group(axis), n, rank)
    for block in model.blocks():
        block.num_heads //= n
        block.num_kv_heads //= n
        block.tp = tp
    model.tp = tp
    return model
