"""Fully-sharded data parallelism (ZeRO-3) on ``torch.distributed``.

Counterpart of ``runia_core_tpu/parallel/fsdp.py``. Every parameter above
a size threshold and its two Adam moments are sharded over the ``data``
axis (each rank holds 1/N of every large tensor), as DTensors placed by
:func:`fsdp_spec`. A step gathers the parameters for the forward
(``full_tensor()``), runs forward and backward on the rank's rows,
reduce-scatters each gradient to its parameter's placement (a replicated
one is all-reduced) and runs JAX's bias-corrected Adam on the local
shards: the FSDP schedule that GSPMD derives from the shardings, written
out. (FSDP2's ``fully_shard`` shards every parameter and reduces no
gradient of an ignored one, so it cannot keep the small leaves
replicated.)
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard, distribute_tensor

from runia_core_tpu_torch.parallel.mesh import _mesh_device, local_rows

__all__ = ["fsdp_spec", "fsdp_shard_params", "fsdp_train_step"]


def fsdp_spec(leaf: torch.Tensor, n_shards: int, min_size: int = 2**14) -> Placement:
    """The ``data`` axis placement of ``leaf``: ``Shard`` of its largest dim
    that divides by ``n_shards``; ``Replicate`` for a leaf under
    ``min_size`` elements (norm scales, biases: gathering them costs more
    latency than they save memory) or with no such dim."""
    if leaf.ndim == 0 or leaf.numel() < min_size:
        return Replicate()
    for d in sorted(range(leaf.ndim), key=lambda d: leaf.shape[d], reverse=True):
        if leaf.shape[d] % n_shards == 0:
            return Shard(d)
    return Replicate()


def _placements(mesh: DeviceMesh, on_data: Placement) -> list:
    return [on_data if name == "data" else Replicate() for name in mesh.mesh_dim_names]


def fsdp_shard_params(params: Dict[str, torch.Tensor], mesh: DeviceMesh,
                      min_size: int = 2**14) -> Dict[str, DTensor]:
    """Each parameter (name -> tensor, every rank holding the same) as a
    DTensor placed on ``mesh`` by its :func:`fsdp_spec` over ``data`` and
    replicated over the other axes."""
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    dev = _mesh_device(mesh)
    return {name: distribute_tensor(p.detach().to(dev), mesh, _placements(mesh, fsdp_spec(p, n, min_size)))
            for name, p in params.items()}


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Dict[str, torch.Tensor]  # placed as the parameters
    nu: Dict[str, torch.Tensor]


class _Trainable(nn.Module):
    """``model`` called through its ``differentiable_forward`` where it has
    one (the port's language models run inference under ``no_grad``)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return getattr(self.model, "differentiable_forward", self.model)(*args, **kwargs)


def fsdp_train_step(
    model: nn.Module,
    mesh: DeviceMesh,
    learning_rate: float = 1e-3,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    min_size: int = 2**14,
    extra_variables: Optional[Dict[str, torch.Tensor]] = None,
    task: str = "classifier",
    loss_fn: Optional[Callable] = None,
) -> Callable:
    """An Adam training step with FSDP parameter and optimizer sharding.

    ``task`` picks the loss: ``"classifier"`` (images, int labels; the
    model in eval mode, as the JAX step applies it) or ``"causal_lm"`` (a
    token batch, its own shifted target: ``step(params, opt, tokens,
    tokens)``; the model's LM flags ask for no attentions and no hiddens).
    ``loss_fn(model_output, labels) -> scalar`` overrides both; it sees a
    rank's rows, and the step averages it over the ``data`` ranks (equal
    shards), which is the whole batch's loss for a mean over rows.
    ``extra_variables``: buffers (state_dict names) loaded into the model
    before each step, flax's non-param collections.

    Returns:
        ``step(params, opt_state, inputs, labels) -> (params, opt_state,
        loss)``: ``params`` the dict ``step.shard_params(dict(
        model.named_parameters()))`` gives (or whole tensors, held
        replicated), ``opt_state`` from ``step.init_opt(params)`` (zero
        moments placed as the parameters), ``inputs`` and ``labels`` whole
        batches or :func:`shard_batch` DTensors whose rows divide by the
        ``data`` axis. The loss is the whole batch's, on every rank.
    """
    if task not in ("classifier", "causal_lm"):
        raise ValueError(f"task {task!r}")
    b1, b2 = betas
    trainable = _Trainable(model)
    data_group = mesh.get_group("data")
    n_data = mesh.size(mesh.mesh_dim_names.index("data"))
    partial = [Partial() if name == "data" else Replicate() for name in mesh.mesh_dim_names]

    def init_opt(params) -> AdamState:
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=_mesh_device(mesh)),
                         mu={n: torch.zeros_like(p) for n, p in params.items()},
                         nu={n: torch.zeros_like(p) for n, p in params.items()})

    def objective(out, labels):
        if loss_fn is not None:
            return loss_fn(out, labels)
        logits = out[0] if isinstance(out, tuple) else out
        if task == "causal_lm":
            logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
            return -logp.gather(2, labels[:, 1:, None].to(torch.int64)).mean()
        return -F.log_softmax(logits.float(), dim=-1).gather(1, labels[:, None].to(torch.int64)).mean()

    def step(params: Dict[str, torch.Tensor], opt_state: AdamState, inputs, labels):
        if inputs.shape[0] % n_data:
            raise ValueError(f"a batch of {inputs.shape[0]} rows does not divide over data={n_data}")
        if extra_variables:
            model.load_state_dict(extra_variables, strict=False)
        model.eval()
        x, y = local_rows(inputs, mesh), local_rows(labels, mesh)
        full = {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach().requires_grad_(True)
                for n, p in params.items()}
        kwargs = {"need_attentions": False, "need_hiddens": False} if task == "causal_lm" and loss_fn is None else {}
        with torch.enable_grad():
            out = torch.func.functional_call(trainable, {f"model.{n}": p for n, p in full.items()}, (x,), kwargs)
            loss = objective(out, y) / n_data
            grads = torch.autograd.grad(loss, list(full.values()))
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=data_group)
        t = opt_state.step + 1
        tf = t.to(torch.float32)
        new_params, new_mu, new_nu = {}, {}, {}
        for (name, p), g in zip(params.items(), grads):
            sharded = isinstance(p, DTensor)
            placements = p.placements if sharded else _placements(mesh, Replicate())
            # Each rank's gradient is its rows' part of the sum: reduce it to the leaf's placement.
            g = DTensor.from_local(g, mesh, partial, run_check=False).redistribute(mesh, placements).to_local()
            m = b1 * _local(opt_state.mu[name]) + (1 - b1) * g
            v = b2 * _local(opt_state.nu[name]) + (1 - b2) * g.square()
            mhat, vhat = m / (1 - b1**tf), v / (1 - b2**tf)
            new = _local(p).detach() - learning_rate * mhat / (vhat.sqrt() + eps)
            if sharded:
                new, m, v = (DTensor.from_local(a, mesh, placements, run_check=False) for a in (new, m, v))
            new_params[name], new_mu[name], new_nu[name] = new, m, v
        return new_params, AdamState(step=t, mu=new_mu, nu=new_nu), loss

    step.shard_params = lambda params: fsdp_shard_params(params, mesh, min_size)
    step.init_opt = init_opt
    return step
