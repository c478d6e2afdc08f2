"""Device meshes and sharded execution helpers on ``torch.distributed``.

Counterpart of ``runia_core_tpu/parallel/mesh.py``. The JAX package builds a
``jax.sharding.Mesh`` over the chips of one program and lets XLA insert the
collectives; here one process drives one GPU, the processes form a
``torch.distributed`` world (NCCL on the GPU, gloo on the CPU), and the
``(data, model)`` mesh is a ``DeviceMesh`` whose dimensions each own a
process group. Axes:

  - ``data``: batch/data parallelism; every detector's ``score`` is a pure
    function of (state, batch), so DP is free;
  - ``model``: tensor parallelism for wide layers (the classifier head here;
    a train bank sharded for ``ops.knn.sharded_kth_neighbor``).

A batch placed with :func:`shard_batch` is a DTensor sharded over ``data``
(``Shard(0)``) and replicated over ``model``, so it keeps a global view as a
``NamedSharding`` does; a rank's own rows are its ``to_local()``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from runia_core_tpu_torch.utils.tree import tree_map

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "shard_batch",
    "replicate",
    "sharded_train_step",
]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: Optional[str] = None,
) -> int:
    """Join a multi-process world and return its device count.

    JAX runs one process per host, which sees every chip of that host; the
    port runs one process per GPU, so ``num_processes`` counts GPUs and
    ``process_id`` is this process's rank. With ``num_processes > 1`` this
    calls ``init_process_group`` (NCCL, and this rank's GPU made current, on
    ``device_type`` "cuda", the default; gloo on "cpu") with
    ``coordinator_address`` as its rendezvous (``host:port`` or a
    ``tcp://`` / ``file://`` URL). Otherwise it joins nothing. Returns the
    world size: the number of devices the mesh can span (1 for a single
    process that is in no group).
    """
    if num_processes is not None and num_processes > 1 and not dist.is_initialized():
        if coordinator_address is None or process_id is None:
            raise ValueError("a multi-process world needs coordinator_address and process_id")
        device_type = device_type or "cuda"
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        if device_type == "cuda":
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method=init_method,
                                world_size=num_processes, rank=process_id)
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    axis_names: Tuple[str, str] = ("data", "model"),
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """A (data, model) ``DeviceMesh`` over the first ``n_devices`` ranks of
    the world (None: all of them), on the GPU unless ``device_type="cpu"``.

    The world must exist (:func:`initialize_distributed`, or
    ``init_process_group``; a single process makes a world of 1 with its own
    group). A world smaller than ``n_devices`` raises: the JAX package falls
    back to the CPU's virtual devices there, the port never does.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed world: call initialize_distributed "
                           "(or init_process_group) first")
    world = dist.get_world_size()
    n_devices = world if n_devices is None else n_devices
    if world < n_devices:
        raise ValueError(f"need {n_devices} devices, the world has {world}")
    if model_parallel < 1 or n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by model_parallel={model_parallel}")
    grid = torch.arange(n_devices).reshape(n_devices // model_parallel, model_parallel)
    return DeviceMesh(device_type or "cuda", grid, mesh_dim_names=tuple(axis_names))


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_rows(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """This rank's rows of a batch: a DTensor's local shard, or of a whole
    batch that every rank holds, its ``torch.chunk`` over ``axis`` (the
    rows ``Shard(0)`` gives it)."""
    if isinstance(x, DTensor):
        return x.to_local()
    return torch.chunk(x, mesh.size(mesh.mesh_dim_names.index(axis)), dim=0)[mesh.get_local_rank(axis)]


def shard_batch(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> DTensor:
    """Place a batch with its leading dim sharded across the ``axis``
    dimension (rank 0's copy is scattered) and replicated across the
    others."""
    placements = [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]
    return distribute_tensor(x.to(_mesh_device(mesh)), mesh, placements)


def replicate(tree, mesh: DeviceMesh):
    """Fully replicate every tensor of a dict / list / tuple across the mesh
    (rank 0's copy is broadcast)."""
    placements = [Replicate()] * mesh.ndim
    return tree_map(lambda t: distribute_tensor(t.to(_mesh_device(mesh)), mesh, placements), tree)


class _ToModelShards(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``:
    each rank's head columns give only their part of it (a column-parallel
    linear layer's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherColumns(torch.autograd.Function):
    """All-gather of each rank's logit columns into the full row; the
    backward hands each rank its own columns' gradient. The loss after it
    is computed alike on every rank of ``group``, so the gradients are not
    summed (``torch.distributed.nn.functional.all_gather`` would sum them,
    scaling them by the group's size)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.rank * ctx.width:(ctx.rank + 1) * ctx.width].contiguous(), None


class _SumReplicated(torch.autograd.Function):
    """All-reduce (sum) of each rank's partial value over ``group`` into one
    that every rank holds alike. The backward is the identity: whatever
    follows is computed alike on every rank of ``group``, so each partial's
    gradient is the sum's (the transpose of a sum into a replicated value;
    ``torch.distributed.nn.functional.all_reduce`` would sum the gradients
    too, scaling them by the group's size)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _ring_shift(tensors, group, step: int = 1) -> list:
    """Each rank of ``group`` sends ``tensors`` to the rank ``step`` after it
    on the ring and returns those of the rank ``step`` before it, in one
    ``batch_isend_irecv`` (JAX's ``ppermute``). A ring of one sends nothing:
    NCCL cannot send to its own rank, and the permutation is the identity."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    me = dist.get_rank(group)
    dst, src = dist.get_global_rank(group, (me + step) % n), dist.get_global_rank(group, (me - step) % n)
    sent = [t.contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in sent]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in sent] + [dist.P2POp(dist.irecv, t, src, group)
                                                                    for t in received]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return received


def sharded_train_step(
    model: torch.nn.Module,
    mesh: DeviceMesh,
    learning_rate: float = 1e-3,
    head_path: Tuple[str, ...] = ("head", "weight"),
    extra_variables: Optional[Dict[str, torch.Tensor]] = None,
) -> Callable:
    """One SGD step with dp (batch) + tp (head) sharding.

    The step minimises the whole batch's mean cross-entropy, with the model
    in eval mode (the JAX step calls the model with ``train=False``). Each
    rank takes its ``data`` rows. The head's weight (``head_path``, (C, d);
    the JAX kernel's columns are its rows) is split by rows over ``model``:
    a rank computes its logit columns from the ``penultimate`` tap, the
    columns are all-gathered (``_GatherColumns``) and the replicated bias
    added; the tap's gradient is summed over ``model``
    (``_ToModelShards``). Gradients are summed over ``data`` (each rank's
    loss is its rows' sum over the global batch size). The port's ResNet
    applies its head with ``F.linear`` on the head's weight, so a
    ``ColwiseParallel`` plan's module hooks would never fire; the head is
    sharded here by hand.

    ``extra_variables``: buffers (state_dict names) loaded into the model
    before each step, the counterpart of flax's non-param collections; None
    uses the model's own.

    Returns:
        ``step(params, images, labels) -> (params, loss)``; ``params`` is
        the dict ``step.shard_params(dict(model.named_parameters()))``
        gives (the head's rows local, the rest replicated), ``images`` and
        ``labels`` whole batches or :func:`shard_batch` DTensors.
    """
    head_name = ".".join(head_path)
    bias_name = f"{head_path[0]}.bias" if len(head_path) > 1 else None
    data_group, model_group = mesh.get_group("data"), mesh.get_group("model")
    mp, mp_rank = mesh.size(mesh.mesh_dim_names.index("model")), mesh.get_local_rank("model")

    def shard_params(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for name, p in params.items():
            p = p.detach()
            if name == head_name and p.ndim == 2:
                if p.shape[0] % mp:
                    raise ValueError(f"{head_name} has {p.shape[0]} rows, not divisible by model={mp}")
                p = torch.chunk(p, mp, dim=0)[mp_rank]
            out[name] = p.clone()
        return out

    def step(params: Dict[str, torch.Tensor], images: torch.Tensor, labels: torch.Tensor):
        if extra_variables:
            model.load_state_dict(extra_variables, strict=False)
        model.eval()
        n_total = images.shape[0]
        x, y = local_rows(images, mesh), local_rows(labels, mesh)
        leaves = {name: p.detach().requires_grad_(True) for name, p in params.items()}
        body = {name: p for name, p in leaves.items() if name not in (head_name, bias_name)}
        with torch.enable_grad():
            _, taps = torch.func.functional_call(model, body, (x,), strict=False)
            pen = _ToModelShards.apply(taps["penultimate"], model_group)
            w = leaves[head_name]
            logits = _GatherColumns.apply(F.linear(pen, w.to(pen.dtype)), model_group)
            if bias_name in leaves:
                logits = logits + leaves[bias_name].to(logits.dtype)
            loss = F.cross_entropy(logits.float(), y.to(torch.int64), reduction="sum") / n_total
            grads = torch.autograd.grad(loss, list(leaves.values()))
        flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.detach().reshape(1)])
        dist.all_reduce(flat, group=data_group)
        new_params, offset = {}, 0
        for (name, p), g in zip(leaves.items(), grads):
            grad = flat[offset:offset + g.numel()].view_as(g).to(p.dtype)
            offset += g.numel()
            new_params[name] = (p - learning_rate * grad).detach()
        return new_params, flat[-1]

    step.shard_params = shard_params
    return step
