"""ResNet family with built-in feature taps, in PyTorch.

Counterpart of ``runia_core_tpu/models/resnet.py``. Every model returns
``(logits, taps)``, where the taps are NHWC as in the JAX package:

  - ``stem``, ``block1..block4``: post-stage feature maps (B, H, W, C)
  - ``pre_pool``: the last feature map (the LaREx hook point)
  - ``penultimate``: pooled features (B, C) feeding the head

Inputs are NHWC images. Inside, tensors are NCHW views; an NHWC input is
already ``channels_last`` in memory, so on the GPU the convolutions run
channels-last and the NHWC taps are contiguous views that cost no copy.

Padding follows XLA's "SAME" rule, as flax does: for a stride-2 3x3 conv or
max-pool on an even input it pads (0, 1), not (1, 1). ``torch_padding=True``
keeps the symmetric k//2 padding of torchvision checkpoints.

Module and parameter names match the flax tree (``conv_init``, ``bn_init``,
``stage{i}_block{j}.Conv_c`` / ``BatchNorm_c`` / ``conv_proj`` /
``norm_proj``, ``head``), so ``models/convert.py`` maps one onto the other.

As in the JAX package: ``s2d_stem`` runs the 7x7/2 stem as a 4x4/1 conv
over the space-to-depth input (convert a 7x7 state with
:func:`stem_to_s2d`); ``output_stride`` trades the later stages' stride 2
for dilation (dilated backbones); ``remat`` recomputes each block in the
backward pass (``torch.utils.checkpoint``). In training mode
(``model.train()``) :class:`BatchNorm` is flax's: it normalises with the
batch's biased variance and moves the running statistics as
``0.9 * running + 0.1 * batch``.

Where XLA fuses each norm, residual add and ReLU into one loop over the
conv's output, the port does so with the conv-norm epilogue
(``ops/conv_epilogue.py``, a hand-written CUDA kernel) on the parameters
prepared once (:func:`_prepared`): each conv's kernel in the compute dtype,
each norm's f32 scale and shift, the head in the compute dtype. It serves a
call that records no gradient, of a module in ``eval()``, on a CUDA
channels_last map, whose convs and norms no forward hook watches
(:func:`_epilogue_serves`); every other call (the CPU, training,
``remat``, an input-gradient baseline, a tapped conv or norm) runs the
modules one by one.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from functools import partial
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules import module as _module_hooks
from torch.utils.checkpoint import checkpoint

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.ops import conv_epilogue as epilogue
from runia_core_tpu_torch.utils.graphs import current_graph

__all__ = [
    "BatchNorm",
    "BottleneckResNetBlock",
    "Conv",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNetBlock",
    "SimpleConvNet",
    "build_tapped_forward",
    "same_padding",
    "space_to_depth_2x2",
    "stem_to_s2d",
]


def same_padding(size: int, kernel: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """(low, high) padding of XLA "SAME" along one spatial dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def space_to_depth_2x2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C): each 2x2 pixel block becomes one
    position whose channels are ordered (row parity, column parity,
    channel), the layout :func:`stem_to_s2d`'s kernel contracts against."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def stem_to_s2d(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A 7x7/2-stem state_dict in the ``s2d_stem=True`` layout: the (O, C, 7,
    7) kernel zero-padded to 8x8 at the leading row and column and regrouped
    into (O, 4C, 4, 4), input channels in :func:`space_to_depth_2x2`'s order.
    The converted model's outputs equal the original's up to the order of
    the sums. Every other entry is passed through."""
    w = state_dict["conv_init.weight"]
    cout, cin, kh, kw = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 stem kernel, got {tuple(w.shape)}")
    w = F.pad(w.permute(2, 3, 1, 0), (0, 0, 0, 0, 1, 0, 1, 0))  # HWIO, (8, 8, C, O)
    w = w.reshape(4, 2, 4, 2, cin, cout).permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * cin, cout)
    return {**state_dict, "conv_init.weight": w.permute(3, 2, 0, 1).contiguous()}


def _current(stamp, sources: Sequence[torch.Tensor]) -> bool:
    return len(stamp) == len(sources) and all(
        ref() is t and version == t._version and ptr == t.data_ptr() for (ref, version, ptr), t in zip(stamp, sources))


def _prepared(owner: nn.Module, key, sources: Sequence[torch.Tensor], make: Callable[[], object]):
    """``make()``, kept on ``owner`` for ``key`` (the compute dtype) and made
    again when a source is replaced, edited in place or moved (its object,
    held weakly, its ``_version`` or its storage). An edit through
    ``.data``, which keeps the tensor's version, is not seen: edit under
    ``torch.no_grad()``. For calls that record no gradient.

    Nothing is kept from inside a stream capture, whose kernels have not run
    yet: :class:`CudaGraph`'s warm-up calls make the copy. A graph being
    warmed up or captured holds what it read (``workspaces``), so a copy
    made later for new weights leaves it reading the old one, as a jitted
    JAX program keeps the constants it closed over; a ``ProgramCache``
    drops such a graph when it builds one over the new copy."""
    kept = owner.__dict__.setdefault("_prepared", {})
    entry = kept.get(key)
    if entry is not None and _current(entry[0], sources):
        value = entry[1]
    else:
        value = make()
        if not (sources[0].is_cuda and torch.cuda.is_current_stream_capturing()):
            kept[key] = (tuple((weakref.ref(t), t._version, t.data_ptr()) for t in sources), value)
    graph = current_graph()
    if graph is not None:
        graph.workspaces[("prepared", id(owner), key)] = value
    return value


class _KeepsPrepared:
    """A module whose :func:`_prepared` copies go when it is moved or cast,
    and are not pickled or copied with it."""

    def _apply(self, fn, *args, **kwargs):
        self.__dict__.pop("_prepared", None)
        return super()._apply(fn, *args, **kwargs)

    def __getstate__(self):
        state = dict(super().__getstate__())
        state.pop("_prepared", None)
        return state


class Conv(_KeepsPrepared, nn.Conv2d):
    """Bias-free convolution with XLA "SAME" padding (``padding="SAME"``), a
    fixed symmetric padding (an int) or explicit ``((top, bottom), (left,
    right))``. Computes in the input's dtype, with the kernel ``weight``
    where given (:meth:`prepared`), else the parameter cast."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int = 1,
                 dilation: int = 1, padding="SAME"):
        super().__init__(in_features, features, kernel, stride, padding=0, dilation=dilation, bias=False)
        self.same = padding == "SAME"
        self.explicit = None if self.same or isinstance(padding, int) else tuple(map(tuple, padding))
        self.fixed_padding = padding if isinstance(padding, int) else 0

    def prepared(self, dtype: torch.dtype) -> torch.Tensor:
        """The kernel in ``dtype``, channels_last, made once per version of
        the weight (:func:`_prepared`)."""
        return _prepared(self, dtype, (self.weight,),
                         lambda: self.weight.detach().to(dtype=dtype, memory_format=torch.channels_last, copy=True))

    def forward(self, x: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        padding = self.fixed_padding
        if self.explicit is not None:
            (h_lo, h_hi), (w_lo, w_hi) = self.explicit
            x = F.pad(x, (w_lo, w_hi, h_lo, h_hi))
        elif self.same:
            (h_lo, h_hi), (w_lo, w_hi) = (
                same_padding(size, self.kernel_size[0], self.stride[0], self.dilation[0])
                for size in x.shape[2:]
            )
            if (h_lo, w_lo) == (h_hi, w_hi):
                padding = (h_lo, w_lo)
            else:
                x = F.pad(x, (w_lo, w_hi, h_lo, h_hi))
                padding = 0
        weight = self.weight.to(x.dtype) if weight is None else weight
        return F.conv2d(x, weight, None, self.stride, padding, self.dilation)


def _padding_rule(torch_padding: bool) -> Callable[..., object]:
    """(kernel size, dilation) -> the ``padding`` argument of :class:`Conv`."""
    return (lambda k, d=1: d * (k // 2)) if torch_padding else (lambda k, d=1: "SAME")


class BatchNorm(_KeepsPrepared, nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW.

    Inference (``eval()``): ``x * s + (bias - mean * s)`` with
    ``s = scale * rsqrt(var + eps)`` folded in f32, one elementwise pass.
    Training (``train()``): the batch's f32 mean and biased variance
    (``E[x^2] - E[x]^2`` clipped at 0, flax's fast variance) normalise, and
    the running statistics become ``0.9 * running + 0.1 * batch``, the
    biased variance included; ``F.batch_norm`` would store the unbiased one
    with weight 0.1 on the old value. ``frozen`` keeps the running
    statistics as they are (a block recomputed for its backward pass)."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.frozen = False
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train_forward(x)
        scale, shift = self._fold()
        return torch.addcmul(shift.to(x.dtype)[:, None, None], x, scale.to(x.dtype)[:, None, None])

    def _fold(self) -> Tuple[torch.Tensor, torch.Tensor]:
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        return scale, self.bias - self.running_mean * scale

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The f32 ``(s, bias - mean * s)`` of inference, made once per
        version of the norm's tensors (:func:`_prepared`)."""
        return _prepared(self, self.eps, (self.weight, self.bias, self.running_mean, self.running_var),
                         lambda: tuple(t.detach() for t in self._fold()))

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=(0, 2, 3))
        var = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        if not self.frozen:
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var + (1 - self.momentum) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


@contextlib.contextmanager
def _frozen_statistics(module: nn.Module):
    """Every BatchNorm in ``module`` keeps its running statistics inside the
    block: a recomputation for the backward pass moves them no second time
    (flax's ``nn.remat`` recomputes without writing ``batch_stats``)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for norm in norms:
        norm.frozen = True
    try:
        yield
    finally:
        for norm in norms:
            norm.frozen = False


def _epilogue_serves(module: nn.Module, x: torch.Tensor, channels: Sequence[int], parts: Sequence[nn.Module]) -> bool:
    """True if the prepared parameters and the conv-norm epilogue serve a
    call of ``module`` on ``x`` whose convs give ``channels`` channels: the
    module in ``eval()``, no gradient recorded, a map the epilogue's kernel
    reads (``ops/conv_epilogue.py::serves``), and no forward hook on the
    convs and norms ``parts`` nor one registered for all modules (the
    epilogue calls no norm and rewrites its conv's output, so a hook there
    would see another tensor than the modules give it)."""
    return (not module.training and not torch.is_grad_enabled() and epilogue.serves(x, channels)
            and not (_module_hooks._global_forward_hooks or _module_hooks._global_forward_pre_hooks)
            and not any(m._forward_hooks or m._forward_pre_hooks for m in parts))


def _conv_epilogue(conv: Conv, norm: BatchNorm, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                   proj_norm: Optional[BatchNorm] = None) -> torch.Tensor:
    """``relu(norm(conv(x)) [+ residual | + proj_norm(residual)])``: ``conv``
    on its prepared kernel, then one epilogue pass over its output."""
    y = conv(x, conv.prepared(x.dtype)).contiguous(memory_format=torch.channels_last)
    scale, shift = norm.affine()
    scale_p, shift_p = (None, None) if proj_norm is None else proj_norm.affine()
    if residual is not None:
        residual = residual.contiguous(memory_format=torch.channels_last)
    return epilogue.conv_epilogue(y, scale, shift, residual, scale_p, shift_p)


def _block_end(block: nn.Module, conv: Conv, norm: BatchNorm, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A block's last conv over ``y`` with its residual, the block input
    ``x`` or its projection, in one epilogue pass."""
    if block.has_proj:
        proj = block.conv_proj
        return _conv_epilogue(conv, norm, y, proj(x, proj.prepared(x.dtype)), block.norm_proj)
    return _conv_epilogue(conv, norm, y, x)


class ResNetBlock(nn.Module):
    """Basic residual block (two 3x3 convs, both dilated by ``dilation``)."""

    expansion = 1

    def __init__(self, in_features: int, filters: int, stride: int = 1, torch_padding: bool = False,
                 dilation: int = 1):
        super().__init__()
        pad = _padding_rule(torch_padding)
        self.Conv_0 = Conv(in_features, filters, 3, stride, dilation, padding=pad(3, dilation))
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, dilation=dilation, padding=pad(3, dilation))
        self.BatchNorm_1 = BatchNorm(filters)
        self.has_proj = stride != 1 or in_features != filters
        if self.has_proj:
            self.conv_proj = Conv(in_features, filters, 1, stride, padding=pad(1))
            self.norm_proj = BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _epilogue_serves(self, x, (self.Conv_1.out_channels,), tuple(self.children())):
            y = _conv_epilogue(self.Conv_0, self.BatchNorm_0, x)
            return _block_end(self, self.Conv_1, self.BatchNorm_1, y, x)
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.has_proj else x
        return torch.relu(residual + y)


class BottleneckResNetBlock(nn.Module):
    """Bottleneck residual block (1x1 -> 3x3 -> 1x1), stride and dilation on
    the 3x3."""

    expansion = 4

    def __init__(self, in_features: int, filters: int, stride: int = 1, torch_padding: bool = False,
                 dilation: int = 1):
        super().__init__()
        pad = _padding_rule(torch_padding)
        self.Conv_0 = Conv(in_features, filters, 1, padding=pad(1))
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, stride, dilation, padding=pad(3, dilation))
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, filters * 4, 1, padding=pad(1))
        self.BatchNorm_2 = BatchNorm(filters * 4)
        self.has_proj = stride != 1 or in_features != filters * 4
        if self.has_proj:
            self.conv_proj = Conv(in_features, filters * 4, 1, stride, padding=pad(1))
            self.norm_proj = BatchNorm(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _epilogue_serves(self, x, (self.Conv_0.out_channels, self.Conv_2.out_channels), tuple(self.children())):
            y = _conv_epilogue(self.Conv_0, self.BatchNorm_0, x)
            y = _conv_epilogue(self.Conv_1, self.BatchNorm_1, y)
            return _block_end(self, self.Conv_2, self.BatchNorm_2, y, x)
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.has_proj else x
        return torch.relu(residual + y)


class ResNet(_KeepsPrepared, nn.Module):
    """ResNet with taps; NHWC in and out; computes in ``dtype`` while the
    parameters stay f32 (as flax's ``dtype`` / ``param_dtype``). They are
    made on ``device``: None is ``runia_core_tpu_torch.default_device()``,
    the GPU. ``ResNet18``, ``ResNet34`` and ``ResNet50`` pass it through.

    ``output_stride`` (None: stride 32, or 8 with the CIFAR stem): once the
    stride reached it, a stage's first block keeps the resolution at the
    running dilation and its later blocks run at twice that (torchvision's
    rule, as the JAX package). ``s2d_stem`` (ignored with ``cifar_stem``):
    the 7x7/2 stem as a 4x4/1 conv with (2, 1) padding over
    :func:`space_to_depth_2x2` of the input. ``remat``: while gradients are
    recorded, each block runs under ``torch.utils.checkpoint`` and is
    recomputed in the backward pass, its batch-norm statistics moved once.
    A new model is in ``eval()`` mode; ``train()`` selects batch statistics.

    A call that records no gradient, in ``eval()``, on a CUDA NHWC batch
    runs each conv's norm, residual and ReLU as one epilogue pass over
    parameters prepared once per weights version (the module docstring).
    A CUDA graph captured over the model reads the prepared copy it found at
    capture, as a jitted JAX program holds the constants it closed over:
    after an edit of the weights, build the graph (the scorer) again. A
    scorer's ``ProgramCache`` drops its graphs over an older copy when it
    captures one over a newer. An edit through ``.data`` is not seen (edit
    under ``torch.no_grad()``)."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls: type,
        num_classes: int,
        num_filters: int = 64,
        cifar_stem: bool = False,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        output_stride: Optional[int] = None,
        include_head: bool = True,
        torch_padding: bool = False,
        s2d_stem: bool = False,
        in_channels: int = 3,
        device=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.cifar_stem = cifar_stem
        self.remat = remat
        self.output_stride = output_stride
        self.include_head = include_head
        self.torch_padding = torch_padding
        self.s2d_stem = s2d_stem and not cifar_stem
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls = block_cls
        pad = _padding_rule(torch_padding)
        # Every parameter and buffer is made on ``device`` (None: the GPU).
        with torch.device(default_device() if device is None else device):
            if cifar_stem:
                self.conv_init = Conv(in_channels, num_filters, 3, padding=pad(3))
            elif self.s2d_stem:
                self.conv_init = Conv(4 * in_channels, num_filters, 4, padding=((2, 1), (2, 1)))
            else:
                self.conv_init = Conv(in_channels, num_filters, 7, 2, padding=3)
            self.bn_init = BatchNorm(num_filters)
            features = num_filters
            cum_stride, dilation = (1 if cifar_stem else 4), 1
            for i, size in enumerate(self.stage_sizes):
                for j in range(size):
                    stride, block_dilation = 1, dilation
                    if i > 0 and j == 0:
                        if output_stride is not None and cum_stride >= output_stride:
                            dilation *= 2
                        else:
                            stride, cum_stride = 2, cum_stride * 2
                    filters = num_filters * 2**i
                    block = block_cls(features, filters, stride, torch_padding, block_dilation)
                    self.add_module(f"stage{i + 1}_block{j}", block)
                    features = filters * block_cls.expansion
            if include_head:
                self.head = nn.Linear(features, num_classes)
        self.eval()  # flax's default call is train=False: running statistics

    def _max_pool(self, x: torch.Tensor) -> torch.Tensor:
        if self.torch_padding:
            return F.max_pool2d(x, 3, 2, padding=1)
        (h_lo, h_hi), (w_lo, w_hi) = (same_padding(size, 3, 2) for size in x.shape[2:])
        return F.max_pool2d(F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=-math.inf), 3, 2)

    def _block(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(), _frozen_statistics(block)))
        return block(x)

    def forward(self, images: torch.Tensor) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
        images = images.to(self.dtype)
        if self.s2d_stem:
            images = space_to_depth_2x2(images)
        x = images.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        taps: Dict[str, torch.Tensor] = {}
        prepared = _epilogue_serves(self, x, (self.conv_init.out_channels,), (self.conv_init, self.bn_init))
        if prepared:
            x = _conv_epilogue(self.conv_init, self.bn_init, x)
        else:
            x = torch.relu(self.bn_init(self.conv_init(x)))
        if not self.cifar_stem:
            x = self._max_pool(x)
        taps["stem"] = x.permute(0, 2, 3, 1)
        for i, size in enumerate(self.stage_sizes):
            for j in range(size):
                x = self._block(getattr(self, f"stage{i + 1}_block{j}"), x)
            taps[f"block{i + 1}"] = x.permute(0, 2, 3, 1)
        taps["pre_pool"] = taps[f"block{len(self.stage_sizes)}"]
        x = x.mean(dim=(2, 3))
        taps["penultimate"] = x
        if not self.include_head:
            return None, taps
        head = self.head
        if prepared:
            weight, bias = _prepared(self, x.dtype, (head.weight, head.bias), lambda: (
                head.weight.detach().to(x.dtype, copy=True), head.bias.detach().to(x.dtype, copy=True)))
        else:
            weight, bias = head.weight.to(x.dtype), head.bias.to(x.dtype)
        return F.linear(x, weight, bias), taps

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "ResNet":
        """Seeded init mirroring flax's: lecun-normal conv and dense kernels
        (std 1/sqrt(fan_in); flax truncates at 2 std, this does not), batch
        norms at (scale 1, bias 0, mean 0, var 1), the last norm of every
        block at scale 0, the head bias at 0."""
        def normal(p: torch.Tensor, fan_in: int) -> None:
            noise = torch.randn(p.shape, generator=generator, device=p.device, dtype=p.dtype)
            p.copy_(noise / math.sqrt(fan_in))

        for module in self.modules():
            if isinstance(module, Conv):
                normal(module.weight, module.weight[0].numel())
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        for name, module in self.named_children():
            if name.startswith("stage"):
                last = module.BatchNorm_2 if hasattr(module, "BatchNorm_2") else module.BatchNorm_1
                last.weight.zero_()
        if self.include_head:
            normal(self.head.weight, self.head.weight.shape[1])
            self.head.bias.zero_()
        return self


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=ResNetBlock)
ResNet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=ResNetBlock)
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BottleneckResNetBlock)


class SimpleConvNet(nn.Module):
    """Two-conv classifier with taps, the JAX package's ``SimpleConvNet``
    (the reference's MNIST test fixture): 3x3 "SAME" convs with bias, ReLU,
    2x2 max-pools; NHWC in, ``pre_pool`` and ``penultimate`` taps. Module
    names follow the flax tree (``Conv_0``, ``Conv_1``, ``head``)."""

    def __init__(self, num_classes: int = 10, features: int = 32, in_channels: int = 3, device=None):
        super().__init__()
        with torch.device(default_device() if device is None else device):
            self.Conv_0 = nn.Conv2d(in_channels, features, 3, padding=1)
            self.Conv_1 = nn.Conv2d(features, features * 2, 3, padding=1)
            self.head = nn.Linear(features * 2, num_classes)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x = images.to(torch.float32).permute(0, 3, 1, 2)
        x = F.max_pool2d(torch.relu(self.Conv_0(x)), 2)
        x = F.max_pool2d(torch.relu(self.Conv_1(x)), 2)
        taps = {"pre_pool": x.permute(0, 2, 3, 1)}
        x = x.mean(dim=(2, 3))
        taps["penultimate"] = x
        return self.head(x), taps

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "SimpleConvNet":
        """Seeded init after flax's: lecun-normal kernels (std 1/sqrt(fan_in),
        untruncated), zero biases."""
        for module in (self.Conv_0, self.Conv_1, self.head):
            noise = torch.randn(module.weight.shape, generator=generator, device=module.weight.device)
            module.weight.copy_(noise / math.sqrt(module.weight[0].numel()))
            module.bias.zero_()
        return self


def build_tapped_forward(
    model: nn.Module, taps: Sequence[str] = ("pre_pool",), channel_first_taps: bool = False
) -> Callable:
    """Forward returning (logits, {tap: tensor}) for the requested taps only,
    under ``torch.inference_mode``. With ``channel_first_taps`` the 4-D taps
    come out NCHW."""
    wanted = tuple(taps)

    @torch.inference_mode()
    def forward(images: torch.Tensor):
        logits, all_taps = model(images)
        out = {}
        for name in wanted:
            t = all_taps[name]
            out[name] = t.permute(0, 3, 1, 2) if channel_first_taps and t.ndim == 4 else t
        return logits, out

    return forward
