"""Plain ResNet forward, the benchmark's reference for the ResNet family.

He et al. 2016 (arXiv:1512.03385). Two stems: the CIFAR one (3x3/1 conv,
no max-pool; kuangliu/pytorch-cifar) and the ImageNet one (7x7/2 conv,
3x3/2 max-pool; torchvision's ``resnet50``, v1.5: the stride of a
bottleneck sits on its 3x3 conv). Padding is torchvision's symmetric
``k // 2``. Batch norm in inference form with running statistics, eps 1e-5.

Everything is plain ``torch`` in float32 (TF32 off) on NCHW tensors; the
module imports nothing of the program. ``quantize`` rounds every weight and
every tensor the forward stores (each convolution's input and output, each
norm, activation and residual sum, the pooled features and the logits) to a
lower precision, as a forward computed in that precision would: the
benchmark's control runs the same forward with an fp8 rounding there.

Parameter names follow the program's state dict (``conv_init``,
``bn_init``, ``stage{i}_block{j}.Conv_c`` / ``BatchNorm_c`` /
``conv_proj`` / ``norm_proj``, ``head``), so one set of seeded tensors
feeds both.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5
EXPANSION = {"basic": 1, "bottleneck": 4}


def _blocks(cfg: dict) -> Iterator[Tuple[str, int, int, int]]:
    """(prefix, in features, filters, stride) of every residual block."""
    features = cfg["num_filters"]
    for i, size in enumerate(cfg["stage_sizes"]):
        filters = cfg["num_filters"] * 2**i
        for j in range(size):
            stride = 2 if i > 0 and j == 0 else 1
            yield f"stage{i + 1}_block{j}", features, filters, stride
            features = filters * EXPANSION[cfg["block"]]


def _block_convs(cfg: dict, cin: int, filters: int, stride: int) -> List[Tuple[str, str, int, int, int, int]]:
    """(conv name, norm name, in, out, kernel, stride) of one block, the
    projection last; the last conv of the main branch is the one whose norm
    closes the branch."""
    if cfg["block"] == "basic":
        convs = [("Conv_0", "BatchNorm_0", cin, filters, 3, stride),
                 ("Conv_1", "BatchNorm_1", filters, filters, 3, 1)]
        out = filters
    else:
        convs = [("Conv_0", "BatchNorm_0", cin, filters, 1, 1),
                 ("Conv_1", "BatchNorm_1", filters, filters, 3, stride),
                 ("Conv_2", "BatchNorm_2", filters, filters * 4, 1, 1)]
        out = filters * 4
    if stride != 1 or cin != out:
        convs.append(("conv_proj", "norm_proj", cin, out, 1, stride))
    return convs


def _stem(cfg: dict) -> Tuple[int, int]:
    """(kernel, stride) of the stem convolution."""
    return (3, 1) if cfg["stem"] == "cifar" else (7, 2)


def features(cfg: dict) -> int:
    return cfg["num_filters"] * 2 ** (len(cfg["stage_sizes"]) - 1) * EXPANSION[cfg["block"]]


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter and statistic. Kinds:
    ``conv`` (fan-in from the shape), ``norm_scale``, ``norm_scale_last``
    (the norm that closes a residual branch), ``norm_bias``, ``norm_mean``,
    ``norm_var``, ``head_weight``, ``head_bias``."""
    specs: List[Tuple[str, Tuple[int, ...], str]] = []

    def norm(name: str, width: int, last: bool) -> None:
        specs.extend([
            (f"{name}.weight", (width,), "norm_scale_last" if last else "norm_scale"),
            (f"{name}.bias", (width,), "norm_bias"),
            (f"{name}.running_mean", (width,), "norm_mean"),
            (f"{name}.running_var", (width,), "norm_var"),
        ])

    k, _ = _stem(cfg)
    specs.append(("conv_init.weight", (cfg["num_filters"], cfg["channels"], k, k), "conv"))
    norm("bn_init", cfg["num_filters"], False)
    last_conv = "Conv_1" if cfg["block"] == "basic" else "Conv_2"
    for prefix, cin, filters, stride in _blocks(cfg):
        for conv, bn, c_in, c_out, kernel, _ in _block_convs(cfg, cin, filters, stride):
            specs.append((f"{prefix}.{conv}.weight", (c_out, c_in, kernel, kernel), "conv"))
            norm(f"{prefix}.{bn}", c_out, conv == last_conv)
    specs.append(("head.weight", (cfg["num_classes"], features(cfg)), "head_weight"))
    specs.append(("head.bias", (cfg["num_classes"],), "head_bias"))
    return specs


def parameter_count(cfg: dict) -> int:
    """Trainable parameters (running statistics left out)."""
    total = 0
    for _, shape, kind in param_specs(cfg):
        if kind not in ("norm_mean", "norm_var"):
            n = 1
            for s in shape:
                n *= s
            total += n
    return total


def layer_shapes(cfg: dict) -> List[dict]:
    """Every convolution and the head with its output size: what the
    multiply-add count is taken from."""
    size = cfg["image_size"]
    k, s = _stem(cfg)
    size = (size + 2 * (k // 2) - k) // s + 1
    layers = [dict(name="conv_init", cin=cfg["channels"], cout=cfg["num_filters"], k=k, h=size, w=size)]
    if cfg["stem"] != "cifar":
        size = (size + 2 - 3) // 2 + 1
    for prefix, cin, filters, stride in _blocks(cfg):
        branch = size  # the main branch's running size; the projection reads the block's input
        for conv, _, c_in, c_out, kernel, conv_stride in _block_convs(cfg, cin, filters, stride):
            start = size if conv == "conv_proj" else branch
            out = (start - 1) // conv_stride + 1
            if conv != "conv_proj":
                branch = out
            layers.append(dict(name=f"{prefix}.{conv}", cin=c_in, cout=c_out, k=kernel, h=out, w=out))
        size = branch
    layers.append(dict(name="head", cin=features(cfg), cout=cfg["num_classes"], k=1, h=1, w=1))
    return layers


def tap_shape(cfg: dict) -> Tuple[int, int, int]:
    """(H, W, C) of the ``pre_pool`` tap."""
    return (layer_shapes(cfg)[-2]["h"], layer_shapes(cfg)[-2]["w"], features(cfg))


def _bn(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    scale = w[f"{name}.weight"] / torch.sqrt(w[f"{name}.running_var"] + EPS)
    shift = w[f"{name}.bias"] - w[f"{name}.running_mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def forward(
    weights: Dict[str, torch.Tensor],
    images: torch.Tensor,
    cfg: dict,
    quantize: Optional[Callable[[torch.Tensor, bool], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) float images -> (logits (B, classes), tap (B, h, w, C)),
    float32. ``quantize(tensor, is_weight)`` rounds each weight and stored
    tensor (None: float32 as they are)."""
    q = quantize or (lambda t, is_weight: t)

    def a(t: torch.Tensor) -> torch.Tensor:
        return q(t, False)

    w = {name: t.to(torch.float32) for name, t in weights.items()}
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        def conv(x: torch.Tensor, name: str, stride: int) -> torch.Tensor:
            kernel = w[f"{name}.weight"]
            return a(F.conv2d(a(x), q(kernel, True), None, stride, kernel.shape[-1] // 2))

        def bn(x: torch.Tensor, name: str) -> torch.Tensor:
            return a(_bn(x, w, name))

        k, s = _stem(cfg)
        x = images.to(torch.float32).permute(0, 3, 1, 2)
        x = a(torch.relu(bn(conv(x, "conv_init", s), "bn_init")))
        if cfg["stem"] != "cifar":
            x = F.max_pool2d(x, 3, 2, 1)
        for prefix, cin, filters, stride in _blocks(cfg):
            convs = _block_convs(cfg, cin, filters, stride)
            main = [c for c in convs if c[0] != "conv_proj"]
            y = x
            for i, (name, norm, _, _, _, conv_stride) in enumerate(main):
                y = bn(conv(y, f"{prefix}.{name}", conv_stride), f"{prefix}.{norm}")
                if i < len(main) - 1:
                    y = a(torch.relu(y))
            residual = x
            if len(convs) > len(main):
                residual = bn(conv(x, f"{prefix}.conv_proj", stride), f"{prefix}.norm_proj")
            x = a(torch.relu(a(residual + y)))
        tap = x.permute(0, 2, 3, 1)
        pooled = a(x.mean(dim=(2, 3)))
        logits = a(F.linear(pooled, q(w["head.weight"], True), w["head.bias"]))
        return logits, tap
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
