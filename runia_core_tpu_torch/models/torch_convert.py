"""Load torchvision-layout ResNet checkpoints and ``transformers`` ViTs into
the port's models.

Counterpart of ``runia_core_tpu/models/torch_convert.py``, with no flax in
between: ``convert_torch_resnet`` maps a torchvision ``state_dict``
(resnet18/34/50 key layout: ``conv1.*``, ``bn1.*``, ``layer{i}.{j}.*``,
``fc.*``) onto :class:`runia_core_tpu_torch.models.ResNet` with
``torch_padding=True`` (torch's symmetric conv and pool padding), and
``convert_hf_vit`` a ``transformers`` ViT classifier onto
:class:`runia_core_tpu_torch.models.vit.ViT`. No torchvision import is
needed: the input is a plain mapping of name -> tensor or array, e.g.
``torch.load(path, map_location="cpu")`` or a ``model.state_dict()``.
``transformers`` is imported by neither function; ``convert_hf_vit`` reads
the model it is given.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.models.resnet import BottleneckResNetBlock, ResNet, ResNetBlock
from runia_core_tpu_torch.models.vit import ViT

__all__ = ["convert_hf_vit", "convert_torch_resnet"]

_ARCHS = {
    "resnet18": ((2, 2, 2, 2), ResNetBlock),
    "resnet34": ((3, 4, 6, 3), ResNetBlock),
    "resnet50": ((3, 4, 6, 3), BottleneckResNetBlock),
}


def _f32(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(t, dtype=np.float32))


def _infer_arch(sd: Mapping) -> str:
    if "layer1.0.conv3.weight" in sd:
        return "resnet50"
    return "resnet34" if "layer2.3.conv1.weight" in sd else "resnet18"


def convert_torch_resnet(state_dict: Mapping[str, Any], arch: Optional[str] = None,
                         dtype: torch.dtype = torch.float32, device=None) -> ResNet:
    """A torchvision ``state_dict`` -> the port's ``ResNet(torch_padding=True)``
    with its weights, in eval mode on ``device`` (None: the GPU).

    ``arch`` is inferred from the key layout when omitted. Keys with a
    ``module.`` / ``model.`` prefix (DataParallel / lightning dumps) are
    accepted. The BatchNorm running statistics become the model's."""
    sd = {k.removeprefix("module.").removeprefix("model."): v for k, v in state_dict.items()}
    arch = arch or _infer_arch(sd)
    if arch not in _ARCHS:
        raise ValueError(f"unknown arch {arch!r}; expected one of {sorted(_ARCHS)}")
    stage_sizes, block_cls = _ARCHS[arch]
    model = ResNet(stage_sizes, block_cls, num_classes=_f32(sd["fc.weight"]).shape[0],
                   num_filters=_f32(sd["conv1.weight"]).shape[0], dtype=dtype, torch_padding=True,
                   device=default_device() if device is None else device)

    state: Dict[str, torch.Tensor] = {"conv_init.weight": _f32(sd["conv1.weight"])}

    def bn(dst: str, src: str) -> None:
        for mine, theirs in (("weight", "weight"), ("bias", "bias"), ("running_mean", "running_mean"),
                             ("running_var", "running_var")):
            state[f"{dst}.{mine}"] = _f32(sd[f"{src}.{theirs}"])

    bn("bn_init", "bn1")
    n_convs = 3 if block_cls is BottleneckResNetBlock else 2
    for i, size in enumerate(stage_sizes):
        for j in range(size):
            src, dst = f"layer{i + 1}.{j}", f"stage{i + 1}_block{j}"
            for c in range(n_convs):
                state[f"{dst}.Conv_{c}.weight"] = _f32(sd[f"{src}.conv{c + 1}.weight"])
                bn(f"{dst}.BatchNorm_{c}", f"{src}.bn{c + 1}")
            if f"{src}.downsample.0.weight" in sd:
                state[f"{dst}.conv_proj.weight"] = _f32(sd[f"{src}.downsample.0.weight"])
                bn(f"{dst}.norm_proj", f"{src}.downsample.1")
    state["head.weight"] = _f32(sd["fc.weight"])
    state["head.bias"] = _f32(sd["fc.bias"])
    model.load_state_dict(state)
    return model.eval()


def convert_hf_vit(hf_model, device=None) -> ViT:
    """A ``transformers`` ``ViTForImageClassification`` (or any model with
    its ``vit.*`` / ``classifier`` state-dict layout) -> the port's ``ViT``
    in the HF configuration (CLS token, ``pool="cls"``, exact GELU, HF's
    ``layer_norm_eps``), in eval mode on ``device`` (None: the GPU)."""
    cfg = hf_model.config
    sd = hf_model.state_dict()
    model = ViT(
        num_classes=getattr(cfg, "num_labels", None) or sd["classifier.weight"].shape[0],
        patch_size=cfg.patch_size, d_model=cfg.hidden_size, num_layers=cfg.num_hidden_layers,
        num_heads=cfg.num_attention_heads, use_cls_token=True, pool="cls", exact_gelu=True,
        ln_eps=float(getattr(cfg, "layer_norm_eps", 1e-12)), image_size=cfg.image_size,
        in_channels=cfg.num_channels,
        device=default_device() if device is None else device,
    )
    emb = "vit.embeddings"
    state = {
        "patch_embed.weight": sd[f"{emb}.patch_embeddings.projection.weight"],
        "patch_embed.bias": sd[f"{emb}.patch_embeddings.projection.bias"],
        "cls_token": sd[f"{emb}.cls_token"],
        "pos_embed": sd[f"{emb}.position_embeddings"],
        "encoder_norm.weight": sd["vit.layernorm.weight"],
        "encoder_norm.bias": sd["vit.layernorm.bias"],
        "head.weight": sd["classifier.weight"],
        "head.bias": sd["classifier.bias"],
    }
    renames = {
        "LayerNorm_0": "layernorm_before", "LayerNorm_1": "layernorm_after",
        "attn.query": "attention.attention.query", "attn.key": "attention.attention.key",
        "attn.value": "attention.attention.value", "attn.out": "attention.output.dense",
        "Dense_0": "intermediate.dense", "Dense_1": "output.dense",
    }
    for i in range(cfg.num_hidden_layers):
        for mine, theirs in renames.items():
            for leaf in ("weight", "bias"):
                state[f"block_{i}.{mine}.{leaf}"] = sd[f"vit.encoder.layer.{i}.{theirs}.{leaf}"]
    model.load_state_dict({k: _f32(v) for k, v in state.items()})
    return model.eval()
