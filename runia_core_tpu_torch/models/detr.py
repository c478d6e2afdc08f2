"""DETR (DEtection TRansformer) in PyTorch, with an HF-checkpoint converter.

Counterpart of ``runia_core_tpu/models/detr.py``: a post-LN DETR (Carion et
al. 2020) over an NHWC backbone. The backbone's ``pre_pool`` map goes
through a 1x1 input projection; sine position embeddings are added to the
queries and keys (never the values) of every attention; a 6-layer encoder
and a 6-layer decoder of learned queries; a shared final LayerNorm; a class
head (num_labels + the no-object column) and a 3-layer sigmoid box MLP
predicting normalized (cx, cy, w, h). Attention is a plain product and
softmax in f32, as the JAX package computes it outside any Pallas kernel.

Taps: ``backbone_fmap`` (B, H', W', C), ``encoder_tokens`` (B, H', W', d)
and ``decoder_queries`` (B, Q, d), beside the backbone's own.

:func:`convert_hf_detr` maps a ``transformers.DetrForObjectDetection``
(HF-native ResNet backbone) onto the port's model and accepts both layouts
of its state dict: transformers 4.x (``model.backbone.conv_encoder.model``,
``out_proj``, ``fc1``) and 5.x (``model.backbone.model``, ``o_proj``,
``mlp.fc1``). :class:`DetrAdapter` (also exported as ``DetrJaxAdapter``,
the JAX name) is the ``DetectionResult`` protocol over the model. Module
names follow the flax tree, so ``models/convert.py::detr_from_flax`` carries
a JAX DETR's variables across.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.extraction.adapters import DetectionResult
from runia_core_tpu_torch.models.resnet import BottleneckResNetBlock, ResNet, ResNetBlock
from runia_core_tpu_torch.utils.graphs import copy_to_host
from runia_core_tpu_torch.utils.placement import as_tensor

__all__ = ["DETR", "DetrAdapter", "DetrAttention", "DetrJaxAdapter", "convert_hf_detr", "sine_position_embedding"]


def sine_position_embedding(h: int, w: int, d_model: int, temperature: float = 10000.0,
                            device=None) -> torch.Tensor:
    """Normalized 2-D sine/cosine position embedding, (h*w, d_model): the
    DETR variant (normalize=True, scale=2*pi) over an all-valid pixel mask.
    Channels are [y-embedding | x-embedding], each interleaved sin/cos over
    a shared temperature ladder."""
    dim = d_model // 2
    scale = 2 * math.pi
    ts = temperature ** (2 * (torch.arange(dim, device=device) // 2) / dim)

    def embed(coords):
        ang = coords[:, None] / ts[None, :]
        return torch.stack([torch.sin(ang[:, 0::2]), torch.cos(ang[:, 1::2])], dim=-1).reshape(coords.shape[0], dim)

    y = embed(torch.arange(1, h + 1, dtype=torch.float32, device=device) / (h + 1e-6) * scale)
    x = embed(torch.arange(1, w + 1, dtype=torch.float32, device=device) / (w + 1e-6) * scale)
    grid = torch.cat([y[:, None, :].expand(h, w, dim), x[None, :, :].expand(h, w, dim)], dim=-1)
    return grid.reshape(h * w, d_model)


class DetrAttention(nn.Module):
    """Multi-head attention with DETR's convention: positions are added to
    the queries and keys before their projections; values come from the raw
    stream."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, queries, q_pos, keys, k_pos, values) -> torch.Tensor:
        hd = self.d_model // self.num_heads
        q = self.q_proj(queries if q_pos is None else queries + q_pos) * hd ** -0.5
        k = self.k_proj(keys if k_pos is None else keys + k_pos)
        v = self.v_proj(values)

        def split(t):  # (B, N, d) -> (B, heads, N, hd)
            return t.reshape(t.shape[0], t.shape[1], self.num_heads, hd).transpose(1, 2)

        attn = torch.softmax(torch.matmul(split(q), split(k).transpose(-1, -2)), dim=-1)
        out = torch.matmul(attn, split(v)).transpose(1, 2).reshape(queries.shape[0], queries.shape[1], self.d_model)
        return self.out_proj(out)


class DetrEncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, ln_eps: float = 1e-5):
        super().__init__()
        self.self_attn = DetrAttention(d_model, num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d_model, eps=ln_eps)
        self.fc1 = nn.Linear(d_model, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d_model)
        self.final_layer_norm = nn.LayerNorm(d_model, eps=ln_eps)

    def forward(self, x, pos):
        x = self.self_attn_layer_norm(x + self.self_attn(x, pos, x, pos, x))
        return self.final_layer_norm(x + self.fc2(torch.relu(self.fc1(x))))


class DetrDecoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, ln_eps: float = 1e-5):
        super().__init__()
        self.self_attn = DetrAttention(d_model, num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d_model, eps=ln_eps)
        self.encoder_attn = DetrAttention(d_model, num_heads)
        self.encoder_attn_layer_norm = nn.LayerNorm(d_model, eps=ln_eps)
        self.fc1 = nn.Linear(d_model, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d_model)
        self.final_layer_norm = nn.LayerNorm(d_model, eps=ln_eps)

    def forward(self, x, query_pos, memory, mem_pos):
        x = self.self_attn_layer_norm(x + self.self_attn(x, query_pos, x, query_pos, x))
        x = self.encoder_attn_layer_norm(x + self.encoder_attn(x, query_pos, memory, mem_pos, memory))
        return self.final_layer_norm(x + self.fc2(torch.relu(self.fc1(x))))


def _backbone_features(backbone: nn.Module) -> int:
    """Channels of a port ResNet's last stage."""
    n = len(backbone.stage_sizes)
    block = getattr(backbone, f"stage{n}_block{backbone.stage_sizes[-1] - 1}")
    return (block.Conv_2 if hasattr(block, "Conv_2") else block.Conv_1).weight.shape[0]


class DETR(nn.Module):
    """Post-LN DETR over an NHWC backbone returning ``(_, taps)`` with a
    ``pre_pool`` map (e.g. ``ResNet(include_head=False)``), made on
    ``device`` (None: the GPU). ``model(images) -> (outputs, taps)`` with
    ``outputs = {"logits": (B, Q, num_labels + 1), "pred_boxes": (B, Q,
    4)}`` (normalized cxcywh, sigmoid). The input projection's width is
    read from the port ResNet's last stage."""

    def __init__(self, backbone: nn.Module, num_labels: int, num_queries: int = 100, d_model: int = 256,
                 num_heads: int = 8, num_encoder_layers: int = 6, num_decoder_layers: int = 6, ffn_dim: int = 2048,
                 ln_eps: float = 1e-5, device=None):
        super().__init__()
        self.num_labels, self.num_queries, self.d_model = num_labels, num_queries, d_model
        self.num_encoder_layers, self.num_decoder_layers = num_encoder_layers, num_decoder_layers
        self.backbone = backbone
        with torch.device(default_device() if device is None else device):
            self.input_projection = nn.Conv2d(_backbone_features(backbone), d_model, 1)
            for i in range(num_encoder_layers):
                self.add_module(f"encoder_layer{i}", DetrEncoderLayer(d_model, num_heads, ffn_dim, ln_eps))
            self.query_position_embeddings = nn.Parameter(torch.randn(num_queries, d_model))
            for i in range(num_decoder_layers):
                self.add_module(f"decoder_layer{i}", DetrDecoderLayer(d_model, num_heads, ffn_dim, ln_eps))
            self.decoder_norm = nn.LayerNorm(d_model, eps=ln_eps)
            self.class_labels_classifier = nn.Linear(d_model, num_labels + 1)
            self.bbox_mlp0 = nn.Linear(d_model, d_model)
            self.bbox_mlp1 = nn.Linear(d_model, d_model)
            self.bbox_mlp2 = nn.Linear(d_model, 4)
        self.eval()

    def forward(self, images: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        _, btaps = self.backbone(images)
        fmap = btaps["pre_pool"]  # (B, H', W', C)
        b, h, w, _ = fmap.shape
        src = self.input_projection(fmap.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)  # (B, H'W', d)
        pos = sine_position_embedding(h, w, self.d_model, device=src.device)[None].to(src.dtype)

        x = src
        for i in range(self.num_encoder_layers):
            x = getattr(self, f"encoder_layer{i}")(x, pos)
        memory = x
        query_pos = self.query_position_embeddings[None].to(src.dtype)
        q = torch.zeros((b, self.num_queries, self.d_model), dtype=src.dtype, device=src.device)
        for i in range(self.num_decoder_layers):
            q = getattr(self, f"decoder_layer{i}")(q, query_pos, memory, pos)
        q = self.decoder_norm(q)

        logits = self.class_labels_classifier(q)
        bx = torch.relu(self.bbox_mlp1(torch.relu(self.bbox_mlp0(q))))
        boxes = torch.sigmoid(self.bbox_mlp2(bx))
        taps = dict(btaps)
        taps["backbone_fmap"] = fmap
        taps["encoder_tokens"] = memory.reshape(b, h, w, self.d_model)
        taps["decoder_queries"] = q
        return {"logits": logits, "pred_boxes": boxes}, taps


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------


def _pick(sd: Dict[str, torch.Tensor], *names: str) -> str:
    """The first of ``names`` in the state dict (the transformers 4.x and
    5.x spellings of one entry)."""
    for name in names:
        if name in sd:
            return name
    raise KeyError(f"none of {names} in the DETR state dict")


def _hf_backbone_state(sd, prefix: str, backbone_cfg) -> Tuple[Tuple[int, ...], type, int, Dict[str, torch.Tensor]]:
    """HF-native ResNet backbone (``embedder.embedder.*`` /
    ``encoder.stages.{s}.layers.{j}.{layer.c,shortcut}.*``) -> (stages,
    block class, num_filters, the port ResNet's state dict)."""
    bottleneck = backbone_cfg.layer_type == "bottleneck"
    num_filters = int(backbone_cfg.embedding_size)
    mult = 4 if bottleneck else 1
    expected = [num_filters * (2 ** i) * mult for i in range(len(backbone_cfg.depths))]
    if list(backbone_cfg.hidden_sizes) != expected:
        raise NotImplementedError(
            "convert_hf_detr supports doubling-width ResNet backbones "
            f"(hidden_sizes {expected}); got {list(backbone_cfg.hidden_sizes)}"
        )
    if getattr(backbone_cfg, "downsample_in_bottleneck", False):
        raise NotImplementedError("stride-on-1x1 bottleneck variant")

    state: Dict[str, torch.Tensor] = {}

    def conv_bn(ours_conv, ours_bn, theirs):
        state[f"{ours_conv}.weight"] = sd[f"{theirs}.convolution.weight"]
        for name in ("weight", "bias", "running_mean", "running_var"):
            state[f"{ours_bn}.{name}"] = sd[f"{theirs}.normalization.{name}"]

    conv_bn("conv_init", "bn_init", f"{prefix}.embedder.embedder")
    for s, depth in enumerate(backbone_cfg.depths):
        for j in range(depth):
            src, dst = f"{prefix}.encoder.stages.{s}.layers.{j}", f"stage{s + 1}_block{j}"
            for c in range(3 if bottleneck else 2):
                conv_bn(f"{dst}.Conv_{c}", f"{dst}.BatchNorm_{c}", f"{src}.layer.{c}")
            if f"{src}.shortcut.convolution.weight" in sd:
                conv_bn(f"{dst}.conv_proj", f"{dst}.norm_proj", f"{src}.shortcut")
    block = BottleneckResNetBlock if bottleneck else ResNetBlock
    return tuple(backbone_cfg.depths), block, num_filters, state


def convert_hf_detr(hf_model, device=None) -> Tuple[DETR, Dict[str, torch.Tensor]]:
    """``transformers.DetrForObjectDetection`` -> (DETR, state_dict), the
    model holding the state, made on ``device`` (None: the GPU).

    Requires the HF-native ResNet backbone (``use_timm_backbone=False``);
    a timm backbone, unequal encoder / decoder heads or FFN widths, and
    ``downsample_in_first_stage`` raise, as in the JAX converter: they load
    cleanly into another forward and would give wrong outputs."""
    cfg = hf_model.config
    if getattr(cfg, "use_timm_backbone", False):
        raise NotImplementedError(
            "timm-backbone DETR checkpoints: reload with use_timm_backbone="
            "False (HF-native ResNet) before converting"
        )
    if getattr(cfg, "decoder_attention_heads", cfg.encoder_attention_heads) != cfg.encoder_attention_heads:
        raise NotImplementedError("DETR with decoder_attention_heads != encoder_attention_heads")
    if cfg.decoder_ffn_dim != cfg.encoder_ffn_dim:
        raise NotImplementedError("DETR with decoder_ffn_dim != encoder_ffn_dim")
    if getattr(cfg.backbone_config, "downsample_in_first_stage", False):
        raise NotImplementedError("DETR backbone with downsample_in_first_stage=True")
    sd = {k: v.detach().to(torch.float32) for k, v in hf_model.state_dict().items()}
    stem = _pick(sd, "model.backbone.conv_encoder.model.embedder.embedder.convolution.weight",
                 "model.backbone.model.embedder.embedder.convolution.weight")
    prefix = stem[: -len(".embedder.embedder.convolution.weight")]
    stages, block, num_filters, state = _hf_backbone_state(sd, prefix, cfg.backbone_config)

    device = default_device() if device is None else torch.device(device)
    backbone = ResNet(stages, block, 0, num_filters=num_filters, include_head=False, torch_padding=True,
                      device=device)
    model = DETR(backbone, num_labels=cfg.num_labels, num_queries=cfg.num_queries, d_model=cfg.d_model,
                 num_heads=cfg.encoder_attention_heads, num_encoder_layers=cfg.encoder_layers,
                 num_decoder_layers=cfg.decoder_layers, ffn_dim=cfg.encoder_ffn_dim, device=device)
    state = {f"backbone.{k}": v for k, v in state.items()}

    def lin(ours, theirs):
        state[f"{ours}.weight"] = sd[f"{theirs}.weight"]
        state[f"{ours}.bias"] = sd[f"{theirs}.bias"]

    lin("input_projection", "model.input_projection")
    state["query_position_embeddings"] = sd["model.query_position_embeddings.weight"]
    lin("decoder_norm", "model.decoder.layernorm")
    lin("class_labels_classifier", "class_labels_classifier")
    for k in range(3):
        lin(f"bbox_mlp{k}", f"bbox_predictor.layers.{k}")
    for kind, n in (("encoder", cfg.encoder_layers), ("decoder", cfg.decoder_layers)):
        for i in range(n):
            src, dst = f"model.{kind}.layers.{i}", f"{kind}_layer{i}"
            attentions = ("self_attn", "encoder_attn") if kind == "decoder" else ("self_attn",)
            for attn in attentions:
                for proj in ("q_proj", "k_proj", "v_proj"):
                    lin(f"{dst}.{attn}.{proj}", f"{src}.{attn}.{proj}")
                out = _pick(sd, f"{src}.{attn}.out_proj.weight", f"{src}.{attn}.o_proj.weight")
                lin(f"{dst}.{attn}.out_proj", out[: -len(".weight")])
                lin(f"{dst}.{attn}_layer_norm", f"{src}.{attn}_layer_norm")
            for fc in ("fc1", "fc2"):
                theirs = _pick(sd, f"{src}.{fc}.weight", f"{src}.mlp.{fc}.weight")
                lin(f"{dst}.{fc}", theirs[: -len(".weight")])
            lin(f"{dst}.final_layer_norm", f"{src}.final_layer_norm")
    state = {k: v.to(device, copy=True).contiguous() for k, v in state.items()}
    model.load_state_dict(state, assign=True)
    return model, state


# ---------------------------------------------------------------------------
# DetectionResult adapter
# ---------------------------------------------------------------------------


class DetrAdapter:
    """``adapter(image, predict_conf) -> DetectionResult`` over the port's
    DETR, the JAX package's ``DetrJaxAdapter``.

    The classic-DETR postprocess: softmax over the classes and the trailing
    no-object column, which is then dropped; each query's best class and
    score; the queries scoring above ``predict_conf`` kept; cxcywh ->
    absolute xyxy boxes. ``fmaps`` holds the backbone map as an NCHW tensor
    on the model's device (for ROIAlign), ``features`` the decoder query
    embeddings. The forward runs on the model's device; its logits, boxes
    and queries come to the host in one copy."""

    def __init__(self, model: DETR):
        self.model = model

    @torch.inference_mode()
    def __call__(self, image, predict_conf: float = 0.25, **kw) -> DetectionResult:
        device = self.model.input_projection.weight.device
        x = as_tensor(image, device, torch.float32).to(device)
        if x.ndim == 3:  # HWC -> NHWC
            x = x[None]
        img_h, img_w = int(x.shape[1]), int(x.shape[2])
        outputs, taps = self.model(x)
        logits, cxcywh, queries = copy_to_host(outputs["logits"][0], outputs["pred_boxes"][0],
                                               taps["decoder_queries"][0])
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs = (probs / probs.sum(-1, keepdims=True))[:, :-1]
        scores = probs.max(-1)
        classes = probs.argmax(-1)
        keep = scores > predict_conf

        cx, cy, bw, bh = cxcywh.T
        boxes = np.stack([(cx - bw / 2) * img_w, (cy - bh / 2) * img_h,
                          (cx + bw / 2) * img_w, (cy + bh / 2) * img_h], axis=-1).astype(np.float32)[keep]
        return DetectionResult(
            boxes=boxes,
            img_shape=(img_h, img_w),
            scores=scores[keep],
            classes=classes[keep].astype(np.int64),
            logits=logits[keep, :-1],
            features=queries[keep],
            fmaps=[taps["backbone_fmap"].permute(0, 3, 1, 2)],
        )


DetrJaxAdapter = DetrAdapter
