"""The program's ResNet, built from a configuration file and the benchmark's
seeded tensors: ``runia_core_tpu_torch.models.ResNet`` in the served dtype,
channels_last, in inference mode, with the tapped forward the scorer takes.
"""

from __future__ import annotations

import torch


def build_forward(cfg: dict, weights: dict, device):
    """images (B, H, W, 3) -> (logits, {tap: (B, h, w, C)})."""
    from runia_core_tpu_torch.models.resnet import BottleneckResNetBlock, ResNet, ResNetBlock, build_tapped_forward

    block = {"basic": ResNetBlock, "bottleneck": BottleneckResNetBlock}[cfg["block"]]
    model = ResNet(
        stage_sizes=cfg["stage_sizes"], block_cls=block, num_classes=cfg["num_classes"],
        num_filters=cfg["num_filters"], cifar_stem=cfg["stem"] == "cifar", dtype=getattr(torch, cfg["dtype"]),
        torch_padding=cfg["padding"] == "torch", in_channels=cfg["channels"], device=device,
    )
    model.load_state_dict(weights)
    model = model.to(memory_format=torch.channels_last).eval()
    return build_tapped_forward(model, (cfg["larex"]["tap"],))
