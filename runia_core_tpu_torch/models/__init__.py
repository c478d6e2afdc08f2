"""Models of the PyTorch port: ResNets returning (logits, taps)."""

from runia_core_tpu_torch.models.convert import (
    detector_state_from_arrays,
    pca_state_from_arrays,
    resnet_from_flax,
)
from runia_core_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    build_tapped_forward,
)

__all__ = [
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "build_tapped_forward",
    "detector_state_from_arrays",
    "pca_state_from_arrays",
    "resnet_from_flax",
]
