"""Models of the PyTorch port: ResNets returning (logits, taps), and the
Llama-family decoder LM with its KV cache."""

from runia_core_tpu_torch.models.convert import (
    detector_state_from_arrays,
    llama_from_flax,
    pca_state_from_arrays,
    resnet_from_flax,
)
from runia_core_tpu_torch.models.llama import (
    LlamaLM,
    QDense,
    fuse_quantized_llama_params,
    quantize_llama_params,
)
from runia_core_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    build_tapped_forward,
)
from runia_core_tpu_torch.models.transformer import init_cache

__all__ = [
    "LlamaLM",
    "QDense",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "build_tapped_forward",
    "detector_state_from_arrays",
    "fuse_quantized_llama_params",
    "init_cache",
    "llama_from_flax",
    "pca_state_from_arrays",
    "quantize_llama_params",
    "resnet_from_flax",
]
