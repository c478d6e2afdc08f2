"""Online inference of the PyTorch port."""

from runia_core_tpu_torch.inference.image_level import (
    InferenceModule,
    LaRDInference,
    LaRExInference,
    build_larex_scorer,
)

__all__ = ["InferenceModule", "LaRDInference", "LaRExInference", "build_larex_scorer"]
