"""Online inference of the PyTorch port."""

from runia_core_tpu_torch.detectors.base import (
    OodPostprocessor,
    Postprocessor,
    get_baselines_thresholds,
    get_method_threshold,
    record_time,
)
from runia_core_tpu_torch.inference.image_level import (
    InferenceModule,
    LaRDInference,
    LaRExInference,
    ProbabilisticInferenceModule,
    build_larex_scorer,
)

__all__ = [
    "InferenceModule",
    "LaRDInference",
    "LaRExInference",
    "OodPostprocessor",
    "Postprocessor",
    "ProbabilisticInferenceModule",
    "build_larex_scorer",
    "get_baselines_thresholds",
    "get_method_threshold",
    "record_time",
]
