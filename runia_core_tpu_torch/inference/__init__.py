"""Online inference of the PyTorch port: image level (LaREx / LaRD, the\nscorer) and object level (per-detection scoring)."""

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
    ObjectDetectionInferenceBase,
    ProbabilisticInferenceModule,
    build_larex_scorer,
)
from runia_core_tpu_torch.inference.object_level import (
    BoxInferenceYolo,
    ObjectLevelInference,
    adjust_predictions_faster_rcnn,
)

__all__ = [
    "BoxInferenceYolo",
    "InferenceModule",
    "LaRDInference",
    "LaRExInference",
    "ObjectDetectionInferenceBase",
    "ObjectLevelInference",
    "OodPostprocessor",
    "Postprocessor",
    "ProbabilisticInferenceModule",
    "adjust_predictions_faster_rcnn",
    "build_larex_scorer",
    "get_baselines_thresholds",
    "get_method_threshold",
    "record_time",
]
