"""Online inference of the PyTorch port: image level (LaREx / LaRD, the\nscorer), object level (per-detection scoring) and per-pixel segmentation\nuncertainty."""

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
from runia_core_tpu_torch.inference.segmentation import build_pixel_uncertainty_scorer

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
    "build_pixel_uncertainty_scorer",
    "get_baselines_thresholds",
    "get_method_threshold",
    "record_time",
]
