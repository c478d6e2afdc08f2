"""Feature extraction of the PyTorch port: forward-hook taps, the
image-level MC-dropout extractors, and the object level (detection adapters,
HF DETR-family adapters, per-detection ROI features, the batched object
scorer)."""

from runia_core_tpu_torch.extraction.adapters import (
    SUPPORTED_OBJECT_DETECTION_ARCHITECTURES,
    DetectionResult,
    postprocess_architecture_taps,
    yolo_get_logits,
)
from runia_core_tpu_torch.extraction.hf_adapters import HFDetrAdapter, cxcywh_to_xyxy
from runia_core_tpu_torch.extraction.image_level import (
    FastMCDSamplesExtractor,
    ImageLvlFeatureExtractor,
    MCDSamplesExtractor,
    deeplabv3p_get_ls_mcd_samples,
    get_latent_representation_mcd_samples,
)
from runia_core_tpu_torch.extraction.image_level import _ExtractorBase as Extractor
from runia_core_tpu_torch.extraction.object_level import BoxFeaturesExtractor
from runia_core_tpu_torch.extraction.object_level_batched import (
    PaddedDetections,
    batched_roi_features,
    build_object_scorer,
    pad_detections,
)
from runia_core_tpu_torch.extraction.taps import Hook, apply_dropout, tap_torch_model
from runia_core_tpu_torch.extraction.utils import (
    associate_precalculated_baselines_with_raw_predictions,
    get_aggregated_data_dict,
)

__all__ = [
    "BoxFeaturesExtractor",
    "DetectionResult",
    "Extractor",
    "FastMCDSamplesExtractor",
    "HFDetrAdapter",
    "Hook",
    "ImageLvlFeatureExtractor",
    "MCDSamplesExtractor",
    "PaddedDetections",
    "SUPPORTED_OBJECT_DETECTION_ARCHITECTURES",
    "apply_dropout",
    "associate_precalculated_baselines_with_raw_predictions",
    "batched_roi_features",
    "build_object_scorer",
    "cxcywh_to_xyxy",
    "deeplabv3p_get_ls_mcd_samples",
    "get_aggregated_data_dict",
    "get_latent_representation_mcd_samples",
    "pad_detections",
    "postprocess_architecture_taps",
    "tap_torch_model",
    "yolo_get_logits",
]
