"""Feature extraction of the PyTorch port: forward-hook taps and the
image-level MC-dropout extractors."""

from runia_core_tpu_torch.extraction.image_level import (
    FastMCDSamplesExtractor,
    MCDSamplesExtractor,
    deeplabv3p_get_ls_mcd_samples,
    get_latent_representation_mcd_samples,
)
from runia_core_tpu_torch.extraction.image_level import _ExtractorBase as Extractor
from runia_core_tpu_torch.extraction.taps import Hook, apply_dropout, tap_torch_model
from runia_core_tpu_torch.extraction.utils import (
    associate_precalculated_baselines_with_raw_predictions,
    get_aggregated_data_dict,
)

__all__ = [
    "Extractor",
    "FastMCDSamplesExtractor",
    "Hook",
    "MCDSamplesExtractor",
    "apply_dropout",
    "associate_precalculated_baselines_with_raw_predictions",
    "deeplabv3p_get_ls_mcd_samples",
    "get_aggregated_data_dict",
    "get_latent_representation_mcd_samples",
    "tap_torch_model",
]
