"""OoD postprocessors of the PyTorch port (LaRED / LaREM so far)."""

from runia_core_tpu_torch.detectors.base import (
    OodPostprocessor,
    Postprocessor,
    postprocessor_input_dict,
    postprocessors_dict,
    record_time,
    register_postprocessor,
)
from runia_core_tpu_torch.detectors.latent import (
    KDELatentSpace,
    LaREDPostprocessor,
    LaREMPostprocessor,
    MDLatentSpace,
    kde_log_density,
    md_score,
)

__all__ = [
    "KDELatentSpace",
    "LaREDPostprocessor",
    "LaREMPostprocessor",
    "MDLatentSpace",
    "OodPostprocessor",
    "Postprocessor",
    "kde_log_density",
    "md_score",
    "postprocessor_input_dict",
    "postprocessors_dict",
    "record_time",
    "register_postprocessor",
]
