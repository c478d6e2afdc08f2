"""OoD postprocessors of the PyTorch port: the latent-space scorers (LaRED,
LaREM, cMD, LaREK, LaREG) and the registry. The feature and logit scorers
come with the rest of ``detectors/funcs.py``."""

from runia_core_tpu_torch.detectors.base import (
    OodPostprocessor,
    Postprocessor,
    get_baselines_thresholds,
    get_method_threshold,
    postprocessor_input_dict,
    postprocessors_dict,
    record_time,
    register_postprocessor,
)
from runia_core_tpu_torch.detectors.funcs import GMMState, gmm_fit, gmm_log_prob, normalizer
from runia_core_tpu_torch.detectors.latent import (
    DetectorKDE,
    GMMLatentSpace,
    KDELatentSpace,
    KNNLatentSpace,
    LaREDPostprocessor,
    LaREGPostprocessor,
    LaREKPostprocessor,
    LaREMPostprocessor,
    MDLatentSpace,
    cMDLatentSpace,
    kde_log_density,
    md_score,
)

__all__ = [
    "DetectorKDE",
    "GMMLatentSpace",
    "GMMState",
    "KDELatentSpace",
    "KNNLatentSpace",
    "LaREDPostprocessor",
    "LaREGPostprocessor",
    "LaREKPostprocessor",
    "LaREMPostprocessor",
    "MDLatentSpace",
    "OodPostprocessor",
    "Postprocessor",
    "cMDLatentSpace",
    "get_baselines_thresholds",
    "get_method_threshold",
    "gmm_fit",
    "gmm_log_prob",
    "kde_log_density",
    "md_score",
    "normalizer",
    "postprocessor_input_dict",
    "postprocessors_dict",
    "record_time",
    "register_postprocessor",
]
