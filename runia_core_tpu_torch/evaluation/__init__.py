"""Evaluation layer of the PyTorch port: the entropy engine, the metrics,
the baselines and the LaREx evaluation sweep (every name of the JAX
package's ``evaluation`` but ``subset_boxes``, which comes with the
object-level evaluation)."""

from runia_core_tpu_torch.evaluation.entropy import get_dl_h_z, neighbors_for, single_image_entropy_calculation
from runia_core_tpu_torch.evaluation.baselines import (
    baseline_name_dict,
    calculate_all_baselines,
    get_labels_from_logits,
    remove_latent_features,
)
from runia_core_tpu_torch.evaluation.latent_space import log_baselines, log_evaluate_larex, plot_roc_curves
from runia_core_tpu_torch.evaluation.metrics import (
    get_auroc_results,
    log_evaluate_postprocessors,
    save_roc_ood_detector,
    save_scores_plots,
    select_and_log_best_larex,
    torch_auroc,
)

__all__ = [
    "baseline_name_dict",
    "calculate_all_baselines",
    "get_auroc_results",
    "get_dl_h_z",
    "get_labels_from_logits",
    "log_baselines",
    "log_evaluate_larex",
    "log_evaluate_postprocessors",
    "neighbors_for",
    "plot_roc_curves",
    "remove_latent_features",
    "save_roc_ood_detector",
    "save_scores_plots",
    "select_and_log_best_larex",
    "single_image_entropy_calculation",
    "torch_auroc",
]
