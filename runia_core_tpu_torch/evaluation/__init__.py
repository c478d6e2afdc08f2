"""Evaluation layer of the PyTorch port: the entropy engine, the metrics,
the baselines, the LaREx evaluation sweep and the object level's open-set
evaluation (``open_set``): every name of the JAX package's ``evaluation``,
and the open-set evaluator's."""

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
    get_gtu_uu_metrics,
    log_evaluate_postprocessors,
    save_roc_ood_detector,
    save_scores_plots,
    select_and_log_best_larex,
    subset_boxes,
    torch_auroc,
)
from runia_core_tpu_torch.evaluation.open_set import (
    COCOParser,
    OpenSetEvaluator,
    get_overall_open_set_results,
    voc_ap,
    voc_eval,
)

__all__ = [
    "COCOParser",
    "OpenSetEvaluator",
    "baseline_name_dict",
    "calculate_all_baselines",
    "get_auroc_results",
    "get_dl_h_z",
    "get_gtu_uu_metrics",
    "get_labels_from_logits",
    "get_overall_open_set_results",
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
    "subset_boxes",
    "torch_auroc",
    "voc_ap",
    "voc_eval",
]
