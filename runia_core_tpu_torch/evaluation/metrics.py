"""OoD detection metrics: AUROC, FPR@95 and AUPR from exact (sort-based)
curves, the postprocessor sweep and the choice of the best LaREx setting.

Counterpart of ``runia_core_tpu/evaluation/metrics.py``, with its own copy
of that module's numpy curves: InD is the positive class (label 1), OoD 0;
FPR@95 is the false-positive rate at the first threshold where the TPR
reaches 0.95. Scores may arrive as tensors on any device; ``to_numpy``
brings them to the host for the curves. :func:`torch_auroc` is the same
AUROC as one reduction on the scores' device (the JAX package's
``jax_auroc``). pandas builds the results tables and is imported by the
functions that build them, matplotlib and seaborn by the plots; ``mlflow``
is optional, as in the JAX package. ``subset_boxes`` and
``get_gtu_uu_metrics`` serve the object-level evaluation
(``evaluation/open_set.py``): host numpy code, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from runia_core_tpu_torch.detectors import postprocessors_dict
from runia_core_tpu_torch.utils.placement import as_tensor, to_numpy

__all__ = [
    "auc",
    "binary_precision_recall_curve",
    "binary_roc",
    "get_auroc_results",
    "get_gtu_uu_metrics",
    "get_pred_scores_plots",
    "log_evaluate_postprocessors",
    "plot_roc_ood_detector",
    "save_roc_ood_detector",
    "save_scores_plots",
    "select_and_log_best_larex",
    "subset_boxes",
    "torch_auroc",
]

METRIC_COLUMNS = ["auroc", "fpr@95", "aupr", "fpr", "tpr"]


def _optional_mlflow():
    try:
        import mlflow

        return mlflow
    except ImportError:
        return None


# ---------------------------------------------------------------------------
# Exact curves (numpy, on the host)
# ---------------------------------------------------------------------------
def _sorted_counts(scores, labels):
    scores = to_numpy(scores).ravel().astype(np.float64)
    labels = to_numpy(labels).ravel()
    order = np.argsort(-scores, kind="stable")
    sorted_scores = scores[order]
    distinct = np.where(np.diff(sorted_scores))[0]
    thr_idx = np.r_[distinct, len(scores) - 1]
    tps = np.cumsum(labels[order])[thr_idx].astype(np.float64)
    return sorted_scores, thr_idx, tps, (1 + thr_idx) - tps


def binary_roc(scores, labels):
    """Exact ROC curve (fpr, tpr, thresholds), thresholds descending, with
    the (0, 0) point first."""
    sorted_scores, thr_idx, tps, fps = _sorted_counts(scores, labels)
    tpr = np.r_[0.0, tps] / max(tps[-1], 1e-12)
    fpr = np.r_[0.0, fps] / max(fps[-1], 1e-12)
    return fpr, tpr, np.r_[np.inf, sorted_scores[thr_idx]]


def binary_precision_recall_curve(scores, labels):
    """Exact PR curve with sklearn's conventions: recall decreasing, the
    (precision 1, recall 0) point last."""
    sorted_scores, thr_idx, tps, fps = _sorted_counts(scores, labels)
    precision = tps / (tps + fps)
    recall = tps / max(tps[-1], 1e-12)
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], sorted_scores[thr_idx][::-1]


def auc(x, y) -> float:
    """Trapezoidal area under y(x), x monotonic either way (sklearn.metrics.auc)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    dx = np.diff(x)
    if np.all(dx <= 0):
        direction = -1.0
    elif np.all(dx >= 0):
        direction = 1.0
    else:
        raise ValueError("x is neither increasing nor decreasing")
    return float(direction * np.trapezoid(y, x))


def torch_auroc(ind_scores, ood_scores) -> torch.Tensor:
    """AUROC (InD positive) as one reduction on the scores' device (an array
    goes to the GPU): the rank statistic (U - n_pos (n_pos + 1) / 2) /
    (n_pos n_neg) with average ranks over ties, which equals the area under
    :func:`binary_roc`. Ranks are float64 for float64 scores, else float32,
    as JAX's; a tie group's average rank is (first + last position) / 2 from
    two binary searches of the sorted scores."""
    ind = as_tensor(ind_scores).reshape(-1)
    scores = torch.cat([ind, torch.as_tensor(ood_scores, device=ind.device).reshape(-1)])
    rank_dtype = torch.float64 if scores.dtype == torch.float64 else torch.float32
    labels = torch.zeros(scores.shape[0], dtype=rank_dtype, device=scores.device)
    labels[: ind.shape[0]] = 1.0
    sorted_scores, order = torch.sort(scores, stable=True)
    first = torch.searchsorted(sorted_scores, sorted_scores, right=False)
    last = torch.searchsorted(sorted_scores, sorted_scores, right=True)
    avg_rank = (first + last + 1).to(rank_dtype) / 2.0
    n_pos = labels.sum()
    n_neg = labels.shape[0] - n_pos
    u = (avg_rank * labels[order]).sum() - n_pos * (n_pos + 1) / 2.0
    return u / torch.clamp_min(n_pos * n_neg, 1.0)


# ---------------------------------------------------------------------------
# The reference's API
# ---------------------------------------------------------------------------
def _ood_metrics(ind_samples_scores, ood_samples_scores) -> Tuple[float, float, float, np.ndarray, np.ndarray]:
    """(AUROC, FPR@95, AUPR, fpr, tpr) of one InD-against-OoD experiment,
    without pandas: the core of :func:`get_auroc_results`."""
    ind = to_numpy(ind_samples_scores).ravel()
    ood = to_numpy(ood_samples_scores).ravel()
    scores = np.concatenate([ind, ood])
    labels = np.concatenate([np.ones(ind.shape[0]), np.zeros(ood.shape[0])]).astype(np.int32)
    fpr, tpr, _ = binary_roc(scores, labels)
    fpr_95 = float(fpr[np.where(tpr >= 0.95)[0][0]])
    precision, recall, _ = binary_precision_recall_curve(scores, labels)
    return auc(fpr, tpr), fpr_95, auc(recall, precision), fpr, tpr


def get_auroc_results(
    detect_exp_name: str, ind_samples_scores, ood_samples_scores, return_results_for_mlflow: bool = False
):
    """A one-row table (auroc, fpr@95, aupr, fpr, tpr) named
    ``detect_exp_name``; with ``return_results_for_mlflow`` also the three
    metrics as a dict ("fpr@95" as "fpr_95": mlflow refuses '@')."""
    import pandas as pd

    roc_auc, fpr_95, aupr, fpr, tpr = _ood_metrics(ind_samples_scores, ood_samples_scores)
    results_table = pd.DataFrame.from_dict(
        {detect_exp_name: [roc_auc, fpr_95, aupr, fpr.tolist(), tpr.tolist()]}, orient="index",
        columns=METRIC_COLUMNS,
    )
    if not return_results_for_mlflow:
        return results_table
    results_for_mlflow = results_table.loc[detect_exp_name, ["auroc", "fpr@95", "aupr"]].to_dict()
    results_for_mlflow["fpr_95"] = results_for_mlflow.pop("fpr@95")
    return results_table, results_for_mlflow


def plot_roc_ood_detector(results_table, plot_title: str = "Plot Title"):
    """Show the ROC curve of every row of a results table."""
    import matplotlib.pyplot as plt

    _, ax = plt.subplots(figsize=(8, 6))
    _draw_roc_overlay(ax, results_table, plot_title, highlight=None)
    plt.show()


def _draw_roc_overlay(ax, results_table, plot_title, highlight):
    """ROC curves of a table's rows; rows whose name holds one of
    ``highlight`` drawn solid and bold, the others dashed."""
    for row_name in results_table.index:
        row = results_table.loc[row_name]
        if highlight is None:
            style = {}
        elif any(h in row_name for h in highlight):
            style = {"linestyle": "solid", "linewidth": 3.0}
        else:
            style = {"linestyle": "dashed", "linewidth": 1.7}
        ax.plot(row["fpr"], row["tpr"], label=f"{row_name}, AUROC={row['auroc']:.4f}", **style)
    ax.plot([0, 1], [0, 1], color="orange", linestyle="--")
    ticks = np.arange(0.0, 1.1, step=0.1)
    ax.set_xticks(ticks)
    ax.set_yticks(ticks)
    ax.set_xlabel("False Positive Rate", fontsize=15)
    ax.set_ylabel("True Positive Rate", fontsize=15)
    ax.set_title(plot_title, fontweight="bold", fontsize=15)
    ax.legend(prop={"size": 12}, loc="lower right")


def save_roc_ood_detector(results_table, postprocessors: List[str], plot_title: str = "Plot Title"):
    """The ROC overlay figure, the named postprocessors' rows highlighted."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    _draw_roc_overlay(ax, results_table, plot_title, highlight=postprocessors)
    return fig


def save_scores_plots(
    scores_ind, ood_scores_dict: Dict, ood_datasets_list: List[str], ind_dataset_name: str,
    post_processor_name: str = "LaREM",
) -> Dict:
    """One score-histogram figure per OoD dataset, InD beside it."""
    import pandas as pd
    import seaborn as sns

    if post_processor_name not in postprocessors_dict:
        raise AssertionError(f"Got {post_processor_name}")
    score_col = f"{post_processor_name} score"

    def labeled(scores, dataset):
        return pd.DataFrame({"Dataset": dataset, score_col: to_numpy(scores).ravel()})

    ind_frame = labeled(scores_ind, ind_dataset_name)
    return {
        f"{name}_{post_processor_name}_scores": sns.displot(
            pd.concat([ind_frame, labeled(ood_scores_dict[name], name)], ignore_index=True),
            x=score_col, hue="Dataset", kind="hist", fill=True,
        )
        for name in ood_datasets_list
    }


def get_pred_scores_plots(experiment: Dict, ood_datasets_list: list, title: str, ind_dataset_name: str):
    """The density figure of one predictive score over InD and each OoD set."""
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns

    x_axis = experiment["x_axis"]
    frames = [
        pd.DataFrame({"Dataset": name, x_axis: to_numpy(experiment[key]).ravel()})
        for key, name in [("InD", ind_dataset_name)] + [(d, d) for d in ood_datasets_list]
    ]
    ax = sns.displot(pd.concat(frames, ignore_index=True), x=x_axis, hue="Dataset", kind="hist",
                     fill=True).set(title=title)
    plt.tight_layout()
    return ax


def log_evaluate_postprocessors(
    ind_dict: Dict, ood_dict: Dict, ood_datasets_names: List[str], experiment_name_extension: str = "",
    return_density_scores: Optional[str] = None, log_step: Optional[int] = None, mlflow_logging: bool = False,
    postprocessors=None, cfg=None,
) -> Dict:
    """Fit each latent postprocessor on "train latent_space_means", score the
    InD valid split and every OoD split, and table each (OoD set,
    postprocessor) experiment's metrics. ``postprocessors`` defaults to
    ("LaRED", "LaREM", "LaREK"), and each is built as ``cls(cfg=cfg)``.
    Scores stay tensors where the detector computed them."""
    import pandas as pd

    if return_density_scores is not None and return_density_scores not in postprocessors_dict:
        raise AssertionError(f"Got {return_density_scores}")
    if postprocessors is None:
        postprocessors = ("LaRED", "LaREM", "LaREK")

    overall_metrics_df = pd.DataFrame(columns=METRIC_COLUMNS)
    ind_scores_dict, ood_scores_dict = {}, {}
    for postprocessor in postprocessors:
        instance = postprocessors_dict[postprocessor](cfg=cfg)
        instance._setup_flag = False
        instance.setup(ind_dict["train latent_space_means"], ind_train_labels=ind_dict.get("train labels"))
        ind_scores_dict[postprocessor] = instance.postprocess(ind_dict["valid latent_space_means"],
                                                              pred_labels=ind_dict.get("valid labels"))
        ood_scores_dict[postprocessor] = {
            name: instance.postprocess(ood_dict[f"{name} latent_space_means"],
                                       pred_labels=ood_dict.get(f"{name} labels"))
            for name in ood_datasets_names
        }

    mlflow = _optional_mlflow()
    for ood_dataset_name in ood_datasets_names:
        for postprocessor in postprocessors:
            experiment_name = f"{ood_dataset_name} {postprocessor}{experiment_name_extension}"
            results_df, results_mlflow = get_auroc_results(
                detect_exp_name=experiment_name, ind_samples_scores=ind_scores_dict[postprocessor],
                ood_samples_scores=ood_scores_dict[postprocessor][ood_dataset_name], return_results_for_mlflow=True,
            )
            prefix = " ".join(experiment_name.split()[:-1]) if "PCA" in experiment_name else experiment_name
            if mlflow_logging and mlflow is not None:
                mlflow.log_metrics({f"{prefix}_{k}": v for k, v in results_mlflow.items()}, step=log_step)
            for result in results_df.index.values:
                overall_metrics_df.loc[result] = results_df.loc[result]

    results = {"results_df": overall_metrics_df}
    if return_density_scores is not None:
        results["InD"] = ind_scores_dict[return_density_scores]
        results["OoD"] = ood_scores_dict[return_density_scores]
    return results


def select_and_log_best_larex(
    overall_metrics_df, n_pca_components_list: Union[list, Tuple], postprocessor_name: str,
    multiple_ood_datasets_flag: bool, log_mlflow: bool = False,
) -> Tuple[float, float, float, int]:
    """Each configuration's metrics averaged over the OoD sets (the no-PCA
    rows, then one per PCA setting: rows ending in exactly "PCA {n}"); the
    best mean AUROC wins. Returns (auroc, aupr, fpr@95, components; 0 = no
    PCA)."""
    import pandas as pd

    if postprocessor_name not in postprocessors_dict:
        raise AssertionError(f"Got {postprocessor_name}")
    summary_cols = ["auroc", "fpr@95", "aupr"]

    def config_rows(predicate):
        selected = [overall_metrics_df.loc[row, summary_cols] for row in overall_metrics_df.index
                    if postprocessor_name in row and predicate(row)]
        return pd.DataFrame(selected, columns=summary_cols)

    configs = {postprocessor_name: config_rows(lambda row: "anomalies" not in row and "PCA" not in row)}
    for n in n_pca_components_list:
        configs[f"{postprocessor_name} PCA {n}"] = config_rows(
            lambda row, n=n: f"PCA {n}" in row and row.split(f"PCA {n}")[-1] == "")
    means_df = pd.DataFrame({name: rows.mean() for name, rows in configs.items()}).T
    stds_df = pd.DataFrame({name: rows.std() for name, rows in configs.items()}).T

    best_index = means_df[means_df.auroc == means_df.auroc.max()].index[0]
    best_n_comps = int(best_index.split()[-1]) if "PCA" in best_index else 0
    best_mean = means_df.loc[best_index]

    mlflow = _optional_mlflow()
    if log_mlflow and mlflow is not None:
        for metric, short in (("auroc", "auroc"), ("aupr", "aupr"), ("fpr@95", "fpr95")):
            mlflow.log_metric(f"{postprocessor_name}_{short}_mean", best_mean[metric])
            if multiple_ood_datasets_flag:
                mlflow.log_metric(f"{postprocessor_name}_{short}_std", stds_df.loc[best_index, metric])
        mlflow.log_metric(f"Best {postprocessor_name}", best_n_comps)
    return best_mean["auroc"], best_mean["aupr"], best_mean["fpr@95"], best_n_comps


def subset_boxes(
    ind_dict: Dict[str, np.ndarray],
    ood_dict: Dict[str, np.ndarray],
    ind_train_limit: int,
    ood_limit: int,
    random_seed: int,
    ood_names: List[str],
    non_empty_predictions_id: Optional[Dict[str, List]] = None,
    non_empty_predictions_ood: Optional[Dict[str, List]] = None,
):
    """Random subsetting of extracted boxes for faster eval (metrics.py:465-575).

    Train boxes are subsampled uniformly; the InD valid set is subsampled by
    whole images (so per-image prediction dicts stay consistent); OoD sets are
    subsampled uniformly. Host numpy arrays, drawn from numpy's global
    generator seeded with ``random_seed``: the JAX package's subsets for the
    same seed.
    """
    from collections import Counter

    np.random.seed(random_seed)

    def take(store, split, idx):
        """Apply one index selection to every array of a split."""
        for kind in ("latent_space_means", "logits", "features"):
            key = f"{split} {kind}"
            if key in store:
                store[key] = store[key][np.asarray(idx)]

    train_key = "train latent_space_means"
    if train_key in ind_dict and ind_dict[train_key].shape[0] > ind_train_limit:
        total = ind_dict[train_key].shape[0]
        print(f"Subsetting train set to {ind_train_limit} from {total} extracted boxes")
        take(ind_dict, "train",
             np.random.choice(total, size=ind_train_limit, replace=False))

    valid_key = "valid latent_space_means"
    if (
        valid_key in ind_dict
        and ind_dict[valid_key].shape[0] > ood_limit
        and non_empty_predictions_id is not None
    ):
        # Pick whole images until ~ood_limit boxes are kept.
        per_image = Counter(non_empty_predictions_id["valid"])
        avg_boxes = int(ind_dict[valid_key].shape[0] / len(per_image))
        kept_images = np.random.choice(
            list(per_image.keys()), size=int(ood_limit / avg_boxes), replace=False
        )
        kept_set = set(np.asarray(kept_images).tolist())
        chosen = [
            i for i, im_id in enumerate(non_empty_predictions_id["valid"])
            if im_id in kept_set
        ]
        print(
            f"Subsetting valid set to {len(chosen)} from "
            f"{ind_dict[valid_key].shape[0]} extracted boxes"
        )
        take(ind_dict, "valid", chosen)
        if non_empty_predictions_id is not None:
            non_empty_predictions_id["valid"] = [
                non_empty_predictions_id["valid"][i] for i in chosen
            ]

    for name in ood_names:
        total = ood_dict[f"{name} latent_space_means"].shape[0]
        if total > ood_limit:
            print(f"Subsetting {name} to {ood_limit} from {total} extracted boxes")
            chosen = np.random.choice(total, size=ood_limit, replace=False)
            take(ood_dict, name, chosen)
            if non_empty_predictions_ood is not None:
                non_empty_predictions_ood[name] = [
                    non_empty_predictions_ood[name][i] for i in chosen
                ]

    if non_empty_predictions_id is not None and non_empty_predictions_ood is not None:
        return ind_dict, ood_dict, non_empty_predictions_id, non_empty_predictions_ood
    return ind_dict, ood_dict


def get_gtu_uu_metrics(
    ind_dataset_name: str,
    ind_gt_annotations_path: str,
    ind_data_dict: Dict,
    ood_data_dict: Dict,
    ood_datasets_names: List[str],
    ood_annotations_paths: Dict[str, str],
    methods_names: List[str],
    metric_2007: bool,
    min_conf_score: Optional[float] = None,
) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """AUROC split into GTU (ground-truth unknown) vs UU (unknown unknown)
    detections (reference metrics.py:578-657): InD valid scores vs the OoD
    detections grouped by whether they overlap an unknown GT box."""
    from runia_core_tpu_torch.evaluation.open_set import get_boxes_gtu_and_uu_ood_dataset

    def flat_scores(method):
        values = [
            v for pred_dict in ind_data_dict["valid"].values()
            for v in pred_dict[method]
        ]
        return np.array([values]).squeeze()

    def auroc_vs(ind_scores, ood_scores):
        _, metrics = get_auroc_results(
            detect_exp_name="", ind_samples_scores=ind_scores,
            ood_samples_scores=ood_scores, return_results_for_mlflow=True,
        )
        return metrics

    id_valid_scores = {method: flat_scores(method) for method in methods_names}
    results: Dict = {}
    for ood_name in ood_datasets_names:
        results[ood_name] = {}
        for method in methods_names:
            gtu, uu = get_boxes_gtu_and_uu_ood_dataset(
                id_dataset_name=ind_dataset_name,
                id_gt_annotations_path=ind_gt_annotations_path,
                predictions_dict=ood_data_dict[ood_name],
                method_name=method,
                test_gt_annotations_path=ood_annotations_paths[ood_name],
                metric_2007=metric_2007,
                evaluating_ood=True,
                min_conf_score=min_conf_score,
            )
            results[ood_name][method] = {
                "gtu": auroc_vs(id_valid_scores[method], gtu),
                "uu": auroc_vs(id_valid_scores[method], uu),
            }
    return results
