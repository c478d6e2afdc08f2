"""The LaREx evaluation sweep: baselines -> full-vector evaluation -> PCA sweep ->
best configuration -> thresholds -> ROC and score plots.

Counterpart of ``runia_core_tpu/evaluation/latent_space.py``: the latent
postprocessors fit and score where their inputs lie (an array goes to the
GPU), the tables are pandas on the host, and ``mlflow`` stays optional. A
figure is drawn only where it goes: to mlflow, or to the local logs folder
(``save_plots_to_local``); with neither, the JAX package draws it and drops
it, and here matplotlib and seaborn are not needed.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Dict, List, Tuple, Union

import numpy as np

from runia_core_tpu_torch.detectors import postprocessors_dict
from runia_core_tpu_torch.evaluation.baselines import baseline_name_dict
from runia_core_tpu_torch.evaluation.metrics import (
    METRIC_COLUMNS,
    _optional_mlflow,
    get_auroc_results,
    get_pred_scores_plots,
    log_evaluate_postprocessors,
    save_roc_ood_detector,
    save_scores_plots,
    select_and_log_best_larex,
)
from runia_core_tpu_torch.reduction import apply_pca_ds_split, apply_pca_transform
from runia_core_tpu_torch.utils.placement import to_numpy

__all__ = ["log_baselines", "log_evaluate_larex", "plot_roc_curves"]

DEFAULT_POSTPROCESSORS = ("LaRED", "LaREM", "LaREK")


def _empty_metrics_df():
    import pandas as pd

    return pd.DataFrame(columns=METRIC_COLUMNS)


def _append_rows(dst, src):
    for row_name in src.index.values:
        dst.loc[row_name] = src.loc[row_name]
    return dst


def _figures_go_somewhere(mlflow, mlflow_logging: bool, logs_folder) -> bool:
    return (mlflow_logging and mlflow is not None) or logs_folder is not None


def _log_figure(mlflow, mlflow_logging, logs_folder, figure, artifact_name):
    """Send a figure to mlflow or the local logs folder."""
    if mlflow_logging and mlflow is not None:
        mlflow.log_figure(figure=figure, artifact_file=f"figs/{artifact_name}.png")
    elif logs_folder is not None:
        figure.savefig(f"{logs_folder}/{artifact_name}.png")


def _pca_reduced_dicts(ind_data_dict, ood_data_dict, ood_datasets, n_components):
    """PCA fitted on the train entropies, every split projected with it."""
    train_red, transformation = apply_pca_ds_split(samples=ind_data_dict["train latent_space_means"],
                                                   nro_components=n_components)
    ind_pca = {"train latent_space_means": train_red,
               "valid latent_space_means": apply_pca_transform(ind_data_dict["valid latent_space_means"],
                                                               transformation)}
    for key in ("train labels", "valid labels"):
        if key in ind_data_dict:
            ind_pca[key] = ind_data_dict[key]
    ood_pca = {}
    for name in ood_datasets:
        ood_pca[f"{name} latent_space_means"] = apply_pca_transform(ood_data_dict[f"{name} latent_space_means"],
                                                                    transformation)
        if f"{name} labels" in ood_data_dict:
            ood_pca[f"{name} labels"] = ood_data_dict[f"{name} labels"]
    return ind_pca, ood_pca


def log_evaluate_larex(
    cfg, baselines_names: List[str], ood_baselines_scores: Dict, ind_data_dict: Dict, ood_data_dict: Dict,
    mlflow_run_name: str, mlflow_logging: bool, visualize_score: Union[None, str] = None,
    postprocessors: Union[None, List[str]] = None, save_csv: bool = False, save_plots_to_local: bool = False,
) -> Tuple[object, Dict[str, Dict[str, float]], Dict[str, float], Dict]:
    """The full InD-against-OoD evaluation: table the precomputed baselines;
    fit and score the latent postprocessors on the full entropy vectors and
    after each PCA of ``cfg.n_pca_components``; pick each postprocessor's
    best configuration by mean AUROC; refit it and set its threshold (mean -
    1.645 std of the InD valid scores); plot the ROC overlays. Returns
    (metrics table, best configurations, thresholds, the OoD dict with the
    best configurations' scores)."""
    if postprocessors is None:
        postprocessors = DEFAULT_POSTPROCESSORS
    if visualize_score is not None and visualize_score not in postprocessors_dict:
        raise AssertionError(f"Got {visualize_score}")
    mlflow = _optional_mlflow()
    current_date = datetime.today().strftime("%Y-%m-%d_%H:%M:%S")
    overall_metrics_df = _empty_metrics_df()

    logs_folder = f"./results_logs/ind_{cfg.ind_dataset}/{mlflow_run_name}"
    if not mlflow_logging and save_plots_to_local:
        os.makedirs(logs_folder, exist_ok=False)
    plots_folder = logs_folder if save_plots_to_local else None

    if len(baselines_names) > 0:
        overall_metrics_df = log_baselines(
            baselines_names=baselines_names, ind_dataset=cfg.ind_dataset, ind_data_dict=ind_data_dict,
            ood_baselines_scores=ood_baselines_scores, ood_datasets=cfg.ood_datasets,
            overall_metrics_df=overall_metrics_df, mlflow_logging=mlflow_logging, logs_folder=plots_folder,
        )

    print(f"{postprocessors} running...")
    full_vector_eval = log_evaluate_postprocessors(
        ind_dict=ind_data_dict, ood_dict=ood_data_dict, ood_datasets_names=cfg.ood_datasets,
        experiment_name_extension="", return_density_scores=visualize_score, mlflow_logging=mlflow_logging,
        postprocessors=postprocessors, cfg=cfg,
    )
    overall_metrics_df = _append_rows(overall_metrics_df, full_vector_eval["results_df"])

    if visualize_score is not None and _figures_go_somewhere(mlflow, mlflow_logging, plots_folder):
        score_plots = save_scores_plots(
            scores_ind=full_vector_eval["InD"], ood_scores_dict=full_vector_eval["OoD"],
            ood_datasets_list=cfg.ood_datasets, ind_dataset_name=cfg.ind_dataset,
            post_processor_name=visualize_score,
        )
        for plot_name, plot in score_plots.items():
            _log_figure(mlflow, mlflow_logging, plots_folder, plot.figure, plot_name)

    for n_components in cfg.n_pca_components:
        ind_pca, ood_pca = _pca_reduced_dicts(ind_data_dict, ood_data_dict, cfg.ood_datasets, n_components)
        pca_eval = log_evaluate_postprocessors(
            ind_dict=ind_pca, ood_dict=ood_pca, ood_datasets_names=cfg.ood_datasets,
            experiment_name_extension=f" PCA {n_components}", return_density_scores=None, log_step=n_components,
            mlflow_logging=mlflow_logging, postprocessors=postprocessors, cfg=cfg,
        )
        overall_metrics_df = _append_rows(overall_metrics_df, pca_eval["results_df"])

    if save_csv:
        os.makedirs(f"./results_csvs/{cfg.mlflow_experiment_name}", exist_ok=True)
        csv_name = f"./results_csvs/{cfg.mlflow_experiment_name}/{mlflow_run_name}_{current_date}.csv.gz"
        print(f"Saving csv to {csv_name}")
        overall_metrics_df.to_csv(path_or_buf=csv_name, compression="gzip")
        if mlflow_logging and mlflow is not None:
            mlflow.log_artifact(csv_name)

    best_postprocessors_dict = _get_best_postprocessors_metrics(
        baselines_names=baselines_names, overall_metrics_df=overall_metrics_df, mlflow_logging=mlflow_logging,
        postprocessors=postprocessors, n_pca_components=cfg.n_pca_components, ood_datasets_names=cfg.ood_datasets,
    )
    print(f"Best postprocessors metrics: { {k: v for k, v in best_postprocessors_dict.items() if k != 'best'} }")
    postprocessor_thresholds, ood_data_dict = _get_best_post_processor_thresholds(
        postprocessors_names=postprocessors, best_postprocessors_dict=best_postprocessors_dict, cfg=cfg,
        ind_data=ind_data_dict, ood_data=ood_data_dict, logs_folder=plots_folder, log_mlflow=mlflow_logging,
    )
    print(f"Best postprocessor thresholds: {postprocessor_thresholds}")

    plot_roc_curves(
        ood_datasets=cfg.ood_datasets, postprocessors=postprocessors, overall_metrics_df=overall_metrics_df,
        best_postprocessors_dict=best_postprocessors_dict, mlflow_logging=mlflow_logging,
        ind_dataset=cfg.ind_dataset, logs_folder=plots_folder, baselines_names=baselines_names,
    )
    return overall_metrics_df, best_postprocessors_dict, postprocessor_thresholds, ood_data_dict


def log_baselines(
    baselines_names: List[str], ind_dataset: str, ind_data_dict: Dict, ood_baselines_scores: Dict,
    ood_datasets: List[str], overall_metrics_df, mlflow_logging: bool, logs_folder: Union[str, None],
):
    """Table every precomputed baseline's metrics. pred_h / mi are
    uncertainties (higher = OoD), so they are negated: higher = InD for
    every row."""
    print("Logging baselines")
    mlflow = _optional_mlflow()

    def signed(baseline, values):
        return -values if baseline in ("pred_h", "mi") else values

    if _figures_go_somewhere(mlflow, mlflow_logging, logs_folder):
        for baseline in baselines_names:
            meta = baseline_name_dict[baseline]
            experiment = {"InD": ind_data_dict[baseline], "x_axis": meta["x_axis"], "plot_name": meta["plot_name"]}
            for ood_dataset in ood_datasets:
                experiment[ood_dataset] = ood_baselines_scores[f"{ood_dataset} {baseline}"]
            figure = get_pred_scores_plots(experiment, ood_datasets, title=meta["plot_title"],
                                           ind_dataset_name=ind_dataset)
            _log_figure(mlflow, mlflow_logging, logs_folder, figure.figure, experiment["plot_name"])

    for baseline in baselines_names:
        for ood_dataset in ood_datasets:
            experiment_name = f"{ood_dataset} {baseline}"
            results_df, results_mlflow = get_auroc_results(
                detect_exp_name=experiment_name, ind_samples_scores=signed(baseline, ind_data_dict[baseline]),
                ood_samples_scores=signed(baseline, ood_baselines_scores[experiment_name]),
                return_results_for_mlflow=True,
            )
            if mlflow_logging and mlflow is not None:
                mlflow.log_metrics({f"{experiment_name}_{k}": v for k, v in results_mlflow.items()})
            overall_metrics_df = _append_rows(overall_metrics_df, results_df)
    return overall_metrics_df


def _collect_roc_tables(ood_dataset, postprocessors, overall_metrics_df, best_rows, baselines_names):
    """The 'base' overlay (baselines and best configurations) and one PCA
    sweep per postprocessor, row names without the dataset prefix."""
    tables = {"base": _empty_metrics_df(), **{p: _empty_metrics_df() for p in postprocessors}}
    for row_name in overall_metrics_df.index:
        if ood_dataset not in row_name:
            continue
        short = row_name.split(ood_dataset)[1]
        if row_name in best_rows or row_name.split(f"{ood_dataset} ")[-1] in baselines_names:
            tables["base"].loc[short] = overall_metrics_df.loc[row_name]
        if "PCA" in row_name:
            for postprocessor in postprocessors:
                if postprocessor in row_name:
                    tables[postprocessor].loc[short] = overall_metrics_df.loc[row_name]
    return tables


def plot_roc_curves(
    ood_datasets: List[str], postprocessors: List[str], overall_metrics_df, best_postprocessors_dict: Dict,
    mlflow_logging: bool, ind_dataset: str, logs_folder: Union[str, None], baselines_names: List[str],
) -> None:
    """ROC overlays per OoD dataset and per-postprocessor PCA sweeps, sent to
    mlflow or the logs folder (with neither, nothing is drawn)."""
    mlflow = _optional_mlflow()
    if not _figures_go_somewhere(mlflow, mlflow_logging, logs_folder):
        return
    for ood_dataset in ood_datasets:
        tables = _collect_roc_tables(ood_dataset, postprocessors, overall_metrics_df,
                                     set(best_postprocessors_dict["best"]), baselines_names)
        base_fig = save_roc_ood_detector(results_table=tables["base"],
                                         plot_title=f"ROC {ind_dataset} vs {ood_dataset}",
                                         postprocessors=postprocessors)
        _log_figure(mlflow, mlflow_logging, logs_folder, base_fig, f"roc_{ood_dataset}")
        for postprocessor in postprocessors:
            pca_fig = save_roc_ood_detector(results_table=tables[postprocessor],
                                            plot_title=f"ROC {ind_dataset} vs {ood_dataset} {postprocessor} PCA",
                                            postprocessors=postprocessors)
            _log_figure(mlflow, mlflow_logging, logs_folder, pca_fig, f"roc_{ood_dataset}_pca_{postprocessor}")


def _baseline_mean_metrics(baseline, overall_metrics_df):
    """Mean and std of one baseline's auroc / aupr / fpr@95 over the OoD
    sets; rows end in exactly " {baseline}" ('react' must not take the
    'dice_react' rows)."""
    import pandas as pd

    table = pd.DataFrame([overall_metrics_df.loc[row_name, ["auroc", "fpr@95", "aupr"]]
                          for row_name in overall_metrics_df.index if row_name.rsplit(" ", 1)[-1] == baseline])
    return table.mean(), table.std()


def _get_best_postprocessors_metrics(
    baselines_names: List[str], overall_metrics_df, mlflow_logging: bool, postprocessors: List[str],
    n_pca_components: List[int], ood_datasets_names: List[str],
) -> Dict[str, Dict[str, float]]:
    """Each baseline's means, and each postprocessor's best PCA setting
    ({"best_comp", "auroc", "aupr", "fpr"}; "best" lists the winning rows)."""
    mlflow = _optional_mlflow()
    multiple_ood = len(ood_datasets_names) > 1
    all_aurocs, all_auprs, all_fprs = [], [], []
    for baseline in baselines_names:
        means, stds = _baseline_mean_metrics(baseline, overall_metrics_df)
        all_aurocs.append(means["auroc"])
        all_auprs.append(means["aupr"])
        all_fprs.append(means["fpr@95"])
        if mlflow_logging and mlflow is not None:
            for metric, short in (("auroc", "auroc"), ("aupr", "aupr"), ("fpr@95", "fpr95")):
                mlflow.log_metric(f"{baseline}_{short}_mean", means[metric])
                mlflow.log_metric(f"{baseline}_{short}_std", stds[metric])

    best: Dict[str, Dict] = {"best": []}
    for postprocessor in postprocessors:
        auroc, aupr, fpr, best_comp = select_and_log_best_larex(
            overall_metrics_df, n_pca_components, postprocessor_name=postprocessor, log_mlflow=mlflow_logging,
            multiple_ood_datasets_flag=multiple_ood,
        )
        best_name = postprocessor if best_comp == 0 else f"{postprocessor} PCA {best_comp}"
        best[postprocessor] = {"best_comp": best_name, "auroc": auroc, "aupr": aupr, "fpr": fpr}
        all_aurocs.append(auroc)
        all_auprs.append(aupr)
        all_fprs.append(fpr)
        best["best"].extend(f"{ood_dataset} {best_name}" for ood_dataset in ood_datasets_names)

    if mlflow_logging and mlflow is not None and multiple_ood:
        for name, values in (("auroc", all_aurocs), ("aupr", all_auprs), ("fpr", all_fprs)):
            mlflow.log_metric(f"global_{name}_mean", np.mean(values))
            mlflow.log_metric(f"global_{name}_std", np.std(values))
    return best


def _get_best_post_processor_thresholds(
    postprocessors_names: List, best_postprocessors_dict: Dict, cfg, ind_data: Dict, ood_data: Dict,
    logs_folder: Union[str, None], log_mlflow: bool = False,
) -> Tuple[Dict[str, float], Dict]:
    """Refit each postprocessor's best configuration on the train entropies
    and set its threshold, mean - 1.645 std of its InD valid scores (numpy
    on the host, as the JAX package); the best configuration's OoD scores go
    into ``ood_data`` under "{ood} {config}", and its score histogram to
    mlflow or the logs folder."""
    mlflow = _optional_mlflow()
    draw = _figures_go_somewhere(mlflow, log_mlflow, logs_folder)
    if draw:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    thresholds: Dict[str, float] = {}
    for name in postprocessors_names:
        best_config = best_postprocessors_dict[name]["best_comp"]
        train = ind_data["train latent_space_means"]
        valid = ind_data["valid latent_space_means"]
        transformation = None
        if "PCA" in best_config:
            train, transformation = apply_pca_ds_split(samples=train, nro_components=int(best_config.split("PCA")[1]))
            valid = apply_pca_transform(valid, transformation)
        instance = postprocessors_dict[name](cfg=cfg)
        instance._setup_flag = False
        instance.setup(train, ind_train_labels=ind_data.get("train labels"))
        valid_scores = to_numpy(instance.postprocess(valid, pred_labels=ind_data.get("valid labels")))
        threshold = float(np.mean(valid_scores) - 1.645 * np.std(valid_scores))
        thresholds[best_config] = threshold

        ood_scores = {}
        for ood_name in cfg.ood_datasets:
            ood_split = ood_data[f"{ood_name} latent_space_means"]
            if transformation is not None:
                ood_split = apply_pca_transform(ood_split, transformation)
            ood_scores[ood_name] = instance.postprocess(ood_split, pred_labels=ood_data.get(f"{ood_name} labels"))
            ood_data[f"{ood_name} {best_config}"] = ood_scores[ood_name]
        if log_mlflow and mlflow is not None:
            mlflow.log_metric(f"Threshold_{best_config}", threshold)
        if draw:
            fig, ax = plt.subplots(figsize=(8, 6))
            ax.hist(valid_scores, bins=100, label="InD valid set", alpha=0.4)
            for ood_name, scores in ood_scores.items():
                ax.hist(to_numpy(scores), bins=100, label=f"OoD {ood_name} ", alpha=0.4)
            ax.vlines(x=threshold, ymin=0, ymax=ax.dataLim.bounds[3], colors="r",
                      label=f"95% threshold={round(threshold, 2)}")
            ax.legend()
            ax.set_xlabel("Score")
            ax.set_ylabel("Frquency")
            ax.set_title(f"Empirical {best_config} score distribution")
            _log_figure(mlflow, log_mlflow, logs_folder, fig, f"{best_config}_score_threshold")
            plt.close(fig)
    return thresholds, ood_data
