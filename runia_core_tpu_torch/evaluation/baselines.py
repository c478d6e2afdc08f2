"""Baselines harness: any subset of the post-hoc OoD scores from
pre-extracted {features, logits} dictionaries.

Counterpart of ``runia_core_tpu/evaluation/baselines.py``, driving the
port's detector classes: the RCNN background column is dropped from 21- and
11-wide logits before their argmax (``get_labels_from_logits``), 'raw' is
MSP with no threshold, and each baseline reads its hyperparameter from the
cfg keys the reference uses. ``calculate_all_baselines`` places the arrays
of both dictionaries on ``device`` (None: the GPU) once, so every
detector fits and scores there; the scores it adds are tensors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from runia_core_tpu_torch.detectors import ASH, DDU, DICE, GEN, KNN, MSP, DICEReAct, Energy, Mahalanobis, ReAct, ViM
from runia_core_tpu_torch.detectors.logits import msp_score
from runia_core_tpu_torch.utils.placement import as_tensor

__all__ = ["baseline_name_dict", "calculate_all_baselines", "get_labels_from_logits", "remove_latent_features"]


def _run_detector(postp, ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict, key,
                  ind_input="valid features", ood_suffix="features", **post_kwargs):
    ind_data_dict[key] = postp.postprocess(test_data=ind_data_dict[ind_input], **post_kwargs)
    for ood_name in ood_names:
        ood_baselines_dict[f"{ood_name} {key}"] = postp.postprocess(
            test_data=ood_data_dict[f"{ood_name} {ood_suffix}"], **post_kwargs)
    return ind_data_dict, ood_baselines_dict


def _fit_on_features(postp, fc_params, ind_data_dict):
    postp.setup(ind_train_data=ind_data_dict["train features"], valid_feats=ind_data_dict["valid features"],
                final_linear_layer_params=fc_params)
    return postp


def get_dice_score_from_features(fc_params, ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict,
                                 percentile):
    print("Calculating DICE score")
    postp = DICE(flip_sign=False, dice_percentile=percentile, num_classes=ind_data_dict["train logits"].shape[1])
    return _run_detector(_fit_on_features(postp, fc_params, ind_data_dict), ind_data_dict, ood_data_dict,
                         ood_names, ood_baselines_dict, "dice")


def get_react_score_from_features(fc_params, ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict,
                                  percentile):
    print("Calculating ReAct score")
    postp = ReAct(flip_sign=False, react_percentile=percentile)
    return _run_detector(_fit_on_features(postp, fc_params, ind_data_dict), ind_data_dict, ood_data_dict,
                         ood_names, ood_baselines_dict, "react")


def get_dice_react_score_from_features(fc_params, ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict,
                                       dice_percentile, react_percentile):
    print("Calculating DICE+ReAct score")
    postp = DICEReAct(flip_sign=False, dice_percentile=dice_percentile, react_percentile=react_percentile,
                      num_classes=ind_data_dict["train logits"].shape[1])
    return _run_detector(_fit_on_features(postp, fc_params, ind_data_dict), ind_data_dict, ood_data_dict,
                         ood_names, ood_baselines_dict, "dice_react")


def get_ash_score_from_features(fc_params, ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict,
                                ash_percentile):
    print("Calculating ash score")
    postp = ASH(flip_sign=False, ash_percentile=ash_percentile)
    return _run_detector(_fit_on_features(postp, fc_params, ind_data_dict), ind_data_dict, ood_data_dict,
                         ood_names, ood_baselines_dict, "ash")


def get_gen_score_from_logits(ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict, gamma, gen_m):
    print("Calculating GEN score")
    postp = GEN(flip_sign=False, gamma=gamma, num_classes=gen_m)
    postp.setup(ind_train_data=ind_data_dict["train logits"])
    return _run_detector(postp, ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict, "gen",
                         ind_input="valid logits", ood_suffix="logits")


def calculate_vim_score(fc_params, ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict):
    print("Calculating ViM score")
    postp = ViM(flip_sign=False)
    postp.setup(ind_train_data=ind_data_dict["train features"], train_logits=ind_data_dict["train logits"],
                valid_feats=ind_data_dict["valid features"], valid_logits=ind_data_dict["valid logits"],
                final_linear_layer_params=fc_params)
    ind_data_dict["vim"] = postp.postprocess(test_data=ind_data_dict["valid features"],
                                             logits=ind_data_dict["valid logits"])
    for ood_name in ood_names:
        ood_baselines_dict[f"{ood_name} vim"] = postp.postprocess(
            test_data=ood_data_dict[f"{ood_name} features"], logits=ood_data_dict[f"{ood_name} logits"])
    return ind_data_dict, ood_baselines_dict


def get_msp_score_from_logits(ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict):
    print("Calculating msp score")
    postp = MSP(flip_sign=False)
    postp.setup(ind_train_data=ind_data_dict["train logits"])
    return _run_detector(postp, ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict, "msp",
                         ind_input="valid logits", ood_suffix="logits")


def get_raw_score_from_logits(ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict):
    """MSP passed through with no detector and no threshold."""
    print("Calculating raw score")
    ind_data_dict["raw"] = msp_score(ind_data_dict["valid logits"])
    for ood_name in ood_names:
        ood_baselines_dict[f"{ood_name} raw"] = msp_score(ood_data_dict[f"{ood_name} logits"])
    return ind_data_dict, ood_baselines_dict


def get_energy_score_from_logits(ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict):
    print("Calculating energy score")
    postp = Energy(flip_sign=False)
    postp.setup(ind_train_data=ind_data_dict["train logits"])
    return _run_detector(postp, ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict, "energy",
                         ind_input="valid logits", ood_suffix="logits")


def get_mahalanobis_score_from_features(ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict,
                                        num_classes):
    print("Calculating mahalanobis score")
    postp = Mahalanobis(flip_sign=False, num_classes=num_classes)
    postp.setup(ind_train_data=ind_data_dict["train features"], train_labels=ind_data_dict["train labels"],
                valid_feats=ind_data_dict["valid features"])
    return _run_detector(postp, ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict, "mdist")


def get_knn_score_from_features(ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict, k_neighbors):
    print("Calculating knn score")
    postp = KNN(flip_sign=False, k_neighbors=k_neighbors)
    postp.setup(ind_train_data=ind_data_dict["train features"], valid_feats=ind_data_dict["valid features"])
    return _run_detector(postp, ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict, "knn")


def get_ddu_score_from_features(ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict, num_classes):
    print("Calculating ddu score")
    postp = DDU(flip_sign=False, num_classes=num_classes)
    postp.setup(ind_train_data=ind_data_dict["train features"], train_labels=ind_data_dict["train labels"],
                valid_feats=ind_data_dict["valid features"])
    return _run_detector(postp, ind_data_dict, ood_data_dict, ood_names, ood_baselines_dict, "ddu")


def _argmax_labels(logits, device) -> Optional[torch.Tensor]:
    """Argmax labels of a logits array or tensor, or None if there is none.

    21- and 11-wide logits are RCNN-style (VOC20 / BDD10 and a trailing
    background column); the background column is dropped first, so labels
    index real classes. An empty list (a split without detections) gives an
    empty label tensor."""
    if isinstance(logits, (np.ndarray, torch.Tensor)):
        logits = as_tensor(logits, device)
        if logits.ndim == 2 and logits.shape[1] in (11, 21):
            logits = logits[:, :-1]
        return logits.argmax(dim=-1)
    if isinstance(logits, list) and not logits:
        return as_tensor(np.empty(0, dtype=np.int64), device)
    return None


def get_labels_from_logits(id_data: Dict, ood_data: Dict, ood_names: List[str], device=None) -> Tuple[Dict, Dict]:
    """Replace the "... logits" entries with "... labels" argmax predictions
    (the logits are popped). A missing InD split gets empty labels as long
    as one InD split carried logits. Labels of an array go to ``device``
    (None: the GPU); of a tensor, stay on its device."""
    train_labels = _argmax_labels(id_data.pop("train logits", None), device)
    valid_labels = _argmax_labels(id_data.pop("valid logits", None), device)
    if train_labels is None and valid_labels is None:
        raise NotImplementedError("in-distribution logits must be numpy arrays or empty lists")
    empty = _argmax_labels([], device) if train_labels is None or valid_labels is None else None
    id_data["train labels"] = train_labels if train_labels is not None else empty
    id_data["valid labels"] = valid_labels if valid_labels is not None else empty
    for ood_name in ood_names:
        labels = _argmax_labels(ood_data.pop(f"{ood_name} logits", None), device)
        if labels is None:
            raise NotImplementedError(f"OoD logits for {ood_name!r} must be a numpy array or an empty list")
        ood_data[f"{ood_name} labels"] = labels
    return id_data, ood_data


def remove_latent_features(id_data: Dict, ood_data: Dict, ood_names: List[str]):
    """Drop the feature arrays to free memory."""
    id_data.pop("train features", None)
    id_data.pop("valid features", None)
    for ood_name in ood_names:
        ood_data.pop(f"{ood_name} features", None)
    return id_data, ood_data


def calculate_all_baselines(
    baselines_names: List[str], ind_data_dict: Dict, ood_data_dict: Dict, fc_params: Optional[Dict], cfg,
    num_classes: int, device=None,
) -> Tuple[Dict, Dict, Dict]:
    """Compute the selected baselines: (InD dict with a score per baseline
    and labels for the logits, OoD dict with labels, {"{ood} {baseline}":
    scores}). ``cfg`` supplies ``ood_datasets``, ``k_neighbors``,
    ``ash_percentile``, ``gen_gamma``, ``react_percentile`` and
    ``dice_percentile``. Every array of the two dictionaries is replaced by
    a tensor on ``device`` (None: the GPU) first."""
    if num_classes > 21 and "gen" in baselines_names:
        raise ValueError(
            "Implementation of gen baseline does not yet support num_classes greater than 21. "
            "Otherwise implement M parameter specification"
        )
    for data in (ind_data_dict, ood_data_dict):
        for key, value in data.items():
            if isinstance(value, np.ndarray):
                data[key] = as_tensor(value, device)
    scores: Dict = {}
    ood_names = list(cfg.ood_datasets)
    args = (ind_data_dict, ood_data_dict, ood_names, scores)
    if "vim" in baselines_names:
        calculate_vim_score(fc_params, *args)
    if "msp" in baselines_names:
        get_msp_score_from_logits(*args)
    if "raw" in baselines_names:
        get_raw_score_from_logits(*args)
    if "knn" in baselines_names:
        get_knn_score_from_features(*args, k_neighbors=cfg.k_neighbors)
    if "energy" in baselines_names:
        get_energy_score_from_logits(*args)
    if "ash" in baselines_names:
        get_ash_score_from_features(fc_params, *args, ash_percentile=cfg.ash_percentile)
    if "gen" in baselines_names:
        get_gen_score_from_logits(*args, gamma=cfg.gen_gamma, gen_m=num_classes)
    if "react" in baselines_names:
        get_react_score_from_features(fc_params, *args, percentile=cfg.react_percentile)
    if "dice" in baselines_names:
        get_dice_score_from_features(fc_params, *args, percentile=cfg.dice_percentile)
    if "dice_react" in baselines_names:
        get_dice_react_score_from_features(fc_params, *args, dice_percentile=cfg.dice_percentile,
                                           react_percentile=cfg.react_percentile)
    ind_data_dict, ood_data_dict = get_labels_from_logits(ind_data_dict, ood_data_dict, ood_names, device)
    args = (ind_data_dict, ood_data_dict, ood_names, scores)
    if "mdist" in baselines_names:
        get_mahalanobis_score_from_features(*args, num_classes=num_classes)
    if "ddu" in baselines_names:
        get_ddu_score_from_features(*args, num_classes=num_classes)
    return ind_data_dict, ood_data_dict, scores


def _plot_names(title: str, x_axis: str, plot_name: str) -> Dict[str, str]:
    return {"plot_title": title, "x_axis": x_axis, "plot_name": plot_name}


baseline_name_dict = {
    "pred_h": _plot_names("Predictive H distribution", "Predictive H score", "pred_h"),
    "mi": _plot_names("Predictive MI distribution", "Predictive MI score", "pred_mi"),
    "msp": _plot_names("Predictive MSP distribution", "Predictive MSP score", "pred_msp"),
    "energy": _plot_names("Predictive energy score distribution", "Predictive energy score", "pred_energy"),
    "mdist": _plot_names("Mahalanobis Distance distribution", "Mahalanobis Distance score", "pred_mdist"),
    "knn": _plot_names("kNN distance distribution", "kNN Distance score", "pred_knn"),
    "ash": _plot_names("ASH score distribution", "ASH score", "ash_score"),
    "dice": _plot_names("DICE score distribution", "DICE score", "dice_score"),
    "react": _plot_names("ReAct score distribution", "ReAct score", "react_score"),
    "dice_react": _plot_names("DICE + ReAct score distribution", "DICE + ReAct score", "dice_react_score"),
    "vim": _plot_names("ViM score distribution", "ViM score", "vim_score"),
    "gen": _plot_names("GEN score distribution", "GEN score", "gen_score"),
    "ddu": _plot_names("DDU score distribution", "DDU score", "ddu_score"),
    "raw": _plot_names("Raw predictions", "Raw predictions", "raw_predictions"),
}
