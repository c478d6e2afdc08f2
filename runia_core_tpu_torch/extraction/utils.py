"""Aggregation utilities for object-level extraction results (numpy only).

Counterpart of ``runia_core_tpu/extraction/utils.py``, kept as the port's
own copy. Flattens the per-image dicts produced by an object-level
extractor into the flat ``"{dataset} features|logits|latent_space_means"``
arrays the baseline harness consumes, and re-attaches flat per-detection
baseline scores onto the per-image dicts. Behavioral parity with reference
``runia_core/feature_extraction/utils.py:127-244``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = [
    "get_aggregated_data_dict",
    "associate_precalculated_baselines_with_raw_predictions",
]


def _nonempty_blocks(per_image: Dict, field: str) -> List[np.ndarray]:
    """The per-image arrays for one field, skipping images with no detections."""
    return [
        np.asarray(result[field])
        for result in per_image.values()
        if len(result[field]) > 0
    ]


def get_aggregated_data_dict(
    data_dict: Dict,
    dataset_name: str,
    aggregated_data_dict: Dict[str, np.ndarray],
    no_obj_dict: Dict[str, List],
    non_empty_predictions_ids: Dict[str, List],
    probs_as_logits: bool,
) -> Tuple[Dict, Dict, Dict]:
    """Flatten one dataset's per-image extraction dicts into big arrays.

    ``probs_as_logits`` converts probability outputs to log space
    (``log(p + 1e-10)``) so downstream logit-based scorers see logits.
    Also records, per dataset, the image id owning each flattened row
    (``non_empty_predictions_ids``) and any ``no_obj`` bookkeeping entry.
    """
    per_image = data_dict[dataset_name]
    if "no_obj" in per_image:
        no_obj_dict[dataset_name] = per_image.pop("no_obj")

    features = _nonempty_blocks(per_image, "features")
    if features:
        aggregated_data_dict[f"{dataset_name} features"] = np.concatenate(features)

    logits = _nonempty_blocks(per_image, "logits")
    if logits:
        stacked = np.concatenate(logits)
        if probs_as_logits:
            stacked = np.log(stacked + 1e-10)
        aggregated_data_dict[f"{dataset_name} logits"] = stacked

    # Latent means carry row ownership: one im_id per flattened detection row.
    owners: List = []
    means: List[np.ndarray] = []
    for im_id, result in per_image.items():
        n_rows = len(result["latent_space_means"])
        if n_rows == 0:
            continue
        means.append(np.asarray(result["latent_space_means"]))
        owners.extend([im_id] * n_rows)
    non_empty_predictions_ids[dataset_name] = owners
    aggregated_data_dict[f"{dataset_name} latent_space_means"] = np.concatenate(means)

    return aggregated_data_dict, no_obj_dict, non_empty_predictions_ids


def associate_precalculated_baselines_with_raw_predictions(
    data_dict: Dict[str, Dict],
    dataset_name: str,
    ood_baselines_dict: Dict[str, np.ndarray],
    baselines_names: List[str],
    non_empty_ids: List[str],
    is_ood: bool,
) -> Dict[str, Dict]:
    """Scatter flat per-detection baseline scores back onto per-image dicts.

    ``non_empty_ids[i]`` names the image that owns flattened row ``i`` (the
    ownership list produced by :func:`get_aggregated_data_dict`); each image's
    dict grows one list per baseline, in row order. OoD score arrays are keyed
    ``"{dataset} {baseline}"``, in-distribution ones just ``"{baseline}"``.
    """
    key_prefix = f"{dataset_name} " if is_ood else ""
    for baseline_name in baselines_names:
        flat_scores = ood_baselines_dict[f"{key_prefix}{baseline_name}"]
        for row, im_id in enumerate(non_empty_ids):
            data_dict[im_id].setdefault(baseline_name, []).append(flat_scores[row])
    return data_dict
