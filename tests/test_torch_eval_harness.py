"""The port's evaluation harness against runia_core_tpu: ``calculate_all_baselines``
with all twelve baselines and ``log_evaluate_larex`` (baselines, full-vector
scorers, PCA sweep, best configuration, thresholds).

The data are ``tests/test_eval_harness.py``'s shapes (24 features, 4
classes; 300 train, 120 valid, 120 shifted OoD rows). The port is handed CPU
tensors, JAX the same arrays. Baseline scores agree within 1e-5 of the
largest magnitude (1e-4 for mdist, vim and ddu, as in
``tests/test_torch_feature_detectors.py``); the swept tables have the same
rows in the same order, AUROC, FPR@95 and AUPR within 1e-6, the same best
configurations and thresholds within 1e-5.
"""

import copy

import numpy as np
import pytest
import torch

from runia_core_tpu.config import Config
from runia_core_tpu.detectors import get_baselines_thresholds as jax_thresholds
from runia_core_tpu.detectors.funcs import get_predictive_uncertainty_score as jax_pred_uncertainty
from runia_core_tpu.evaluation import baselines as jax_baselines
from runia_core_tpu.evaluation import latent_space as jax_latent_space
from runia_core_tpu_torch.detectors import get_baselines_thresholds
from runia_core_tpu_torch.detectors.funcs import get_predictive_uncertainty_score
from runia_core_tpu_torch.evaluation import (
    baseline_name_dict,
    calculate_all_baselines,
    get_labels_from_logits,
    log_evaluate_larex,
    remove_latent_features,
)

torch.set_num_threads(1)

ALL_BASELINES = ["vim", "msp", "raw", "knn", "energy", "ash", "gen", "react", "dice", "dice_react", "mdist", "ddu"]
LOOSE = ("mdist", "vim", "ddu")


def _close(got, want, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _make_data():
    rng = np.random.RandomState(1)
    d, num_classes = 24, 4
    w = rng.randn(num_classes, d).astype(np.float32) * 0.3
    b = rng.randn(num_classes).astype(np.float32) * 0.1

    def feats(n, shift=0.0):
        labels = rng.randint(0, num_classes, n)
        centers = rng.randn(num_classes, d) * 1.5
        return (np.abs(centers[labels] + rng.randn(n, d)) + shift).astype(np.float32)

    train_f, valid_f, ood_f = feats(300), feats(120), feats(120, shift=2.0)
    ind = {"train features": train_f, "valid features": valid_f, "train logits": train_f @ w.T + b,
           "valid logits": valid_f @ w.T + b, "train latent_space_means": train_f,
           "valid latent_space_means": valid_f}
    ood = {"far features": ood_f, "far logits": ood_f @ w.T + b, "far latent_space_means": ood_f}
    mc_logits = {"ind": rng.randn(120 * 4, num_classes).astype(np.float32),
                 "far": (2.0 * rng.randn(120 * 4, num_classes)).astype(np.float32)}
    cfg = Config(num_classes=num_classes, k_neighbors=5, ash_percentile=85, gen_gamma=0.1, react_percentile=90,
                 dice_percentile=90, ood_datasets=["far"], ind_dataset="synth", n_pca_components=[2, 4],
                 mlflow_experiment_name="test")
    return ind, ood, {"weight": w, "bias": b}, cfg, mc_logits


IND, OOD, FC, CFG, MC_LOGITS = _make_data()


def _tensors(d):
    return {k: torch.from_numpy(v.copy()) for k, v in d.items()}


@pytest.fixture(scope="module")
def both_baselines():
    """Both packages' calculate_all_baselines over all twelve names, once."""
    want = jax_baselines.calculate_all_baselines(ALL_BASELINES, copy.deepcopy(IND), copy.deepcopy(OOD), FC, CFG, 4)
    got = calculate_all_baselines(ALL_BASELINES, _tensors(IND), _tensors(OOD), _tensors(FC), CFG, 4)
    return got, want


@pytest.mark.parametrize("name", ALL_BASELINES)
def test_every_baseline_score_matches_jax(both_baselines, name):
    (got_ind, _, got_ood), (want_ind, _, want_ood) = both_baselines
    rel = 1e-4 if name in LOOSE else 1e-5
    assert got_ind[name].device.type == "cpu" and got_ind[name].shape == (120,)
    _close(got_ind[name], want_ind[name], rel)
    _close(got_ood[f"far {name}"], want_ood[f"far {name}"], rel)


def test_labels_and_thresholds_match_jax(both_baselines):
    (got_ind, got_ood_data, got_ood), (want_ind, want_ood_data, want_ood) = both_baselines
    for split in ("train labels", "valid labels"):
        np.testing.assert_array_equal(got_ind[split].numpy(), want_ind[split])
    np.testing.assert_array_equal(got_ood_data["far labels"].numpy(), want_ood_data["far labels"])
    assert "train logits" not in got_ind and "far logits" not in got_ood_data
    assert set(got_ood) == set(want_ood)
    got = get_baselines_thresholds(ALL_BASELINES, got_ind)
    want = jax_thresholds(ALL_BASELINES, want_ind)
    assert got["raw"] == want["raw"] == 0.0
    for name in ALL_BASELINES:
        assert got[name] == pytest.approx(want[name], rel=1e-4, abs=1e-4), name


def test_gen_class_limit_raises_as_jax():
    for module, make in ((jax_baselines, copy.deepcopy), (None, _tensors)):
        fn = module.calculate_all_baselines if module else calculate_all_baselines
        with pytest.raises(ValueError, match="num_classes greater than 21"):
            fn(["gen"], make(IND), make(OOD), FC, CFG, num_classes=25)


@pytest.mark.parametrize("width", [21, 11, 10])
def test_labels_from_logits_strip_the_background_as_jax(width):
    logits = np.random.RandomState(width).randn(50, width).astype(np.float32)
    want_ind, want_ood = jax_baselines.get_labels_from_logits(
        {"train logits": logits.copy(), "valid logits": []}, {"x logits": logits.copy()}, ["x"])
    got_ind, got_ood = get_labels_from_logits(
        {"train logits": torch.from_numpy(logits.copy()), "valid logits": []},
        {"x logits": torch.from_numpy(logits.copy())}, ["x"], device="cpu")
    np.testing.assert_array_equal(got_ind["train labels"].numpy(), want_ind["train labels"])
    np.testing.assert_array_equal(got_ood["x labels"].numpy(), want_ood["x labels"])
    assert got_ind["valid labels"].shape == want_ind["valid labels"].shape == (0,)
    with pytest.raises(NotImplementedError):
        get_labels_from_logits({}, {}, [], device="cpu")


def test_remove_latent_features_and_plot_names_as_jax():
    got_ind, got_ood = remove_latent_features(dict(IND), dict(OOD), ["far"])
    want_ind, want_ood = jax_baselines.remove_latent_features(dict(IND), dict(OOD), ["far"])
    assert set(got_ind) == set(want_ind) and set(got_ood) == set(want_ood)
    assert baseline_name_dict == jax_baselines.baseline_name_dict


@pytest.fixture(scope="module")
def both_sweeps(tmp_path_factory):
    """Both packages' log_evaluate_larex on the same baselines (msp, energy
    and the MC-dropout pred_h / mi), LaRED / LaREM / LaREK, PCA 2 and 4."""
    names = ["msp", "energy", "pred_h", "mi"]
    results = {}
    for side in ("jax", "port"):
        ind, ood = copy.deepcopy(IND), copy.deepcopy(OOD)
        if side == "jax":
            ind, ood, scores = jax_baselines.calculate_all_baselines(["msp", "energy"], ind, ood, FC, CFG, 4)
            uncertainty = jax_pred_uncertainty
        else:
            ind, ood, scores = calculate_all_baselines(["msp", "energy"], _tensors(ind), _tensors(ood),
                                                       _tensors(FC), CFG, 4)
            uncertainty = get_predictive_uncertainty_score
        for split, key in (("ind", None), ("far", "far")):
            logits = MC_LOGITS[split] if side == "jax" else torch.from_numpy(MC_LOGITS[split])
            pred_h, mi = uncertainty(logits, 4)
            if key is None:
                ind["pred_h"], ind["mi"] = pred_h, mi
            else:
                scores["far pred_h"], scores["far mi"] = pred_h, mi
        run = jax_latent_space.log_evaluate_larex if side == "jax" else log_evaluate_larex
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(tmp_path_factory.mktemp(side))
            results[side] = run(cfg=CFG, baselines_names=names, ood_baselines_scores=scores, ind_data_dict=ind,
                                ood_data_dict=ood, mlflow_run_name="test_run", mlflow_logging=False,
                                postprocessors=["LaRED", "LaREM", "LaREK"])
    return results["port"], results["jax"]


def test_sweep_rows_and_metrics_match_jax(both_sweeps):
    (got_df, _, _, _), (want_df, _, _, _) = both_sweeps
    assert list(got_df.index) == list(want_df.index)
    assert len(got_df) == 4 + 3 * 3  # the baselines, then each scorer on the full vector and at PCA 2 and 4
    assert list(got_df.columns) == list(want_df.columns)
    for column in ("auroc", "fpr@95", "aupr"):
        np.testing.assert_allclose(got_df[column].astype(float), want_df[column].astype(float), rtol=0, atol=1e-6)


def test_sweep_best_configurations_and_thresholds_match_jax(both_sweeps):
    (_, got_best, got_thr, got_ood), (_, want_best, want_thr, want_ood) = both_sweeps
    assert got_best["best"] == want_best["best"]
    for name in ("LaRED", "LaREM", "LaREK"):
        assert got_best[name]["best_comp"] == want_best[name]["best_comp"]
        for metric in ("auroc", "aupr", "fpr"):
            assert got_best[name][metric] == pytest.approx(want_best[name][metric], abs=1e-6)
    assert list(got_thr) == list(want_thr)
    for config, threshold in want_thr.items():
        assert got_thr[config] == pytest.approx(threshold, rel=1e-5, abs=1e-5), config
        _close(got_ood[f"far {config}"], want_ood[f"far {config}"], 1e-4)
