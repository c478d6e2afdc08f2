"""The port's evaluation metrics against runia_core_tpu.

The port keeps its own copy of the JAX package's numpy curves, so
``binary_roc``, ``binary_precision_recall_curve``, ``auc`` and
``get_auroc_results`` must give JAX's arrays exactly, ties included, for
scores handed over as tensors. ``torch_auroc`` is a rank statistic in
float32 (float64 for float64 scores) as ``jax_auroc`` is: within 1e-6 of
it and of the curve's area. ``percentile`` is ``np.percentile`` to the bit,
also above the 2^24 elements ``torch.quantile`` refuses.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from runia_core_tpu.evaluation import metrics as jax_metrics
from runia_core_tpu_torch.detectors.funcs import percentile
from runia_core_tpu_torch.evaluation import metrics

torch.set_num_threads(1)


def _scores(case: str, dtype=np.float32):
    rng = np.random.RandomState({"continuous": 0, "ties": 1, "all_tied": 2, "separable": 3, "f64": 4}[case])
    ind, ood = rng.randn(300) + 1.0, rng.randn(250)
    if case == "ties":  # a few hundred scores on 21 values
        ind, ood = np.round(ind * 4) / 4, np.round(ood * 4) / 4
    elif case == "all_tied":
        ind, ood = np.zeros(40), np.zeros(30)
    elif case == "separable":
        ood = ood - 10.0
    return ind.astype(dtype), ood.astype(dtype)


CASES = ("continuous", "ties", "all_tied", "separable", "f64")


def _dtype(case):
    return np.float64 if case == "f64" else np.float32


@pytest.mark.parametrize("case", CASES)
def test_curves_and_auc_equal_jax(case):
    ind, ood = _scores(case, _dtype(case))
    scores = np.concatenate([ind, ood])
    labels = np.concatenate([np.ones(ind.size), np.zeros(ood.size)]).astype(np.int32)
    for got, want in ((metrics.binary_roc(torch.from_numpy(scores), torch.from_numpy(labels)),
                       jax_metrics.binary_roc(scores, labels)),
                      (metrics.binary_precision_recall_curve(torch.from_numpy(scores), torch.from_numpy(labels)),
                       jax_metrics.binary_precision_recall_curve(scores, labels))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    fpr, tpr, _ = jax_metrics.binary_roc(scores, labels)
    assert metrics.auc(fpr, tpr) == jax_metrics.auc(fpr, tpr)
    assert metrics.auc(fpr[::-1], tpr[::-1]) == jax_metrics.auc(fpr[::-1], tpr[::-1])


@pytest.mark.parametrize("case", CASES)
def test_get_auroc_results_equals_jax(case):
    ind, ood = _scores(case, _dtype(case))
    got_df, got_ml = metrics.get_auroc_results("x", torch.from_numpy(ind), torch.from_numpy(ood), True)
    want_df, want_ml = jax_metrics.get_auroc_results("x", ind, ood, True)
    assert list(got_df.columns) == list(want_df.columns) and list(got_df.index) == ["x"]
    assert got_ml == want_ml
    for column in ("fpr", "tpr"):
        np.testing.assert_array_equal(got_df.loc["x", column], want_df.loc["x", column])
    plain = metrics.get_auroc_results("x", ind, ood)
    assert plain.loc["x", "auroc"] == want_df.loc["x", "auroc"]


def test_auc_refuses_a_non_monotonic_x_as_jax():
    with pytest.raises(ValueError, match="neither increasing nor decreasing"):
        jax_metrics.auc([0.0, 1.0, 0.5], [0.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="neither increasing nor decreasing"):
        metrics.auc([0.0, 1.0, 0.5], [0.0, 1.0, 1.0])


@pytest.mark.parametrize("case", CASES)
def test_torch_auroc_matches_jax_auroc_and_the_curve(case):
    ind, ood = _scores(case, _dtype(case))
    got = metrics.torch_auroc(torch.from_numpy(ind), torch.from_numpy(ood))
    want = jax_metrics.jax_auroc(jnp.asarray(ind), jnp.asarray(ood))
    assert got.dtype == (torch.float64 if case == "f64" else torch.float32)
    assert got.device.type == "cpu" and got.ndim == 0
    assert float(got) == pytest.approx(float(want), abs=1e-6)
    if case != "all_tied":  # the curve of a single threshold is the diagonal: 0.5 either way
        assert float(got) == pytest.approx(jax_metrics.get_auroc_results("x", ind, ood).loc["x", "auroc"], abs=1e-6)


def test_torch_auroc_takes_jax_test_ties():
    ind, ood = np.array([0.9, 0.5, 0.5, 0.1]), np.array([0.5, 0.5, 0.1, 0.0])
    assert float(metrics.torch_auroc(torch.from_numpy(ind), torch.from_numpy(ood))) == pytest.approx(
        float(jax_metrics.jax_auroc(ind, ood)), abs=1e-6)
    # 11.5 of the 16 pairs won, a tie counting half
    assert float(metrics.torch_auroc(torch.from_numpy(ind), torch.from_numpy(ood))) == pytest.approx(11.5 / 16)


@pytest.mark.parametrize("shape,q", [((7,), 50), ((100,), 90), ((10, 2048), 90), ((3, 5), 0), ((3, 5), 100),
                                     ((1,), 37), ((999,), 85.5), ((4, 4, 4), 12.5)])
def test_percentile_is_numpys(shape, q):
    x = np.random.RandomState(len(shape) + int(q)).randn(*shape).astype(np.float32)
    assert percentile(torch.from_numpy(x), q) == float(np.percentile(x, q))
    x64 = x.astype(np.float64) * np.pi
    assert percentile(torch.from_numpy(x64), q) == float(np.percentile(x64, q))


def test_percentile_above_two_to_the_24_elements():
    """ImageNet-sized train features (50 k x 2048 = 102 M values) pass the
    2^24 elements ``torch.quantile`` takes; the helper does not refuse, and
    numpy's float32 index arithmetic is kept at this size."""
    x = torch.rand(2**24 + 4099, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        torch.quantile(x, 0.9)
    assert percentile(x, 90) == float(np.percentile(x.numpy(), 90))


def test_select_and_log_best_larex_equals_jax():
    rng = np.random.RandomState(7)
    rows = [f"{ood} LaREM{pca}" for ood in ("a", "b") for pca in ("", " PCA 2", " PCA 4", " PCA 16")]
    table = jax_metrics.get_auroc_results(rows[0], rng.randn(50) + 1, rng.randn(40))
    for row in rows[1:]:
        table.loc[row] = jax_metrics.get_auroc_results(row, rng.randn(50) + 1, rng.randn(40)).loc[row]
    for flag in (False, True):
        got = metrics.select_and_log_best_larex(table, [2, 4, 16], "LaREM", flag)
        assert got == jax_metrics.select_and_log_best_larex(table, [2, 4, 16], "LaREM", flag)
    with pytest.raises(AssertionError):
        metrics.select_and_log_best_larex(table, [2], "nope", False)


def test_figures_are_drawn_where_they_go(tmp_path, monkeypatch):
    """With ``save_plots_to_local`` the sweep draws the JAX package's figures
    (baseline score densities, the chosen scorer's histograms, the threshold
    histograms, the ROC overlays) into the logs folder; without a
    destination it draws none, so it runs where matplotlib is absent."""
    import matplotlib

    matplotlib.use("Agg")
    from runia_core_tpu.config import Config
    from runia_core_tpu_torch.evaluation import log_evaluate_larex

    rng = np.random.RandomState(9)
    feats = {"train": rng.rand(60, 6), "valid": rng.rand(30, 6), "far": rng.rand(30, 6) + 0.5}
    ind = {f"{s} latent_space_means": torch.from_numpy(feats[s].astype(np.float32)) for s in ("train", "valid")}
    ood = {"far latent_space_means": torch.from_numpy(feats["far"].astype(np.float32))}
    ind["msp"], scores = torch.from_numpy(rng.rand(30)), {"far msp": torch.from_numpy(rng.rand(30))}
    cfg = Config(ood_datasets=["far"], ind_dataset="synth", n_pca_components=[2], k_neighbors=5)
    monkeypatch.chdir(tmp_path)
    kw = dict(cfg=cfg, baselines_names=["msp"], ood_baselines_scores=scores, ind_data_dict=ind, ood_data_dict=ood,
              mlflow_logging=False, postprocessors=["LaREM", "LaREK"])
    log_evaluate_larex(mlflow_run_name="none", **kw)
    assert not (tmp_path / "results_logs").exists()
    log_evaluate_larex(mlflow_run_name="local", visualize_score="LaREM", save_plots_to_local=True, **kw)
    drawn = sorted(p.name for p in (tmp_path / "results_logs" / "ind_synth" / "local").iterdir())
    assert "pred_msp.png" in drawn and "far_LaREM_scores.png" in drawn and "roc_far.png" in drawn
    assert {"roc_far_pca_LaREM.png", "roc_far_pca_LaREK.png"} <= set(drawn)
    assert sum(name.endswith("_score_threshold.png") for name in drawn) == 2
