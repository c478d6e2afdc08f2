"""The port's kNN search, linear algebra and latent scorers (cMD, KNN / LaREK,
GMM / LaREG) and the thresholds, against runia_core_tpu.

Scores agree within 1e-5 of the largest magnitude: both sides run f32
matmuls, Cholesky factorisations and triangular solves, in other orders and
libraries. The GMM's jitter rung (the first of the shared ladder at which
every class covariance is positive definite) must be JAX's.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from runia_core_tpu import detectors as jax_detectors
from runia_core_tpu.detectors import funcs as jax_funcs
from runia_core_tpu.detectors.base import get_baselines_thresholds as jax_thresholds
from runia_core_tpu.ops import knn as jax_knn
from runia_core_tpu.ops import linalg as jax_linalg
from runia_core_tpu_torch import detectors
from runia_core_tpu_torch.detectors import funcs
from runia_core_tpu_torch.ops import knn, linalg

torch.set_num_threads(1)


def _close(got, want, rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    scale = max(1.0, float(np.abs(want[finite]).max())) if finite.any() else 1.0
    np.testing.assert_allclose(got[finite], want[finite], rtol=rel, atol=rel * scale)


def _features(n=90, d=6, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n)
    centres = 3.0 * rng.randn(classes, d)
    x = centres[labels] + rng.randn(n, d) @ (np.eye(d) + 0.3 * rng.randn(d, d))
    return x.astype(np.float32), labels


@pytest.mark.parametrize("k,row_chunk", [(1, 1024), (5, 7), (40, 16)])
def test_knn_search_matches_jax(k, row_chunk):
    train, _ = _features(seed=1)
    test, _ = _features(n=23, seed=2)
    want_d, want_i = jax_knn.knn_search(jnp.asarray(test), jnp.asarray(train), k, row_chunk=row_chunk)
    got_d, got_i = knn.knn_search(torch.from_numpy(test), torch.from_numpy(train), k, row_chunk=row_chunk)
    _close(got_d, want_d)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    _close(knn.squared_l2_kth_neighbor(torch.from_numpy(test), torch.from_numpy(train), k, row_chunk),
           jax_knn.squared_l2_kth_neighbor(jnp.asarray(test), jnp.asarray(train), k, row_chunk))


def test_streaming_moments_match_jax_and_the_whole_data():
    x, _ = _features(n=70, seed=3)
    x = x + 50.0  # |mean| >> std: the shift keeps the one-pass covariance exact in f32
    jm = jax_linalg.StreamingMoments(x.shape[1])
    pm = linalg.StreamingMoments(x.shape[1], device="cpu")
    for part in np.array_split(x, 3):
        jm.update(part)
        pm.update(torch.from_numpy(part))
    assert pm.n == jm.n == 70
    _close(pm.mean, jm.mean)
    _close(pm.covariance, jm.covariance)
    _close(pm.covariance, linalg.empirical_covariance(torch.from_numpy(x)).numpy())
    _close(pm.md_state()["precision"], jm.md_state()["precision"], rel=1e-4)


def test_class_means_center_and_shared_precision_match_jax():
    x, labels = _features(seed=4, classes=4)
    labels[labels == 2] = 1  # class 2 empty: a NaN mean row and a warning
    t = torch.from_numpy(x)
    got_means = linalg.class_means(t, torch.from_numpy(labels), 4)
    want_means = jax_linalg.class_means(jnp.asarray(x), jnp.asarray(labels), 4)
    _close(got_means, want_means)
    assert bool(torch.isnan(got_means[2]).all())
    _close(linalg.classwise_center(t, torch.from_numpy(labels), got_means),
           jax_linalg.classwise_center(jnp.asarray(x), jnp.asarray(labels), want_means))
    with pytest.warns(UserWarning) as jw:
        jm, jp = jax_linalg.shared_class_precision(jnp.asarray(x), jnp.asarray(labels), 4)
    with pytest.warns(UserWarning) as pw:
        pm, pp = linalg.shared_class_precision(t, labels, 4)
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw] == ["No examples for class 2"]
    _close(pm, jm)
    _close(pp, jp, rel=1e-4)
    test, _ = _features(n=11, seed=5)
    # an empty class scores -inf and never wins the max
    _close(linalg.classwise_mahalanobis_max(torch.from_numpy(test), pm, pp),
           jax_linalg.classwise_mahalanobis_max(jnp.asarray(test), jm, jp), rel=1e-4)


def _class_covs(x, labels, classes):
    return np.stack([np.cov(x[labels == c].T).astype(np.float32) for c in range(classes)])


@pytest.mark.parametrize("case", ["healthy", "singular"])
def test_mvn_fit_cholesky_takes_jax_rung(case):
    if case == "healthy":
        x, labels = _features(seed=6)
        covs = _class_covs(x, labels, 3)
    else:
        # Each class's 5 samples span 4 of 6 dimensions: rank-deficient.
        rng = np.random.RandomState(7)
        covs = np.stack([np.cov((rng.randn(5, 6) * 3.0).T).astype(np.float32) for _ in range(3)])
    want_chol, want_jitter = jax_linalg.mvn_fit_cholesky(jnp.asarray(covs))
    got_chol, got_jitter = linalg.mvn_fit_cholesky(torch.from_numpy(covs))
    np.testing.assert_array_equal(got_jitter.numpy(), np.asarray(want_jitter))
    assert (float(got_jitter[0]) == 0.0) == (case == "healthy")
    if case == "healthy":
        _close(got_chol, want_chol, rel=1e-4)
    else:  # the factors' null-space pivots are square roots of rounding: compare L L^T
        eye = np.eye(6, dtype=np.float32) * float(want_jitter[0])
        _close(got_chol @ got_chol.transpose(1, 2), covs + eye, rel=1e-5)
    with pytest.raises(ValueError, match="not positive-definite") as got:
        linalg.mvn_fit_cholesky(-torch.eye(3)[None], jitters=[0.0, 1e-3])
    with pytest.raises(ValueError) as want:
        jax_linalg.mvn_fit_cholesky(-jnp.eye(3)[None], jitters=[0.0, 1e-3])
    assert str(got.value) == str(want.value)


def test_mvn_log_prob_matches_jax():
    x, labels = _features(seed=8)
    covs = _class_covs(x, labels, 3)
    means = np.stack([x[labels == c].mean(0) for c in range(3)])
    chols = np.linalg.cholesky(covs).astype(np.float32)
    test, _ = _features(n=13, seed=9)
    _close(linalg.mvn_log_prob(*map(torch.from_numpy, (test, means, chols))),
           jax_linalg.mvn_log_prob(*map(jnp.asarray, (test, means, chols))))
    dist = torch.distributions.MultivariateNormal(torch.from_numpy(means).double(),
                                                  scale_tril=torch.from_numpy(chols).double())
    _close(linalg.mvn_log_prob(*map(torch.from_numpy, (test, means, chols))),
           dist.log_prob(torch.from_numpy(test).double()[:, None]).float().numpy(), rel=1e-4)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_normalizer_matches_jax(as_tensor):
    x, _ = _features(n=9, seed=10)
    x[3] = 0.0
    got = funcs.normalizer(torch.from_numpy(x) if as_tensor else x)
    assert isinstance(got, torch.Tensor) == as_tensor
    _close(torch.as_tensor(got), jax_funcs.normalizer(x))


def test_gmm_fit_and_log_prob_match_jax():
    x, labels = _features(seed=11, classes=4)
    labels[labels == 3] = 0
    labels[0] = 3  # one sample in class 3: its covariance divides by 1 (and is singular)
    # five classes: class 4 has no sample and leaves the mixture
    want, want_jitter = jax_funcs.gmm_fit(x, labels, 5)
    got, got_jitter = funcs.gmm_fit(torch.from_numpy(x), labels, 5)
    assert got.means.shape == (4, 6) and want_jitter > 0.0
    assert got_jitter == want_jitter
    _close(got.means, want.means)
    test, _ = _features(n=10, seed=12)
    _close(funcs.gmm_log_prob(got, torch.from_numpy(test)), jax_funcs.gmm_log_prob(want, jnp.asarray(test)), rel=1e-4)
    _close(got.log_prob(torch.from_numpy(test)[:, None]), want.log_prob(jnp.asarray(test)[:, None]), rel=1e-4)


@pytest.fixture(scope="module")
def fitted():
    x, labels = _features(n=120, d=8, classes=3, seed=13)
    test, _ = _features(n=17, d=8, classes=3, seed=14)
    return x, labels, test


@pytest.mark.parametrize("name", ["cMD", "KNN", "LaREK", "GMM", "LaREG"])
def test_latent_scorers_match_jax(fitted, name):
    x, labels, test = fitted
    jax_det, det = jax_detectors.postprocessors_dict[name](), detectors.postprocessors_dict[name]()
    fit_kw = {} if name in ("KNN", "LaREK") else {"ind_train_labels": labels}
    jax_det.setup(x, **fit_kw)
    det.setup(torch.from_numpy(x), **fit_kw)
    score_kw = {"pred_labels": np.zeros(len(test))} if name == "cMD" else {}
    want = jax_det.postprocess(test, **score_kw)
    got = det.postprocess(torch.from_numpy(test), **score_kw)
    _close(got, want, rel=1e-4 if name == "cMD" else 1e-5)
    with pytest.warns(UserWarning, match="already trained"):
        det.setup(torch.from_numpy(x), **fit_kw)
    loaded = type(det)()
    loaded.load_state(det.state)
    _close(loaded.postprocess(torch.from_numpy(test), **score_kw), got.numpy(), rel=1e-6)


def test_knn_k_and_class_count_come_from_the_cfg():
    class Cfg:
        k_neighbors = 3
        num_classes = 4

    assert detectors.KNNLatentSpace(Cfg()).K == jax_detectors.KNNLatentSpace(Cfg()).K == 3
    assert detectors.KNNLatentSpace().K == jax_detectors.KNNLatentSpace().K == 50
    assert detectors.GMMLatentSpace(Cfg()).num_classes == detectors.cMDLatentSpace(Cfg()).num_classes == 4
    assert detectors.cMDLatentSpace().num_classes == jax_detectors.cMDLatentSpace().num_classes == 10


@pytest.mark.parametrize("name,setup,kw", [
    ("cMD", True, {}), ("cMD", False, {}), ("GMM", True, {}), ("KNN", True, {"extra": 1}),
])
def test_latent_scorer_errors_have_the_jax_wording(fitted, name, setup, kw):
    x, labels, test = fitted
    jax_det, det = jax_detectors.postprocessors_dict[name](), detectors.postprocessors_dict[name]()
    if setup:
        bad = x[:, :, None] if name == "KNN" else x
        with pytest.raises((ValueError, AssertionError)) as want:
            jax_det.setup(bad, **kw)
        with pytest.raises(ValueError) as got:
            det.setup(torch.from_numpy(bad), **kw)
        assert str(got.value) == str(want.value) or "2 dimensional" in str(got.value)
    else:
        jax_det.setup(x, ind_train_labels=labels)
        det.setup(torch.from_numpy(x), ind_train_labels=labels)
        with pytest.raises(ValueError) as want:
            jax_det.postprocess(test)
        with pytest.raises(ValueError) as got:
            det.postprocess(torch.from_numpy(test))
        assert str(got.value) == str(want.value)


def test_baselines_thresholds_match_jax():
    rng = np.random.RandomState(15)
    scores = {"MD": rng.randn(50).astype(np.float32) - 3.0, "KNN": rng.rand(31).astype(np.float32),
              "raw": rng.randn(5)}
    names = ["raw", "MD", "KNN"]
    want = jax_thresholds(names, scores, 1.645)
    got = detectors.get_baselines_thresholds(names, {k: torch.from_numpy(v) for k, v in scores.items()}, 1.645)
    assert got["raw"] == want["raw"] == 0.0
    for name in ("MD", "KNN"):  # numpy's f32 sums on the JAX side, f64 here
        assert got[name] == pytest.approx(want[name], rel=1e-5)
        x = scores[name].astype(np.float64)
        assert got[name] == pytest.approx(x.mean() - 1.645 * x.std(ddof=0), rel=1e-9)


def test_registry_holds_every_jax_latent_key():
    latent = {name for name, cls in jax_detectors.postprocessors_dict.items()
              if cls.__module__ == "runia_core_tpu.detectors.latent"}
    assert latent == {"KDE", "LaRED", "MD", "LaREM", "cMD", "KNN", "LaREK", "GMM", "LaREG"}
    assert latent <= set(detectors.postprocessors_dict)
    for name in latent:
        assert detectors.postprocessor_input_dict[name] == jax_detectors.postprocessor_input_dict[name]
        assert detectors.postprocessors_dict[name].__name__ == jax_detectors.postprocessors_dict[name].__name__
    assert detectors.LaREKPostprocessor is detectors.KNNLatentSpace
    assert detectors.LaREGPostprocessor is detectors.GMMLatentSpace
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        detectors.KNNLatentSpace().setup(torch.zeros(60, 3))
