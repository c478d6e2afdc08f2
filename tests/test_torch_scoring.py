"""The scoring stack (covariance, pseudo-inverse, Mahalanobis, PCA, LaREM,
LaRED) of the port against runia_core_tpu, on the same numpy inputs.

Both sides compute in f32 (the JAX matmuls at Precision.HIGHEST); sums and
factorisations run in other orders, so values agree to about 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.detectors import KDELatentSpace as JaxKDE
from runia_core_tpu.detectors import MDLatentSpace as JaxMD
from runia_core_tpu.detectors.latent import kde_log_density as jax_kde
from runia_core_tpu.ops import linalg as jax_linalg
from runia_core_tpu.ops.knn import squared_l2_distances as jax_sq_dists
from runia_core_tpu.reduction import apply_pca_ds_split as jax_pca_split
from runia_core_tpu.reduction import pca_fit as jax_pca_fit
from runia_core_tpu.reduction import pca_transform as jax_pca_transform
from runia_core_tpu_torch.detectors import (
    KDELatentSpace,
    LaREDPostprocessor,
    LaREMPostprocessor,
    MDLatentSpace,
    kde_log_density,
    postprocessors_dict,
)
from runia_core_tpu_torch.detectors.base import OodPostprocessor, get_method_threshold
from runia_core_tpu_torch.models import detector_state_from_arrays, pca_state_from_arrays
from runia_core_tpu_torch.ops import linalg
from runia_core_tpu_torch.ops.knn import squared_l2_distances
from runia_core_tpu_torch.reduction import apply_pca_ds_split, apply_pca_transform, pca_fit, pca_transform

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)


def _close(got, want, rel=1e-5):
    """Relative to the largest magnitude: f32 sums and SVDs in other orders."""
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=rel * np.abs(want).max())


def _data(n=64, d=12, seed=0):
    rng = np.random.RandomState(seed)
    mix = (np.eye(d) + 0.5 * rng.randn(d, d) / np.sqrt(d)).astype(np.float32)  # well conditioned
    return (rng.randn(n, d).astype(np.float32) @ mix + 3.0).astype(np.float32)


@pytest.mark.parametrize("assume_centered", [False, True])
def test_empirical_covariance(assume_centered):
    x = _data()
    got = linalg.empirical_covariance(torch.from_numpy(x), assume_centered).numpy()
    want = np.asarray(jax_linalg.empirical_covariance(jnp.asarray(x), assume_centered))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n", [64, 8])  # full rank, and rank 7 of 12 (cut off)
def test_pinvh_and_precision(n):
    x = _data(n=n)
    got = linalg.empirical_precision(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_linalg.empirical_precision(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_mahalanobis_quadform_and_distances():
    x, train = _data(seed=1), _data(seed=2)
    mean = x.mean(0, keepdims=True)
    prec = np.array(jax_linalg.empirical_precision(jnp.asarray(x)))
    got = linalg.mahalanobis_quadform(*map(torch.from_numpy, (x, mean, prec))).numpy()
    want = np.asarray(jax_linalg.mahalanobis_quadform(*map(jnp.asarray, (x, mean, prec))))
    np.testing.assert_allclose(got, want, **TOL)
    got = squared_l2_distances(torch.from_numpy(x), torch.from_numpy(train)).numpy()
    want = np.asarray(jax_sq_dists(jnp.asarray(x), jnp.asarray(train)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("whiten", [True, False])
def test_pca_fit_and_transform_match_jax_with_signs(whiten):
    x, test = _data(n=80, d=20, seed=3), _data(n=10, d=20, seed=4)
    got_t, got_state = apply_pca_ds_split(torch.from_numpy(x), 8, whiten=whiten)
    want_t, want_state = jax_pca_split(x, 8, whiten=whiten)
    # Components are compared signed: both sides apply sklearn's svd_flip.
    _close(got_state.components.numpy(), np.asarray(want_state.components))
    _close(got_state.explained_variance.numpy(), np.asarray(want_state.explained_variance))
    _close(got_t.numpy(), want_t)
    want = np.asarray(jax_pca_transform(want_state, jnp.asarray(test)))
    _close(pca_transform(got_state, torch.from_numpy(test)).numpy(), want)
    # The JAX state carried across gives the same projection.
    _close(apply_pca_transform(torch.from_numpy(test), pca_state_from_arrays(want_state, device="cpu")).numpy(), want)
    assert got_state.n_components_ == 8
    # The randomized SVD is ported: given JAX's Gaussian test matrix it
    # fits JAX's state (tests/test_torch_reduction_ops.py holds it wider).
    omega = torch.tensor(np.asarray(jax.random.normal(jax.random.key(0), (20, 18), jnp.float32)))
    got_r = pca_fit(torch.from_numpy(x), 8, whiten, svd_solver="randomized", omega=omega)[1]
    want_r = jax_pca_fit(x, 8, whiten, svd_solver="randomized")[1]
    _close(got_r.components.numpy(), np.asarray(want_r.components))


def test_md_latent_space_matches_jax():
    train, test = _data(seed=5), _data(n=16, seed=6)
    md, jmd = LaREMPostprocessor(), JaxMD()
    md.setup(torch.from_numpy(train))
    jmd.setup(train)
    np.testing.assert_allclose(md.feats_mean.numpy(), np.asarray(jmd.feats_mean), **TOL)
    want = jmd.postprocess(test)
    np.testing.assert_allclose(md.postprocess(test).numpy(), want, rtol=1e-4, atol=1e-3)
    loaded = MDLatentSpace()
    loaded.load_state(detector_state_from_arrays(jmd.state, device="cpu"))
    np.testing.assert_allclose(loaded.postprocess(test).numpy(), want, rtol=1e-4, atol=1e-3)
    assert postprocessors_dict["LaREM"] is MDLatentSpace
    with pytest.warns(UserWarning):
        md.setup(torch.from_numpy(train))


def test_kde_latent_space_matches_jax():
    train, test = _data(n=48, d=6, seed=7) / 4, _data(n=20, d=6, seed=8) / 4
    kde, jkde = LaREDPostprocessor(), JaxKDE()
    kde.setup(torch.from_numpy(train))
    jkde.setup(train)
    want = jkde.postprocess(test)
    np.testing.assert_allclose(kde.postprocess(test).numpy(), want, rtol=1e-5, atol=1e-4)
    loaded = KDELatentSpace()
    loaded.load_state(detector_state_from_arrays(jkde.state, device="cpu"))
    np.testing.assert_allclose(loaded.postprocess(test).numpy(), want, rtol=1e-5, atol=1e-4)
    # Row chunking does not change the result.
    got = kde_log_density(torch.from_numpy(test), torch.from_numpy(train), 0.7, row_chunk=7).numpy()
    want = np.asarray(jax_kde(jnp.asarray(test), jnp.asarray(train), 0.7, row_chunk=16))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_thresholds():
    scores = np.random.RandomState(9).randn(100)
    want = float(np.mean(scores) - 1.645 * np.std(scores))
    assert abs(get_method_threshold(scores, 1.645) - want) < 1e-9
    class Scorer(OodPostprocessor):
        def setup(self, ind_train_data, **kwargs):
            pass

        def postprocess(self, test_data, **kwargs):
            return test_data

    detector = Scorer(flip_sign=True)
    detector.set_threshold(torch.from_numpy(scores))
    assert abs(detector.threshold - want) < 1e-9 and detector.state["threshold"] == detector.threshold
    assert torch.equal(detector.flip_sign_fn(torch.ones(3)), -torch.ones(3))
