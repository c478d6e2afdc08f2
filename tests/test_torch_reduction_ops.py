"""The port's reductions, dropout, sampler layer types, entropies and PCA
against runia_core_tpu.

Random streams never match across frameworks, so every draw the JAX side
makes (Bernoulli keep masks, DropBlock keep-weights, the randomized SVD's
Gaussian test matrix) is injected into the port. Tolerances: 1e-6 where
both sides run the same f32 operations (relative to the largest magnitude),
1e-5 where an SVD or an eigendecomposition runs in another library.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.evaluation.entropy import single_image_entropy_calculation as jax_single_entropy
from runia_core_tpu.ops import entropy as jax_entropy
from runia_core_tpu.ops import reductions as jax_reductions
from runia_core_tpu.ops.dropblock import dropout as jax_dropout
from runia_core_tpu.ops.linalg import StreamingMoments as JaxMoments
from runia_core_tpu.ops.mc_entropy_pallas import mc_dropblock_weights as jax_mc_weights
from runia_core_tpu import reduction as jax_reduction
from runia_core_tpu.sampling import MCSamplerModule as JaxSampler
from runia_core_tpu.sampling import mc_dropblock_samples as jax_mc_samples
from runia_core_tpu_torch import reduction
from runia_core_tpu_torch.evaluation import single_image_entropy_calculation
from runia_core_tpu_torch.ops import entropy, reductions
from runia_core_tpu_torch.ops.dropblock import dropout
from runia_core_tpu_torch.ops.linalg import StreamingMoments
from runia_core_tpu_torch.sampling import MCSamplerModule, mc_dropblock_samples

torch.set_num_threads(1)


def _close(got, want, rel=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(1.0, float(np.abs(want).max())))


def _map(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name", ["mean", "fullmean"])
def test_mean_or_fullmean_matches_jax(name):
    x = _map(0, (3, 5, 4, 6))
    _close(reductions.get_mean_or_fullmean_ls_sample(torch.from_numpy(x), name),
           jax_reductions.get_mean_or_fullmean_ls_sample(jnp.asarray(x), name))


@pytest.mark.parametrize("fn", ["get_variance_ls_sample", "get_std_ls_sample"])
def test_std_and_variance_of_stds_keep_ddof_1(fn):
    x = _map(1, (2, 7, 5, 4))
    got = getattr(reductions, fn)(torch.from_numpy(x))
    _close(got, getattr(jax_reductions, fn)(jnp.asarray(x)))
    # the composition: ddof=1 over W, then ddof=1 over H
    inner = np.std(x, axis=3, ddof=1) if fn == "get_std_ls_sample" else np.var(x, axis=3, ddof=1)
    outer = np.std(inner, axis=2, ddof=1) if fn == "get_std_ls_sample" else np.var(inner, axis=2, ddof=1)
    _close(got, outer, rel=1e-5)


def test_reductions_refuse_an_unknown_method():
    with pytest.raises(ValueError, match="'mean' or 'fullmean'"):
        reductions.get_mean_or_fullmean_ls_sample(torch.zeros(1, 2, 3, 3), "max")


@pytest.mark.parametrize("rate", [0.0, 0.3, 0.5])
def test_dropout_with_jax_keep_mask(rate):
    x = _map(2, (4, 33))
    key = jax.random.key(3)
    want = np.asarray(jax_dropout(key, jnp.asarray(x), rate))
    keep = torch.from_numpy(np.array(jax.random.bernoulli(key, 1.0 - rate, x.shape)))
    _close(dropout(torch.from_numpy(x), rate, keep=keep), want)


def test_dropout_draws_at_its_rate():
    x = torch.ones(200, 500)
    out = dropout(x, 0.3, generator=torch.Generator().manual_seed(0))
    kept = float((out != 0).float().mean())
    assert abs(kept - 0.7) < 5 * np.sqrt(0.21 / x.numel())
    assert torch.allclose(out[out != 0], torch.tensor(1 / 0.7))
    assert dropout(x, 0.0) is x


def _layout(x_nchw, channel_axis):
    return x_nchw if channel_axis == 1 else np.ascontiguousarray(x_nchw.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("channel_axis", [1, 3])
@pytest.mark.parametrize("layer_type,reduction_", [("Conv", "mean"), ("FC", "fullmean"), ("RPN", "fullmean"),
                                                   ("Conv", "fullmean")])
def test_sampler_layer_types_with_jax_weights(layer_type, reduction_, channel_axis):
    b, c, h, w, s = 3, 6, 5, 4, 8
    latent = _layout(_map(4, (b, c, h, w)), channel_axis)
    key = jax.random.key(11)
    want = np.asarray(jax_mc_samples(key, jnp.asarray(latent), s, 3, 0.5, layer_type, reduction=reduction_,
                                     channel_axis=channel_axis))
    weights = torch.tensor(np.asarray(jax_mc_weights(key, b, h, w, s, 3, 0.5)))
    got = mc_dropblock_samples(torch.from_numpy(latent), s, 3, 0.5, layer_type, reduction=reduction_,
                               channel_axis=channel_axis, weights=weights)
    _close(got, want)


def test_nhwc_mean_samples_are_c_major_as_nchw():
    x = _map(5, (2, 6, 5, 4))
    w = torch.rand(2, 4, 20, generator=torch.Generator().manual_seed(1))
    nchw = mc_dropblock_samples(torch.from_numpy(x), 4, 3, 0.5, "Conv", "mean", channel_axis=1, weights=w)
    nhwc = mc_dropblock_samples(torch.from_numpy(_layout(x, 3)), 4, 3, 0.5, "Conv", "mean", channel_axis=3,
                                weights=w)
    _close(nhwc, nchw.numpy())


def test_sampler_module_api_and_shims():
    jax_sampler = JaxSampler(mc_samples=4, block_size=3, drop_prob=0.5, layer_type="FC")
    sampler = MCSamplerModule(mc_samples=4, block_size=3, drop_prob=0.5, layer_type="FC",
                              generator=torch.Generator().manual_seed(0))
    for obj in (sampler, jax_sampler):
        assert obj.to("cpu") is obj and obj.train() is obj and obj.eval() is obj
    x = _map(6, (1, 3, 4, 4))
    key = jax.random.key(2)
    weights = torch.tensor(np.asarray(jax_mc_weights(key, 1, 4, 4, 4, 3, 0.5)))
    _close(sampler(torch.from_numpy(x), weights=weights), jax_sampler(jnp.asarray(x), key))
    assert sampler(torch.from_numpy(x)).shape == (4, 48)


def _clouds(seed, b=3, n=12, d=7):
    x = _map(seed, (b, n, d))
    x[:, :3, :2] = 0.0  # duplicates, as DropBlock makes
    return x


def test_kl_entropy_matches_jax():
    cloud = _clouds(7)[0]
    _close(entropy.kl_entropy(torch.from_numpy(cloud), 5), jax_entropy.kl_entropy(jnp.asarray(cloud), 5))


def test_batched_cloud_entropies_match_jax():
    clouds = _clouds(8)
    joint, marginal = entropy.batched_cloud_entropies(torch.from_numpy(clouds), 5)
    want_joint, want_marginal = jax_entropy.batched_cloud_entropies(jnp.asarray(clouds), 5)
    _close(joint, want_joint)
    _close(marginal, want_marginal)
    # the joint entropy of one cloud is its kl_entropy
    _close(joint[0], entropy.kl_entropy(torch.from_numpy(clouds[0]), 5).numpy())


@pytest.mark.parametrize("n,k", [(16, 5), (4, 3)])
def test_single_image_entropy_calculation_matches_jax(n, k):
    cloud = _clouds(9, b=1, n=n, d=11)[0]
    got = single_image_entropy_calculation(torch.from_numpy(cloud), k)
    assert got.shape == (11,)
    _close(got, jax_single_entropy(cloud, k))


def _wide(n=40, d=30, seed=10):
    rng = np.random.RandomState(seed)
    basis = rng.randn(6, d).astype(np.float32)
    return (rng.randn(n, 6).astype(np.float32) * np.array([9, 7, 5, 3, 2, 1], np.float32)) @ basis \
        + 0.01 * rng.randn(n, d).astype(np.float32) + 2.0


@pytest.mark.parametrize("whiten", [True, False])
def test_randomized_svd_with_jax_test_matrix(whiten):
    x, k = _wide(), 4
    want_t, want = jax_reduction.pca_fit(x, k, whiten, svd_solver="randomized", seed=3)
    omega = torch.tensor(np.asarray(jax.random.normal(jax.random.key(3), (x.shape[1], k + 10), jnp.float32)))
    got_t, got = reduction.pca_fit(torch.from_numpy(x), k, whiten, svd_solver="randomized", omega=omega)
    _close(got.components, want.components, rel=1e-5)
    _close(got.explained_variance, want.explained_variance, rel=1e-5)
    _close(got_t, want_t, rel=1e-5)
    # drawn from a generator: another subspace basis, the same leading components
    _, drawn = reduction.pca_fit(torch.from_numpy(x), k, whiten, svd_solver="randomized",
                                 generator=torch.Generator().manual_seed(0))
    _close(drawn.components, want.components, rel=1e-4)


def test_auto_solver_is_randomized_only_above_4096(monkeypatch):
    calls = []
    real = reduction._randomized_svd
    monkeypatch.setattr(reduction, "_randomized_svd", lambda x, *a, **kw: calls.append(tuple(x.shape)) or real(x, *a, **kw))
    x = torch.from_numpy(_wide(n=12, d=4100, seed=11))
    assert reduction.pca_fit(x, 2, generator=torch.Generator().manual_seed(0))[1].components.shape == (2, 4100)
    assert reduction.pca_fit(x[:, :300], 2)[1].components.shape == (2, 300)
    assert calls == [(12, 4100)]


def test_pca_from_covariance_matches_jax():
    x = _wide(seed=12)
    moments = JaxMoments(x.shape[1])
    moments.update(x[:25]).update(x[25:])
    want = jax_reduction.pca_from_covariance(moments.mean, moments.covariance, x.shape[0], 5)
    port = StreamingMoments(x.shape[1], device="cpu")
    port.update(torch.from_numpy(x[:25])).update(torch.from_numpy(x[25:]))
    _close(port.mean, moments.mean, rel=1e-5)
    _close(port.covariance, moments.covariance, rel=1e-5)
    got = reduction.pca_from_covariance(port.mean, port.covariance, x.shape[0], 5)
    _close(got.components, want.components, rel=1e-5)
    _close(got.explained_variance, want.explained_variance, rel=1e-5)
    # the moments' PCA is the data's, component by component
    _close(got.components, reduction.pca_fit(torch.from_numpy(x), 5)[1].components.numpy(), rel=1e-4)


def test_apply_pca_ds_matches_jax():
    train, test = _wide(seed=13), _wide(n=9, seed=14)
    want_train, want_test, _ = jax_reduction.apply_pca_ds(train, test, 5)
    got_train, got_test, state = reduction.apply_pca_ds(torch.from_numpy(train), torch.from_numpy(test), 5)
    _close(got_train, want_train, rel=1e-5)
    _close(got_test, want_test, rel=1e-5)
    assert state.n_components_ == 5


@pytest.mark.parametrize("call", ["fit_pacmap", "plot_samples_pacmap"])
def test_pacmap_needs_the_optional_package_as_in_jax(call):
    args = (np.zeros((4, 3)),) if call == "fit_pacmap" else (np.zeros((4, 3)), np.zeros((4, 3)))
    with pytest.raises(ImportError) as want:
        getattr(jax_reduction, call)(*args)
    with pytest.raises(ImportError) as got:
        getattr(reduction, call)(*args)
    assert str(got.value) == str(want.value)
