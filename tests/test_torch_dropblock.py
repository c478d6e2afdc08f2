"""DropBlock and MC sampling: the port against runia_core_tpu.

Random streams never match across frameworks (threefry vs Philox), so the
parity tests rebuild the JAX Bernoulli seed and feed it to the port; the
port's own torch-RNG draw is checked statistically.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.ops.dropblock import dropblock2d as jax_dropblock2d
from runia_core_tpu.ops.mc_entropy_pallas import mc_dropblock_weights as jax_mc_weights
from runia_core_tpu.sampling import mc_dropblock_samples as jax_mc_samples
from runia_core_tpu_torch.ops.dropblock import dropblock2d, dropblock_keep_weights, dropblock_seed
from runia_core_tpu_torch.ops.mc_entropy_cuda import mc_dropblock_weights
from runia_core_tpu_torch.sampling import MCSamplerModule, mc_dropblock_samples

torch.set_num_threads(1)


def _jax_seed(key, shape, drop_prob, block_size):
    """The draw dropblock.py:53 makes, as f32 0/1."""
    return np.asarray(jax.random.bernoulli(key, drop_prob / block_size**2, shape), np.float32)


@pytest.mark.parametrize("channel_axis", [1, 3])
@pytest.mark.parametrize("block_size", [2, 3, 5])
def test_dropblock2d_matches_jax_to_one_ulp(block_size, channel_axis):
    rng = np.random.RandomState(block_size)
    b, c, h, w = 3, 4, 9, 8
    x = rng.randn(*((b, c, h, w) if channel_axis == 1 else (b, h, w, c))).astype(np.float32)
    key = jax.random.key(10 + block_size)
    want = np.asarray(jax_dropblock2d(key, jnp.asarray(x), 0.5, block_size, channel_axis=channel_axis))
    seed = torch.from_numpy(_jax_seed(key, (b, h, w), 0.5, block_size))
    got = dropblock2d(torch.from_numpy(x), 0.5, block_size, channel_axis=channel_axis, seed=seed).numpy()
    # Same f32 operations in the same order: equal to within one ulp.
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("block_size", [2, 3, 5])
def test_keep_weights_match_jax_mc_weights(block_size):
    b, s, h, w = 3, 8, 7, 7
    key = jax.random.key(block_size)
    want = np.asarray(jax_mc_weights(key, b, h, w, s, block_size, 0.4))
    # mc_dropblock_weights draws sample i's seed from split(key, S)[i].
    seeds = np.stack([_jax_seed(k, (b, h, w), 0.4, block_size) for k in jax.random.split(key, s)], axis=1)
    got = dropblock_keep_weights(torch.from_numpy(seeds), block_size).reshape(b, s, h * w).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("channel_axis", [1, 3])
def test_samples_with_injected_weights_match_jax(channel_axis):
    rng = np.random.RandomState(7)
    b, c, h, w, s = 4, 16, 6, 6, 8
    key = jax.random.key(5)
    latent = rng.rand(*((b, c, h, w) if channel_axis == 1 else (b, h, w, c))).astype(np.float32)
    want = np.asarray(jax_mc_samples(key, jnp.asarray(latent), s, 3, 0.5, "Conv", channel_axis=channel_axis))
    weights = torch.tensor(np.asarray(jax_mc_weights(key, b, h, w, s, 3, 0.5)))
    got = mc_dropblock_samples(
        torch.from_numpy(latent), s, 3, 0.5, "Conv", channel_axis=channel_axis, weights=weights
    ).numpy()
    # The tolerance of tests/test_mc_entropy_fused.py:52 (matmul association).
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_torch_rng_seed_rate_is_gamma():
    drop_prob, block_size = 0.5, 3
    gamma = drop_prob / block_size**2
    seed = dropblock_seed((64, 16, 8, 8), drop_prob, block_size, torch.Generator().manual_seed(1))
    n = seed.numel()
    # Binomial bound: the rate of n Bernoulli(gamma) draws within 5 sigma.
    assert abs(float(seed.mean()) - gamma) < 5 * np.sqrt(gamma * (1 - gamma) / n)
    assert set(torch.unique(seed).tolist()) <= {0.0, 1.0}


def test_torch_rng_keep_weights_average_one_per_image():
    weights = mc_dropblock_weights(32, 8, 8, 16, 3, 0.5, torch.Generator().manual_seed(2))
    assert weights.shape == (32, 16, 64)
    # keep * HW / sum(keep) averages to 1 over each mask, up to f32 rounding.
    np.testing.assert_allclose(weights.mean(dim=-1).numpy(), 1.0, rtol=0, atol=1e-6)
    assert bool((weights == 0).any())  # blocks were dropped


def test_zero_drop_prob_is_identity_and_ones():
    x = torch.randn(2, 3, 4, 4)
    assert dropblock2d(x, 0.0, 3) is x
    assert torch.equal(mc_dropblock_weights(2, 4, 4, 5, 3, 0.0), torch.ones(2, 5, 16))


def test_sampler_module_squeezes_single_image_and_rejects_unported_paths():
    sampler = MCSamplerModule(mc_samples=8, block_size=3, drop_prob=0.5,
                              generator=torch.Generator().manual_seed(3))
    assert sampler(torch.rand(1, 16, 6, 6)).shape == (8, 16)
    assert sampler(torch.rand(2, 16, 6, 6)).shape == (2, 8, 16)
    with pytest.raises(NotImplementedError):
        mc_dropblock_samples(torch.rand(2, 16, 6, 6), 8, 3, 0.5, layer_type="FC")
