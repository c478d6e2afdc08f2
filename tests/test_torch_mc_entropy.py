"""Fused MC-DropBlock + entropy: the port's plain version of CUDA kernel 2
against the JAX Pallas kernel (interpreter mode), given the JAX keep-weights.

Configurations and tolerance are those of tests/test_mc_entropy_fused.py:
the (S, HW) @ (HW, C) products sum in another order, rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.ops.mc_entropy_pallas import fused_mc_entropy as jax_fused
from runia_core_tpu.ops.mc_entropy_pallas import mc_dropblock_weights as jax_mc_weights
from runia_core_tpu_torch.ops.entropy import marginal_entropy
from runia_core_tpu_torch.ops.mc_entropy_cuda import fused_mc_entropy, fused_mc_entropy_plain
from runia_core_tpu_torch.sampling import mc_dropblock_samples

torch.set_num_threads(1)

CONFIGS = [
    # (fmap shape, key, S, block_size, drop_prob)
    ((5, 4, 4, 300), 3, 16, 3, 0.5),
    ((3, 8, 8, 64), 11, 8, 2, 0.3),
]


@pytest.mark.parametrize("shape,seed,s,bs,p", CONFIGS)
def test_fused_matches_jax_kernel(shape, seed, s, bs, p):
    fmap = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    b, h, w, _ = shape
    key = jax.random.key(seed)
    want = np.asarray(jax_fused(key, jnp.asarray(fmap), s, bs, p, interpret=True))
    weights = torch.tensor(np.asarray(jax_mc_weights(key, b, h, w, s, bs, p)))
    got = fused_mc_entropy(weights, torch.from_numpy(fmap)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,seed,s,bs,p", CONFIGS)
def test_fused_plain_equals_two_step(shape, seed, s, bs, p):
    """The kernel's plain version is the scorer's two-step route in one call."""
    fmap = torch.from_numpy(np.random.RandomState(seed).rand(*shape).astype(np.float32))
    b, h, w, _ = shape
    weights = torch.tensor(np.asarray(jax_mc_weights(jax.random.key(seed), b, h, w, s, bs, p)))
    k = 5 if s > 5 else s - 1
    two_step = marginal_entropy(mc_dropblock_samples(fmap, s, bs, p, channel_axis=3, weights=weights), k)
    torch.testing.assert_close(fused_mc_entropy_plain(weights, fmap), two_step, rtol=0, atol=0)


def test_fused_contract():
    from runia_core_tpu_torch.ops.mc_entropy_cuda import fused_mc_entropy_supported

    assert fused_mc_entropy_supported(16, 16, 5)  # the headline tap
    assert fused_mc_entropy_supported(512, 49, 5)  # RN50 tap, 512 samples
    assert not fused_mc_entropy_supported(513, 16, 5)
    assert not fused_mc_entropy_supported(16, 16, 16)
    assert fused_mc_entropy_supported(40, 16, 20)  # k past the 15 it was held to as a template parameter
    assert not fused_mc_entropy_supported(256, 196, 5)  # keep-weights past 227 KB


def test_scorer_fused_route_takes_the_plain_version_past_the_contract(monkeypatch):
    """A 64 x 64 tap's 16 x 4096 keep-weights do not fit one block's shared
    memory: the fused route must not reach the kernel's wrapper, and scores
    as the two-step route does."""
    import runia_core_tpu_torch.inference.image_level as image_level

    def refuse(*args, **kwargs):
        raise AssertionError("the fused kernel's wrapper was called past its contract")

    monkeypatch.setattr(image_level, "fused_mc_entropy", refuse)
    rng = np.random.RandomState(0)
    tap = torch.from_numpy(rng.rand(2, 64, 64, 4).astype(np.float32))
    weights = torch.from_numpy(rng.rand(2, 16, 64 * 64).astype(np.float32))
    state = {"feats_mean": torch.zeros(4), "precision": torch.eye(4)}
    scores = {
        fused: image_level.build_larex_scorer(
            lambda x: (x, {"pre_pool": tap}), None, state, 16, 0.5, 3, fused=fused
        )(tap, weights=weights)[1]
        for fused in (False, True)
    }
    torch.testing.assert_close(scores[True], scores[False], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_scorer_fused_route_reads_the_tap_in_the_forwards_type(monkeypatch, dtype):
    """A bf16 or f32 tap reaches the fused kernel's wrapper as it is, with no
    f32 copy (widening is exact, so the scores equal those of the f32-cast
    tap bit for bit); any other type is cast to f32 first."""
    import runia_core_tpu_torch.inference.image_level as image_level

    seen = []
    wrapper = image_level.fused_mc_entropy

    def spy(weights, fmap, k=None, min_dist=1e-5):
        seen.append(fmap)
        return wrapper(weights, fmap, k, min_dist)

    monkeypatch.setattr(image_level, "fused_mc_entropy", spy)
    rng = np.random.RandomState(1)
    tap = torch.from_numpy(rng.rand(3, 4, 4, 24).astype(np.float32)).to(dtype)
    weights = torch.from_numpy(rng.rand(3, 16, 16).astype(np.float32))
    state = {"feats_mean": torch.zeros(24), "precision": torch.eye(24)}

    def scores(latent, fused):
        scorer = image_level.build_larex_scorer(lambda x: (x, {"pre_pool": latent}), None, state, 16, 0.5, 3, fused=fused)
        return scorer(latent, weights=weights)[1]

    got = scores(tap, True)
    assert len(seen) == 1 and seen[0].dtype == (torch.float32 if dtype == torch.float16 else dtype)
    if dtype != torch.float16:
        assert seen[0].data_ptr() == tap.data_ptr()  # the tap itself, not a copy
    assert torch.equal(got, scores(tap.to(torch.float32), True))
    torch.testing.assert_close(got, scores(tap, False), rtol=1e-6, atol=1e-6)
