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
