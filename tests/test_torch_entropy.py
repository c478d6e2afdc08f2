"""KL entropy: the port's plain versions against every JAX path.

The JAX Pallas kernel runs in interpreter mode, as tests/test_entropy_pallas.py
runs it. The port's marginal_entropy on a CPU tensor is the sorted-window
plain version, which is also what the CUDA kernel is held against on the
card. All paths select the same f32 differences, so they agree to f32
reduction-order noise: 1e-6, the bound of tests/test_entropy_pallas.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from runia_core_tpu.evaluation.entropy import get_dl_h_z as jax_get_dl_h_z
from runia_core_tpu.ops.entropy import _marginal_entropy_sorted as jax_sorted
from runia_core_tpu.ops.entropy import _marginal_entropy_xla as jax_pairwise
from runia_core_tpu.ops.entropy import joint_entropy as jax_joint
from runia_core_tpu.ops.entropy_pallas import marginal_entropy_pallas
from runia_core_tpu_torch.evaluation.entropy import get_dl_h_z
from runia_core_tpu_torch.ops.entropy import (
    _marginal_entropy_xla,
    joint_entropy,
    marginal_entropy,
)

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def _clouds(n, seed, b=4, d=40):
    """Clouds with exact duplicates: DropBlock's zeros and repeated values."""
    rng = np.random.RandomState(seed)
    clouds = rng.randn(b, n, d).astype(np.float32)
    clouds[:, : n // 2, : d // 2] = 0.0
    clouds[:, -2:, d // 2 :] = clouds[:, :1, d // 2 :]
    return clouds


@pytest.mark.parametrize("n,k", [(4, 3), (8, 3), (8, 5), (16, 3), (16, 5), (32, 3), (32, 5)])
def test_marginal_entropy_matches_every_jax_path(n, k):
    clouds = _clouds(n, seed=n + k)
    got = marginal_entropy(torch.from_numpy(clouds), k).numpy()
    got_pairwise = _marginal_entropy_xla(torch.from_numpy(clouds), k, image_chunk=3).numpy()
    x = jnp.asarray(clouds)
    for want in (jax_sorted(x, k), jax_pairwise(x, k), marginal_entropy_pallas(x, k, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        np.testing.assert_allclose(got_pairwise, np.asarray(want), **TOL)


def test_all_identical_cloud_is_clamped():
    clouds = np.ones((2, 16, 8), np.float32)
    got = marginal_entropy(torch.from_numpy(clouds), 5).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_sorted(jnp.asarray(clouds), 5)), **TOL)


def test_joint_entropy_matches_jax():
    clouds = _clouds(16, seed=3, d=300)
    got = joint_entropy(torch.from_numpy(clouds), 5, chunk=128).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_joint(jnp.asarray(clouds), 5)), rtol=1e-5, atol=1e-5)


def test_get_dl_h_z_matches_jax():
    rng = np.random.RandomState(4)
    samples = rng.randn(6 * 16, 24).astype(np.float32)
    samples[:16, :5] = 0.0
    joint, marginal = get_dl_h_z(samples, 16)
    want_joint, want_marginal = jax_get_dl_h_z(samples, 16)
    assert joint.shape == (6, 1) and marginal.shape == (6, 24)
    np.testing.assert_allclose(joint.numpy(), want_joint, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(marginal.numpy(), want_marginal, **TOL)
    with pytest.raises(ValueError):
        get_dl_h_z(samples[:-1], 16)
