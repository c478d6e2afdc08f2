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
from runia_core_tpu.ops.entropy import marginal_entropy as jax_marginal_entropy
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


@pytest.mark.parametrize("n,k", [(100, 5), (600, 5), (40, 20)])
def test_marginal_entropy_past_the_old_kernel_limit_matches_jax(n, k):
    """n = 100 raised on the card while the kernel took n <= 64, and k = 20
    was past its contract while k was a template parameter; n = 600 still is
    and takes the sorted-window form."""
    clouds = _clouds(n, seed=n, b=2, d=24)
    got = marginal_entropy(torch.from_numpy(clouds), k).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_marginal_entropy(jnp.asarray(clouds), k)), **TOL)


def test_marginal_entropy_route_is_chosen_by_shape(monkeypatch):
    import runia_core_tpu_torch.ops.entropy_cuda as entropy_cuda

    seen = []
    kernel_wrapper = entropy_cuda.marginal_entropy_cuda

    def spy(clouds, k, min_dist=1e-5):
        seen.append((clouds.shape[1], k))
        return kernel_wrapper(clouds, k, min_dist)

    monkeypatch.setattr(entropy_cuda, "marginal_entropy_cuda", spy)
    # k is taken at run time, so any k < n goes to the kernel's wrapper.
    for n, k in ((100, 5), (512, 15), (513, 5), (40, 16), (40, 39), (40, 40), (40, 0)):
        marginal_entropy(torch.zeros((1, n, 3)), k)
    assert seen == [(100, 5), (512, 15), (40, 16), (40, 39)]


def test_entropy_kernels_block_width_fits_shared_memory():
    from runia_core_tpu_torch.ops.entropy_cuda import MAX_SMEM, block_width

    assert block_width(16) == 128  # the headline clouds
    assert block_width(454) == 128 and block_width(455) == 64  # n columns of 128 floats pass 227 KB
    assert block_width(512) == 64
    assert block_width(16, 16 * 16 * 4) == 128  # the fused kernel's keep-weights at the headline tap
    assert block_width(256, 256 * 196 * 4) == 0  # keep-weights alone pass 227 KB
    for rows, extra in ((100, 0), (512, 0), (300, 300 * 49 * 4)):
        width = block_width(rows, extra)
        assert rows * width * 4 + extra <= MAX_SMEM < rows * 2 * width * 4 + extra or width == 128


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
