"""The port's flash_prefix_attention against runia_core_tpu's.

On a CPU tensor the port's wrapper takes its plain version (the dense masked
attention of ``reference_prefix_attention``, restated in torch); the JAX
kernel runs in interpret mode. The cases are the JAX test's
(tests/test_flash_prefill.py): chunked windows, left pad with empty rows, KV8,
a garbage tail past the window, GQA. Bound: atol = rtol = 2e-5 (2e-4 for
KV8, whose int8 products reach 127^2 times the scales), the JAX test's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from runia_core_tpu.ops.flash_prefill import flash_prefix_attention as jax_flash
from runia_core_tpu.ops.flash_prefill import reference_prefix_attention as jax_reference
from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention, reference_prefix_attention

torch.set_num_threads(1)


def _case(seed, b, hq, g, tq, kk, d):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, hq, tq, d) * 0.3).astype(np.float32)
    k = (rng.randn(b, g, kk, d) * 0.3).astype(np.float32)
    v = (rng.randn(b, g, kk, d) * 0.5).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("tq,kk,bq,bk", [(16, 64, 8, 16), (8, 32, 8, 8), (24, 64, 8, 32)])
def test_chunked_windows_match_the_jax_kernel(tq, kk, bq, bk):
    q, k, v = _case(1, 2, 4, 2, tq, kk, 8)
    q_start = np.asarray([0, 24], np.int32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_start),
                     block_q=bq, block_k=bk, interpret=True)
    got = flash_prefix_attention(*_t(q, k, v, q_start))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_left_pad_gives_zero_rows_for_empty_windows():
    q, k, v = _case(2, 2, 2, 1, 16, 32, 8)
    q_start, kv_start = np.zeros(2, np.int32), np.asarray([5, 0], np.int32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_start), jnp.asarray(kv_start),
                     block_q=8, block_k=8, interpret=True)
    got = flash_prefix_attention(*_t(q, k, v, q_start, kv_start)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
    assert np.all(got[0, :, :5, :] == 0.0)


def test_kv8_scales_on_logits_and_probabilities():
    rng = np.random.RandomState(3)
    q, _, _ = _case(3, 1, 4, 2, 16, 32, 8)
    k8 = rng.randint(-127, 128, (1, 2, 32, 8)).astype(np.int8)
    v8 = rng.randint(-127, 128, (1, 2, 32, 8)).astype(np.int8)
    k_scale = (0.01 + 0.02 * rng.rand(1, 32, 2)).astype(np.float32)
    v_scale = (0.01 + 0.02 * rng.rand(1, 32, 2)).astype(np.float32)
    q_start = np.asarray([8], np.int32)
    args = [jnp.asarray(a) for a in (q, k8, v8, q_start)]
    want = jax_flash(*args, None, jnp.asarray(k_scale), jnp.asarray(v_scale), block_q=8, block_k=8, interpret=True)
    oracle = jax_reference(*args, None, k_scale=jnp.asarray(k_scale), v_scale=jnp.asarray(v_scale))
    qt, kt, vt, qs, ks, vs = _t(q, k8, v8, q_start, k_scale, v_scale)
    got = flash_prefix_attention(qt, kt, vt, qs, None, ks, vs).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=2e-4, rtol=2e-4)


def test_garbage_past_the_window_does_not_leak():
    q, k, v = _case(4, 1, 2, 2, 8, 64, 8)
    q_start = np.asarray([4], np.int32)  # valid keys end at 11
    poison = np.where(np.arange(64)[None, None, :, None] >= 16, np.nan, 0.0).astype(np.float32)
    want = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_start))
    got = flash_prefix_attention(*_t(q, k + poison, v + poison, q_start)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_gqa_reads_the_head_group():
    q, k, v = _case(5, 1, 4, 2, 8, 16, 8)
    v[:, 1] += 100.0
    out = flash_prefix_attention(*_t(q, k, v, np.asarray([8], np.int32))).numpy()
    assert out[0, 0].mean() < 50 and out[0, 1].mean() < 50
    assert out[0, 2].mean() > 50 and out[0, 3].mean() > 50


def test_strided_cache_view_and_launch_count():
    """The model hands its (B, K, G, D) cache over as a transposed view; the
    CPU call takes the plain version and launches nothing."""
    q, k, v = _case(6, 2, 4, 2, 12, 40, 16)
    q_start = np.asarray([3, 28], np.int32)
    qt, kt, vt, qs = _t(q, k, v, q_start)
    cache_k, cache_v = kt.transpose(1, 2).contiguous(), vt.transpose(1, 2).contiguous()
    before = flash_prefix_attention.launches
    got = flash_prefix_attention(qt, cache_k.transpose(1, 2), cache_v.transpose(1, 2), qs)
    want = reference_prefix_attention(qt, kt, vt, qs)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert flash_prefix_attention.launches == before
