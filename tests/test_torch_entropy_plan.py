"""What the two entropy kernels' design fixes outside the device code: the
sorting network, the selection the kernels make step by step, and the launch
plans. The CUDA sources cannot run here; these are the parts of them that
live in Python (ops/entropy_cuda.py, ops/mc_entropy_cuda.py), held to the
plain version and to the JAX package.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from runia_core_tpu.ops.entropy_pallas import marginal_entropy_pallas
from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.evaluation.entropy import neighbors_for
from runia_core_tpu_torch.ops.entropy import _digamma_const, _sorted_kth_distances
from runia_core_tpu_torch.ops.entropy_cuda import (
    CHUNK,
    MAX_N,
    MAX_SMEM,
    REGISTER_WIDTHS,
    STATIC_K,
    batcher_pairs,
    block_width,
    entropy_plan,
    kernel_twin_kth_distances,
    marginal_entropy_plain,
    marginal_entropy_supported,
    resident_width,
    sort_network_header,
)
from runia_core_tpu_torch.ops.mc_entropy_cuda import fused_mc_entropy_supported, fused_plan

torch.set_num_threads(1)


def _apply(pairs, rows):
    """Run the comparators over every row of a (cases, n) array at once."""
    rows = rows.copy()
    for i, j in pairs:
        lo, hi = np.minimum(rows[:, i], rows[:, j]), np.maximum(rows[:, i], rows[:, j])
        rows[:, i], rows[:, j] = lo, hi
    return rows


def _random_and_tied(n, cases, seed):
    """Half continuous values, half drawn from five values (many duplicates),
    with DropBlock's exact zeros in the first columns."""
    rng = np.random.RandomState(seed)
    rows = rng.randn(cases, n).astype(np.float32)
    rows[cases // 2 :] = rng.randint(-2, 3, (cases - cases // 2, n))
    rows[: cases // 4, : n // 2] = 0.0
    return rows


@pytest.mark.parametrize("width,comparators", [(8, 19), (16, 63), (32, 191), (64, 543)])
def test_network_has_batchers_comparator_count(width, comparators):
    pairs = batcher_pairs(width)
    assert len(pairs) == comparators
    assert all(0 <= i < j < width for i, j in pairs)


@pytest.mark.parametrize("width", [8, 16])
def test_network_sorts_every_zero_one_input(width):
    """The 0-1 principle: a comparator network that sorts every 0/1 input
    sorts every input."""
    bits = np.array(list(itertools.product((0, 1), repeat=width)), dtype=np.int8)
    got = _apply(batcher_pairs(width), bits)
    assert (np.diff(got, axis=1) >= 0).all()
    assert (got.sum(axis=1) == bits.sum(axis=1)).all()


@pytest.mark.parametrize("n", [32, 64, 128, 256, 512, 5, 17, 100, 257, 300])
def test_network_sorts_random_and_tied_inputs(n):
    rows = _random_and_tied(n, 2000, seed=n)
    np.testing.assert_array_equal(_apply(batcher_pairs(n), rows), np.sort(rows, axis=1))


@pytest.mark.parametrize("n", [65, 100, 128, 257, 300, 512])
def test_merge_passes_sort_columns_of_sorted_chunks(n):
    """The shared-memory part of a long column: chunks of 64 sorted on their
    own, then the network's passes from p = 64 on."""
    rows = _random_and_tied(n, 2000, seed=n + 1)
    for base in range(0, n, CHUNK):
        rows[:, base : base + CHUNK] = np.sort(rows[:, base : base + CHUNK], axis=1)
    merges = batcher_pairs(n, first_p=CHUNK)
    assert len(merges) < len(batcher_pairs(n))
    np.testing.assert_array_equal(_apply(merges, rows), np.sort(rows, axis=1))


def test_checked_in_header_is_the_generators_output():
    assert (_kernels.CSRC / "kl_sort_networks.cuh").read_text() == sort_network_header()
    for width in REGISTER_WIDTHS:
        assert f"#define RUNIA_SORT_NETWORK_{width}(CX)" in sort_network_header()


def _columns(n, seed):
    """Columns of n values: continuous, tied, with exact zeros, all equal, and
    with one value at each of +/-1e20 (far below the 1e30 padding)."""
    rng = np.random.RandomState(seed)
    cols = [rng.randn(n), rng.randint(-2, 3, n).astype(np.float64), np.full(n, 0.25)]
    zeros = rng.randn(n)
    zeros[: n // 2] = 0.0
    cols.append(zeros)
    if n >= 4:
        wide = rng.randn(n)
        wide[0], wide[-1] = 1e20, -1e20
        cols.append(wide)
    return torch.tensor(np.stack(cols, axis=1)[None], dtype=torch.float32)  # (1, n, columns)


@pytest.mark.parametrize("n", [2, 4, 5, 16, 17, 32, 33, 64, 65, 100, 512])
def test_kernel_twin_selects_the_plain_versions_distances(n):
    """Network-sorted, 1e30-padded chunks, merged, then the window pass over
    the windows inside the column with k at run time: the same f32 distances
    as the plain version, bit for bit, and the same entropy within 1e-6."""
    clouds = _columns(n, seed=n)
    for k in sorted({1, neighbors_for(n), n - 1}):
        want = _sorted_kth_distances(clouds, k)[0]
        got = torch.stack([kernel_twin_kth_distances(clouds[0, :, c], k) for c in range(clouds.shape[2])], dim=1)
        assert torch.equal(got, want), (n, k)
        # The kernel's compensated sum of n f32 logs: their exact sum, rounded once.
        logs = torch.log(2.0 * got.clamp_min(1e-5)).double().sum(dim=0) / n
        entropy = (_digamma_const(k, n) + logs).float()
        # 1e-6, and two f32 ulps where the +/-1e20 column's logs (about 46) make the result large.
        torch.testing.assert_close(entropy, marginal_entropy_plain(clouds, k)[0], rtol=2.4e-7, atol=1e-6)


@pytest.mark.parametrize("n", [16, 32])
def test_kernel_twin_matches_the_jax_kernel(n):
    """Against the TPU kernel in interpreter mode, within the bound
    tests/test_torch_entropy.py holds the plain version to."""
    rng = np.random.RandomState(n)
    clouds = rng.randn(1, n, 6).astype(np.float32)
    clouds[:, : n // 2, :3] = 0.0
    k = neighbors_for(n)
    kth = torch.stack([kernel_twin_kth_distances(torch.from_numpy(clouds[0, :, c]), k) for c in range(6)], dim=1)
    logs = torch.log(2.0 * kth.clamp_min(1e-5)).double().sum(dim=0) / n
    got = (_digamma_const(k, n) + logs).float().numpy()
    want = np.asarray(marginal_entropy_pallas(jnp.asarray(clouds), k, interpret=True))[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [2, 5, 8, 9, 16, 17, 32, 33, 64, 65, 100, 227, 228, 300, 454, 455, 512])
def test_entropy_plan_over_the_contract(n):
    for k in sorted({1, min(STATIC_K, n - 1), n - 1}):
        assert marginal_entropy_supported(n, k)
        plan = entropy_plan(n, k)
        assert plan.register_width in REGISTER_WIDTHS
        assert plan.register_width >= n or (plan.register_width == CHUNK and plan.merged)
        assert plan.merged == (n > CHUNK)
        # narrower instances hold the whole column: the smallest that does is taken
        assert not any(n <= w < plan.register_width for w in REGISTER_WIDTHS)
        assert plan.static_k == (k == STATIC_K and n <= CHUNK)
        assert plan.width in (32, 64, 128)
        assert plan.smem_bytes == (0 if plan.static_k else n * plan.width * 4) <= MAX_SMEM


def test_entropy_plan_keeps_the_most_warps_resident():
    assert entropy_plan(16, 3).width == 128 and entropy_plan(16, 5).smem_bytes == 0
    assert entropy_plan(454, 5).width == 128  # the one width that leaves 4 warps on an SM
    assert entropy_plan(512, 5).width == 32  # three 64 KB blocks, not one of 128 KB
    assert resident_width(512) == 32 and block_width(512) == 64
    assert resident_width(16, MAX_SMEM) == 0  # nothing fits
    for n in range(2, MAX_N + 1, 7):
        width = resident_width(n)
        assert 0 < width <= block_width(n)
    assert not marginal_entropy_supported(MAX_N + 1, 5)
    assert not marginal_entropy_supported(16, 16) and not marginal_entropy_supported(16, 0)


@pytest.mark.parametrize("s,hw,k", [
    (16, 16, 5), (16, 49, 5), (8, 64, 5), (17, 16, 5), (32, 16, 5), (33, 16, 5), (64, 196, 5), (64, 16, 3),
    (17, 3136, 5), (65, 16, 5), (300, 16, 5), (512, 49, 5), (100, 49, 99),
])
def test_fused_plan_over_the_contract(s, hw, k):
    assert fused_mc_entropy_supported(s, hw, k)
    plan = fused_plan(s, hw, k)
    row = next((w for w in REGISTER_WIDTHS if s <= w), CHUNK)  # a sample-minor row
    assert plan.width in (32, 64, 128) and plan.smem_bytes <= MAX_SMEM
    if plan.sample_minor:
        assert s <= plan.register_width <= CHUNK and not any(s <= w < plan.register_width for w in REGISTER_WIDTHS)
        assert plan.static_k == (k == STATIC_K)
        assert plan.smem_bytes == hw * row * 4 + (0 if plan.static_k else s * plan.width * 4)
    else:
        assert plan.register_width == CHUNK and not plan.static_k
        assert plan.smem_bytes == s * hw * 4 + s * plan.width * 4
        # the (S, HW) layout is taken only where the padded rows cannot be
        assert s > CHUNK or hw * row * 4 > MAX_SMEM


def test_fused_plan_layouts_and_limits():
    assert fused_plan(16, 16, 5) == (16, True, True, 128, 16 * 16 * 4)  # the headline tap: weights only
    assert fused_plan(64, 16, 5).sample_minor and fused_plan(65, 16, 5).sample_minor is False
    assert not fused_plan(17, 3136, 5).sample_minor  # 32 x 3136 floats pass 227 KB; 17 x 3136 do not
    # the contract did not narrow: what (S, HW) plus S samples of a 32-wide block held, it still holds
    for s, hw in itertools.product((2, 8, 17, 33, 64, 100, 257, 512), (1, 16, 49, 196, 784, 3136)):
        old = s * (hw + 32) * 4 <= MAX_SMEM
        assert fused_mc_entropy_supported(s, hw, min(5, s - 1)) >= old, (s, hw)
    assert not fused_mc_entropy_supported(256, 196, 5) and not fused_mc_entropy_supported(16, 4096, 5)
    assert fused_mc_entropy_supported(100, 49, 99) and not fused_mc_entropy_supported(100, 49, 100)
