"""The port's weight-only int8 product against runia_core_tpu's quant_matmul.

The JAX kernel runs in interpret mode on the CPU, the port's wrapper takes
its plain version on a CPU tensor. Bounds are the JAX test's
(tests/test_quant_matmul.py): relative to max|ref|, one bf16 ulp (8e-3) in
bf16, 1e-5 in f32 (the sums run in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from runia_core_tpu.ops.quant_matmul import quant_matmul as jax_quant_matmul
from runia_core_tpu_torch.models.llama import QDense
from runia_core_tpu_torch.ops.quant_matmul import (
    BLOCK_N,
    MAX_ROWS,
    STAGE_K,
    plan_split_k,
    quant_matmul,
    quant_matmul_plain,
    quant_matmul_supported,
)

torch.set_num_threads(1)

_TORCH = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _case(seed, lead, k, n, dt):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (k,)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(1e-3, 1e-2, (n,)).astype(np.float32)
    x = np.array(jnp.asarray(x, dt).astype(jnp.float32))  # values exact in dt
    return x, wq, scale


@pytest.mark.parametrize("lead,k,n,dt", [
    ((16, 1), 512, 512, jnp.bfloat16),   # decode rows
    ((1,), 256, 512, jnp.float32),
    ((3,), 128, 256, jnp.float32),       # rows not tile-aligned
    ((16, 5), 256, 1280, jnp.bfloat16),  # speculative verify rows, N not a multiple of 512
])
def test_plain_version_matches_the_jax_kernel(lead, k, n, dt):
    x, wq, scale = _case(7, lead, k, n, dt)
    want = np.asarray(
        jax_quant_matmul(jnp.asarray(x, dt), jnp.asarray(wq), jnp.asarray(scale), interpret=True), np.float32
    )
    got = quant_matmul(torch.from_numpy(x).to(_TORCH[dt]), torch.from_numpy(wq), torch.from_numpy(scale))
    assert got.dtype == _TORCH[dt] and tuple(got.shape) == want.shape
    rel = np.abs(got.float().numpy() - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < (8e-3 if dt == jnp.bfloat16 else 1e-5), rel


def test_ragged_k_and_n_need_no_padding():
    x, wq, scale = _case(3, (5,), 100, 37, jnp.float32)
    got = quant_matmul_plain(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(scale))
    want = (x.astype(np.float64) @ wq.astype(np.float64)) * scale
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_contract_is_the_row_count():
    assert quant_matmul_supported(1) and quant_matmul_supported(MAX_ROWS)
    assert not quant_matmul_supported(MAX_ROWS + 1)
    assert not quant_matmul_supported(0)


@pytest.mark.parametrize("rows", [4, MAX_ROWS + 6])
def test_qdense_routes_by_rows_and_matches_the_dequantized_product(rows):
    """Up to 1024 rows QDense goes through quant_matmul (its plain version on
    the CPU); above, through the dequantized weight. Both equal the JAX
    QDense's product, x @ (wq * scale), to f32 rounding."""
    x, wq, scale = _case(11, (rows,), 128, 96, jnp.float32)
    layer = QDense(128, 96, torch.float32)
    layer.load_state_dict({"kernel_q": torch.from_numpy(wq), "scale": torch.from_numpy(scale)})
    before = quant_matmul.launches
    got = layer(torch.from_numpy(x))
    want = x @ (wq.astype(np.float32) * scale[None, :])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert quant_matmul.launches == before  # a CPU tensor launches nothing


# The production Llama's int8 projections (K, N): qkv, gate|up, o, down, lm_head.
_PROD_SHAPES = [(2048, 4096), (2048, 11264), (2048, 2048), (5632, 2048), (2048, 32000)]


@pytest.mark.parametrize("rows", [1, 16, 17, 512, 1024])
@pytest.mark.parametrize("k,n", _PROD_SHAPES + [(1000, 1000), (100, 37), (64, 2050), (65, 128), (5632, 1)])
def test_split_k_plan_covers_k_once_and_sizes_the_scratch(rows, k, n):
    plan = plan_split_k(rows, k, n)
    assert plan.block_rows in (16, 32, 64) and plan.block_rows * plan.row_blocks >= rows
    assert plan.block_rows * (plan.row_blocks - 1) < rows
    assert plan.n_tiles == -(-n // BLOCK_N)
    # The ranges [s * k_per_split, min(K, (s + 1) * k_per_split)) tile K exactly once.
    assert plan.k_per_split % STAGE_K == 0 and plan.splits >= 1
    covered = [0] * k
    for split in range(plan.splits):
        lo, hi = split * plan.k_per_split, min(k, (split + 1) * plan.k_per_split)
        assert lo < hi, "no empty split"
        if split < plan.splits - 1:
            assert (hi - lo) % STAGE_K == 0  # only the last range may be ragged
        for j in range(lo, hi):
            covered[j] += 1
    assert covered == [1] * k
    want_scratch = plan.splits * plan.row_blocks * plan.block_rows * plan.n_tiles * BLOCK_N if plan.splits > 1 else 0
    assert plan.scratch_floats == want_scratch
    assert plan.blocks == plan.n_tiles * plan.splits * plan.row_blocks


@pytest.mark.parametrize("rows", [1, 16])
@pytest.mark.parametrize("k,n", _PROD_SHAPES)
def test_split_k_plan_fills_the_card_at_the_decode_shapes(rows, k, n):
    """At decode every projection gets at least one block for each of the
    H100's 132 SMs, and no more than four."""
    plan = plan_split_k(rows, k, n)
    assert 132 <= plan.blocks <= 4 * 132
