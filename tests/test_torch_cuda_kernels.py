"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper GPU and skip elsewhere. They import no JAX,
so on a machine without it they run with the repository's conftest left out:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda_kernels.py
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda, marginal_entropy_plain
from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention, reference_prefix_attention
from runia_core_tpu_torch.ops.mc_entropy_cuda import (
    fused_mc_entropy,
    fused_mc_entropy_plain,
    mc_dropblock_weights,
)
from runia_core_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain
from runia_core_tpu_torch.utils.graphs import CudaGraph

pytestmark = pytest.mark.requires_cuda

# Kernel 1 selects the same f32 differences as the sorted-window plain
# version; only the order of the final sum differs (the kernel's is
# compensated, so the bound does not grow with n).
ENTROPY_ATOL = 1e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _offset_view(t):
    """A copy of t that starts one element into its buffer (no 16-byte alignment)."""
    view = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


_ENTROPY_SHAPES = [
    (512, 16, 512, 5), (3, 4, 300, 3), (1, 16, 1, 5), (7, 64, 130, 15), (5, 2, 129, 1), (9, 32, 64, 8),
    (16, 100, 300, 5), (4, 300, 200, 5), (2, 512, 70, 15),  # past the old n <= 64 (dynamic shared memory)
    (3, 40, 70, 16), (2, 100, 40, 99),  # k past the 15 it was held to as a template parameter
] + [
    # around every register width and chunk edge, with the least, the usual and the largest k
    (3, n, 70, k) for n in (5, 8, 17, 31, 32, 33, 64, 65, 128, 257) for k in sorted({1, min(5, n - 1), n - 1})
]


@pytest.mark.parametrize("b,n,d,k", _ENTROPY_SHAPES)
def test_marginal_entropy_kernel_matches_plain(gen, b, n, d, k):
    clouds = torch.randn((b, n, d), generator=gen, device="cuda")
    clouds[:, : n // 2, : d // 2] = 0.0  # exact duplicates, as DropBlock makes
    before = marginal_entropy_cuda.launches
    got = marginal_entropy_cuda(clouds, k)
    again = marginal_entropy_cuda(clouds, k)
    torch.cuda.synchronize()
    assert marginal_entropy_cuda.launches == before + 2
    assert torch.equal(got, again)  # no atomics: two runs are bit-identical
    torch.testing.assert_close(got, marginal_entropy_plain(clouds, k), rtol=0, atol=ENTROPY_ATOL)


def test_marginal_entropy_kernel_integer_ties(gen):
    clouds = torch.randint(-2, 3, (64, 16, 256), generator=gen, device="cuda").float()
    torch.testing.assert_close(
        marginal_entropy_cuda(clouds, 5), marginal_entropy_plain(clouds, 5), rtol=0, atol=ENTROPY_ATOL
    )


@pytest.mark.parametrize("n", [16, 32, 100])
@pytest.mark.parametrize("order", ["sorted", "reversed", "all_equal", "outliers_1e20"])
def test_marginal_entropy_kernel_column_orders(gen, n, order):
    """Columns the sort meets already ascending, descending or constant, and
    columns with one value at +1e20 and one at -1e20 (their distances stay
    far below the 1e30 padding)."""
    clouds = torch.randn((4, n, 96), generator=gen, device="cuda")
    if order == "sorted":
        clouds = clouds.sort(dim=1).values
    elif order == "reversed":
        clouds = clouds.sort(dim=1, descending=True).values
    elif order == "all_equal":
        clouds = clouds[:, :1].expand(-1, n, -1)
    else:
        clouds[:, 1], clouds[:, n - 2] = 1e20, -1e20
    clouds = clouds.contiguous()
    torch.testing.assert_close(
        marginal_entropy_cuda(clouds, 5), marginal_entropy_plain(clouds, 5), rtol=0, atol=ENTROPY_ATOL
    )


@pytest.mark.parametrize("n", [16, 40])
@pytest.mark.parametrize("d", [1, 3, 127, 130])
def test_marginal_entropy_kernel_ragged_and_misaligned_d(gen, n, d):
    """d off every block and vector width, in a view that starts one element
    into its buffer (4-byte aligned only)."""
    clouds = _offset_view(torch.randn((5, n, d), generator=gen, device="cuda"))
    assert clouds.is_contiguous() and clouds.data_ptr() % 8 != 0
    torch.testing.assert_close(
        marginal_entropy_cuda(clouds, 5), marginal_entropy_plain(clouds, 5), rtol=0, atol=ENTROPY_ATOL
    )


_FUSED_SHAPES = [
    (512, 4, 4, 512, 16, 3, 0.5), (8, 7, 7, 2048, 16, 3, 0.5), (3, 8, 8, 130, 8, 2, 0.3),
    (2, 14, 14, 64, 64, 5, 0.5),  # 64 x 196 keep-weights: above 48 KB of shared memory
    (4, 4, 4, 300, 300, 3, 0.5), (2, 7, 7, 200, 512, 3, 0.5),  # S past the old 64; narrower blocks
    (2, 56, 56, 40, 17, 3, 0.5),  # S = 17 at a tap whose padded sample-minor rows pass 227 KB: the (S, HW) layout
] + [(3, 4, 4, 130, s, 3, 0.5) for s in (8, 17, 32, 33, 64)]  # around every register width and chunk edge


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32_map", "bf16_map"])
@pytest.mark.parametrize("b,h,w,c,s,bs,p", _FUSED_SHAPES)
def test_fused_kernel_matches_plain(gen, b, h, w, c, s, bs, p, dtype):
    fmap = torch.rand((b, h, w, c), generator=gen, device="cuda").to(dtype)
    weights = mc_dropblock_weights(b, h, w, s, bs, p, gen, "cuda")
    before = fused_mc_entropy.launches
    got = fused_mc_entropy(weights, fmap)
    again = fused_mc_entropy(weights, fmap)
    torch.cuda.synchronize()
    assert fused_mc_entropy.launches == before + 2
    assert torch.equal(got, again)  # no atomics: two runs are bit-identical
    # The bound of tests/test_mc_entropy_fused.py: the products sum in another order.
    torch.testing.assert_close(got, fused_mc_entropy_plain(weights, fmap), rtol=1e-4, atol=1e-5)
    if dtype == torch.bfloat16:  # widening in registers is exact: the f32 copy gives the same bits
        assert torch.equal(got, fused_mc_entropy(weights, fmap.float()))


def test_wrappers_raise_on_inputs_the_kernels_do_not_take(gen):
    clouds = torch.randn((4, 16, 32), generator=gen, device="cuda")
    for bad, k in ((clouds.transpose(1, 2), 5), (clouds.double(), 5), (clouds.bfloat16(), 5), (clouds, 16), (clouds, 0)):
        with pytest.raises(ValueError):
            marginal_entropy_cuda(bad, k)
    with pytest.raises(ValueError):
        marginal_entropy_cuda(torch.randn((2, 513, 8), generator=gen, device="cuda"), 5)
    fmap = torch.rand((4, 4, 4, 32), generator=gen, device="cuda")
    weights = mc_dropblock_weights(4, 4, 4, 16, 3, 0.5, gen, "cuda")
    with pytest.raises(ValueError):
        fused_mc_entropy(weights[:, :, :8].contiguous(), fmap)
    with pytest.raises(ValueError):
        fused_mc_entropy(weights, fmap.permute(0, 2, 1, 3))
    for bad_weights, bad_map in ((weights, fmap.half()), (weights.bfloat16(), fmap), (weights, fmap.double())):
        with pytest.raises(ValueError):
            fused_mc_entropy(bad_weights, bad_map)


# quant_matmul: relative to max|ref|, one bf16 ulp in bf16 (the kernel and
# the plain version sum in f32 in other orders, then round once), 1e-5 in f32
# (tests/test_quant_matmul.py's bounds).
QMM_BOUND = {torch.bfloat16: 8e-3, torch.float32: 1e-5}


# The int8 projections (K, N), qkv, gate|up, o, down, lm_head, of the
# production Llama and of the Mixtral width (fused qkv, o, an expert's w_gate
# / w_up and w_down, lm_head).
_PROD_SHAPES = [(2048, 4096), (2048, 11264), (2048, 2048), (5632, 2048), (2048, 32000),
                (4096, 6144), (4096, 4096), (4096, 14336), (14336, 4096), (4096, 32000)]


def _qmm_inputs(gen, rows, k, n, dtype, misaligned=False):
    x = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
    if misaligned:  # a contiguous weight that starts one byte into its buffer
        wq = torch.randint(-127, 128, (k * n + 1,), generator=gen, device="cuda", dtype=torch.int8)[1:].view(k, n)
        assert wq.data_ptr() % 16 != 0
    else:
        wq = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    scale = torch.rand((n,), generator=gen, device="cuda") * 1e-2 + 1e-3
    return x, wq, scale


def _check_qmm(x, wq, scale):
    before = quant_matmul.launches
    got = quant_matmul(x, wq, scale)
    again = quant_matmul(x, wq, scale)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 2 and got.dtype == x.dtype
    assert torch.equal(got, again)  # the split-K sum does not depend on the order blocks ran in
    want = quant_matmul_plain(x, wq, scale).float()
    rel = float((got.float() - want).abs().max() / want.abs().max())
    assert rel <= QMM_BOUND[x.dtype], rel


@pytest.mark.parametrize("rows,k,n,dtype", [
    (16, 2048, 4096, torch.bfloat16), (16, 2048, 11264, torch.bfloat16), (16, 5632, 2048, torch.bfloat16),
    (16, 2048, 32000, torch.bfloat16), (1, 2048, 2048, torch.bfloat16), (13, 2048, 2048, torch.bfloat16),
    (512, 2048, 2048, torch.bfloat16), (1024, 512, 1000, torch.bfloat16), (7, 100, 37, torch.bfloat16),
    (16, 2048, 4096, torch.float32), (33, 129, 61, torch.float32),
])
def test_quant_matmul_kernel_matches_plain(gen, rows, k, n, dtype):
    _check_qmm(*_qmm_inputs(gen, rows, k, n, dtype))


# 4: a 4-row prefill's last positions; 16: a decode step; 1,024: a 16 x 64 prompt prefill.
@pytest.mark.parametrize("rows", [1, 4, 13, 16, 17, 100, 512, 1024])
@pytest.mark.parametrize("k,n", _PROD_SHAPES)
def test_quant_matmul_kernel_at_the_production_shapes(gen, rows, k, n):
    _check_qmm(*_qmm_inputs(gen, rows, k, n, torch.bfloat16))


# The int8 self-draft of the production Llama (unfused q, k / v, o, gate / up,
# down, lm_head) at its decode rows, 1 (generate) and 5 (generate_samples),
# and at its prefill of a 32- and a 256-token prompt (the lm_head takes the
# last row only).
@pytest.mark.parametrize("rows,k,n", [(rows, k, n) for rows in (1, 5, 32, 256)
                                      for k, n in ((2048, 2048), (2048, 1024), (2048, 5632), (5632, 2048))]
                         + [(rows, 2048, 32000) for rows in (1, 5)])
def test_quant_matmul_kernel_at_the_draft_shapes(gen, rows, k, n):
    _check_qmm(*_qmm_inputs(gen, rows, k, n, torch.bfloat16))


@pytest.mark.parametrize("rows,k,n,dtype,misaligned", [
    (16, 1000, 1000, torch.bfloat16, False),   # ragged against every tile and split
    (17, 1000, 1000, torch.float32, False),
    (16, 2048, 2050, torch.bfloat16, False),   # N no multiple of 16: element-wise weight staging
    (100, 1001, 2050, torch.bfloat16, False),  # K no multiple of 8: element-wise x staging
    (16, 2048, 2048, torch.bfloat16, True),    # a misaligned weight
    (64, 5632, 2048, torch.float32, True),
    (1024, 5632, 2048, torch.float32, False),  # f32 x at the row limit
    (16, 64, 128, torch.bfloat16, False),      # one stage, one tile
    (16, 1, 1, torch.bfloat16, False),
])
def test_quant_matmul_kernel_edges(gen, rows, k, n, dtype, misaligned):
    _check_qmm(*_qmm_inputs(gen, rows, k, n, dtype, misaligned))


def test_quant_matmul_raises_on_inputs_it_does_not_take(gen):
    x = torch.randn((4, 64), generator=gen, device="cuda")
    wq = torch.zeros((64, 32), dtype=torch.int8, device="cuda")
    for args in ((x.double(), wq, torch.ones(32, device="cuda")), (x, wq.float(), torch.ones(32, device="cuda")),
                 (x, wq, torch.ones(31, device="cuda")), (torch.randn((1025, 64), device="cuda"), wq,
                                                          torch.ones(32, device="cuda"))):
        with pytest.raises(ValueError):
            quant_matmul(*args)


def _flash_case(gen, b, hq, g, tq, kk, d, dtype, kv8=False):
    # Unit-variance q and k: logits of std about 1, a peaked softmax.
    q = torch.randn((b, hq, tq, d), generator=gen, device="cuda").to(dtype)
    if kv8:
        k = torch.randint(-127, 128, (b, g, kk, d), generator=gen, device="cuda", dtype=torch.int8)
        v = torch.randint(-127, 128, (b, g, kk, d), generator=gen, device="cuda", dtype=torch.int8)
        ks = torch.rand((b, kk, g), generator=gen, device="cuda") * 0.02 + 0.005
        vs = torch.rand((b, kk, g), generator=gen, device="cuda") * 0.02 + 0.005
        return q, k, v, ks, vs
    k = torch.randn((b, g, kk, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, g, kk, d), generator=gen, device="cuda").to(dtype)
    return q, k, v, None, None


def flash_bf16_within(got, want, q, k, v, q_start, kv_start=None, ks=None, vs=None):
    """Per-element bf16 bound. The kernel rounds each probability p_j (p_j
    v_scale_j in KV8) to bf16 before P.V, a relative error of at most 2^-8,
    which moves an output by sum_j e_j p_j v_j: a sum of independent
    roundings of standard deviation 2^-8 / sqrt(3) * s, where
    s = sqrt(sum_j p_j^2 v_j^2) is taken from the f32 probabilities. The two
    outputs then round to bf16 once each, at most one ulp apart, 2^-7 |want|.
    Bound: 2^-7 |want| + 2^-6 s (about 7 standard deviations, and the worst
    case for a window of up to 16 keys)."""
    b, hq, tq, d = q.shape
    g, kk = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if ks is not None:
        kf, vf = kf * ks.permute(0, 2, 1)[..., None], vf * vs.permute(0, 2, 1)[..., None]
    logits = torch.einsum("bgrtd,bgkd->bgrtk", q.float().reshape(b, g, hq // g, tq, d), kf) / d**0.5
    rows = torch.tensor(q_start, device=q.device)[:, None, None] + torch.arange(tq, device=q.device)[:, None]
    starts = torch.tensor(kv_start or [0] * b, device=q.device)[:, None, None]
    keys = torch.arange(kk, device=q.device)
    mask = (keys <= rows) & (keys >= starts)  # (B, Tq, K)
    probs = torch.softmax(logits.masked_fill(~mask[:, None, None], float("-inf")), dim=-1).nan_to_num(0.0)
    spread = torch.einsum("bgrtk,bgkd->bgrtd", probs.square(), vf.square()).sqrt().reshape(b, hq, tq, d)
    bound = 2.0**-7 * want.float().abs() + 2.0**-6 * spread
    return bool(((got.float() - want.float()).abs() <= bound).all())


_FLASH_CASES = [  # (name, B, Hq, G, Tq, K, D, q_start, kv_start, dtype, kv8)
    ("prefill", 2, 16, 8, 1024, 1280, 128, [0, 0], None, torch.bfloat16, False),
    ("chunked", 2, 16, 8, 256, 2048, 128, [0, 700], None, torch.bfloat16, False),
    ("left_pad", 3, 4, 2, 96, 160, 64, [0, 0, 40], [0, 70, 10], torch.bfloat16, False),
    ("kv8", 2, 16, 8, 256, 1280, 128, [0, 900], None, torch.bfloat16, True),
    ("kv8_prefill", 8, 16, 8, 1024, 1280, 128, [0] * 8, None, torch.bfloat16, True),  # the main path's shape
    ("tq200", 2, 8, 2, 200, 333, 64, [0, 100], None, torch.bfloat16, False),
    ("f32", 2, 8, 4, 130, 300, 128, [0, 150], [0, 3], torch.float32, False),
    ("f32_kv8", 1, 4, 4, 70, 200, 64, [100], [7], torch.float32, True),
    ("f32_prefill", 8, 16, 8, 1024, 1280, 128, [0] * 8, None, torch.float32, False),  # the main path's shape
    ("f32_kv8_prefill", 8, 16, 8, 1024, 1280, 128, [0] * 8, None, torch.float32, True),
    # the tensor-core kernel: both head widths, KV8, windows with empty rows,
    # Tq and K off the 64-row tiles, one row past a tile, windows that start
    # and end inside one tile, a cache shorter than the queries' positions
    ("d64_kv8", 2, 8, 4, 300, 500, 64, [0, 150], [0, 20], torch.bfloat16, True),
    ("d128_kv8_left_pad", 3, 16, 8, 96, 160, 128, [0, 0, 40], [0, 70, 10], torch.bfloat16, True),
    ("tq65", 2, 16, 8, 65, 129, 128, [0, 64], None, torch.bfloat16, False),
    ("tq1", 2, 4, 4, 1, 77, 128, [5, 76], None, torch.bfloat16, False),
    ("narrow_window", 2, 4, 2, 130, 400, 64, [100, 200], [97, 260], torch.bfloat16, False),
    ("short_cache", 2, 4, 2, 100, 120, 128, [0, 60], None, torch.bfloat16, False),
    ("short_cache_kv8", 2, 4, 2, 100, 120, 64, [0, 60], [3, 0], torch.bfloat16, True),
    ("all_empty", 1, 4, 2, 70, 200, 128, [0], [150], torch.bfloat16, False),
    ("mha", 1, 4, 4, 129, 129, 64, [0], None, torch.bfloat16, False),
    # heads of 32 and 256, the kernel's other D instances, in bf16, KV8 and f32
    *((f"d{d}{tag}", 2, 8, 4, 300, 500, d, [0, 150], [0, 20], dtype, kv8) for d in (32, 256)
      for tag, dtype, kv8 in (("", torch.bfloat16, False), ("_kv8", torch.bfloat16, True),
                              ("_f32", torch.float32, False))),
]
# Every small case of the tensor-core kernel again through views that start
# one element into their buffers (no 16-byte alignment).
_FLASH_PARAMS = [(*case, "plain") for case in _FLASH_CASES] + [
    (*case, "misaligned") for case in _FLASH_CASES if case[9] == torch.bfloat16 and case[1] < 8
]


# f32: the JAX bound (tests/test_flash_prefill.py). bf16: flash_bf16_within.
@pytest.mark.parametrize("name,b,hq,g,tq,kk,d,q_start,kv_start,dtype,kv8,layout", _FLASH_PARAMS,
                         ids=[f"{case[0]}-{case[-1]}" for case in _FLASH_PARAMS])
def test_flash_prefix_attention_kernel_matches_plain(gen, name, b, hq, g, tq, kk, d, q_start, kv_start, dtype, kv8,
                                                     layout):
    q, k, v, ks, vs = _flash_case(gen, b, hq, g, tq, kk, d, dtype, kv8)
    qs = torch.tensor(q_start, dtype=torch.int32, device="cuda")
    kvs = None if kv_start is None else torch.tensor(kv_start, dtype=torch.int32, device="cuda")
    q_in, k_in, v_in = (q, k, v) if layout == "plain" else (_offset_view(q), _offset_view(k), _offset_view(v))
    before = (flash_prefix_attention.launches, flash_prefix_attention.kv8_launches)
    got = flash_prefix_attention(q_in, k_in, v_in, qs, kvs, ks, vs)
    again = flash_prefix_attention(q_in, k_in, v_in, qs, kvs, ks, vs)
    torch.cuda.synchronize()
    assert flash_prefix_attention.launches == before[0] + 2
    assert flash_prefix_attention.kv8_launches == before[1] + 2 * int(kv8)
    assert torch.equal(got, again)
    want = reference_prefix_attention(q, k, v, qs, kvs, None, ks, vs)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    else:
        assert flash_bf16_within(got, want, q, k, v, q_start, kv_start, ks, vs), float((got.float() - want.float()).abs().max())
    if kv_start is not None:  # rows before their kv_start have an empty window
        for row, (qs_r, kvs_r) in enumerate(zip(q_start, kv_start)):
            empty = max(0, kvs_r - qs_r)
            assert bool((got[row, :, :empty] == 0).all())


def _check_transposed_cache(gen, b, hq, g, tq, kk, d, q_start, written, kv8):
    """Kernel 4 on the model's (B, K, G, D) cache as a transposed view, with
    garbage past the ``written`` slots (NaN values; in KV8, NaN scales): the
    kernel never reads it into a product."""
    q, k, v, ks, vs = _flash_case(gen, b, hq, g, tq, kk, d, torch.bfloat16, kv8)
    cache_k, cache_v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    if kv8:
        cache_k[:, written:], cache_v[:, written:] = 127, -127
        ks[:, written:], vs[:, written:] = float("nan"), float("nan")
    else:
        cache_k[:, written:], cache_v[:, written:] = float("nan"), float("nan")
    qs = torch.tensor(q_start, dtype=torch.int32, device="cuda")
    got = flash_prefix_attention(q, cache_k.transpose(1, 2), cache_v.transpose(1, 2), qs, None, ks, vs)
    want = reference_prefix_attention(q, k, v, qs, None, None, ks, vs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    clean = (None, None) if not kv8 else (ks.nan_to_num(0.0), vs.nan_to_num(0.0))
    assert flash_bf16_within(got, want, q, k, v, q_start, None, *clean), float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_reads_a_transposed_cache_and_skips_garbage(gen, d, kv8):
    _check_transposed_cache(gen, 2, 8, 4, 64, 512, d, [0, 200], 300, kv8)  # last key read 263


@pytest.mark.parametrize("kv8", [False, True])
def test_flash_at_the_mixtral_prefill(gen, kv8):
    """The Mixtral-width 4 x 512 prefill as the model gives it: 32 query and
    8 KV heads of 128 over its 520-slot cache, the 8 slots past the prompt
    unwritten."""
    _check_transposed_cache(gen, 4, 32, 8, 512, 520, 128, [0] * 4, 512, kv8)


# ---- the compiled-program layer: CUDA graphs of the decode step and the scorer ----


@contextlib.contextmanager
def no_host_sync():
    """Every synchronising call raises inside the block but for the port's
    own copies of results to the host (``utils.graphs.host_sync``)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _tiny_llama(form, use_flash=True):
    from runia_core_tpu_torch.models import LlamaLM, fuse_quantized_llama_params, quantize_llama_params

    cfg = dict(vocab_size=512, num_layers=2, num_heads=4, num_kv_heads=2, d_model=128, hidden_dim=256, max_len=512)
    dense = LlamaLM(**cfg, use_flash=use_flash, device="cuda").eval()
    dense.init_weights(torch.Generator(device="cuda").manual_seed(0))
    if form == "f32":
        return dense
    int8 = LlamaLM(**cfg, use_flash=True, quantized=True, quantized_kv=True, fused_qkv=True, device="cuda").eval()
    int8.load_state_dict(fuse_quantized_llama_params(quantize_llama_params(dense.state_dict())))
    return int8


@pytest.mark.parametrize("form", ["f32", "int8_kv8"])
def test_decode_graph_replays_match_the_eager_loop(gen, form):
    from runia_core_tpu_torch.llm import TorchGenerator

    new = 12
    model = _tiny_llama(form)
    prompts = torch.randint(1, 512, (3, 140), generator=torch.Generator().manual_seed(1)).tolist()
    prompts[2] = prompts[2][:100]  # left-padded
    graph, eager = TorchGenerator(model, max_new_tokens=new), TorchGenerator(model, max_new_tokens=new, use_scan=False)
    for kwargs in (dict(output_attentions=True), dict(output_scores=False)):
        want = eager.generate_batch(prompts, **kwargs)
        with no_host_sync():
            graph.generate_batch(prompts, **kwargs)  # captures
            before = quant_matmul.launches
            got = graph.generate_batch(prompts, **kwargs)  # replays
        if form == "int8_kv8":  # 2 x 4 projections + lm_head a forward: the prefill, then one a replay
            assert quant_matmul.launches - before == 9 * new
        assert (got["sequences"] == want["sequences"]).all()
        torch.testing.assert_close(torch.from_numpy(got["log_probs"]), torch.from_numpy(want["log_probs"]),
                                   atol=1e-5, rtol=0)
    assert "prev_token_attention" not in got
    want = eager.generate_batch(prompts, output_attentions=True, max_new_tokens=2)  # a one-row tap buffer
    with no_host_sync():
        got = graph.generate_batch(prompts, output_attentions=True, max_new_tokens=2)
    assert (got["sequences"] == want["sequences"]).all()
    torch.testing.assert_close(torch.from_numpy(got["prev_token_attention"]),
                               torch.from_numpy(want["prev_token_attention"]), atol=1e-5, rtol=0)
    want = eager.generate(prompts[0], num_return_sequences=3)
    with no_host_sync():
        got = graph.generate(prompts[0], num_return_sequences=3)
    assert (got["sequences"] == want["sequences"]).all()
    torch.testing.assert_close(torch.from_numpy(got["log_probs"]), torch.from_numpy(want["log_probs"]),
                               atol=1e-5, rtol=0)
    for key in ("attentions", "hidden_states"):
        for step_got, step_want in zip(got[key], want[key]):
            for a, b in zip(step_got, step_want):
                torch.testing.assert_close(torch.from_numpy(a), torch.from_numpy(b), atol=1e-5, rtol=0)
    # Sampling: from one seed the replays draw what the eager loop draws,
    # and a new generator object per call replays the same graph.
    drawn = torch.Generator(device="cuda")
    sampled = []
    for g in (graph, graph, eager):
        drawn.manual_seed(7)
        with no_host_sync() if g is graph else contextlib.nullcontext():
            sampled.append(g.generate(prompts[0], num_return_sequences=4, do_sample=True, top_k=50,
                                      generator=drawn)["sequences"])
    assert (sampled[0] == sampled[1]).all() and (sampled[0] == sampled[2]).all()
    captures = CudaGraph.captures
    for seed in (8, 9):
        want = eager.generate(prompts[0], num_return_sequences=4, do_sample=True, top_k=50,
                              generator=torch.Generator(device="cuda").manual_seed(seed))["sequences"]
        with no_host_sync():
            got = graph.generate(prompts[0], num_return_sequences=4, do_sample=True, top_k=50,
                                 generator=torch.Generator(device="cuda").manual_seed(seed))["sequences"]
        assert (got == want).all()
    assert CudaGraph.captures == captures


def test_decode_programs_stay_bounded_over_many_prompt_lengths(gen, monkeypatch):
    """70 distinct prompt lengths over 8 buckets with a byte budget of three
    of the largest programs: the cached programs keep to it, and the device
    memory allocated never grows past it. (Head dim 32: the prefill takes
    the dense route.)"""
    import runia_core_tpu_torch.llm.generate as generate
    from runia_core_tpu_torch.llm import TorchGenerator
    from runia_core_tpu_torch.utils.graphs import ProgramCache

    model = _tiny_llama("f32", use_flash=False)
    tokens = torch.randint(1, 512, (600,), generator=torch.Generator().manual_seed(2)).tolist()
    graph = TorchGenerator(model, max_new_tokens=4)
    graph.generate_batch([tokens[:484]])
    largest = max(program.nbytes for program in generate._PROGRAM_CACHE.entries.values())
    cache = ProgramCache(generate._PROGRAM_CACHE_MAX, max_bytes=3 * largest)
    monkeypatch.setattr(generate, "_PROGRAM_CACHE", cache)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    lengths = range(1, 485, 7)
    for n in lengths:
        graph.generate_batch([tokens[:n]])
        assert cache.nbytes <= cache.max_bytes
        assert torch.cuda.memory_allocated() <= base + cache.max_bytes + (1 << 20)
    assert len(lengths) == 70 and len({generate._bucket(n) for n in lengths}) == 8 and len(cache) < 8


def test_a_pool_whose_graphs_went_is_replaced(gen):
    x = torch.randn((1024,), generator=gen, device="cuda")
    first = CudaGraph(lambda x: x * 3, {"x": x})
    assert torch.equal(first.replay()[0], x * 3)
    del first
    torch.cuda.empty_cache()
    second = CudaGraph(lambda x: x + 1, {"x": x})  # the old pool went with its last graph
    assert torch.equal(second.replay()[0], x + 1)


def test_a_graph_of_kernel_3_resets_its_counters_on_every_replay(gen):
    x, wq, scale = _qmm_inputs(gen, 16, 2048, 11264, torch.bfloat16)
    want = quant_matmul(x, wq, scale)
    graph = CudaGraph(lambda x: quant_matmul(x, wq, scale), {"x": x})
    scratch, counters = graph.workspaces[("quant_matmul", torch.cuda.current_device())]
    before = quant_matmul.launches
    for _ in range(256):
        (out,) = graph.replay()
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 256
    assert int(counters.abs().sum()) == 0
    assert torch.equal(out, want)
    x2 = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
    graph.load(x=x2)
    (out,) = graph.replay()
    assert torch.equal(out, quant_matmul(x2, wq, scale)) and int(counters.abs().sum()) == 0


def _tiny_scorer_parts():
    from runia_core_tpu_torch.models import ResNet18, build_tapped_forward

    model = ResNet18(num_classes=10, cifar_stem=True, num_filters=16, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    model = model.to(memory_format=torch.channels_last).eval()
    state = {"feats_mean": torch.zeros(128, device="cuda"), "precision": torch.eye(128, device="cuda")}
    return build_tapped_forward(model), state


@pytest.mark.parametrize("fused", [False, True])
def test_scorer_replays_match_eager(gen, fused):
    from runia_core_tpu_torch.inference import build_larex_scorer

    torch.backends.cudnn.allow_tf32 = False
    forward, state = _tiny_scorer_parts()
    graph = build_larex_scorer(forward, None, state, 16, 0.5, 3, fused=fused)
    eager = build_larex_scorer(forward, None, state, 16, 0.5, 3, fused=fused, use_graph=False)
    images = [torch.rand((64, 32, 32, 3), generator=gen, device="cuda") for _ in range(3)]
    weights = [mc_dropblock_weights(64, 4, 4, 16, 3, 0.5, gen, "cuda") for _ in range(3)]
    kept = []
    for x, w in zip(images, weights):
        with no_host_sync():
            logits, scores = graph(x, weights=w)
        want_logits, want = eager(x, weights=w)
        kept.append((scores, want))
        torch.testing.assert_close(logits, want_logits, rtol=1e-6, atol=1e-6 * float(want_logits.abs().max()))
    for scores, want in kept:  # later replays did not overwrite what an earlier call returned
        torch.testing.assert_close(scores, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    captures = None
    for seed in (5, 6, 7):  # a new generator per call: one capture, then replays
        with no_host_sync():
            got = graph(images[0], generator=torch.Generator(device="cuda").manual_seed(seed))[1]
        want = eager(images[0], generator=torch.Generator(device="cuda").manual_seed(seed))[1]
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
        captures = CudaGraph.captures if captures is None else captures
    assert CudaGraph.captures == captures


def test_a_recorded_second_scorer_call_replays_with_one_kernel_1_launch(gen):
    """The first call of a shape captures (a ``runia.graph.capture`` span);
    a second call of that shape records no capture, one launch of kernel 1
    (and the forward's 17 of the conv-norm epilogue), and its stages as
    children of the call, with answers equal bit for bit
    to the same call unrecorded."""
    from runia_core_tpu_torch.inference import build_larex_scorer
    from runia_core_tpu_torch.utils.profiling import recording

    forward, state = _tiny_scorer_parts()
    scorer = build_larex_scorer(forward, None, state, 16, 0.5, 3)
    images = torch.rand((64, 32, 32, 3), generator=gen, device="cuda")
    with recording() as first:
        scorer(images, torch.Generator(device="cuda").manual_seed(1))
    assert first.counters["CudaGraph.captures"] == 1
    assert [s.name for s in first.spans].count("runia.graph.capture") == 1
    with recording() as second, no_host_sync():
        recorded = scorer(images, torch.Generator(device="cuda").manual_seed(2))
    plain = scorer(images, torch.Generator(device="cuda").manual_seed(2))
    assert second.counters == {"CudaGraph.captures": 0, "marginal_entropy_cuda.launches": 1,
                               "fused_mc_entropy.launches": 0, "conv_epilogue.launches": 17,
                               "moe_grouped.launches": 0, "flash_prefix_attention.launches": 0,
                               "flash_prefix_attention.window_launches": 0}
    (call,) = [s for s in second.spans if s.name == "runia.scorer.call"]
    stages = [s for s in second.spans if s is not call]
    assert [s.name for s in stages] == ["runia.scorer.load", "runia.scorer.replay", "runia.scorer.copy_out"]
    assert call.parent is None and all(s.parent == call.id and s.trace == call.id for s in stages)
    assert all(torch.equal(a, b) for a, b in zip(recorded, plain))


def test_a_capture_that_fails_raises(gen):
    x = torch.randn((8,), generator=gen, device="cuda")
    with pytest.raises(RuntimeError):
        CudaGraph(lambda x: x * float(x.sum()), {"x": x})  # a host read inside the capture
    torch.cuda.synchronize()
    assert torch.equal(CudaGraph(lambda x: x * 2, {"x": x}).replay()[0], x * 2)  # the device is still usable


# ---- the MoE LlamaLM and the NLI judge as CUDA-graph replays ----


def test_moe_decode_replays_match_the_eager_loop(gen):
    """An int8 + KV8 MoE model: 2 x (qkv + o + 4 experts x 3) + lm_head =
    29 launches of kernel 3 a forward, so a replaying call launches 29 a
    token (its prefill, then one a replay)."""
    from runia_core_tpu_torch.llm import TorchGenerator
    from runia_core_tpu_torch.models import LlamaLM, fuse_quantized_llama_params, quantize_llama_params

    new = 10
    cfg = dict(vocab_size=512, num_layers=2, num_heads=4, num_kv_heads=2, d_model=128, hidden_dim=256, max_len=512,
               num_experts=4, num_experts_per_tok=2, use_flash=True)
    dense = LlamaLM(**cfg, device="cuda").eval()
    dense.init_weights(torch.Generator(device="cuda").manual_seed(0))
    int8 = LlamaLM(**cfg, quantized=True, quantized_kv=True, fused_qkv=True, device="cuda").eval()
    int8.load_state_dict(fuse_quantized_llama_params(quantize_llama_params(dense.state_dict())))
    prompts = torch.randint(1, 512, (3, 140), generator=torch.Generator().manual_seed(1)).tolist()
    prompts[2] = prompts[2][:100]  # left-padded
    for model in (dense, int8):
        graph = TorchGenerator(model, max_new_tokens=new)
        want = TorchGenerator(model, max_new_tokens=new, use_scan=False).generate_batch(prompts)
        with no_host_sync():
            graph.generate_batch(prompts)  # captures
            before = quant_matmul.launches
            got = graph.generate_batch(prompts)  # replays
        assert quant_matmul.launches - before == (29 * new if model is int8 else 0)
        assert (got["sequences"] == want["sequences"]).all()
        torch.testing.assert_close(torch.from_numpy(got["log_probs"]), torch.from_numpy(want["log_probs"]),
                                   atol=1e-5, rtol=0)


def test_nli_replays_match_eager(gen):
    """A small DeBERTa judge: the replayed bucket gives the eager logits bit
    for bit and the same labels; a second call of the bucket replays."""
    from runia_core_tpu_torch.models import DebertaV2Classifier, wrap_torch_nli

    model = DebertaV2Classifier(vocab_size=1000, num_layers=3, num_heads=4, d_model=128, intermediate_size=256,
                                position_buckets=32, conv_kernel_size=3, dtype=torch.bfloat16, device="cuda").eval()
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))

    def tok(premises, hypotheses, padding=True, truncation=True, max_length=64, return_tensors="np"):
        rows = [([1] + p + [2] + h + [2])[:max_length] for p, h in zip(premises, hypotheses)]
        ids = np.zeros((len(rows), max(map(len, rows))), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}

    rng = np.random.RandomState(0)
    premises = [list(rng.randint(3, 1000, n)) for n in (5, 40, 20)]
    hypotheses = [list(rng.randint(3, 1000, n)) for n in (30, 7, 20)]
    graph = wrap_torch_nli(model, tok, max_len=64, len_buckets=(32, 64), batch_bucket=4)
    eager = wrap_torch_nli(model, tok, max_len=64, len_buckets=(32, 64), batch_bucket=4, use_graph=False)
    want, want_labels = eager.logits(premises, hypotheses), eager(premises, hypotheses)
    with no_host_sync():
        got = graph.logits(premises, hypotheses)  # captures the (4, 64) bucket
        captures = CudaGraph.captures
        labels = graph(premises, hypotheses)
    assert CudaGraph.captures == captures
    assert got.shape == (3, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(labels, want_labels)


# ---- speculative rounds, GPT-2 and GPT-NeoX decode as CUDA-graph replays ----


@pytest.mark.parametrize("do_sample", [False, True])
def test_speculative_round_replays_match_the_eager_round(gen, do_sample):
    """An f32 Llama target with its int8 self-draft (kernel 3 in every draft
    step): the replayed rounds give the eager rounds' tokens, log-probs
    (1e-5), rounds and acceptance, from one seed when sampling; a second
    call replays; kernel 3 launches (7 x layers + 1) x (gamma + 1) times a
    round; the target's 140-token prefill runs kernel 4 (heads of 32)."""
    from runia_core_tpu_torch.llm import SpeculativeGenerator
    from runia_core_tpu_torch.models import LlamaLM, quantize_llama_params

    target = _tiny_llama("f32")
    draft = LlamaLM(**{k: getattr(target, k) for k in ("vocab_size", "num_layers", "num_heads", "num_kv_heads",
                                                       "d_model", "hidden_dim", "max_len")},
                    quantized=True, device="cuda").eval()
    draft.load_state_dict(quantize_llama_params(target.state_dict()))
    prompt = torch.randint(1, 512, (140,), generator=torch.Generator().manual_seed(2)).tolist()
    kw = dict(gamma=4, max_new_tokens=20, do_sample=do_sample)
    graph, eager = SpeculativeGenerator(target, draft, **kw), SpeculativeGenerator(target, draft, use_graph=False, **kw)
    calls = [((1, 140), lambda g: g.generate(prompt, generator=torch.Generator(device="cuda").manual_seed(5)))]
    if do_sample:
        calls.append(((5, 30), lambda g: g.generate_samples(prompt[:30], 5,
                                                             generator=torch.Generator(device="cuda").manual_seed(6))))
    for key, call in calls:
        flash_before = flash_prefix_attention.launches
        want = call(eager)
        assert flash_prefix_attention.launches - flash_before == (2 if key[1] >= 128 else 0)  # one a target layer
        with no_host_sync():
            call(graph)  # captures
            program = graph._run_cache.get(key)
            captures, before, replays = CudaGraph.captures, quant_matmul.launches, program.graph.replays
            got = call(graph)  # replays
        assert CudaGraph.captures == captures
        per_replay = program.graph.launches[(quant_matmul, "launches")]
        assert per_replay == (7 * 2 + 1) * 5  # gamma + 1 draft steps a round
        assert quant_matmul.launches - before == 15 + per_replay * (program.graph.replays - replays)  # + the prefill
        np.testing.assert_array_equal(got["sequences"], want["sequences"])
        np.testing.assert_allclose(got["log_probs"], want["log_probs"], atol=1e-5, rtol=0)
        assert got["rounds"] == want["rounds"] and got["acceptance_rate"] == want["acceptance_rate"]
        assert graph.last_syncs <= kw["max_new_tokens"] - 2  # the flag after each round but the last


@pytest.mark.parametrize("family", ["gpt2", "neox"])
def test_causal_lm_and_neox_decode_replays_match_eager(gen, family):
    from runia_core_tpu_torch.llm import TorchGenerator
    from runia_core_tpu_torch.models import CausalLM, NeoXLM

    cls = CausalLM if family == "gpt2" else NeoXLM
    model = cls(vocab_size=512, num_layers=2, num_heads=4, d_model=128, max_len=256, device="cuda").eval()
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.randint(1, 512, (3, 70), generator=torch.Generator().manual_seed(1)).tolist()
    prompts[2] = prompts[2][:40]  # left-padded
    graph, eager = TorchGenerator(model, max_new_tokens=12), TorchGenerator(model, max_new_tokens=12, use_scan=False)
    want = eager.generate_batch(prompts, output_attentions=True)
    with no_host_sync():
        graph.generate_batch(prompts, output_attentions=True)  # captures
        got = graph.generate_batch(prompts, output_attentions=True)
    np.testing.assert_array_equal(got["sequences"], want["sequences"])
    np.testing.assert_allclose(got["log_probs"], want["log_probs"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["prev_token_attention"], want["prev_token_attention"], atol=1e-5, rtol=0)
    want = eager.generate(prompts[0], num_return_sequences=3)
    with no_host_sync():
        got = graph.generate(prompts[0], num_return_sequences=3)
    np.testing.assert_array_equal(got["sequences"], want["sequences"])
    for key in ("attentions", "hidden_states"):
        for step_got, step_want in zip(got[key], want[key]):
            for a, b in zip(step_got, step_want):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def _served(engine, prompts, budgets):
    ids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]
    engine.run_until_drained()
    return [engine.result(i) for i in ids]


def _same_served(got, want, atol, rel=False):
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"]
        scale = max(1.0, float(np.abs(w["log_probs"]).max())) if rel and len(w["tokens"]) else 1.0
        np.testing.assert_allclose(g["log_probs"], w["log_probs"], atol=atol * scale, rtol=0)


def _serving_prompts(seed, n, lo, hi, shared=0):
    rng = np.random.RandomState(seed)
    system = list(rng.randint(1, 512, shared))
    return [system + list(rng.randint(1, 512, rng.randint(lo, hi))) for _ in range(n)]


@pytest.mark.parametrize("form", ["f32", "int8_kv8"])
@pytest.mark.parametrize("defer_fetch", [False, True], ids=["lookahead", "open_loop"])
def test_engine_replays_match_the_eager_engine(gen, form, defer_fetch):
    """ContinuousBatchingEngine with its decode chunk and prefill lanes as
    CUDA-graph replays against the same programs run eagerly
    (use_graph=False), under sync-debug "error": chunked prefill of 128 in
    lanes of 4 (kernel 4 with per-row q_start; its KV8 variant in int8) with
    the prefix cache, RAUQ and hidden taps; tokens identical, scores within
    1e-5; a warm pass captures nothing; kernel 3 runs in every int8
    program."""
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine

    model = _tiny_llama(form)
    prompts = _serving_prompts(3, 8, 10, 200, shared=130)
    budgets = [3, 9, 1, 6, 12, 2, 8, 5]
    kw = dict(num_slots=4, max_ctx=384, max_new_tokens=12, chunk_tokens=4, prefill_chunk=128, prefill_lanes=4,
              prefix_cache=True, collect_rauq=True, collect_hidden=-1, admission="lpt", defer_fetch=defer_fetch)
    eager = ContinuousBatchingEngine(model, use_graph=False, **kw)
    graph = ContinuousBatchingEngine(model, **kw)
    assert graph._chunk_prog.graph is not None and all(p.graph is not None for p in graph._lane_progs.values())
    k4, k4_kv8, k3 = flash_prefix_attention.launches, flash_prefix_attention.kv8_launches, quant_matmul.launches
    with no_host_sync():
        want = _served(eager, prompts, budgets)
        got = _served(graph, prompts, budgets)
        captures = CudaGraph.captures
        again = _served(graph, prompts, budgets)
    assert CudaGraph.captures == captures
    assert flash_prefix_attention.launches > k4 and graph.stats()["prefix_hits"] > 0
    if form == "int8_kv8":
        assert flash_prefix_attention.kv8_launches > k4_kv8 and quant_matmul.launches > k3
        assert graph._chunk_prog.graph.launches[(quant_matmul, "launches")] == 4 * (2 * 4 + 1)
    _same_served(got, want, 1e-5)
    # The second pass finds the first's prompts resident: more prefix hits,
    # other lane groups, f32 sums over other row sets.
    _same_served(again, got, 1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["rauq"], w["rauq"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["hidden"], w["hidden"], atol=1e-5, rtol=0)


def test_engine_bucketed_and_sampled_replays_match_eager(gen):
    """Bucketed prefill (eager in both) with decode chunks replayed, in a
    sampling engine serving greedy and sampled requests: from one seed the
    replays draw what the eager chunks draw, and a new generator replays."""
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine

    model = _tiny_llama("f32")
    prompts = _serving_prompts(4, 10, 5, 90)
    kw = dict(num_slots=3, max_ctx=192, max_new_tokens=10, chunk_tokens=5, prompt_bucket=32, do_sample=True,
              temperature=0.9, top_k=50, top_p=0.95)
    results = []
    for use_graph in (False, True, True):
        engine = ContinuousBatchingEngine(model, use_graph=use_graph,
                                          generator=torch.Generator(device="cuda").manual_seed(11), **kw)
        ids = [engine.submit(p, sample=i % 3 != 0) for i, p in enumerate(prompts)]
        with no_host_sync():
            engine.run_until_drained()
        results.append([engine.result(i) for i in ids])
    _same_served(results[1], results[0], 1e-5)
    _same_served(results[2], results[1], 0.0)


@pytest.mark.parametrize("form", ["f32", "int8_kv8"])
def test_engine_on_the_card_matches_the_cpu(gen, form):
    """The same engine on the card and on the CPU (plain kernel versions),
    f32: tokens identical, log-probs within 1e-4 of max(1, |lp|) (5e-3 with
    KV8: a cached code may round to the other neighbour of a half-integer)."""
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine

    card = _tiny_llama(form)
    cpu = type(card)(**{k: getattr(card, k) for k in ("vocab_size", "num_layers", "num_heads", "num_kv_heads",
                                                       "d_model", "hidden_dim", "max_len", "use_flash", "quantized",
                                                       "quantized_kv", "fused_qkv")}, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    prompts = _serving_prompts(5, 6, 10, 120, shared=140)
    budgets = [6] * len(prompts)
    kw = dict(num_slots=4, max_ctx=384, max_new_tokens=6, chunk_tokens=4, prefill_chunk=128, prefill_lanes=4,
              prefix_cache=True)
    with no_host_sync():
        got = _served(ContinuousBatchingEngine(card, **kw), prompts, budgets)
    want = _served(ContinuousBatchingEngine(cpu, **kw), prompts, budgets)
    _same_served(got, want, 1e-4 if form == "f32" else 5e-3, rel=True)


def test_engine_greedy_equals_torch_generator_on_the_card(gen):
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine, TorchGenerator

    model = _tiny_llama("f32")
    prompts = _serving_prompts(6, 5, 10, 200)
    generator = TorchGenerator(model, max_new_tokens=8)
    for kw in (dict(prefill_chunk=128, prefill_lanes=2), dict(prompt_bucket=64)):
        engine = ContinuousBatchingEngine(model, num_slots=2, max_ctx=384, max_new_tokens=8, chunk_tokens=3, **kw)
        with no_host_sync():
            got = engine.generate_all(prompts)
            want = [generator.generate(p, output_attentions=False, output_hidden_states=False) for p in prompts]
        for p, g, w in zip(prompts, got, want):
            assert g["tokens"] == w["sequences"][0, len(p):].tolist()
            np.testing.assert_allclose(g["log_probs"], w["log_probs"][0], atol=1e-5, rtol=0)


def _tiny_draft(model):
    """The first block of ``model`` with its embedding, final norm and head:
    the distilled draft's construction, holding the same tensors."""
    from runia_core_tpu_torch.models import LlamaLM

    keys = ("vocab_size", "num_heads", "num_kv_heads", "d_model", "hidden_dim", "max_len", "use_flash", "quantized",
            "quantized_kv", "fused_qkv")
    draft = LlamaLM(**{k: getattr(model, k) for k in keys}, num_layers=1, device="cuda").eval()
    draft.load_state_dict({k: v for k, v in model.state_dict().items() if not k.startswith("block_")
                           or k.startswith("block_0.")}, assign=True)
    return draft


@pytest.mark.parametrize("form", ["f32", "int8_kv8"])
@pytest.mark.parametrize("draft", ["first_block", "perfect"])
def test_spec_engine_replays_match_the_eager_engine(gen, form, draft):
    """The speculative engine's round chunk and its lane programs (with the
    draft's leg) as CUDA-graph replays against use_graph=False, under
    sync-debug "error": tokens identical, log-probs within 1e-5, accepted /
    proposed equal; a warm pass captures nothing; the greedy tokens are the
    plain engine's; in int8 kernel 3 runs in the round's graph and kernel
    4's KV8 variant in the lanes."""
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine

    model = _tiny_llama(form)
    dm = model if draft == "perfect" else _tiny_draft(model)
    prompts = _serving_prompts(13, 8, 10, 200, shared=130)
    budgets = [3, 9, 1, 6, 12, 2, 8, 5]
    kw = dict(num_slots=4, max_ctx=384, max_new_tokens=12, chunk_tokens=10, prefill_chunk=128, prefill_lanes=4,
              prefix_cache=True, collect_rauq=True, admission="lpt")
    eager = ContinuousBatchingEngine(model, draft_model=dm, gamma=4, use_graph=False, **kw)
    graph = ContinuousBatchingEngine(model, draft_model=dm, gamma=4, **kw)
    assert graph._chunk_prog.graph is not None and all(p.graph is not None for p in graph._lane_progs.values())
    k4_kv8 = flash_prefix_attention.kv8_launches
    with no_host_sync():
        want = _served(eager, prompts, budgets)
        got = _served(graph, prompts, budgets)
        captures = CudaGraph.captures
        again = _served(graph, prompts, budgets)
    assert CudaGraph.captures == captures
    _same_served(got, want, 1e-5)
    _same_served(again, got, 1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["rauq"], w["rauq"], atol=1e-5, rtol=0)
    assert {k: graph.stats()[k] for k in ("accepted", "proposed")} == {
        k: 2 * eager.stats()[k] for k in ("accepted", "proposed")}
    if form == "int8_kv8":
        assert graph._chunk_prog.graph.launches[(quant_matmul, "launches")] > 0
        assert flash_prefix_attention.kv8_launches > k4_kv8
    else:
        plain = ContinuousBatchingEngine(model, **{k: v for k, v in kw.items() if k != "collect_rauq"})
        with no_host_sync():
            _same_served(got, _served(plain, prompts, budgets), 1e-4)
    if draft == "perfect":
        assert graph.stats()["acceptance"] > 0.9


def test_spec_engine_sampled_replays_match_eager(gen):
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine

    model = _tiny_llama("f32")
    prompts = _serving_prompts(14, 6, 10, 150)
    kw = dict(num_slots=3, max_ctx=256, max_new_tokens=10, chunk_tokens=10, prefill_chunk=128, prefill_lanes=2,
              do_sample=True, temperature=0.9, gamma=4)
    results = []
    for use_graph in (False, True, True):
        engine = ContinuousBatchingEngine(model, draft_model=_tiny_draft(model), use_graph=use_graph,
                                          generator=torch.Generator(device="cuda").manual_seed(5), **kw)
        with no_host_sync():
            results.append(_served(engine, prompts, [10] * len(prompts)))
    _same_served(results[1], results[0], 1e-5)
    _same_served(results[2], results[1], 0.0)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_fused_drain_replays_match_eager(gen, spec):
    """generate_all_fused's two iteration programs as replays against the
    same programs run eagerly, int8 + KV8, lanes 4 x 128 chosen on the
    device: tokens identical, log-probs within 1e-5, _last_fused_stats
    equal; a second call captures nothing; prefill_lanes=1 equals the
    interactive drain bit for bit."""
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine

    model = _tiny_llama("int8_kv8")
    prompts = _serving_prompts(15, 10, 10, 300)
    budgets = [3, 9, 1, 6, 12, 2, 8, 5, 7, 4]
    kw = dict(num_slots=4, max_ctx=384, max_new_tokens=12, chunk_tokens=10 if spec else 4, prefill_chunk=128)
    if spec:
        kw.update(draft_model=_tiny_draft(model), gamma=4)
    eager = ContinuousBatchingEngine(model, use_graph=False, **kw)
    graph = ContinuousBatchingEngine(model, **kw)
    k3, k4 = quant_matmul.launches, flash_prefix_attention.kv8_launches
    with no_host_sync():
        want = eager.generate_all_fused(prompts, budgets)
        captures = CudaGraph.captures
        got = graph.generate_all_fused(prompts, budgets)
        assert CudaGraph.captures == captures + 2
        again = graph.generate_all_fused(prompts, budgets)
        assert CudaGraph.captures == captures + 2
        one_lane = graph.generate_all_fused(prompts, budgets, prefill_lanes=1)
        interactive = _served(graph, prompts, budgets)
    assert quant_matmul.launches > k3 and flash_prefix_attention.kv8_launches > k4
    _same_served(got, want, 1e-5)
    _same_served(again, got, 0.0)
    _same_served(one_lane, interactive, 0.0)
    assert graph._last_fused_stats["prefill_iters"] > 0
    drain = graph._fused_cache.get((len(prompts), 384, 12, 4))
    assert drain is not None and all(p.graph is not None for p in drain.programs)


def test_spec_guard_captures_the_plain_programs_at_a_drain_boundary(gen):
    """An uncorrelated draft under a floor of 0.99: the second drain runs on
    the plain chunk and draft-free lanes, captured then, and equals the
    plain engine."""
    import warnings

    from runia_core_tpu_torch.llm import ContinuousBatchingEngine
    from runia_core_tpu_torch.models import LlamaLM

    model = _tiny_llama("f32")
    other = LlamaLM(**{k: getattr(model, k) for k in ("vocab_size", "num_heads", "num_kv_heads", "d_model",
                                                      "hidden_dim", "max_len")}, num_layers=1, device="cuda").eval()
    other.init_weights(torch.Generator(device="cuda").manual_seed(9))
    prompts = _serving_prompts(16, 12, 10, 150)
    budgets = [12] * len(prompts)
    kw = dict(num_slots=4, max_ctx=256, max_new_tokens=12, chunk_tokens=10, prefill_chunk=128, prefill_lanes=2)
    engine = ContinuousBatchingEngine(model, draft_model=other, spec_min_acceptance=0.99, **kw)
    with no_host_sync():
        _served(engine, prompts, budgets)
        assert engine.stats()["proposed"] >= engine._SPEC_EVIDENCE
        with pytest.warns(UserWarning, match="speculative decoding disabled"):
            got = _served(engine, prompts, budgets)
        want = _served(ContinuousBatchingEngine(model, **kw), prompts, budgets)
    assert engine.stats()["spec_disabled"] == 1 and engine._chunk_prog.graph is not None
    _same_served(got, want, 1e-5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with no_host_sync():
            _same_served(_served(engine, prompts, budgets), got, 1e-5)


def test_generation_service_from_several_threads(gen):
    """GenerationService's worker captures and replays the decode programs
    while four threads submit: every result equals a direct generate_batch."""
    import threading

    from runia_core_tpu_torch.llm import GenerationService, TorchGenerator

    generator = TorchGenerator(_tiny_llama("f32"), max_new_tokens=8)
    prompts = _serving_prompts(17, 24, 5, 100)
    service = GenerationService(generator, max_batch=8, max_wait_s=0.05, length_bucket=64)
    futures = [None] * len(prompts)

    def submit(part):
        for i in range(part, len(prompts), 4):
            futures[i] = service.submit(prompts[i])

    threads = [threading.Thread(target=submit, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        results = [f.result(timeout=300) for f in futures]
    finally:
        service.close()
    for p, res in zip(prompts, results):
        want = generator.generate_batch([p], output_scores=False)
        np.testing.assert_array_equal(res["sequences"][0], want["sequences"][0])
        np.testing.assert_allclose(res["log_probs"], want["log_probs"][0], atol=1e-4, rtol=0)


def test_spec_guard_keeps_slot_0_resident_for_the_prefix_cache(gen):
    """The guard fires and captures the draft-free lanes on null lanes aimed
    at slot 0; slot 0's rows are put back, so later requests that share only
    slot 0's prompt prefix hit as often as in the use_graph=False engine
    (the CPU engine's twin), and their tokens agree."""
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine
    from runia_core_tpu_torch.models import LlamaLM

    model = _tiny_llama("f32")
    other = LlamaLM(**{k: getattr(model, k) for k in ("vocab_size", "num_heads", "num_kv_heads", "d_model",
                                                      "hidden_dim", "max_len")}, num_layers=1, device="cuda").eval()
    other.init_weights(torch.Generator(device="cuda").manual_seed(9))
    first = _serving_prompts(17, 8, 130, 200)  # no shared prefix: each slot holds its own prompt
    suffixes = _serving_prompts(18, 5, 10, 60)
    kw = dict(num_slots=4, max_ctx=384, max_new_tokens=12, chunk_tokens=10, prefill_chunk=128, prefill_lanes=2,
              prefix_cache=True)
    engines = {g: ContinuousBatchingEngine(model, draft_model=other, spec_min_acceptance=0.99, use_graph=g, **kw)
               for g in (True, False)}
    hits, served, resident = {}, {}, {}
    for use_graph, engine in engines.items():
        with no_host_sync() if use_graph else contextlib.nullcontext():
            _served(engine, first, [12] * len(first))
            assert engine.stats()["proposed"] >= engine._SPEC_EVIDENCE
            resident[use_graph] = list(engine._slot_prompt[0])
            later = [resident[use_graph][:128] + s for s in suffixes]
            before = engine.stats()["prefix_hits"]
            with pytest.warns(UserWarning, match="speculative decoding disabled"):
                served[use_graph] = _served(engine, later, [6] * len(later))
        hits[use_graph] = engine.stats()["prefix_hits"] - before
    assert resident[True] == resident[False]
    assert engines[True]._lane_progs[1].graph is not None and engines[True].stats()["spec_disabled"] == 1
    assert hits[True] == hits[False] > 0
    _same_served(served[True], served[False], 1e-5)


def _rn50(dtype, device="cuda", weights_of=None):
    from runia_core_tpu_torch.models import ResNet50

    model = ResNet50(num_classes=10, dtype=dtype, device=device)
    if weights_of is None:
        model.init_weights(torch.Generator(device=device).manual_seed(0))
    else:
        model.load_state_dict({k: v.to(device) for k, v in weights_of.state_dict().items()})
    return model.to(memory_format=torch.channels_last).eval()


def test_tapped_rn50_forward_replays_match_eager(gen):
    """tap_torch_model's forward hooks under a CUDA-graph capture: the taps
    are outputs of the captured function, so each replay returns the new
    images' tap; a Hook filled from a replay keeps its copy after the next."""
    from runia_core_tpu_torch.extraction import Hook, tap_torch_model

    torch.backends.cudnn.allow_tf32 = False
    model = _rn50(torch.bfloat16)
    tapped = tap_torch_model(model, ("stage4_block2",), tap_aliases={"pre_pool": "stage4_block2"})

    def fn(images):
        (logits, _), taps = tapped(images)
        return logits, taps["pre_pool"]

    batches = [torch.rand((16, 224, 224, 3), generator=gen, device="cuda") for _ in range(3)]
    graph = CudaGraph(fn, {"images": batches[0]})
    hooks = []
    for x in batches:
        graph.load(images=x)
        with no_host_sync():
            logits, tap = graph.replay()
        want_logits, want_tap = fn(x)
        torch.testing.assert_close(logits, want_logits, rtol=1e-6, atol=1e-6 * float(want_logits.abs().max()))
        torch.testing.assert_close(tap, want_tap, rtol=1e-6, atol=1e-6 * float(want_tap.abs().max()))
        assert tap.shape == (16, 2048, 7, 7)
        hooks.append((Hook("pre_pool").capture({"pre_pool": tap}), want_tap))
    for hook, want_tap in hooks:  # later replays overwrote the graph's buffer, not the copies
        torch.testing.assert_close(hook.output, want_tap, rtol=1e-6, atol=1e-6 * float(want_tap.abs().max()))
    assert all(not m._forward_hooks for m in model.modules())


def test_extractor_on_the_card_matches_the_cpu(gen):
    """FastMCDSamplesExtractor (return_stds, raw_preds) and get_dl_h_z on an
    f32 RN50 at 224 px, batch 4, the same keep-weights: the card (TF32 off,
    kernel 1) against the CPU (plain versions), relative to each output's
    largest magnitude."""
    from runia_core_tpu_torch.evaluation import get_dl_h_z
    from runia_core_tpu_torch.extraction import FastMCDSamplesExtractor, tap_torch_model

    torch.backends.cudnn.allow_tf32 = False
    card = _rn50(torch.float32)
    x = torch.rand((4, 224, 224, 3), generator=gen, device="cuda")
    weights = mc_dropblock_weights(4, 7, 7, 16, 3, 0.5, gen, "cuda")
    out = {}
    for device, model in (("cuda", card), ("cpu", _rn50(torch.float32, "cpu", weights_of=card))):
        tapped = tap_torch_model(model, ("stage4_block2",), tap_aliases={"pre_pool": "stage4_block2"}, device=device)
        extractor = FastMCDSamplesExtractor(
            lambda images: (lambda o, t: (o[0], t))(*tapped(images)), "Conv", "fullmean", channel_axis=1,
            mcd_nro_samples=16, dropblock_probs=0.5, dropblock_sizes=3, return_stds=True,
            return_raw_predictions=True, device=device)
        before = marginal_entropy_cuda.launches
        got = extractor.get_ls_samples([(x.to(device), torch.zeros(4))], draws=[[weights.to(device)]])
        got["entropies"] = get_dl_h_z(got["latent_space_means"], 16)[1]
        assert (marginal_entropy_cuda.launches > before) == (device == "cuda")
        out[device] = got
    for key in ("latent_space_means", "stds", "raw_preds", "entropies"):
        want = out["cpu"][key]
        assert out["cuda"][key].is_cuda
        torch.testing.assert_close(out["cuda"][key].cpu(), want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("b,h,cin,cout,k,stride,pad", [
    (2, 32, 3, 64, 3, 1, 1),  # the CIFAR stem: depth 27 padded to 32
    (1, 4, 16, 12, 3, 2, 1),  # 4 rows (< 17) and 12 outputs padded to 16
    (8, 16, 128, 256, 1, 2, 0),  # a strided 1x1 projection
    (4, 8, 512, 512, 3, 1, 1),  # |sums| past 2^24 possible
])
def test_int8_conv_on_the_card_is_exact(gen, b, h, cin, cout, k, stride, pad):
    """quant_vision.int8_conv (patches + torch._int_mm) on the card against
    the same call on the CPU: int32 sums bit for bit."""
    from runia_core_tpu_torch.models.quant_vision import _weight_matrix, int8_conv

    xq = torch.randint(-127, 128, (b, h, h, cin), generator=gen, device="cuda", dtype=torch.int8)
    w_q = torch.randint(-127, 128, (k, k, cin, cout), generator=gen, device="cuda", dtype=torch.int8)
    args = ((k, k), cout, stride, ((pad, pad), (pad, pad)))
    got = int8_conv(xq, _weight_matrix(w_q), *args)
    want = int8_conv(xq.cpu(), _weight_matrix(w_q.cpu()), *args)
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


def test_int8_forward_replays_and_matches_the_cpu(gen):
    """quantize_resnet's forward captured in a CUDA graph equals the eager
    forward bit for bit under sync-debug "error", and equals the CPU's on
    the same qparams: the pre_pool tap bit for bit (exact int32 sums, the
    same IEEE f32 elementwise operations), logits within 1e-5 of max (the
    mean pool and the head sum in other orders)."""
    from runia_core_tpu_torch.models import ResNet18, quantize_resnet, quantize_resnet_params

    torch.backends.cudnn.allow_tf32 = False
    model = ResNet18(num_classes=10, cifar_stem=True, num_filters=16)
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("running_var", "weight")) and t.ndim == 1:
                t.uniform_(0.5, 1.5, generator=gen)
    calib = torch.rand((32, 32, 32, 3), generator=gen, device="cuda")
    qparams = quantize_resnet_params(model, calib)
    forward = quantize_resnet(model, None, taps=("pre_pool",), qparams=qparams)
    x = torch.rand((20, 32, 32, 3), generator=gen, device="cuda")
    def logits_and_tap(images):
        logits, taps = forward(images)
        return logits, taps["pre_pool"]

    graph = CudaGraph(logits_and_tap, {"images": x})
    graph.load(images=x)
    with no_host_sync():
        logits, tap = graph.replay()
    want_logits, want_taps = forward(x)
    assert torch.equal(logits, want_logits) and torch.equal(tap, want_taps["pre_pool"])
    cpu = ResNet18(num_classes=10, cifar_stem=True, num_filters=16, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_logits, cpu_taps = quantize_resnet(cpu, None, taps=("pre_pool",), qparams=qparams)(x.cpu())
    assert torch.equal(want_taps["pre_pool"].cpu(), cpu_taps["pre_pool"])
    torch.testing.assert_close(want_logits.cpu(), cpu_logits, rtol=1e-5, atol=1e-5 * float(cpu_logits.abs().max()))


def test_train_step_and_vit_on_the_card_match_the_cpu(gen):
    """One SGD step of a small ResNet (BatchNorm in train mode) and a small
    ViT's forward, card (TF32 off) against CPU: loss 1e-5 relative,
    gradients 1e-3 of each tensor's largest magnitude, running statistics
    1e-5; ViT logits and taps 1e-4 of max."""
    from runia_core_tpu_torch.models import ResNet, ViT, build_tapped_forward
    from runia_core_tpu_torch.models.resnet import ResNetBlock
    from runia_core_tpu_torch.training import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    x = torch.rand((16, 16, 16, 3), generator=gen, device="cuda")
    y = torch.randint(0, 4, (16,), generator=gen, device="cuda")
    models = {"cuda": ResNet((1, 1), ResNetBlock, 4, num_filters=8, cifar_stem=True)}
    models["cuda"].init_weights(torch.Generator(device="cuda").manual_seed(1))
    models["cpu"] = ResNet((1, 1), ResNetBlock, 4, num_filters=8, cifar_stem=True, device="cpu")
    models["cpu"].load_state_dict({k: v.cpu() for k, v in models["cuda"].state_dict().items()})
    losses = {}
    for device, model in models.items():
        state, _ = create_train_state(model, tx=lambda p: torch.optim.SGD(p, lr=0.05))
        losses[device] = float(make_train_step(model)(state, x.to(device), y.to(device))[1]["loss"])
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-5)
    for (name, p), q in zip(models["cpu"].named_parameters(), models["cuda"].parameters()):
        scale = float(p.grad.abs().max())
        assert float((q.grad.cpu() - p.grad).abs().max()) <= 1e-3 * max(scale, 1e-30), name
    for name, t in models["cpu"].state_dict().items():
        if "running" in name:
            assert float((models["cuda"].state_dict()[name].cpu() - t).abs().max()) <= 1e-5, name

    vit = ViT(num_classes=5, patch_size=4, d_model=32, num_layers=2, num_heads=2, use_cls_token=True, pool="cls",
              exact_gelu=True, image_size=16).init_weights(torch.Generator(device="cuda").manual_seed(2))
    vit_cpu = ViT(num_classes=5, patch_size=4, d_model=32, num_layers=2, num_heads=2, use_cls_token=True, pool="cls",
                  exact_gelu=True, image_size=16, device="cpu")
    vit_cpu.load_state_dict({k: v.cpu() for k, v in vit.state_dict().items()})
    taps = ("encoder_tokens", "pre_head")
    got, want = build_tapped_forward(vit, taps)(x), build_tapped_forward(vit_cpu, taps)(x.cpu())
    for a, b in ((got[0], want[0]), *((got[1][t], want[1][t]) for t in taps)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def _random_boxes(gen, n, size=640.0, lo=8.0, hi=200.0):
    """n xyxy boxes at ``size`` px with widths and heights in [lo, hi)."""
    xy = torch.rand((n, 2), generator=gen, device="cuda") * size
    wh = torch.rand((n, 2), generator=gen, device="cuda") * (hi - lo) + lo
    return torch.cat([xy, xy + wh], dim=1)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 8400, 30000])
@pytest.mark.parametrize("thr", [0.45, 0.7])
def test_nms_kernel_matches_plain_bit_for_bit(gen, n, thr):
    """The NMS kernel decides each pair with the plain version's rounding:
    the keep masks are identical, at ragged 64-box edges and at N up to
    ultralytics' max_nms."""
    from runia_core_tpu_torch.ops.nms import nms_keep_cuda, nms_keep_plain, nms_mask

    boxes = _random_boxes(gen, n)
    scores = torch.rand(n, generator=gen, device="cuda")
    before = nms_keep_cuda.launches
    order, keep = nms_mask(boxes, scores, thr)
    again = nms_mask(boxes, scores, thr)[1]
    assert nms_keep_cuda.launches == before + 2
    assert torch.equal(keep, again)
    want = nms_keep_plain(boxes[order], thr) if n <= 8400 else nms_keep_plain(boxes[order].cpu(), thr).cuda()
    assert torch.equal(keep, want)


def test_nms_kernel_chains_ties_and_degenerate_boxes(gen):
    """The alternating chain keeps every other box; identical boxes keep one;
    zero-area boxes (0 / 0 IoU) suppress nothing."""
    from runia_core_tpu_torch.ops.nms import nms_indices

    n = 200
    chain = torch.stack([torch.arange(n) * 6.0, torch.zeros(n), torch.arange(n) * 6.0 + 10, torch.full((n,), 10.0)], 1)
    scores = torch.linspace(0.9, 0.1, n)
    assert nms_indices(chain.cuda(), scores.cuda(), 0.2).tolist() == list(range(0, n, 2))
    same = torch.tensor([[0.0, 0.0, 10.0, 10.0]]).repeat(130, 1)
    assert nms_indices(same.cuda(), torch.linspace(0.1, 0.9, 130).cuda(), 0.5).tolist() == [129]
    flat = torch.tensor([[5.0, 5.0, 5.0, 9.0]]).repeat(70, 1)
    assert nms_indices(flat.cuda(), torch.rand(70, generator=gen, device="cuda"), 0.0).shape == (70,)


def _yolo_like(gen, n, classes=80, max_wh=7680.0, candidates=0.3):
    """n YOLOv8-style score-sorted boxes as the adapter hands them to NMS:
    boxes about anchors on a 640-px image, each moved by class * max_wh,
    the candidates first (by descending score), the rest after them as the
    adapter's -inf scores sort them."""
    boxes = _random_boxes(gen, n, size=600.0, lo=4.0, hi=160.0)
    cls = torch.randint(0, classes, (n,), generator=gen, device="cuda")
    scores = torch.rand(n, generator=gen, device="cuda")
    scores = torch.where(torch.rand(n, generator=gen, device="cuda") < candidates, scores, -torch.inf)
    order = torch.sort(scores, descending=True, stable=True).indices
    return (boxes + cls[:, None].float() * max_wh)[order].contiguous(), cls[order]


def _plain_by_class(sorted_boxes, cls, thr):
    """nms_keep_plain over each class's boxes apart (in their order): the
    whole set's keep mask, where boxes of two classes never overlap, without
    the (N, N) matrices of all N."""
    from runia_core_tpu_torch.ops.nms import nms_keep_plain

    keep = torch.zeros(sorted_boxes.shape[0], dtype=torch.bool, device=sorted_boxes.device)
    for c in torch.unique(cls).tolist():
        rows = torch.nonzero(cls == c).flatten()
        keep[rows] = nms_keep_plain(sorted_boxes[rows], thr)
    return keep


@pytest.mark.parametrize("case", ["yolo_class_offsets", "ragged_8401", "chain_4000", "identical_5000", "n65536"])
def test_nms_kernel_structured_cases(gen, case):
    """Keep masks equal to the plain version's and bit-identical over two
    runs: YOLOv8's 8,400 class-offset anchors with the non-candidates
    last; N one past a 64-box edge; a chain in which every box suppresses
    the next (every other kept, across 63 column blocks); 5,000 identical
    boxes; N = 65,536 class-offset boxes (the kernel's largest N)."""
    from runia_core_tpu_torch.ops.nms import nms_keep_cuda, nms_keep_plain

    thr = 0.45
    if case == "yolo_class_offsets":
        boxes, cls = _yolo_like(gen, 8400)
        want = _plain_by_class(boxes, cls, 0.7)
        thr = 0.7
    elif case == "n65536":
        boxes, cls = _yolo_like(gen, 65536, classes=256, candidates=1.0)
        want = _plain_by_class(boxes, cls, thr)
    elif case == "ragged_8401":
        boxes = _random_boxes(gen, 8401)
        boxes = boxes[torch.randperm(8401, generator=gen, device="cuda")].contiguous()
        want = nms_keep_plain(boxes, thr)
    elif case == "chain_4000":
        n = 4000
        x = torch.arange(n, device="cuda", dtype=torch.float32) * 6.0
        boxes = torch.stack([x, torch.zeros_like(x), x + 10, torch.full_like(x, 10.0)], 1)  # IoU(i, i + 1) = 0.25
        thr = 0.2
        want = torch.arange(n, device="cuda") % 2 == 0
        assert torch.equal(nms_keep_plain(boxes[:500], thr), want[:500])
    else:
        boxes = torch.tensor([[3.0, 4.0, 50.0, 60.0]], device="cuda").repeat(5000, 1)
        want = torch.arange(5000, device="cuda") == 0
        assert torch.equal(nms_keep_plain(boxes[:300], thr), want[:300])
    before = nms_keep_cuda.launches
    got = nms_keep_cuda(boxes, thr)
    again = nms_keep_cuda(boxes, thr)
    assert nms_keep_cuda.launches == before + 2
    assert torch.equal(got, again)
    assert int((got != want).sum()) == 0, case


_ROI_CASES = {  # (B, H, W, C, M, image size, out): the bench leg's tap, YOLOv8m's p5 and p3, small edges
    "bench_tap": (128, 8, 8, 512, 20, 256, 7),
    "yolo_p5": (1, 20, 20, 576, 300, 640, 7),
    "yolo_p3": (1, 80, 80, 192, 300, 640, 7),
    "ragged_c": (2, 9, 13, 70, 5, 100, 3),
    "c100": (2, 20, 20, 100, 50, 640, 7),
}


@pytest.mark.parametrize("case", sorted(_ROI_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mean", [False, True], ids=["pooled", "mean"])
def test_roi_align_kernel_matches_plain(gen, case, dtype, mean):
    """Kernel against the plain (JAX) form on the same inputs: f32 within
    1e-5 of max |feature|; bf16 within ROI_BF16_REL of it (the plain form
    rounds its weights and its intermediate to bf16, the kernel sums in f32)."""
    from runia_core_tpu_torch.ops.roi_align import roi_align_nhwc_cuda, roi_align_nhwc_plain

    b, h, w, c, m, img, out = _ROI_CASES[case]
    fmap = torch.rand((b, h, w, c), generator=gen, device="cuda").to(dtype)
    boxes = _random_boxes(gen, b * m, size=img * 0.8, lo=1.0, hi=img * 0.5)
    boxes[0] = torch.tensor([0.0, 0.0, img, img])  # the whole image: the adaptive grid at its cap
    scale = w / img
    before = roi_align_nhwc_cuda.launches
    got = roi_align_nhwc_cuda(fmap, boxes, out, scale, mean=mean)
    assert roi_align_nhwc_cuda.launches == before + 1
    assert torch.equal(got, roi_align_nhwc_cuda(fmap, boxes, out, scale, mean=mean))
    want = roi_align_nhwc_plain(fmap, boxes, out, scale, mean=mean)
    assert got.shape == want.shape and got.dtype == dtype
    bound = (1e-5 if dtype == torch.float32 else ROI_BF16_REL) * float(fmap.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= bound


ROI_BF16_REL = 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mean", [False, True], ids=["pooled", "mean"])
def test_roi_align_kernel_on_detrs_map_and_a_misaligned_view(gen, dtype, mean):
    """DETR-R50's (1, 25, 38, 2048) backbone map at 800 x 1216 with a
    whole-image box and 99 random ones, against the plain form (the map in
    [0, 1), as the other cases); a bf16 map also against the plain form's
    f32 sums of the same bf16 values, within one bf16 rounding of the
    result (the kernel sums in f32 and rounds once); the same map as a view
    whose base is 4 (f32) or 2 (bf16) bytes past 16-byte alignment takes
    the kernel's scalar loads and gives the same bits as the 16-byte ones
    (each channel's sums run in the same order)."""
    from runia_core_tpu_torch.ops.roi_align import roi_align_nhwc_cuda, roi_align_nhwc_plain

    fmap = torch.rand((1, 25, 38, 2048), generator=gen, device="cuda").to(dtype)
    boxes = torch.cat([torch.tensor([[0.0, 0.0, 1216.0, 800.0]], device="cuda"),
                       _random_boxes(gen, 99, size=900.0, lo=8.0, hi=500.0)])
    got = roi_align_nhwc_cuda(fmap, boxes, 7, 1 / 32, mean=mean)
    assert torch.equal(got, roi_align_nhwc_cuda(fmap, boxes, 7, 1 / 32, mean=mean))
    want = roi_align_nhwc_plain(fmap, boxes, 7, 1 / 32, mean=mean)
    bound = (1e-5 if dtype == torch.float32 else ROI_BF16_REL) * float(fmap.float().abs().max())
    assert got.shape == want.shape and float((got.float() - want.float()).abs().max()) <= bound
    if dtype == torch.bfloat16:
        sums = roi_align_nhwc_plain(fmap.float(), boxes, 7, 1 / 32, mean=mean)
        assert bool(((got.float() - sums).abs() <= 2**-8 * sums.abs() + 1e-5 * float(fmap.float().abs().max())).all())
    storage = torch.empty(fmap.numel() + 8, dtype=dtype, device="cuda")
    view = storage[1: 1 + fmap.numel()].view(fmap.shape)
    view.copy_(fmap)
    assert view.is_contiguous() and view.data_ptr() % 16
    assert torch.equal(roi_align_nhwc_cuda(view, boxes, 7, 1 / 32, mean=mean), got)


def test_object_scorer_replays_and_yolo_adapter_on_the_card(gen):
    """build_object_scorer's graph against its eager call (bit for bit) and
    against the CPU (f32, TF32 off: 1e-4 of max |score|), padded rows -inf;
    YoloV8JaxAdapter on the card (NMS kernel) against the CPU (plain NMS)."""
    from runia_core_tpu_torch.detectors import MDLatentSpace
    from runia_core_tpu_torch.extraction import build_object_scorer, pad_detections
    from runia_core_tpu_torch.models import ResNet18, YoloV8, YoloV8JaxAdapter, build_tapped_forward
    from runia_core_tpu_torch.ops.nms import nms_keep_cuda
    from runia_core_tpu_torch.ops.roi_align import roi_align_nhwc_cuda

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    dets = []
    for n in (3, 0, 6, 2):
        xy = rng.rand(n, 2) * 40
        dets.append({"boxes": np.concatenate([xy, xy + rng.rand(n, 2) * 20 + 4], 1).astype(np.float32)})
    card = ResNet18(num_classes=3, num_filters=8)
    card.init_weights(torch.Generator(device="cuda").manual_seed(0))
    cpu = ResNet18(num_classes=3, num_filters=8, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    md = MDLatentSpace()
    md.setup(torch.randn((100, 64), generator=gen, device="cuda"))
    x = torch.rand((4, 64, 64, 3), generator=gen, device="cuda")
    scores = {}
    for name, model, device, graph in (("graph", card, "cuda", True), ("eager", card, "cuda", False),
                                       ("cpu", cpu, "cpu", False)):
        scorer = build_object_scorer(build_tapped_forward(model), {k: v.to(device) for k, v in md.state.items()},
                                     output_sizes=(7,), img_shape=(64, 64), use_graph=graph)
        padded = pad_detections(dets, 6, (64, 64), device=device)
        before = roi_align_nhwc_cuda.launches
        with no_host_sync() if graph else contextlib.nullcontext():
            scores[name] = [scorer(x.to(device), padded) for _ in range(2)]
        assert (roi_align_nhwc_cuda.launches > before) == (device == "cuda")
    assert all(torch.equal(s, scores["eager"][0]) for s in scores["graph"] + scores["eager"])
    want = scores["cpu"][0]
    finite = torch.isfinite(want)
    assert int(finite.sum()) == 3 + 1 + 6 + 2 and torch.equal(torch.isfinite(scores["graph"][0]).cpu(), finite)
    torch.testing.assert_close(scores["graph"][0].cpu()[finite], want[finite], rtol=0,
                               atol=1e-4 * float(want[finite].abs().max()))

    yolo = YoloV8(4, "n").init_weights(torch.Generator(device="cuda").manual_seed(1))
    yolo_cpu = YoloV8(4, "n", device="cpu")
    yolo_cpu.load_state_dict({k: v.cpu() for k, v in yolo.state_dict().items()})
    image = torch.rand((64, 64, 3), generator=gen, device="cuda")
    before = nms_keep_cuda.launches
    eager = YoloV8JaxAdapter(yolo, fmap_taps=("backbone_p5", "p3"), use_graph=False)(image, 0.3)
    assert nms_keep_cuda.launches == before + 1
    adapter = YoloV8JaxAdapter(yolo, fmap_taps=("backbone_p5", "p3"))
    for _ in range(2):  # the first call captures the adapter's graph, both replay it
        got = adapter(image, 0.3)
        np.testing.assert_array_equal(got.boxes, eager.boxes)
        np.testing.assert_array_equal(got.logits, eager.logits)
        assert all(torch.equal(g, e) for g, e in zip(got.fmaps, eager.fmaps))
    assert nms_keep_cuda.launches == before + 1 + 2 + 2  # eager, the capture's two warm-ups, two replays
    want = YoloV8JaxAdapter(yolo_cpu, fmap_taps=("backbone_p5", "p3"))(image.cpu(), 0.3)
    assert got.boxes.shape[0] > 0 and got.fmaps[0].is_cuda
    np.testing.assert_array_equal(got.classes, want.classes)
    np.testing.assert_allclose(got.boxes, want.boxes, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.logits, want.logits, rtol=1e-4, atol=1e-4)


# ---- segmentation and DETR on the card, the native open-set matcher ----


def test_pixel_scorer_replays_match_eager(gen):
    """build_pixel_uncertainty_scorer over a small DeepLabV3Plus with decoder
    dropout: its graph against the eager call on the same generator seed
    (1e-6 relative, pred equal), a new generator per call replaying one
    capture, nothing synchronising inside."""
    from runia_core_tpu_torch.inference import build_pixel_uncertainty_scorer
    from runia_core_tpu_torch.models import DeepLabV3Plus
    from runia_core_tpu_torch.models.resnet import ResNetBlock

    torch.backends.cudnn.allow_tf32 = False
    model = DeepLabV3Plus(num_classes=5, backbone_stages=(1, 1, 1, 1), backbone_block=ResNetBlock, num_filters=8,
                          aspp_features=16, low_level_features=8, aspp_rates=(2, 4), dropout_rate=0.5)
    with torch.no_grad():  # tests/test_torch_deeplab.py's random weights: PyTorch's init leaves MI near 1e-5
        for name, t in model.state_dict().items():
            if name.endswith("running_var") or (name.endswith("weight") and t.ndim == 1):
                t.copy_(torch.rand(t.shape, generator=gen, device="cuda") + 0.5)
            elif name.endswith("running_mean"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen, device="cuda"))
            else:
                t.copy_(0.2 * torch.randn(t.shape, generator=gen, device="cuda"))
    graph = build_pixel_uncertainty_scorer(model, mc_samples=4)
    eager = build_pixel_uncertainty_scorer(model, mc_samples=4, use_graph=False)
    x = torch.rand((2, 64, 64, 3), generator=gen, device="cuda")
    captures = None
    for seed in (1, 2, 3):
        with no_host_sync():
            got = graph(x, torch.Generator(device="cuda").manual_seed(seed))
        want = eager(x, torch.Generator(device="cuda").manual_seed(seed))
        captures = CudaGraph.captures if captures is None else captures
        assert torch.equal(got["pred"], want["pred"]) and got["pred"].dtype == torch.int32
        for name in ("pred_h", "mi", "msp"):
            torch.testing.assert_close(got[name], want[name], rtol=1e-6, atol=1e-6 * float(want[name].abs().max()))
        assert float(want["mi"].max()) > 1e-4
    assert CudaGraph.captures == captures


def test_detr_on_the_card_matches_the_cpu(gen):
    """A small random HF DETR converted onto the card and onto the CPU (f32,
    TF32 off): logits and boxes within rtol 1e-4; DetrAdapter on the card
    against HFDetrAdapter on the card (the same detections), its fmap a card
    tensor."""
    transformers = pytest.importorskip("transformers")
    from runia_core_tpu_torch.extraction import HFDetrAdapter
    from runia_core_tpu_torch.models import DetrAdapter, convert_hf_detr

    torch.backends.cudnn.allow_tf32 = False
    cfg = transformers.DetrConfig(
        use_timm_backbone=False, use_pretrained_backbone=False,
        backbone_config=transformers.ResNetConfig(embedding_size=8, hidden_sizes=[32, 64], depths=[1, 1],
                                                  layer_type="bottleneck"),
        d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64, num_queries=9, num_labels=5)
    torch.manual_seed(0)
    hf = transformers.DetrForObjectDetection(cfg).eval()
    card, _ = convert_hf_detr(hf)
    cpu, _ = convert_hf_detr(hf, device="cpu")
    x = torch.rand((2, 96, 128, 3), generator=gen, device="cuda")
    with torch.inference_mode():
        got, taps = card(x)
        want, _ = cpu(x.cpu())
    for name in ("logits", "pred_boxes"):
        torch.testing.assert_close(got[name].cpu(), want[name], rtol=1e-4, atol=1e-5)
    ours = DetrAdapter(card)(x[0], predict_conf=0.0)
    theirs = HFDetrAdapter(hf)(x[0].cpu().numpy(), predict_conf=0.0)
    assert ours.fmaps[0].is_cuda and theirs.fmaps[0].is_cuda and ours.boxes.shape == (9, 4)
    np.testing.assert_allclose(ours.boxes, theirs.boxes, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(ours.scores, theirs.scores, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ours.fmaps[0], theirs.fmaps[0], rtol=1e-3, atol=1e-4)


def test_native_open_set_matcher_on_the_card_machine(gen):
    """The native matcher builds with the host compiler and equals the numpy
    loops on seeded random problems (missing images, difficult objects)."""
    from runia_core_tpu_torch import _kernels
    from runia_core_tpu_torch.evaluation import open_set

    assert _kernels.osod_matcher().__name__ == "_runia_osod"
    rng = np.random.RandomState(0)
    recs = {}
    for i in range(25):
        n = rng.randint(0, 7)
        xy, wh = rng.uniform(0, 80, (n, 2)), rng.uniform(4, 40, (n, 2))
        recs[f"im{i}"] = {"bbox": np.concatenate([xy, xy + wh], 1) if n else np.array([]),
                          "difficult": rng.rand(n) < 0.15, "det": [False] * n}
    image_ids = [f"im{rng.randint(25)}" if rng.rand() > 0.05 else "missing" for _ in range(400)]
    xy, wh = rng.uniform(0, 80, (400, 2)), rng.uniform(4, 40, (400, 2))
    bb = np.concatenate([xy, xy + wh], 1)
    npos = int(sum((~r["difficult"]).sum() for r in recs.values()))
    got = open_set._greedy_match(image_ids, bb, recs, 0.35, npos, False)
    want = open_set._greedy_match(image_ids, bb, recs, 0.35, npos, False, native=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    got = open_set._mark_unknown_overlaps(400, image_ids, bb, recs, 0.5)
    want = open_set._mark_unknown_overlaps(400, image_ids, bb, recs, 0.5, native=False)
    np.testing.assert_array_equal(got[2], want[2])


# ---- the conv-norm epilogue (csrc/conv_epilogue.cu) and the ResNet path over it ----

# The kernel's FMAs against the twin's multiply-adds on the card: f32 within
# a few steps of the largest term; bf16 one step of the result (2^-7 of it)
# where an f32 difference crosses a rounding boundary.
EPILOGUE_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}

_EPILOGUE_CASES = {  # (N, C, H, W), residual: None, "add" or "projected"
    "rn50_b128_stem": ((128, 64, 112, 112), None),
    "rn50_b128_28x28x128_inner": ((128, 128, 28, 28), None),
    "rn50_b128_56x56x256_residual": ((128, 256, 56, 56), "add"),
    "rn50_b128_56x56x256_projected": ((128, 256, 56, 56), "projected"),
    "rn50_b128_7x7x2048_projected": ((128, 2048, 7, 7), "projected"),
    "rn18_b512_32x32x64_residual": ((512, 64, 32, 32), "add"),
    "rn18_b512_4x4x512_projected": ((512, 512, 4, 4), "projected"),
    "odd_channels_24": ((3, 24, 5, 7), "projected"),
}


def _epilogue_inputs(gen, shape, residual, dtype):
    """y, scale, shift and the residual's arguments: none; the map; the
    map, scale_p and shift_p."""
    def fmap():
        return torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(memory_format=torch.channels_last)

    def affine():
        c = shape[1]
        return [torch.rand(c, generator=gen, device="cuda") + 0.5, 0.3 * torch.randn(c, generator=gen, device="cuda")]

    y, (scale, shift) = fmap(), affine()
    rest = [] if residual is None else [fmap()] + (affine() if residual == "projected" else [])
    return y, scale, shift, rest


def _epilogue_error(got, want, top):
    return float(((got.float() - want.float()).abs() / (want.float().abs() + 1e-6 * top)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(_EPILOGUE_CASES))
def test_conv_epilogue_kernel_matches_its_twin(gen, case, dtype):
    """In place over the map, the residual untouched, against the plain twin
    at the ResNet-50 batch-128 and ResNet-18 batch-512 maps."""
    from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue, conv_epilogue_plain

    shape, residual = _EPILOGUE_CASES[case]
    y, scale, shift, rest = _epilogue_inputs(gen, shape, residual, dtype)
    kept = [t.clone() for t in rest[:1]]
    want = conv_epilogue_plain(y, scale, shift, *rest)
    before = conv_epilogue.launches
    got = conv_epilogue(y, scale, shift, *rest)
    torch.cuda.synchronize()
    assert got.data_ptr() == y.data_ptr() and conv_epilogue.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(rest[:1], kept))
    top = float(want.float().abs().max())
    assert _epilogue_error(got, want, top) <= EPILOGUE_TOL[dtype]


def test_conv_epilogue_refuses_what_it_does_not_read(gen):
    from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue

    y, scale, shift, (r, sp, bp) = _epilogue_inputs(gen, (2, 16, 4, 4), "projected", torch.bfloat16)
    nchw = y.contiguous()
    narrow, s12, b12, _ = _epilogue_inputs(gen, (2, 12, 4, 4), None, torch.bfloat16)
    half = y.to(torch.float16)
    misaligned = _offset_view(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    for args in [(nchw, scale, shift), (narrow, s12, b12), (half, scale, shift), (misaligned, scale, shift),
                 (y, scale, shift, y), (y, scale, shift, r.contiguous()), (y, scale, shift, r.float()),
                 (y, scale, shift, None, sp, bp), (y, scale, shift, r, sp), (y, scale.double(), shift),
                 (y, scale[:8], shift)]:
        with pytest.raises(ValueError, match="conv_epilogue"):
            conv_epilogue(*args)


def _rn(depth, dtype, **kw):
    """A seeded ResNet-18 or -50 on the card, channels_last, in eval(), its
    norms' statistics and scales away from the identity (a wrong fold or a
    lost residual shows)."""
    from runia_core_tpu_torch.models import ResNet18, ResNet50
    from runia_core_tpu_torch.models.resnet import BatchNorm

    g = torch.Generator(device="cuda").manual_seed(depth)
    model = (ResNet50 if depth == 50 else ResNet18)(num_classes=10, dtype=dtype, device="cuda", **kw)
    model.init_weights(g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
    return model.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("depth,launches", [(50, 49), (18, 17)])
def test_the_resnet_path_counts_one_epilogue_a_conv_and_none_elsewhere(gen, depth, launches):
    """An eval, no-gradient call on the card launches the epilogue once for
    the stem and once for each conv that is not a projection (ResNet-50 49,
    ResNet-18 17) and matches the modules' path on the CPU (f32, TF32 off);
    ``train()``, a call recording a gradient and the CPU launch none."""
    from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue

    torch.backends.cudnn.allow_tf32 = False
    model = _rn(depth, torch.float32, **({"cifar_stem": True} if depth == 18 else {}))
    size = 32 if depth == 18 else 64
    x = torch.rand((4, size, size, 3), generator=gen, device="cuda")
    cpu = copy.deepcopy(model).cpu()
    before = conv_epilogue.launches
    with torch.inference_mode():
        logits, taps = model(x)
    assert conv_epilogue.launches == before + launches
    with torch.no_grad():
        want_logits, want_taps = cpu(x.cpu())
    torch.testing.assert_close(logits.cpu(), want_logits, rtol=1e-4, atol=1e-4 * float(want_logits.abs().max()))
    torch.testing.assert_close(taps["pre_pool"].cpu(), want_taps["pre_pool"], rtol=1e-4,
                               atol=1e-4 * float(want_taps["pre_pool"].abs().max()))
    before = conv_epilogue.launches
    model(x.clone().requires_grad_(True))[0].sum().backward()
    model.train()
    with torch.no_grad():
        model(x)
    assert conv_epilogue.launches == before


def test_a_resnet50_graph_replay_equals_the_eager_call_and_keeps_its_weights(gen):
    """A bf16 ResNet-50 forward captured (its warm-up prepares the
    parameters): a replay equals the eager call, 49 launches a replay; after
    an in-place edit of a conv weight an eager call reads the new weights
    and the replay still the copy it was captured with."""
    from runia_core_tpu_torch.models import build_tapped_forward
    from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue

    model = _rn(50, torch.bfloat16)
    forward = build_tapped_forward(model, ("pre_pool",))

    def fn(images):
        logits, taps = forward(images)
        return logits, taps["pre_pool"]

    x = torch.rand((16, 224, 224, 3), generator=gen, device="cuda")
    graph = CudaGraph(fn, {"images": x})
    graph.load(images=x)
    before = conv_epilogue.launches
    with no_host_sync():
        replayed = [t.clone() for t in graph.replay()]
    assert conv_epilogue.launches == before + 49
    eager = fn(x)
    for got, want in zip(replayed, eager):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.float().abs().max()))
    with torch.no_grad():
        model.stage4_block2.Conv_2.weight.mul_(-1.0)
    edited = fn(x)
    assert not torch.equal(edited[1], eager[1])
    for got, want in zip(graph.replay(), eager):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.float().abs().max()))


def test_taps_of_a_conv_and_a_norm_equal_the_modules_path(gen):
    """``tap_torch_model`` hooks on a conv and a norm of a ResNet-50: on an
    inference-mode call (the epilogue's) they equal the same taps of a call
    that records a gradient (the modules' path), and the two hooked blocks
    decline the epilogue (49 - 6 launches)."""
    from runia_core_tpu_torch.extraction import tap_torch_model
    from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue

    torch.backends.cudnn.allow_tf32 = False
    model = _rn(50, torch.float32)
    names = ("stage4_block2.Conv_2", "stage1_block0.BatchNorm_1")
    tapped = tap_torch_model(model, names, device="cuda")
    x = torch.rand((4, 64, 64, 3), generator=gen, device="cuda")
    before = conv_epilogue.launches
    (logits, _), taps = tapped(x)
    assert conv_epilogue.launches == before + 49 - 6
    kept = {}
    handles = [model.get_submodule(n).register_forward_hook(lambda m, a, out, n=n: kept.__setitem__(n, out.detach()))
               for n in names]
    try:
        with torch.enable_grad():
            want_logits = model(x.clone().requires_grad_(True))[0].detach()
    finally:
        for h in handles:
            h.remove()
    for n in names:
        torch.testing.assert_close(taps[n], kept[n], rtol=1e-4, atol=1e-4 * float(kept[n].abs().max()))
    torch.testing.assert_close(logits, want_logits, rtol=1e-4, atol=1e-4 * float(want_logits.abs().max()))


def test_a_scorer_drops_its_graphs_over_weights_edited_since(gen):
    """A LaREx scorer over a ResNet-18: graphs of one batch shape, then an
    in-place edit of the weights, then a new batch shape's capture. The new
    shape's graph reads the new weights, the old shape's graph is dropped
    and captured again over them: both replays equal the eager call."""
    from runia_core_tpu_torch.inference import build_larex_scorer
    from runia_core_tpu_torch.models import build_tapped_forward

    torch.backends.cudnn.allow_tf32 = False
    model = _rn(18, torch.float32, cifar_stem=True)
    forward = build_tapped_forward(model, ("pre_pool",))
    state = {"feats_mean": torch.zeros(512, device="cuda"), "precision": torch.eye(512, device="cuda")}
    scorer = build_larex_scorer(forward, None, state, 16, 0.5, 3)
    eager = build_larex_scorer(forward, None, state, 16, 0.5, 3, use_graph=False)
    small, large = (torch.rand((n, 32, 32, 3), generator=gen, device="cuda") for n in (8, 16))
    captures = CudaGraph.captures
    with no_host_sync():
        scorer(small, torch.Generator(device="cuda").manual_seed(1))
    with torch.no_grad():
        model.stage2_block0.Conv_0.weight.mul_(-1.0)
        model.stage3_block1.BatchNorm_1.running_var.mul_(3.0)
    for x in (large, small):
        with no_host_sync():
            got = scorer(x, torch.Generator(device="cuda").manual_seed(2))
        want = eager(x, torch.Generator(device="cuda").manual_seed(2))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6 * float(w.float().abs().max()))
    assert CudaGraph.captures == captures + 3
