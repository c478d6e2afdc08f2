"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper GPU and skip elsewhere. They import no JAX,
so on a machine without it they run with the repository's conftest left out:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda_kernels.py
"""

import contextlib

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
