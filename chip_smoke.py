#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU: LaREx image
scoring, the Llama LLM-uncertainty slice with semantic entropy on a DeBERTa
NLI judge, and the Mixtral sparse-MoE LlamaLM.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``runia_core_tpu_torch/csrc`` (into
``build/torch_kernels/``, one nvcc per source, in parallel) and holds each
kernel against its plain PyTorch version on the card. Then, through
``runia_core_tpu_torch`` alone:

* LaREx: fits and scores the full-width ``bench.py`` headline configuration:
  ResNet-18 with the CIFAR stem (64 filters, 10 classes, random weights from
  a seed), 32x32x3 images in batches of 512, a bf16 forward, 16 MC-DropBlock
  samples (p=0.5, block 3, k=5) of the (512, 4, 4, 512) ``pre_pool`` tap,
  PCA-256 fitted on 512 images, LaREM. Both routes of the scorer run:
  ``fused=False`` (kernel 1, marginal entropy) and ``fused=True`` (kernel 2,
  fused channel means + entropy).
* LLM: the repository's production Llama (``bench.py`` ``_PROD_CFG``: 22
  layers, d_model 2048, 16/8 heads of 128, SwiGLU 5632, vocab 32000; random
  weights from a seed), bf16 with ``use_flash`` and its int8 + KV8 + fused
  qkv/gate|up form, through ``TorchGenerator.generate_batch`` (8 x 1024
  prompts, and 16 x 64 prompts + 256 greedy tokens) and
  ``compute_uncertainties``; kernel 3 (``quant_matmul``) carries the int8
  projections, kernel 4 (``flash_prefix_attention``) the prefills, in its
  bf16 and KV8 variants. A 2-layer full-width f32 copy is held against the
  CPU route, and tokens/s are timed.
* NLI (``nli``): ``DebertaV2Classifier`` at the deberta-v2-xxlarge-mnli
  geometry (``bench.py`` ``_NLI_XXLARGE``: 48 layers, d 1,536, 24 heads, FFN
  6,144, vocab 128,100, 256 position buckets, conv 3; random bf16 weights
  from a seed), 16 pairs x 128 tokens through ``wrap_torch_nli``, graph
  replay against the eager forward, and a 2-layer f32 copy against the CPU.
* Semantic entropy (``llm_semantic``): ``compute_uncertainties`` with all
  six methods on the production Llama, its judge a DeBERTa at the
  deberta-v2-large geometry (``bench.py`` ``_NLI_LARGE``, 96-token pairs),
  on six prompts of 150-350 tokens, with and without semantic entropy.
* MoE (``moe_slice``): ``LlamaLM`` at the ``mistralai/Mixtral-8x7B-v0.1``
  width (d 4,096, 32/8 heads of 128, 8 experts of 14,336, top-2, vocab
  32,000, rope theta 1e6), depth cut to 2 of 32 layers (32 layers in bf16
  are 93 GB, more than the card holds), bf16 with ``use_flash`` and int8 +
  KV8 + fused qkv: a 4 x 512 prefill and a 16 x 64 + 64 greedy decode,
  graph against eager, and a 1-layer f32 copy against the CPU. Kernel 3
  carries every expert projection of the int8 decode.

Both paths run as the port runs them by default: the LaREx scorer and the
decode steps as replays of CUDA graphs (``utils/graphs.py``; the JAX
package's compiled programs), every replay under
``torch.cuda.set_sync_debug_mode("error")``, so a hidden host sync raises.
``larex_graph`` and ``llm_graph`` hold the replays against the eager routes
at full width (scores within 1e-6 relative; greedy tokens identical,
log-probs within 1e-5; sampled tokens the same from one seed), and
``throughput`` / ``llm_throughput`` time the eager and graph routes side by
side in interleaved windows (the scorer with a new generator every call),
with the kernels' share of the time (``torch.profiler``), the graphs
captured, the first call's cost, and ``compute_uncertainties`` over prompts
of mixed lengths.

Models, caches and states are built with no ``device`` argument: the port's
default is the GPU. Every kernel's line carries its bound (the least time the
card could take: bytes over 3.35 TB/s or operations over the peak rate of
their type, whichever is larger; for the two entropy kernels the operations
of one sort and one window per column, whatever the kernel does). Kernels
1-3 are timed as replays of a CUDA graph with copies of their input cycled
past the L2, so neither the host nor the cache is in the number. Where one PyTorch call computes the
same function (``scaled_dot_product_attention`` for kernel 4), that call's
time, which the port itself never uses. A kernel's launch count is what the
main paths launched (the Llama slice, semantic entropy and the MoE slice,
each counted from zero just before it runs), the kernels inside each graph
replay included.

Every phase prints one JSON line. Any failed check raises, so the script
exits non-zero and never prints its last line, which on success is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
before doing anything. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# The bench.py headline configuration (bench.py:51-63, :111-169).
BATCH = 512
IMG = 32
NUM_CLASSES = 10
NUM_FILTERS = 64
MC_SAMPLES = 16
DROP_PROB = 0.5
BLOCK_SIZE = 3
K = 5
PCA_DIMS = 256
SCORE_BATCHES = 4  # scored per scorer route in the counted main-path run
ROUTE_PAIRS = 10  # timed windows of 30 scorer calls per route and mode (eager, graph)
XCHECK_IMAGES = 8
SEED = 0

# Kernel 1 selects the same f32 differences as the sorted-window plain
# version; only the order of the final sum of n logs differs (the kernel's
# is compensated, so the bound does not grow with n).
ENTROPY_ATOL = 1e-5
# Kernel 2 sums each (S, HW) @ (HW, C) product in another order than bmm:
# the bound of tests/test_mc_entropy_fused.py for the TPU kernel.
FUSED_RTOL, FUSED_ATOL = 1e-4, 1e-5
# The production Llama (bench.py:245-246 _PROD_CFG).
LLM_CFG = dict(vocab_size=32000, num_layers=22, num_heads=16, num_kv_heads=8, d_model=2048,
               hidden_dim=5632, max_len=2048)
PREFILL_BATCH, PREFILL_LEN, PREFILL_NEW = 8, 1024, 16
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 16, 64, 256  # bench.py:316
UQ_PROMPT, UQ_SAMPLES, UQ_NEW = 256, 5, 32
UQ_MIXED_LENGTHS = (150, 200, 230, 256, 300, 350)  # 4 prompt buckets of 64
XCHECK_LAYERS, XCHECK_PROMPT, XCHECK_STEPS = 2, 256, 8
PROFILE_STEPS = 16  # greedy tokens of the profiled decode window (device-busy share)
GRAPH_REL = 1e-6  # scorer replay against eager, relative per score
GRAPH_LOGPROB_ATOL = 1e-5  # decode replay against eager
# Kernel 3 against its plain version, relative to max|ref|: the sums run in
# f32 in other orders, then round once (one bf16 ulp, the JAX bound of
# tests/test_quant_matmul.py:33-35).
QMM_BOUND = {torch.bfloat16: 8e-3, torch.float32: 1e-5}
# Kernel 4 against its plain version: f32 atol = rtol = 2e-5 (the JAX bound,
# tests/test_flash_prefill.py:43-44). bf16, per element: the kernel rounds
# each probability p_j (p_j v_scale_j in KV8) to bf16 before P.V, at most
# 2^-8 relative, which moves an output by a sum of independent roundings of
# standard deviation 2^-8 / sqrt(3) * s, s = sqrt(sum_j p_j^2 v_j^2) from the
# f32 probabilities; the two outputs then round to bf16 at most one ulp
# apart (2^-7 |want|). Bound: 2^-7 |want| + 2^-6 s (about 7 standard
# deviations, and the worst case for a window of up to 16 keys).
FLASH_F32_TOL = 2e-5
FLASH_BF16_RTOL, FLASH_BF16_ATOL_OF_S = 2.0**-7, 2.0**-6
# LLM card route against CPU route, f32, TF32 off, relative to max|logits|:
# the same f32 arithmetic summed in other orders over K = 2048..32000
# (about 1e-6 relative per layer) -> 1e-4; with KV8 an ulp-level difference
# can flip round(x / scale) to the neighbouring int8 step, moving that cached
# value by max|x| / 127 (seen at 2e-4 relative on the CPU tests' small
# model) -> 5e-3.
LLM_XCHECK_REL = {"f32": 1e-4, "int8_kv8": 5e-3}
# microsoft/deberta-v2-xxlarge-mnli's geometry (bench.py:979-982), and the
# deberta-v2-large one the serving leg judges with (bench.py:983-986).
NLI_XXLARGE = dict(vocab_size=128100, num_labels=3, num_layers=48, num_heads=24, d_model=1536,
                   intermediate_size=6144, max_position_embeddings=512, position_buckets=256, conv_kernel_size=3)
NLI_LARGE = dict(NLI_XXLARGE, num_layers=24, num_heads=16, d_model=1024, intermediate_size=4096)
NLI_PAIRS, NLI_LEN, NLI_CALLS = 16, 128, 10  # bench.py:1012-1045; NLI_CALLS calls a timed window
NLI_IDS = 62  # ids each side: [CLS] 62 [SEP] 62 [SEP] fills the 128 bucket but one slot
NLI_XCHECK_LAYERS = 2
# Card against CPU, f32, TF32 off, relative to max|logits|: the same f32
# arithmetic summed in other orders over K = 1,536..6,144 (about 1e-6
# relative a layer, two layers and a pooler).
NLI_XCHECK_REL = 1e-4
# mistralai/Mixtral-8x7B-v0.1 config.json; depth cut from 32 layers to 2.
MOE_CFG = dict(vocab_size=32000, num_layers=2, num_heads=32, num_kv_heads=8, d_model=4096, hidden_dim=14336,
               max_len=32768, rope_theta=1e6, rms_eps=1e-5, num_experts=8, num_experts_per_tok=2)
MOE_PREFILL_BATCH, MOE_PREFILL_LEN, MOE_PREFILL_NEW = 4, 512, 8
MOE_DECODE_BATCH, MOE_DECODE_PROMPT, MOE_DECODE_NEW = 16, 64, 64
MOE_XCHECK_LAYERS, MOE_XCHECK_PROMPT, MOE_XCHECK_STEPS = 1, 128, 4
# Speculative decoding on the production Llama (bench.py:767-871): gamma 4,
# 32 new tokens after a 32-token prompt from RandomState(2), then a 256-token
# prompt (kernel 4 in the target's prefill), 5 sampled continuations, and
# compute_uncertainties through the speculative backend. Drafts: the int8
# self-draft (bench.py:747-764) and the distilled pair (bench.py:810-871: the
# target's o / down of blocks 4-21 scaled by 0.03, the draft its first 4
# blocks, norm_f and lm_head, the same tensors).
SPEC_GAMMA, SPEC_NEW, SPEC_PROMPT, SPEC_LONG_PROMPT, SPEC_SAMPLES = 4, 32, 32, 256, 5
SPEC_DRAFT_LAYERS, SPEC_EPS = 4, 0.03
SPEC_WINDOWS, SPEC_CALLS = 4, 3  # timed windows per route (in turns) of SPEC_CALLS calls each
SPEC_XCHECK_LAYERS = 2
SPEC_REQUESTS = [  # every method but eigen_score, which the fused loop cannot serve
    {"method_name": "perplexity"}, {"method_name": "generation_entropy"}, {"method_name": "normalized_entropy"},
    {"method_name": "RAUQ", "token_aggregation": "mean_all_tokens", "head_aggregation": "rollout"},
    {"method_name": "RAUQ", "token_aggregation": "original", "head_aggregation": "original"},
    {"method_name": "semantic_entropy"},
]
# openai-community/gpt2 (transformers.GPT2Config() defaults) and
# EleutherAI/pythia-1.4b (its config.json), random weights from a seed, f32
# (the JAX CausalLM and NeoXLM compute in f32 only).
GPT2_HF = dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12, n_head=12, layer_norm_epsilon=1e-5,
               activation_function="gelu_new")
PYTHIA_HF = dict(vocab_size=50304, hidden_size=2048, num_hidden_layers=24, num_attention_heads=16,
                 intermediate_size=8192, rotary_pct=0.25, rotary_emb_base=10000, max_position_embeddings=2048,
                 layer_norm_eps=1e-5, use_parallel_residual=True, hidden_act="gelu")
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW = 16, 64, 64
FAMILY_HF_SHAPE = (2, 64)  # tokens of the HF-against-port logits check
FAMILY_XCHECK_LAYERS, FAMILY_XCHECK_STEPS = 2, 4
# HF against the port on the card, f32, TF32 off: the JAX tests' bounds
# (tests/test_torch_convert.py's GPT-2 and tests/test_neox.py).
FAMILY_HF_TOL = {"gpt2": (2e-4, 2e-5), "neox": (1e-3, 1e-4)}  # (rtol, atol)
H100_HBM_BYTES_PER_S = 3.35e12
# Peak rates of one H100 SXM (NVIDIA's data sheet, dense): bf16 tensor cores,
# and f32 outside them, where an FMA counts as two operations. Single
# operations (min, max, subtract) are counted against the same 67e12, which
# keeps the bound below what the card could do.
H100_BF16_OPS_PER_S = 989e12
H100_F32_OPS_PER_S = 67e12


def roofline(bytes_moved: float, operations: float, ops_per_s: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at their peak
    rate, whichever is larger."""
    by_bytes = bytes_moved / H100_HBM_BYTES_PER_S * 1e3
    by_ops = operations / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": bytes_moved, "operations": operations}


def with_share(bound: dict, ms: float) -> dict:
    return {**bound, "share_of_bound": bound["bound_ms"] / ms}

# Card (cuDNN, TF32 off) against CPU, both f32, same weights and keep-weights.
# The conv sums run in other orders (about 1e-6 relative per layer over 18
# layers); each entropy is a mean of logs of distances between channel means
# and carries their relative error; PCA whitening divides by the smallest of
# 256 explained variances. Relative to max(|score|, 1).
XCHECK_RTOL = 2e-3


KERNEL_CATEGORIES = (  # first match wins, on the kernel's name
    ("quant_matmul (kernel 3)", ("quant_matmul_kernel",)),
    ("flash_prefix_attention (kernel 4)", ("flash_mma_kernel", "flash_kernel")),
    ("library GEMM", ("gemm", "cutlass", "cublas", "gemv", "sm90_xmma", "sm80_xmma", "nvjet")),
    ("softmax", ("softmax",)),
    ("cat / copy / cast", ("CatArray", "copy", "Memcpy", "Memset", "index", "gather", "scatter")),
    ("reductions", ("reduce", "argmax", "sort")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_category(name: str) -> str:
    """A profiled kernel's category (``KERNEL_CATEGORIES``), or "other"."""
    for label, needles in KERNEL_CATEGORIES:
        if any(needle in name for needle in needles):
            return label
    return "other"


def nli_category(name: str) -> str:
    """``kernel_category`` with the judge's c2p / p2c gathers, LayerNorms
    and conv apart."""
    for label, needle in (("gather (c2p, p2c)", "gather"), ("layer norm", "layer_norm"), ("conv", "conv")):
        if needle in name:
            return label
    return kernel_category(name)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


@contextlib.contextmanager
def no_host_sync():
    """Every synchronising call raises inside the block but for the port's
    own copies of results to the host (``utils.graphs.host_sync``)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False); nothing was run")
    # f32 numbers below are true f32: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({
        "phase": "device", "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "capability": list(torch.cuda.get_device_capability(0)), "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                       "cudnn": torch.backends.cudnn.allow_tf32},
        "cudnn_benchmark": True,
    })
    return smi


def build_phase() -> None:
    from runia_core_tpu_torch import _kernels

    start = time.perf_counter()
    path = _kernels.build()
    _kernels.library()
    seconds = time.perf_counter() - start
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("ptxas:", line.strip())
    emit({"phase": "build", "seconds": round(seconds, 3), "library": str(path.relative_to(REPO))})


def timed_pair(kernel_fn, plain_fn, iters: int = 30):
    """(kernel ms, plain ms) as replays of a CUDA graph of ``iters`` calls
    (the kernels are shorter than the host takes to enqueue them), timed in
    turns plain, kernel, kernel, plain."""
    from runia_core_tpu_torch.utils import cuda_graph_time_ms

    p1 = cuda_graph_time_ms(plain_fn, iters)
    k1 = cuda_graph_time_ms(kernel_fn, iters)
    k2 = cuda_graph_time_ms(kernel_fn, iters)
    p2 = cuda_graph_time_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


COLD_BYTES = 96 * 2**20  # copies of an input that together pass the 50 MB L2 about twice


def cold_copies(tensors: tuple, read_bytes: int) -> list:
    """``tensors`` and at least three copies of them, as many as together
    hold COLD_BYTES: used in turns, every call reads its input from device
    memory, not from the L2 an earlier call left it in."""
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(max(3, -(-COLD_BYTES // read_bytes) - 1))]


def timed_cold(kernel_fn, plain_fn, copies: list) -> dict:
    """Device ms of ``kernel_fn(*inputs)`` as replays of a CUDA graph of
    calls, cold (the copies in turns) and L2-warm (one copy), and of
    ``plain_fn(*inputs)`` by events over the copies in turns (it is many
    calls and far longer than its enqueue). In turns plain, kernel, kernel,
    plain."""
    from runia_core_tpu_torch.utils import cuda_graph_time_ms, cuda_time_ms

    turns = itertools.cycle(copies)
    calls = len(copies) * max(1, 24 // len(copies))
    p1 = cuda_time_ms(lambda: plain_fn(*next(turns)), 10)
    k1 = cuda_graph_time_ms(lambda: kernel_fn(*next(turns)), calls)
    warm = cuda_graph_time_ms(lambda: kernel_fn(*copies[0]), calls)
    k2 = cuda_graph_time_ms(lambda: kernel_fn(*next(turns)), calls)
    p2 = cuda_time_ms(lambda: plain_fn(*next(turns)), 10)
    return {"ms": (k1 + k2) / 2, "ms_l2_warm": warm, "plain_ms": (p1 + p2) / 2}


def kl_entropy_operations(n: int, k: int) -> int:
    """f32 operations the k-NN entropy of one cloud of n scalars needs,
    whatever a kernel does: one sort (the compare-exchanges of Batcher's
    odd-even merge network on the next power of two, a min and a max each),
    per point the k + 1 windows that hold it (two subtractions, a max and a
    min each), and max, multiply, log and the four operations of the
    compensated sum."""
    t = max(1, (n - 1).bit_length())  # network on 2^t wires: (t^2 - t + 4) 2^(t-2) - 1 comparators
    comparators = (t * t - t + 4) * 2**t // 4 - 1
    return 2 * comparators + 4 * (k + 1) * n + 7 * n


def entropy_phase(device, gen) -> dict:
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda, marginal_entropy_plain

    cases = {
        "headline": (torch.randn((BATCH, MC_SAMPLES, 512), generator=gen, device=device), K),
        "ties": (torch.randint(-3, 4, (64, MC_SAMPLES, 256), generator=gen, device=device).float(), K),
        "n4_k3": (torch.randn((256, 4, 300), generator=gen, device=device), 3),
        "ragged_d": (torch.randn((64, MC_SAMPLES, 300), generator=gen, device=device), K),
        "b1": (torch.randn((1, MC_SAMPLES, 512), generator=gen, device=device), K),
        # 100 MC samples: past the 64 values sorted in registers at a time,
        # so chunks are merged in shared memory.
        "n100": (torch.randn((64, 100, 512), generator=gen, device=device), K),
        # k taken at run time (any k but 5), in registers' reach and past it
        "n16_k3": (torch.randn((64, MC_SAMPLES, 300), generator=gen, device=device), 3),
        "n100_k99": (torch.randn((16, 100, 130), generator=gen, device=device), 99),
    }
    errors = {}
    for name, (clouds, k) in cases.items():
        got = marginal_entropy_cuda(clouds, k)
        again = marginal_entropy_cuda(clouds, k)
        want = marginal_entropy_plain(clouds, k)
        torch.cuda.synchronize()
        require(got.shape == want.shape and bool(torch.isfinite(got).all()), f"entropy {name}: finite, shape")
        require(torch.equal(got, again), f"entropy {name}: two runs on the same inputs are bit-identical")
        errors[name] = float((got - want).abs().max())
        require(errors[name] <= ENTROPY_ATOL, f"entropy {name}: max abs err {errors[name]} > {ENTROPY_ATOL}")
    del cases
    # Timed: the scorer's 16 samples, the upstream extractors' 32 and 64, and
    # the longest column the kernel takes.
    timing = {}
    for name, (b, n, d) in {"headline": (BATCH, MC_SAMPLES, 512), "n32": (BATCH, 32, 512),
                            "n64": (BATCH, 64, 512), "n512": (64, 512, 512)}.items():
        clouds = torch.randn((b, n, d), generator=gen, device=device)
        copies = cold_copies((clouds,), clouds.numel() * 4)
        times = timed_cold(lambda x: marginal_entropy_cuda(x, K), lambda x: marginal_entropy_plain(x, K), copies)
        bound = roofline(4 * (clouds.numel() + b * d), b * d * kl_entropy_operations(n, K), H100_F32_OPS_PER_S)
        timing[name] = {"shape": [b, n, d], "k": K, "copies": len(copies), **times,
                        "read_GBps": clouds.numel() * 4 / (times["ms"] * 1e-3) / 1e9,
                        **with_share(bound, times["ms"])}
        require(timing[name]["share_of_bound"] <= 1.0, f"entropy {name}: faster than its bound: {timing[name]}")
        require(times["ms"] < times["plain_ms"], f"entropy {name}: the kernel is faster than plain: {times}")
        del copies, clouds
    top = timing["headline"]
    emit({
        "phase": "kernel_marginal_entropy", "max_abs_err": errors, "bound": ENTROPY_ATOL, "timing": timing,
        "timed_with": "CUDA-graph replays, inputs cold (copies cycled past the L2); ms_l2_warm: one input",
        "bound_counts": "one sort (Batcher network) and one window per column, whatever the kernel does",
        "library_ms": None, "library": "none: the sort-based form is several calls",
    })
    return {"max_abs_err": max(errors.values()), "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"], "library_ms": None}


def fused_phase(device, gen) -> dict:
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda
    from runia_core_tpu_torch.ops.mc_entropy_cuda import (
        fused_mc_entropy, fused_mc_entropy_plain, mc_dropblock_weights,
    )
    from runia_core_tpu_torch.utils import cuda_graph_time_ms

    bf16, f32 = torch.bfloat16, torch.float32
    errors = {}
    cases = {  # (B, H, W, C, S, map dtype)
        "headline": (BATCH, 4, 4, 512, MC_SAMPLES, f32), "rn50_224": (8, 7, 7, 2048, MC_SAMPLES, f32),
        # the tap as a bf16 forward leaves it; 64 and 100 samples (registers' reach and past it).
        # Many samples are held to this bound at the 4 x 4 tap only, where the kernel and bmm sum
        # alike. The entropy magnifies the products' f32 rounding (near-tied samples): on 7 x 7
        # positions, where bmm sums in another order, 100 samples differ by 3e-4, and both are 8e-4
        # from samples formed in f64 (bench_torch_kernels.py, err_vs_f64_products).
        "headline_bf16": (BATCH, 4, 4, 512, MC_SAMPLES, bf16), "s64": (64, 4, 4, 512, 64, f32),
        "s100_bf16": (16, 4, 4, 300, 100, bf16),
    }
    for name, (b, h, w, c, s_, dtype) in cases.items():
        fmap = torch.rand((b, h, w, c), generator=gen, device=device).to(dtype)
        weights = mc_dropblock_weights(b, h, w, s_, BLOCK_SIZE, DROP_PROB, gen, device)
        got = fused_mc_entropy(weights, fmap, K)
        again = fused_mc_entropy(weights, fmap, K)
        want = fused_mc_entropy_plain(weights, fmap, K)
        torch.cuda.synchronize()
        require(got.shape == (b, c) and bool(torch.isfinite(got).all()), f"fused {name}: finite, shape")
        require(torch.equal(got, again), f"fused {name}: two runs on the same inputs are bit-identical")
        errors[name] = float((got - want).abs().max())
        within = (got - want).abs() <= FUSED_ATOL + FUSED_RTOL * want.abs()
        require(bool(within.all()), f"fused {name}: max abs err {errors[name]} beyond rtol/atol")
        if dtype == bf16:  # widening in registers is exact: the f32 copy of the map gives the same bits
            require(torch.equal(got, fused_mc_entropy(weights, fmap.float(), K)),
                    f"fused {name}: the bf16 map and its f32 copy give the same result")
    timing = {}
    for name, (b, h, w, c, s_, dtype) in {
        "headline": (BATCH, 4, 4, 512, MC_SAMPLES, f32), "headline_bf16": (BATCH, 4, 4, 512, MC_SAMPLES, bf16),
        "rn50_224_b128": (128, 7, 7, 2048, MC_SAMPLES, f32), "headline_s64": (BATCH, 4, 4, 512, 64, f32),
    }.items():
        fmap = torch.rand((b, h, w, c), generator=gen, device=device).to(dtype)
        weights = mc_dropblock_weights(b, h, w, s_, BLOCK_SIZE, DROP_PROB, gen, device)
        read = fmap.numel() * fmap.element_size() + weights.numel() * 4
        copies = cold_copies((weights, fmap), read)
        times = timed_cold(lambda wt, fm: fused_mc_entropy(wt, fm, K), lambda wt, fm: fused_mc_entropy_plain(wt, fm, K),
                           copies)
        bound = roofline(read + 4 * b * c, 2 * b * s_ * h * w * c + b * c * kl_entropy_operations(s_, K),
                         H100_F32_OPS_PER_S)
        timing[name] = {"shape": [b, h, w, c], "samples": s_, "map": str(dtype).replace("torch.", ""),
                        "copies": len(copies), **times, "read_GBps": read / (times["ms"] * 1e-3) / 1e9,
                        **with_share(bound, times["ms"])}
        require(timing[name]["share_of_bound"] <= 1.0, f"fused {name}: faster than its bound: {timing[name]}")
        if name == "headline":
            # The scorer's other route on the same inputs, timed the same way.
            def two_step(wt, fm):
                return marginal_entropy_cuda(torch.bmm(wt, fm.reshape(b, h * w, c)) / (h * w), K)

            turns = itertools.cycle(copies)
            timing[name]["two_step_bmm_plus_kernel1_ms"] = cuda_graph_time_ms(
                lambda: two_step(*next(turns)), len(copies) * max(1, 24 // len(copies)))
        del copies, fmap, weights
    top = timing["headline"]
    emit({
        "phase": "kernel_fused_mc_entropy", "max_abs_err": errors,
        "bound": {"rtol": FUSED_RTOL, "atol": FUSED_ATOL}, "timing": timing,
        "timed_with": "CUDA-graph replays, inputs cold (copies cycled past the L2); ms_l2_warm: one input",
        "library_ms": None, "library": "none: bmm, a sort and a sum of logs are several calls",
    })
    return {"max_abs_err": max(errors.values()), "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"], "library_ms": None}


def build_model(dtype, cpu_copy_of=None):
    """The headline ResNet-18 with seeded random weights, built where the
    port builds by default (the GPU); or, given such a model, its copy on
    the CPU."""
    from runia_core_tpu_torch.models import ResNet18

    cfg = dict(num_classes=NUM_CLASSES, cifar_stem=True, num_filters=NUM_FILTERS, dtype=dtype)
    if cpu_copy_of is None:
        model = ResNet18(**cfg)
        model.init_weights(torch.Generator(device=model.head.weight.device).manual_seed(SEED))
    else:
        model = ResNet18(**cfg, device="cpu")
        model.load_state_dict({name: t.cpu() for name, t in cpu_copy_of.state_dict().items()})
    return model.to(memory_format=torch.channels_last).eval()


def slice_phase(device, gen) -> dict:
    from runia_core_tpu_torch.detectors import MDLatentSpace
    from runia_core_tpu_torch.inference import build_larex_scorer
    from runia_core_tpu_torch.models import build_tapped_forward
    from runia_core_tpu_torch.ops.entropy import marginal_entropy
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda
    from runia_core_tpu_torch.ops.linalg import mahalanobis_quadform
    from runia_core_tpu_torch.ops.mc_entropy_cuda import fused_mc_entropy, mc_dropblock_weights
    from runia_core_tpu_torch.reduction import apply_pca_ds_split, pca_transform
    from runia_core_tpu_torch.sampling import mc_dropblock_samples
    from runia_core_tpu_torch.utils import CudaGraph, cuda_time_ms, device_profile

    model = build_model(torch.bfloat16)
    require(model.head.weight.device == device, f"the default device is the card: {model.head.weight.device}")
    forward = build_tapped_forward(model, ("pre_pool",))

    def images(n):
        return torch.rand((n, IMG, IMG, 3), generator=gen, device=device)

    # ---- the main path, counted: fit, then both scorer routes ----
    marginal_entropy_cuda.launches = 0
    fused_mc_entropy.launches = 0
    _, taps = forward(images(BATCH))
    latent = taps["pre_pool"].to(torch.float32).contiguous()
    mc = mc_dropblock_samples(latent, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, "Conv", channel_axis=3, generator=gen)
    h_train = marginal_entropy(mc, K)
    h_pca, pca_state = apply_pca_ds_split(h_train, nro_components=PCA_DIMS)
    larem = MDLatentSpace()
    larem.setup(h_pca)
    scorers = {
        fused: build_larex_scorer(
            forward, pca_state, larem.state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE, fused=fused
        )
        for fused in (False, True)
    }
    results = {}
    for fused, scorer in scorers.items():
        for _ in range(SCORE_BATCHES):
            x = images(BATCH)
            with no_host_sync():  # the first call captures the scorer's graph, every call replays it
                logits, scores = scorer(x, generator=gen)
            torch.cuda.synchronize()
            require(tuple(scores.shape) == (BATCH,) and bool(torch.isfinite(scores).all()),
                    f"fused={fused}: finite ({BATCH},) scores")
            require(tuple(logits.shape) == (BATCH, NUM_CLASSES) and bool(torch.isfinite(logits).all()),
                    f"fused={fused}: finite logits")
        results[fused] = scores
    launches = {
        "marginal_entropy": marginal_entropy_cuda.launches,
        "fused_mc_entropy": fused_mc_entropy.launches,
    }
    require(all(n > 0 for n in launches.values()), f"every kernel launched on the main path: {launches}")
    emit({
        "phase": "slice", "batch": BATCH, "scored_batches_per_route": SCORE_BATCHES,
        "launches": launches, "h_train_shape": list(h_train.shape), "pca_dims": PCA_DIMS,
        "score_mean": {"two_step": float(results[False].mean()), "fused": float(results[True].mean())},
    })

    # ---- f32 cross-check of 8 images: card against the CPU's plain versions ----
    model32 = build_model(torch.float32)
    model_cpu = build_model(torch.float32, cpu_copy_of=model32)
    x8 = images(XCHECK_IMAGES)
    w8 = mc_dropblock_weights(XCHECK_IMAGES, 4, 4, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, gen, device)
    state_cpu = {name: t.cpu() for name, t in larem.state.items()}
    _, want = build_larex_scorer(
        build_tapped_forward(model_cpu), pca_state.to("cpu"), state_cpu, MC_SAMPLES, DROP_PROB, BLOCK_SIZE
    )(x8.cpu(), weights=w8.cpu())
    xcheck = {}
    for fused in (False, True):
        _, got = build_larex_scorer(
            build_tapped_forward(model32), pca_state, larem.state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE,
            fused=fused,
        )(x8, weights=w8)
        rel = float(((got.cpu() - want).abs() / want.abs().clamp_min(1.0)).max())
        xcheck["fused" if fused else "two_step"] = rel
        require(rel <= XCHECK_RTOL, f"card vs CPU f32 scores (fused={fused}): rel err {rel} > {XCHECK_RTOL}")
    emit({"phase": "xcheck_f32_cpu", "images": XCHECK_IMAGES, "max_rel_err": xcheck, "bound": XCHECK_RTOL})

    # ---- larex_graph: replays against the eager route, full width ----
    eager_scorers = {
        fused: build_larex_scorer(forward, pca_state, larem.state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE, fused=fused,
                                  use_graph=False)
        for fused in (False, True)
    }
    x = images(BATCH)
    w = mc_dropblock_weights(BATCH, 4, 4, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, gen, device)
    graph_record = {}
    for fused in (False, True):
        route = "fused" if fused else "two_step"
        drawn = torch.Generator(device=device)
        want_logits, want = eager_scorers[fused](x, weights=w)
        seeded = []
        for scorer in (scorers[fused], scorers[fused], eager_scorers[fused]):
            drawn.manual_seed(SEED + 9)
            with no_host_sync() if scorer is scorers[fused] else contextlib.nullcontext():
                seeded.append(scorer(x, generator=drawn)[1])
        with no_host_sync():
            got_logits, got = scorers[fused](x, weights=w)  # injected weights: another graph, weights copied in
        torch.cuda.synchronize()
        rel = float(((got - want).abs() / want.abs()).max())
        rel_logits = float((got_logits - want_logits).abs().max() / want_logits.abs().max())
        rel_seeded = float(((seeded[0] - seeded[2]).abs() / seeded[2].abs()).max())
        require(rel <= GRAPH_REL and rel_logits <= GRAPH_REL,
                f"larex_graph {route}: replay vs eager rel err {rel} (logits {rel_logits}) > {GRAPH_REL}")
        require(torch.equal(seeded[0], seeded[1]), f"larex_graph {route}: replays from one seed are identical")
        require(rel_seeded <= GRAPH_REL, f"larex_graph {route}: drawn keep-weights, replay vs eager {rel_seeded}")
        captures = CudaGraph.captures
        for seed in range(3):  # a new generator object per call: replays of the same graph
            with no_host_sync():
                fresh = scorers[fused](x, generator=torch.Generator(device=device).manual_seed(seed))[1]
            want_fresh = eager_scorers[fused](x, generator=torch.Generator(device=device).manual_seed(seed))[1]
            require(bool(((fresh - want_fresh).abs() <= GRAPH_REL * want_fresh.abs()).all()),
                    f"larex_graph {route}: a new generator per call, replay vs eager")
        require(CudaGraph.captures == captures, f"larex_graph {route}: a new generator per call captured again")
        graph_record[route] = {"max_rel_err_injected_weights": rel, "max_rel_err_logits": rel_logits,
                               "max_rel_err_drawn_from_one_seed": rel_seeded,
                               "bit_identical": bool(torch.equal(got, want)),
                               "captures_for_3_new_generators": CudaGraph.captures - captures}
    emit({"phase": "larex_graph", "batch": BATCH, "bound_rel": GRAPH_REL, "sync_debug_mode": "error",
          "routes": graph_record})

    # ---- throughput, eager against graph (CUDA events around windows of calls) ----
    # Windows of 30 calls after 5 warm-up, the four variants in an order that
    # turns by one each round, so that a drift of the shared host shows in
    # every variant alike. Every call gets a new generator, as a caller
    # seeding each batch would: the graph's key does not hold it.
    variants = [(mode, fused) for mode in ("eager", "graph") for fused in (False, True)]
    runner = {("eager", f): eager_scorers[f] for f in (False, True)} | {("graph", f): scorers[f] for f in (False, True)}
    times = {v: [] for v in variants}
    captures = CudaGraph.captures
    for pair in range(ROUTE_PAIRS):
        for v in variants[pair % 4:] + variants[: pair % 4]:
            times[v].append(cuda_time_ms(
                lambda: runner[v](x, generator=torch.Generator(device=device).manual_seed(pair)), iters=30, warmup=5))
    captures = CudaGraph.captures - captures
    # The first call of a new scorer: its warm-up calls and capture (the
    # graph route) or one eager call, host clock.
    first_call_ms = {}
    for mode, fused in variants:
        fresh = build_larex_scorer(forward, pca_state, larem.state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE, fused=fused,
                                   use_graph=mode == "graph")
        torch.cuda.synchronize()
        start = time.perf_counter()
        fresh(x, generator=gen)
        torch.cuda.synchronize()
        first_call_ms[f"{mode}_{'fused' if fused else 'two_step'}"] = (time.perf_counter() - start) * 1e3

    def label(v):
        return f"{v[0]}_{'fused' if v[1] else 'two_step'}"

    ips = {label(v): BATCH / (statistics.median(ms) * 1e-3) for v, ms in times.items()}
    busy = {label(v): device_profile(lambda: [runner[v](x, generator=gen) for _ in range(10)], 10) for v in variants}
    fused_wins = {mode: sum(f < t for f, t in zip(times[(mode, True)], times[(mode, False)]))
                  for mode in ("eager", "graph")}
    graph_wins = sum(g < e for f in (False, True) for g, e in zip(times[("graph", f)], times[("eager", f)]))
    _, taps = forward(x)
    tap = taps["pre_pool"]
    latent = tap.to(torch.float32).contiguous()
    weights = mc_dropblock_weights(BATCH, 4, 4, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, gen, device)
    mc = mc_dropblock_samples(latent, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, "Conv", channel_axis=3, weights=weights)
    h = marginal_entropy(mc, K)
    stages = {
        "forward_bf16": cuda_time_ms(lambda: forward(x)),
        "tap_to_f32": cuda_time_ms(lambda: tap.to(torch.float32).contiguous()),
        "keep_weights": cuda_time_ms(
            lambda: mc_dropblock_weights(BATCH, 4, 4, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, gen, device)
        ),
        "sampling_bmm": cuda_time_ms(
            lambda: mc_dropblock_samples(latent, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, "Conv",
                                         channel_axis=3, weights=weights)
        ),
        "entropy_kernel1": cuda_time_ms(lambda: marginal_entropy(mc, K)),
        "fused_kernel2": cuda_time_ms(lambda: fused_mc_entropy(weights, latent, K)),
        "fused_kernel2_bf16_tap": cuda_time_ms(lambda: fused_mc_entropy(weights, tap.contiguous(), K)),
        "pca_md": cuda_time_ms(
            lambda: mahalanobis_quadform(pca_transform(pca_state, h), larem.feats_mean, larem.precision)
        ),
    }
    emit({"phase": "throughput", "batch": BATCH, "img_per_s_median": ips,
          "scorer_ms": {label(v): ms for v, ms in times.items()},
          "fused_faster_in_pairs": {mode: f"{n}/{ROUTE_PAIRS}" for mode, n in fused_wins.items()},
          "graph_faster_in_pairs": f"{graph_wins}/{2 * ROUTE_PAIRS}",
          "generator": "a new one per call", "captures_in_timed_windows": captures,
          "calls_in_timed_windows": ROUTE_PAIRS * 2 * 35, "first_call_ms": first_call_ms,
          "device_busy": {k: {"share": r["device_busy_share"], "device_ms_per_call": r["device_busy_ms_per_unit"],
                              "wall_ms_per_call_profiled": r["wall_ms_per_unit"],
                              "kernels_per_call": r["kernels_per_unit"], "device_time_seen": r["device_time_seen"]}
                          for k, r in busy.items()},
          "stage_ms": stages})
    return launches


def quant_matmul_bound(rows: int, k: int, n: int, dtype) -> dict:
    """Bytes: the int8 weights, x, the scales and the output, once each.
    Operations: 2 rows K N, on the bf16 tensor cores (f32 x: on the f32 units)."""
    item = 2 if dtype == torch.bfloat16 else 4
    peak = H100_BF16_OPS_PER_S if dtype == torch.bfloat16 else H100_F32_OPS_PER_S
    return roofline(k * n + rows * k * item + 4 * n + rows * n * item, 2 * rows * k * n, peak)


def quant_matmul_phase(device, gen) -> dict:
    from runia_core_tpu_torch.ops.quant_matmul import plan_split_k, quant_matmul, quant_matmul_plain
    from runia_core_tpu_torch.utils import cuda_graph_time_ms

    d, h, g, hd = LLM_CFG["d_model"], LLM_CFG["hidden_dim"], LLM_CFG["num_kv_heads"], LLM_CFG["d_model"] // LLM_CFG["num_heads"]
    md, mh, mg = MOE_CFG["d_model"], MOE_CFG["hidden_dim"], MOE_CFG["num_kv_heads"]
    mhd = md // MOE_CFG["num_heads"]
    decode_names = ("qkv", "gate_up", "o", "down")
    shapes = {  # the int8 model's projections at decode, rows = batch 16
        "qkv": (16, d, d + 2 * g * hd), "gate_up": (16, d, 2 * h), "o": (16, d, d),
        "down": (16, h, d), "lm_head": (16, d, LLM_CFG["vocab_size"]),
        "rows1_qkv": (1, d, d + 2 * g * hd), "rows13_o": (13, d, d), "rows512_o": (512, d, d),
        "rows1024_o": (1024, d, d), "f32_qkv": (16, d, d + 2 * g * hd),
        # rows past one, two and many m16 tiles at down's K; K and N ragged
        # against every tile and split; N that is no multiple of 16; a weight
        # whose first byte is not 16-byte aligned
        "rows17_down": (17, h, d), "rows100_down": (100, h, d), "rows1024_down": (1024, h, d),
        "ragged_k1000_n1000": (16, 1000, 1000), "f32_ragged_k1000_n1000": (33, 1000, 1000),
        "n2050": (16, d, 2050), "misaligned_wq": (16, d, d),
        # the int8 Mixtral's products at the MoE main path's shapes: a decode
        # step of 16 rows (fused qkv, o, one expert's w_gate / w_up and
        # w_down, lm_head) and of 4 rows (the 4 x 512 prompts' steps, whose
        # prefill ends in a 4-row lm_head), the 16 x 64 prompts' prefill
        # (1,024 rows)
        **{f"moe_{name}": (rows, k, n) for rows, tag in ((16, ""), (4, "rows4_"), (1024, "rows1024_"))
           for name, (k, n) in ((f"{tag}qkv", (md, md + 2 * mg * mhd)), (f"{tag}o", (md, md)),
                                (f"{tag}gate_up", (md, mh)), (f"{tag}down", (mh, md)))},
        "moe_lm_head": (16, md, MOE_CFG["vocab_size"]), "moe_rows4_lm_head": (4, md, MOE_CFG["vocab_size"]),
        # the int8 self-draft of the speculative path (unfused q, k / v, o,
        # gate / up, down, lm_head) at its decode rows: 1 (generate) and 5
        # (generate_samples); and its prefill of one prompt row at 32 and 256
        # tokens (the 256-token prompt and the uncertainty prompt), whose
        # lm_head takes the last row only
        **{f"spec_rows{rows}_{name}": (rows, k, n) for rows in (1, SPEC_SAMPLES, SPEC_PROMPT, SPEC_LONG_PROMPT)
           for name, (k, n) in (("q", (d, d)), ("kv", (d, g * hd)), ("o", (d, d)), ("gate_up", (d, h)),
                                ("down", (h, d)), ("lm_head", (d, LLM_CFG["vocab_size"])))
           if rows < SPEC_PROMPT or name != "lm_head"},
    }
    errors, abs_errors, timings = {}, {}, {}
    for name, (rows, k, n) in shapes.items():
        dtype = torch.float32 if name.startswith("f32") else torch.bfloat16
        x = torch.randn((rows, k), generator=gen, device=device).to(dtype)
        if name == "misaligned_wq":
            flat = torch.randint(-127, 128, (k * n + 1,), generator=gen, device=device, dtype=torch.int8)
            wq = flat[1:].view(k, n)
            require(wq.data_ptr() % 16 != 0 and wq.is_contiguous(), "misaligned_wq: the view is misaligned")
        else:
            wq = torch.randint(-127, 128, (k, n), generator=gen, device=device, dtype=torch.int8)
        scale = torch.rand((n,), generator=gen, device=device) * 1e-2 + 1e-3
        got = quant_matmul(x, wq, scale)
        again = quant_matmul(x, wq, scale)
        want = quant_matmul_plain(x, wq, scale).float()
        torch.cuda.synchronize()
        require(got.dtype == dtype and got.shape == (rows, n) and bool(torch.isfinite(got).all()),
                f"quant_matmul {name}: finite, shape, dtype")
        require(torch.equal(got, again), f"quant_matmul {name}: two runs on the same inputs are bit-identical")
        abs_errors[name] = float((got.float() - want).abs().max())
        errors[name] = abs_errors[name] / float(want.abs().max())
        require(errors[name] <= QMM_BOUND[dtype], f"quant_matmul {name}: rel err {errors[name]} > {QMM_BOUND[dtype]}")
        if name in decode_names or name == "lm_head" or name.startswith(("rows", "moe", "spec")):
            # Copies that together exceed the 50 MB L2, used in turns: every
            # call reads its weights from device memory, as a decode step does.
            copies = [(x, wq, scale)] + [(x, wq.clone(), scale) for _ in range(max(0, -(-64 * 2**20 // (k * n)) - 1))]
            turns = itertools.cycle(copies)
            ms, plain_ms = timed_pair(lambda: quant_matmul(*next(turns)), lambda: quant_matmul_plain(*next(turns)))
            plan = plan_split_k(rows, k, n)
            timings[name] = {"ms": ms, "plain_ms": plain_ms, "int8_GBps": k * n / (ms * 1e-3) / 1e9,
                             "grid": [plan.n_tiles, plan.splits, plan.row_blocks],
                             **with_share(quant_matmul_bound(rows, k, n, dtype), ms)}
            require(ms <= plain_ms, f"quant_matmul {name}: the kernel ({ms} ms) is no slower than plain ({plain_ms} ms)")
            if name in decode_names or name == "lm_head" or name.startswith(("moe", "spec")):
                # A different function, as a reference point only: cuBLAS on
                # the dequantized bf16 weight, twice the bytes.
                dense = [(x, copies[i % len(copies)][1].to(torch.bfloat16))
                         for i in range(-(-64 * 2**20 // (2 * k * n)))]
                dense_turns = itertools.cycle(dense)
                timings[name]["bf16_matmul_ms"] = cuda_graph_time_ms(lambda: torch.matmul(*next(dense_turns)), 30)
                timings[name]["int8pack_mm_ms"] = int8pack_mm_ms(x, wq, scale)
                del dense
            del copies
    decode = [timings[n] for n in decode_names]
    emit({"phase": "kernel_quant_matmul", "rel_err": errors, "max_abs_err": abs_errors,
          "bound_rel_err": {"bf16": QMM_BOUND[torch.bfloat16],
          "f32": QMM_BOUND[torch.float32]}, "shapes": {n: list(v) for n, v in shapes.items()}, "timing": timings,
          "timed_with": "CUDA-graph replays of 30 calls, weights cold (copies cycled past the L2)",
          "deterministic": True, "library_ms": None,
          "library": "none: no single PyTorch call takes a (K, N) int8 weight with per-column f32 scales; "
                     "bf16_matmul_ms (x @ w_bf16, cuBLAS, twice the bytes) and int8pack_mm_ms "
                     "(torch._weight_int8pack_mm on the transposed weight, bf16 scales) are other functions",
          "hbm_peak_GBps": H100_HBM_BYTES_PER_S / 1e9})
    bound_ms = sum(t["bound_ms"] for t in decode)
    return {"max_abs_err": max(abs_errors.values()), "ms": sum(t["ms"] for t in decode),
            "plain_ms": sum(t["plain_ms"] for t in decode), "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None}


def int8pack_mm_ms(x, wq, scale):
    """Time ``torch._weight_int8pack_mm`` on the transposed weight where this
    build has it for CUDA tensors; else say why not. It takes (N, K) int8 and
    bf16 scales: another layout and rounding than the port's contract, so it
    is a reference point and never called by the port."""
    from runia_core_tpu_torch.utils import cuda_graph_time_ms

    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return "not in this build"
    wt, sc = wq.t().contiguous(), scale.to(torch.bfloat16)
    try:
        fn(x, wt, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        return f"does not take these CUDA tensors: {str(exc).splitlines()[0][:120]}"
    return cuda_graph_time_ms(lambda: fn(x, wt, sc), 30)


def _window_pairs(q_start, kv_start, tq, kk) -> int:
    """Query-key pairs inside the windows kv_start <= j <= q_start + i < K."""
    total = 0
    for qs, kvs in zip(q_start, kv_start):
        for i in range(tq):
            total += max(0, min(kk - 1, qs + i) - kvs + 1)
    return total


def _keys_read(q_start, kv_start, tq, kk) -> int:
    """Keys some query of its batch row attends, summed over the rows."""
    return sum(max(0, min(kk - 1, qs + tq - 1) - kvs + 1) for qs, kvs in zip(q_start, kv_start))


def rounding_spread(q, k, v, q_start, kv_start, k_scale, v_scale):
    """sqrt(sum_j p_j^2 v_j^2) per output element of the (B, Hq, Tq, D)
    attention, from its f32 probabilities (v_j * v_scale_j in KV8)."""
    b, hq, tq, d = q.shape
    g, kk = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf, vf = kf * k_scale.permute(0, 2, 1)[..., None], vf * v_scale.permute(0, 2, 1)[..., None]
    logits = torch.einsum("bgrtd,bgkd->bgrtk", q.float().reshape(b, g, hq // g, tq, d), kf) / d**0.5
    rows = q_start.long()[:, None, None] + torch.arange(tq, device=q.device)[:, None]
    starts = torch.zeros_like(q_start) if kv_start is None else kv_start
    keys = torch.arange(kk, device=q.device)
    mask = (keys <= rows) & (keys >= starts.long()[:, None, None])  # (B, Tq, K)
    probs = torch.softmax(logits.masked_fill(~mask[:, None, None], float("-inf")), dim=-1).nan_to_num(0.0)
    return torch.einsum("bgrtk,bgkd->bgrtd", probs.square(), vf.square()).sqrt().reshape(b, hq, tq, d)


def _offset_view(t: torch.Tensor) -> torch.Tensor:
    """A copy of t that starts one element into its buffer: the same values
    at an address that is not 16-byte aligned."""
    flat = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def sdpa_library(q, k, v, q_start, kk_used, mask=None):
    """One PyTorch call for the same function: causal (or boolean-masked)
    ``scaled_dot_product_attention`` with GQA. Timed beside kernel 4 as a
    yardstick; the port never calls it."""
    import torch.nn.functional as F

    k, v = k[:, :, :kk_used], v[:, :, :kk_used]
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        extra = {"enable_gqa": True}
    else:  # an older build: the kv heads are repeated outside the timed call
        rep = q.shape[1] // k.shape[1]
        k, v, extra = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1), {}
    if mask is None:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, **extra)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, **extra)


def flash_phase(device, gen) -> dict:
    from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention, reference_prefix_attention
    from runia_core_tpu_torch.utils import cuda_graph_time_ms, cuda_time_ms

    hq, g, hd = LLM_CFG["num_heads"], LLM_CFG["num_kv_heads"], LLM_CFG["d_model"] // LLM_CFG["num_heads"]
    bf16, f32 = torch.bfloat16, torch.float32
    pb, pl = PREFILL_BATCH, PREFILL_LEN
    mb, mt, mhq, mg = MOE_PREFILL_BATCH, MOE_PREFILL_LEN, MOE_CFG["num_heads"], MOE_CFG["num_kv_heads"]
    mhd = MOE_CFG["d_model"] // mhq
    cases = {  # (B, Hq, G, Tq, K, D, q_start, kv_start, dtype, kv8[, layout])
        "prefill": (pb, hq, g, pl, pl + 256, hd, [0] * pb, None, bf16, False),
        "chunked": (2, hq, g, 256, 2048, hd, [0, 700], None, bf16, False),
        "left_pad": (3, hq, g, 96, 160, hd, [0, 0, 40], [0, 70, 10], bf16, False),
        "kv8_prefill": (pb, hq, g, pl, pl + 256, hd, [0] * pb, None, bf16, True),
        "tq200": (2, hq, g, 200, 333, hd, [0, 100], None, bf16, False),
        "f32": (2, hq, g, 130, 300, hd, [0, 150], [0, 3], f32, False),
        # the prefill shapes in f32, held to the JAX bound
        "f32_prefill": (pb, hq, g, pl, pl + 256, hd, [0] * pb, None, f32, False),
        "f32_kv8_prefill": (pb, hq, g, pl, pl + 256, hd, [0] * pb, None, f32, True),
        # heads of 64; the (B, K, G, D) cache passed transposed, NaN past its
        # prefix; one query row past a 64-row tile; views that start one
        # element into their buffers (no 16-byte alignment)
        "d64": (2, 8, 4, 300, 500, 64, [0, 150], [0, 20], bf16, False),
        "d64_kv8": (2, 8, 4, 300, 500, 64, [0, 150], [0, 20], bf16, True),
        "transposed_cache": (2, hq, g, 192, 512, hd, [0, 200], None, bf16, False, "transposed"),
        "transposed_cache_kv8": (2, hq, g, 192, 512, hd, [0, 200], None, bf16, True, "transposed"),
        "tq65": (2, hq, g, 65, 129, hd, [0, 64], None, bf16, False),
        "misaligned": (2, hq, g, 130, 300, hd, [0, 150], [0, 3], bf16, False, "misaligned"),
        "misaligned_kv8": (2, hq, g, 130, 300, hd, [0, 150], [0, 3], bf16, True, "misaligned"),
        # heads of 32 and 256, the other instances of the kernel's D (the
        # port's models: Gemma's heads are 256), in bf16, KV8 and f32; and a
        # Gemma-2b prefill (8 query heads, 1 KV head of 256, 4 x 512)
        **{f"d{dd}{tag}": (2, 8, 4, 300, 500, dd, [0, 150], [0, 20], dt, kv8)
           for dd in (32, 256) for tag, dt, kv8 in (("", bf16, False), ("_kv8", bf16, True), ("_f32", f32, False))},
        "d256_prefill": (4, 8, 1, 512, 512, 256, [0] * 4, None, bf16, False),
        # the Mixtral-width 4 x 512 prefill of the MoE main path: 32 / 8 heads
        # of 128 over its 520-slot (B, K, G, D) cache, bf16 and KV8
        **{name: (mb, mhq, mg, mt, mt + MOE_PREFILL_NEW, mhd, [0] * mb, None, bf16, kv8, "transposed")
           for name, kv8 in (("moe_prefill", False), ("moe_kv8_prefill", True))},
        # the speculative target's 256-token prompt, one row, over its cache
        # of p + max_new + 2 (gamma + 1) slots
        "spec_prefill": (1, hq, g, SPEC_LONG_PROMPT, SPEC_LONG_PROMPT + SPEC_NEW + 2 * (SPEC_GAMMA + 1), hd, [0],
                         None, bf16, False, "transposed"),
    }
    errors, err_over_bound, timings = {}, {}, {}
    for name, (b, nh, ng, tq, kk, d, q_start, kv_start, dtype, kv8, *layout) in cases.items():
        layout = layout[0] if layout else ""
        # Unit-variance q and k: logits of std about 1, a peaked softmax.
        q = torch.randn((b, nh, tq, d), generator=gen, device=device).to(dtype)
        if kv8:
            k = torch.randint(-127, 128, (b, ng, kk, d), generator=gen, device=device, dtype=torch.int8)
            v = torch.randint(-127, 128, (b, ng, kk, d), generator=gen, device=device, dtype=torch.int8)
            ks = torch.rand((b, kk, ng), generator=gen, device=device) * 0.02 + 0.005
            vs = torch.rand((b, kk, ng), generator=gen, device=device) * 0.02 + 0.005
        else:
            k = torch.randn((b, ng, kk, d), generator=gen, device=device).to(dtype)
            v = torch.randn((b, ng, kk, d), generator=gen, device=device).to(dtype)
            ks = vs = None
        qs = torch.tensor(q_start, dtype=torch.int32, device=device)
        kvs = None if kv_start is None else torch.tensor(kv_start, dtype=torch.int32, device=device)
        k_in, v_in, q_in = k, v, q
        if layout == "transposed":
            # The model's cache layout, with garbage past the written prefix.
            k_in, v_in = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
            written = max(q_start) + tq
            if kv8:
                k_in[:, written:], v_in[:, written:] = 127, -127
                ks, vs = ks.clone(), vs.clone()
                ks[:, written:], vs[:, written:] = float("nan"), float("nan")
            else:
                k_in[:, written:], v_in[:, written:] = float("nan"), float("nan")
            k_in, v_in = k_in.transpose(1, 2), v_in.transpose(1, 2)
            require(not k_in.is_contiguous(), f"flash {name}: the cache is a transposed view")
        elif layout == "misaligned":
            q_in, k_in, v_in = _offset_view(q), _offset_view(k), _offset_view(v)
            require(all(t.data_ptr() % 16 for t in (q_in, k_in, v_in)), f"flash {name}: the views are misaligned")
        got = flash_prefix_attention(q_in, k_in, v_in, qs, kvs, ks, vs)
        again = flash_prefix_attention(q_in, k_in, v_in, qs, kvs, ks, vs)
        want = reference_prefix_attention(q, k, v, qs, kvs, None, ks, vs)
        torch.cuda.synchronize()
        require(got.shape == want.shape and bool(torch.isfinite(got).all()), f"flash {name}: finite, shape")
        require(torch.equal(got, again), f"flash {name}: two runs on the same inputs are bit-identical")
        diff = (got.float() - want.float()).abs()
        errors[name] = float(diff.max())
        if dtype == torch.float32:
            tol = FLASH_F32_TOL + FLASH_F32_TOL * want.float().abs()
        else:
            spread_scales = (None, None) if ks is None else (ks.nan_to_num(0.0), vs.nan_to_num(0.0))
            tol = FLASH_BF16_RTOL * want.float().abs() + FLASH_BF16_ATOL_OF_S * rounding_spread(
                q, k, v, qs, kvs, *spread_scales)
        tol = tol.clamp_min(1e-30)  # empty-window rows have a bound of 0 and must be exact
        err_over_bound[name] = float((diff / tol).max())
        require(err_over_bound[name] <= 1.0, f"flash {name}: max abs err {errors[name]} beyond its bound")
        if kv_start is not None:
            for row, (qs_r, kvs_r) in enumerate(zip(q_start, kv_start)):
                empty = max(0, kvs_r - qs_r)
                require(bool((got[row, :, :empty] == 0).all()), f"flash {name}: empty-window rows are exact zeros")
        if name in ("prefill", "kv8_prefill", "chunked", "moe_prefill", "moe_kv8_prefill", "spec_prefill",
                    "d256_prefill"):
            # The kernel by CUDA-graph replays (the chunk case is shorter than
            # its enqueue), the plain version, milliseconds long, by events.
            plain, kernel = [], []
            for _ in range(2):
                plain.append(cuda_time_ms(lambda: reference_prefix_attention(q, k, v, qs, kvs, None, ks, vs), 10))
                kernel.append(cuda_graph_time_ms(lambda: flash_prefix_attention(q_in, k_in, v_in, qs, kvs, ks, vs), 20))
            ms, plain_ms = sum(kernel) / 2, sum(plain) / 2
            starts = kv_start or [0] * b
            flops = 4 * d * nh * _window_pairs(q_start, starts, tq, kk)
            item = 1 if kv8 else 2
            kv_bytes = 2 * ng * _keys_read(q_start, starts, tq, kk) * (d * item + (4 if kv8 else 0))
            bound = roofline(2 * q.numel() * 2 + kv_bytes, flops, H100_BF16_OPS_PER_S)
            timings[name] = {"ms": ms, "plain_ms": plain_ms, "in_window_TFLOPs": flops / (ms * 1e-3) / 1e12,
                             **with_share(bound, ms)}
            if kv8:
                timings[name]["library_ms"] = None  # no PyTorch call attends an int8 cache with per-key scales
                continue
            if name in ("prefill", "moe_prefill", "spec_prefill", "d256_prefill"):  # causal from key 0
                library = sdpa_library(q, k, v, q_start, tq)
            else:
                rows = qs.long()[:, None, None] + torch.arange(tq, device=device)[:, None]
                library = sdpa_library(q, k, v, q_start, kk, (torch.arange(kk, device=device) <= rows)[:, None])
            lib_err = float(((library().float() - want.float()).abs() / tol).max())
            require(lib_err <= 1.0, f"flash {name}: the library call is the same function (err/bound {lib_err})")
            timings[name]["library_ms"] = cuda_graph_time_ms(library, 20)
            timings[name]["library_err_over_bound"] = lib_err
    emit({"phase": "kernel_flash_prefix_attention", "max_abs_err": errors, "max_err_over_bound": err_over_bound,
          "bound": {"f32_atol_rtol": FLASH_F32_TOL, "bf16_rtol": FLASH_BF16_RTOL,
                    "bf16_atol": f"{FLASH_BF16_ATOL_OF_S} * sqrt(sum_j p_j^2 v_j^2)"},
          "cases": {n: [*c[:6], c[6], c[7], str(c[8]).replace("torch.", ""), *c[9:]] for n, c in cases.items()},
          "timing": timings, "deterministic": True,
          "library": "torch.nn.functional.scaled_dot_product_attention (causal / boolean mask, GQA); none for KV8"})
    top = timings["prefill"]
    return {"max_abs_err": max(errors.values()), "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"], "library_ms": top["library_ms"]}


def build_llms(device, num_layers: int, dtype):
    """The production Llama at full width with seeded random weights, and
    its int8 + KV8 + fused qkv/gate|up form made from it on the device."""
    from runia_core_tpu_torch.models import LlamaLM, fuse_quantized_llama_params, quantize_llama_params

    cfg = dict(LLM_CFG, num_layers=num_layers)
    dense = LlamaLM(**cfg, dtype=dtype, use_flash=True).eval()  # no device given: the card
    require(dense.embed.embedding.device == device, f"the default device is the card: {dense.embed.embedding.device}")
    dense.init_weights(torch.Generator(device=device).manual_seed(SEED))
    int8 = LlamaLM(**cfg, dtype=dtype, use_flash=True, quantized=True, quantized_kv=True, fused_qkv=True).eval()
    int8.load_state_dict(fuse_quantized_llama_params(quantize_llama_params(dense.state_dict())))
    return dense, int8


def _weight_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


UQ_REQUESTS = [
    {"method_name": "perplexity"}, {"method_name": "generation_entropy"}, {"method_name": "normalized_entropy"},
    {"method_name": "eigen_score", "layer_index": 15},
    {"method_name": "RAUQ", "token_aggregation": "mean_all_tokens", "head_aggregation": "rollout"},
    {"method_name": "RAUQ", "token_aggregation": "original", "head_aggregation": "original"},
]


def llm_slice_phase(device, models) -> dict:
    from runia_core_tpu_torch.llm import TorchGenerator, compute_uncertainties
    from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention
    from runia_core_tpu_torch.ops.quant_matmul import quant_matmul

    rng = torch.Generator().manual_seed(SEED + 1)
    vocab = LLM_CFG["vocab_size"]

    def prompts(n, length):
        return torch.randint(1, vocab, (n, length), generator=rng).tolist()

    def check(name, out, b, length, new):
        require(out["sequences"].shape == (b, length + new), f"{name}: sequences shape")
        require(bool(np.isfinite(out["log_probs"]).all()), f"{name}: finite log-probs")

    # ---- the main path, counted: decode steps replay CUDA graphs ----
    quant_matmul.launches = 0
    flash_prefix_attention.launches = flash_prefix_attention.kv8_launches = 0
    long_prompts = prompts(PREFILL_BATCH, PREFILL_LEN)
    decode_prompts = prompts(DECODE_BATCH, DECODE_PROMPT)
    uq_prompt = prompts(1, UQ_PROMPT)[0]
    gens = {name: TorchGenerator(model, max_new_tokens=DECODE_NEW) for name, model in models.items()}
    uq_gen = TorchGenerator(models["bf16"], max_new_tokens=UQ_NEW)
    greedy = {}
    with no_host_sync():
        prefilled = {name: gen.generate_batch(long_prompts, max_new_tokens=PREFILL_NEW) for name, gen in gens.items()}
        for name, gen in gens.items():
            greedy[name] = gen.generate_batch(decode_prompts, output_scores=False)
        text, scores = compute_uncertainties(uq_gen, None, uq_prompt, UQ_REQUESTS, num_samples=UQ_SAMPLES)
    for name in gens:
        check(f"{name} prefill", prefilled[name], PREFILL_BATCH, PREFILL_LEN, PREFILL_NEW)
        check(f"{name} decode", greedy[name], DECODE_BATCH, DECODE_PROMPT, DECODE_NEW)
    torch.cuda.synchronize()
    launches = {
        "quant_matmul": quant_matmul.launches,
        "flash_prefix_attention": flash_prefix_attention.launches,
        "flash_prefix_attention_kv8": flash_prefix_attention.kv8_launches,
    }
    require(launches["quant_matmul"] > 0, f"quant_matmul launched on the main path: {launches}")
    require(launches["flash_prefix_attention"] - launches["flash_prefix_attention_kv8"] > 0,
            f"the bf16 variant of flash_prefix_attention launched on the main path: {launches}")
    require(launches["flash_prefix_attention_kv8"] > 0, f"the KV8 variant launched on the main path: {launches}")
    require(len(scores) == len(UQ_REQUESTS) and all(np.isfinite(v) for v in scores.values()),
            f"every uncertainty score is finite: {scores}")
    agree = float((greedy["bf16"]["sequences"][:, DECODE_PROMPT:] == greedy["int8_kv8"]["sequences"][:, DECODE_PROMPT:]).mean())
    emit({"phase": "llm_slice", "config": LLM_CFG, "launches": launches, "uncertainty_scores": scores,
          "uq_tokens": len(text[0]), "weight_bytes": {n: _weight_bytes(m) for n, m in models.items()},
          "bf16_vs_int8_greedy_token_agreement": agree})
    return launches


def llm_graph_phase(device, models) -> dict:
    """Decode replays against the eager loop at full width, both forms:
    greedy 16 x 64 + 256 tokens identical with log-probs within 1e-5; the
    uncertainty call's taps (256-token prompt, 5 samples, hidden states and
    attentions); sampled tokens the same from one seed, replay against
    replay and against the eager loop. Every graph call under
    ``set_sync_debug_mode("error")``; afterwards kernel 3's tile counters of
    every cached decode graph are zero."""
    from runia_core_tpu_torch.llm import TorchGenerator
    from runia_core_tpu_torch.llm.generate import _PROGRAM_CACHE
    from runia_core_tpu_torch.ops.quant_matmul import quant_matmul

    rng = torch.Generator().manual_seed(SEED + 4)
    vocab = LLM_CFG["vocab_size"]
    prompts = torch.randint(1, vocab, (DECODE_BATCH, DECODE_PROMPT), generator=rng).tolist()
    uq_prompt = torch.randint(1, vocab, (UQ_PROMPT,), generator=rng).tolist()
    drawn = torch.Generator(device=device)
    record = {}
    for name, model in models.items():
        eager = TorchGenerator(model, max_new_tokens=DECODE_NEW, use_scan=False)
        graph = TorchGenerator(model, max_new_tokens=DECODE_NEW)
        want = eager.generate_batch(prompts, output_scores=False)
        want_taps = eager.generate(uq_prompt, num_return_sequences=UQ_SAMPLES, max_new_tokens=UQ_NEW)
        drawn.manual_seed(SEED + 5)
        want_sampled = eager.generate_batch(prompts, do_sample=True, generator=drawn, output_scores=False,
                                            max_new_tokens=UQ_NEW)
        sampled = []
        with no_host_sync():
            got = graph.generate_batch(prompts, output_scores=False)
            got_taps = graph.generate(uq_prompt, num_return_sequences=UQ_SAMPLES, max_new_tokens=UQ_NEW)
            for _ in range(2):
                drawn.manual_seed(SEED + 5)
                sampled.append(graph.generate_batch(prompts, do_sample=True, generator=drawn, output_scores=False,
                                                    max_new_tokens=UQ_NEW))
        same = bool((got["sequences"] == want["sequences"]).all())
        lp_err = float(np.abs(got["log_probs"] - want["log_probs"]).max())
        require(same, f"llm_graph {name}: greedy replay tokens equal the eager loop's")
        require(lp_err <= GRAPH_LOGPROB_ATOL, f"llm_graph {name}: log-prob err {lp_err} > {GRAPH_LOGPROB_ATOL}")
        taps_same = bool((got_taps["sequences"] == want_taps["sequences"]).all())
        taps_err = max(float(np.abs(a - b).max()) for key in ("attentions", "hidden_states")
                       for sg, sw in zip(got_taps[key], want_taps[key]) for a, b in zip(sg, sw))
        taps_lp = float(np.abs(got_taps["log_probs"] - want_taps["log_probs"]).max())
        require(taps_same and taps_lp <= GRAPH_LOGPROB_ATOL,
                f"llm_graph {name}: generate with taps, tokens {taps_same}, log-prob err {taps_lp}")
        require(bool((sampled[0]["sequences"] == sampled[1]["sequences"]).all()),
                f"llm_graph {name}: sampled tokens from one seed are reproducible")
        record[name] = {
            "greedy_tokens_identical": same, "max_abs_err_log_probs": lp_err,
            "taps": {"tokens_identical": taps_same, "max_abs_err_log_probs": taps_lp,
                     "max_abs_err_attn_hidden": taps_err},
            "sampled_reproducible": True,
            "sampled_equal_to_eager": bool((sampled[0]["sequences"] == want_sampled["sequences"]).all()),
        }
    graphs = [program.graph for program in _PROGRAM_CACHE.entries.values() if program.graph is not None]
    counters = [ws[1] for g in graphs for key, ws in g.workspaces.items() if key[0] == "quant_matmul"]
    torch.cuda.synchronize()
    require(counters and all(int(c.abs().sum()) == 0 for c in counters),
            "kernel 3's tile counters are zero after every decode graph's replays")
    per_replay = sorted({g.launches.get((quant_matmul, "launches"), 0) for g in graphs})
    emit({"phase": "llm_graph", "shape": [DECODE_BATCH, DECODE_PROMPT, DECODE_NEW], "sync_debug_mode": "error",
          "bound_log_probs": GRAPH_LOGPROB_ATOL, "models": record, "decode_graphs": len(graphs),
          "replays": sum(g.replays for g in graphs), "kernel3_launches_per_replay": per_replay,
          "kernel3_workspaces_checked_zero": len(counters)})
    return record


def llm_xcheck_phase(device) -> dict:
    """Full width, depth cut to XCHECK_LAYERS, f32 (TF32 off): card route
    against CPU route on the same weights, for the bf16-layout model in f32
    and its int8 + KV8 + fused form. A 256-token prefill (kernel 4 on the
    card) then teacher-forced decode steps."""
    from runia_core_tpu_torch.models import init_cache

    card = dict(zip(("f32", "int8_kv8"), build_llms(device, XCHECK_LAYERS, torch.float32)))
    rng = torch.Generator().manual_seed(SEED + 2)
    tokens = torch.randint(1, LLM_CFG["vocab_size"], (2, XCHECK_PROMPT + XCHECK_STEPS), generator=rng)
    errors = {}
    for name, model in card.items():
        cpu = type(model)(**{**LLM_CFG, "num_layers": XCHECK_LAYERS}, dtype=torch.float32, use_flash=True,
                          quantized=model.quantized, quantized_kv=model.quantized_kv, fused_qkv=model.fused_qkv,
                          device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        n = XCHECK_PROMPT + XCHECK_STEPS
        card_cache, cpu_cache = init_cache(model, 2, n), init_cache(cpu, 2, n, "cpu")
        calls = [(tokens[:, :XCHECK_PROMPT], 0)] + [
            (tokens[:, XCHECK_PROMPT + i: XCHECK_PROMPT + i + 1], XCHECK_PROMPT + i) for i in range(XCHECK_STEPS)
        ]
        worst = 0.0
        for chunk, index in calls:
            got = model(chunk.to(device), card_cache, index, need_attentions=False, need_hiddens=False)[0].cpu()
            want = cpu(chunk, cpu_cache, index, need_attentions=False, need_hiddens=False)[0]
            worst = max(worst, float((got - want).abs().max() / want.abs().max()))
        errors[name] = worst
        require(worst <= LLM_XCHECK_REL[name], f"LLM card vs CPU ({name}): rel err {worst} > {LLM_XCHECK_REL[name]}")
    emit({"phase": "llm_xcheck_f32_cpu", "layers": XCHECK_LAYERS, "prompt": XCHECK_PROMPT, "steps": XCHECK_STEPS,
          "max_rel_err": errors, "bound": LLM_XCHECK_REL})
    return errors


def _decode_program(model, rows: int, max_new: int):
    """The most recently used cached decode graph of that shape."""
    from runia_core_tpu_torch.llm.generate import _PROGRAM_CACHE

    return next(p for p in reversed(list(_PROGRAM_CACHE.entries.values()))
                if p.graph is not None and p.model is model and p.rows == rows and p.max_new == max_new)


def decode_replay_ms(model, rows: int, max_new: int) -> float:
    """Ms of one decode step at a cached program's shape: its graph replayed
    back to back from step 0 (the dense decode attention covers the whole
    cache, so every step costs the same), timed with events; the host is not
    in the number, a replay being one launch, but the gaps between the
    graph's nodes are."""
    from runia_core_tpu_torch.utils import cuda_time_ms

    program = _decode_program(model, rows, max_new)

    def first_step():  # the step index back to 0, so no replay writes past the program's buffers
        program.index.zero_()
        program.graph.replay()

    return cuda_time_ms(first_step, iters=50, warmup=5)


def decode_replay_kernels(model, rows: int, max_new: int, replays: int = PROFILE_STEPS) -> dict:
    """The kernels of one replayed decode step at a cached program's shape
    (its whole cache): ``replays`` replays from step 0 under the profiler;
    per replay the kernels and the sum of their durations."""
    from runia_core_tpu_torch.utils import device_profile

    program = _decode_program(model, rows, max_new)
    program.index.zero_()

    def steps():
        for _ in range(replays):
            program.graph.replay()

    return device_profile(steps, replays)


def llm_throughput_phase(device, models) -> dict:
    """Prefill tokens/s; decode tokens/s, ms a step and HBM GB/s of the eager
    loop and of the graph replays in interleaved windows. Beside them: the
    replay share of a step (the graph's event-timed replay at the cell's
    320-slot cache over the route's ms a step, which says how far the host
    still paces the step), the kernel share (the kernels' summed durations
    in a profiled replay at that cache over the route's ms a step, which
    says how busy the kernels keep the card), and the kernels a step of a
    profiled window of PROFILE_STEPS steps of each route.
    ``compute_uncertainties`` seconds per prompt on both routes, for one
    prompt repeated and for prompts of mixed lengths, with the graphs
    captured per call and the first call's cost."""
    from runia_core_tpu_torch.llm import TorchGenerator, compute_uncertainties
    from runia_core_tpu_torch.models import init_cache
    from runia_core_tpu_torch.utils import CudaGraph, cuda_time_ms, device_profile

    rng = torch.Generator().manual_seed(SEED + 3)
    vocab, cfg = LLM_CFG["vocab_size"], LLM_CFG
    tokens = torch.randint(1, vocab, (PREFILL_BATCH, PREFILL_LEN), generator=rng).to(device)
    prefill = {}
    for name, model in models.items():
        cache = init_cache(model, PREFILL_BATCH, PREFILL_LEN)
        ms = cuda_time_ms(lambda: model(tokens, cache, 0, need_attentions=False, need_hiddens=False,
                                        last_logits_only=True), iters=3, warmup=1)
        prefill[name] = {"ms": ms, "tokens_per_s": PREFILL_BATCH * PREFILL_LEN / (ms * 1e-3)}
        del cache

    prompts = torch.randint(1, vocab, (DECODE_BATCH, DECODE_PROMPT), generator=rng).tolist()
    routes = {"eager": False, "graph": True}
    gens = {(name, route): TorchGenerator(model, max_new_tokens=DECODE_NEW, use_scan=scan)
            for name, model in models.items() for route, scan in routes.items()}
    for gen in gens.values():
        gen.generate_batch(prompts, output_scores=False, max_new_tokens=8)  # warm-up
    # Two windows per model and route, in turns (the graphs of this shape
    # were captured by the main path).
    order = [("bf16", "eager"), ("bf16", "graph"), ("int8_kv8", "graph"), ("int8_kv8", "eager"),
             ("int8_kv8", "eager"), ("int8_kv8", "graph"), ("bf16", "graph"), ("bf16", "eager")]
    seconds = {key: [] for key in gens}
    for key in order:
        torch.cuda.synchronize()
        start = time.perf_counter()
        gens[key].generate_batch(prompts, output_scores=False)
        torch.cuda.synchronize()
        seconds[key].append(time.perf_counter() - start)
    # A replayed step at this shape, events, and its kernels under the profiler.
    step_ms = {name: decode_replay_ms(model, DECODE_BATCH, DECODE_NEW) for name, model in models.items()}
    step_kernels = {name: decode_replay_kernels(model, DECODE_BATCH, DECODE_NEW) for name, model in models.items()}
    head_dim = cfg["d_model"] // cfg["num_heads"]
    avg_ctx = DECODE_PROMPT + DECODE_NEW / 2
    decode = {}
    for (name, route), secs in seconds.items():
        model = models[name]
        # All the windows' tokens over all their time, so a stalled window counts.
        total, steps = sum(secs), DECODE_NEW * len(secs)
        kv_item = 1 if model.quantized_kv else 2
        kv_read = DECODE_BATCH * cfg["num_layers"] * 2 * avg_ctx * cfg["num_kv_heads"] * head_dim * kv_item
        if model.quantized_kv:
            kv_read += DECODE_BATCH * cfg["num_layers"] * 2 * avg_ctx * cfg["num_kv_heads"] * 4
        hbm = steps / total * (_weight_bytes(model) + kv_read)
        profiled = TorchGenerator(model, max_new_tokens=PROFILE_STEPS, use_scan=routes[route])
        profiled.generate_batch(prompts, output_scores=False)  # warm-up, capture
        busy = device_profile(lambda: profiled.generate_batch(prompts, output_scores=False), PROFILE_STEPS)
        ms_per_step = total / steps * 1e3
        kernel_ms = step_kernels[name]["device_busy_ms_per_unit"]
        decode[f"{name}_{route}"] = {
            "seconds": secs, "median_s": statistics.median(secs), "spread_s": [min(secs), max(secs)],
            "tokens_per_s": DECODE_BATCH * steps / total, "ms_per_step": ms_per_step,
            "hbm_GBps": hbm / 1e9, "hbm_share_of_3.35TBps": hbm / H100_HBM_BYTES_PER_S,
            "cache_slots": DECODE_PROMPT + DECODE_NEW,
        }
        if route == "graph":
            decode[f"{name}_{route}"] |= {
                "replay_ms": step_ms[name], "replay_share_of_step": step_ms[name] / ms_per_step,
                "kernel_ms_per_replay": kernel_ms, "kernels_per_replay": step_kernels[name]["kernels_per_unit"],
                "kernel_share_of_replay": kernel_ms / step_ms[name], "kernel_share_of_step": kernel_ms / ms_per_step,
            }
        decode[f"{name}_{route}"] |= {
            "profiled_window": {"steps": PROFILE_STEPS, "cache_slots": DECODE_PROMPT + PROFILE_STEPS,
                                "device_busy_share": busy["device_busy_share"],
                                "device_busy_ms_per_step": busy["device_busy_ms_per_unit"],
                                "wall_ms_per_step": busy["wall_ms_per_unit"],
                                "kernels_per_step": busy["kernels_per_unit"],
                                "device_time_seen": busy["device_time_seen"]},
        }
    uq_gens = {route: TorchGenerator(models["bf16"], max_new_tokens=UQ_NEW, use_scan=scan)
               for route, scan in routes.items()}
    prompt = torch.randint(1, vocab, (UQ_PROMPT,), generator=rng).tolist()
    uq_seconds = {route: [] for route in routes}
    for route in ("eager", "graph", "graph", "eager", "eager", "graph"):
        start = time.perf_counter()
        compute_uncertainties(uq_gens[route], None, prompt, UQ_REQUESTS, num_samples=UQ_SAMPLES)
        uq_seconds[route].append(time.perf_counter() - start)
    # Prompts of mixed lengths, each new to the graph route on its first
    # pass: the graphs each call captures, then a second pass on the same
    # prompts. The eager route runs between the two.
    mixed = [torch.randint(1, vocab, (n,), generator=rng).tolist() for n in UQ_MIXED_LENGTHS]
    uq_mixed = {}
    for label, route in (("graph_first_pass", "graph"), ("eager", "eager"), ("graph_second_pass", "graph")):
        secs, captured = [], []
        for p in mixed:
            before = CudaGraph.captures
            start = time.perf_counter()
            compute_uncertainties(uq_gens[route], None, p, UQ_REQUESTS, num_samples=UQ_SAMPLES)
            secs.append(time.perf_counter() - start)
            captured.append(CudaGraph.captures - before)
        uq_mixed[label] = {"s_per_prompt": secs, "mean_s": statistics.mean(secs), "captures_per_call": captured}
    emit({"phase": "llm_throughput", "prefill": prefill, "decode": decode,
          "decode_shape": [DECODE_BATCH, DECODE_PROMPT, DECODE_NEW], "decode_order": order,
          "compute_uncertainties_s_per_prompt": uq_seconds,
          "note": "the first compute_uncertainties call of each route includes its graphs' captures",
          "compute_uncertainties_mixed_lengths": {"prompt_lengths": list(UQ_MIXED_LENGTHS), **uq_mixed}})
    return {"prefill": prefill, "decode": decode}


class PairTok:
    """``bench.py``'s ``_PairTok`` (bench.py:948-973): an HF-style pair
    tokenizer for texts that are token-id lists, packing ``[CLS] p [SEP] h
    [SEP]`` with the ids folded into the NLI vocabulary."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def __call__(self, premises, hypotheses, padding=True, truncation=True, max_length=128, return_tensors="np"):
        half = (max_length - 3) // 2
        rows = []
        for p, h in zip(premises, hypotheses):
            def fold(seq):
                return [1 + int(t) % (self.vocab - 2) for t in seq]

            rows.append([1] + fold(p)[:half] + [2] + fold(h)[:half] + [2])
        t = max(len(r) for r in rows)
        ids = np.zeros((len(rows), t), np.int64)
        mask = np.zeros((len(rows), t), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def reachable_buckets(t: int, span: int, max_position: int) -> int:
    """Rows of the (2 x span, d) relative table a call of length t reads:
    the distinct log buckets (HF ``make_log_bucket_position``) of the
    offsets 1 - t .. t - 1, clipped to the table."""
    rel = np.arange(1 - t, t, dtype=np.float64)
    mid = span // 2
    far = np.abs(rel) > mid
    log_pos = np.ceil(np.log(np.abs(rel[far]) / mid) / np.log((max_position - 1) / mid) * (mid - 1)) + mid
    rel[far] = np.sign(rel[far]) * log_pos
    return len(np.unique(np.clip(rel + span, 0, 2 * span - 1)))


def deberta_work(cfg: dict, rows: int, t: int) -> dict:
    """Operations and bytes of one DeBERTa call on (rows, t) padded tokens,
    from its shapes: every matmul (projections, FFN, the position keys and
    queries of the reachable rows of the relative table, QK, c2p and p2c
    over those rows, PV, the conv, pooler and classifier) at 2 operations a
    multiply-add; bytes the bf16 weights once (of the embedding only the
    rows read), the reachable f32 table rows, and the ids, mask and
    logits."""
    d, ff, layers = cfg["d_model"], cfg["intermediate_size"], cfg["num_layers"]
    buckets = reachable_buckets(t, cfg["position_buckets"], cfg["max_position_embeddings"])
    tokens = rows * t
    per_layer = (2 * tokens * (4 * d * d + 2 * d * ff)  # q, k, v, attention out; FFN in and out
                 + 2 * 2 * buckets * d * d  # position keys and queries (share_att_key)
                 + 2 * rows * (2 * t * t * d + 2 * t * buckets * d))  # QK and PV; c2p and p2c
    ops = layers * per_layer + 2 * tokens * cfg["conv_kernel_size"] * d * d + 2 * rows * (d * d + d * 3)
    weights = layers * (4 * d * d + 2 * d * ff) + cfg["conv_kernel_size"] * d * d + d * d + 3 * d
    return {**roofline(2 * weights + 4 * buckets * d + 2 * tokens * d + 2 * 8 * tokens + 4 * rows * 3, ops,
                       H100_BF16_OPS_PER_S), "table_rows_read": buckets}


def nli_phase(device) -> dict:
    """The deberta-v2-xxlarge-mnli judge at full depth and width, bf16, 16
    pairs x 128 tokens through ``wrap_torch_nli``: the replayed bucket
    against the eager forward (labels identical, logits bit-identical),
    pairs/s of both routes in turns, a replay's device ms and TFLOP/s
    against the bound, the profiler's kernel share of a call, captures per
    call and the first call's ms; then 2 layers in f32 against the CPU."""
    from runia_core_tpu_torch.models import DebertaV2Classifier, wrap_torch_nli
    from runia_core_tpu_torch.utils import CudaGraph, cuda_time_ms, device_profile
    from runia_core_tpu_torch.utils.graphs import upload

    model = DebertaV2Classifier(**NLI_XXLARGE, dtype=torch.bfloat16).eval()
    require(model.pooler.kernel.device == device, f"the default device is the card: {model.pooler.kernel.device}")
    model.init_weights(torch.Generator(device=device).manual_seed(SEED + 6))
    tok = PairTok(NLI_XXLARGE["vocab_size"])
    rng = np.random.RandomState(3)
    premises = [list(rng.randint(1, 32000, NLI_IDS)) for _ in range(NLI_PAIRS)]
    hypotheses = [list(rng.randint(1, 32000, NLI_IDS)) for _ in range(NLI_PAIRS)]
    judges = {route: wrap_torch_nli(model, tok, max_len=NLI_LEN, len_buckets=(NLI_LEN,), batch_bucket=NLI_PAIRS,
                                    use_graph=route == "graph") for route in ("eager", "graph")}
    captures = CudaGraph.captures
    torch.cuda.synchronize()
    start = time.perf_counter()
    with no_host_sync():
        first = judges["graph"].logits(premises, hypotheses)  # warm-up calls and the capture
    first_ms = (time.perf_counter() - start) * 1e3
    first_captures = CudaGraph.captures - captures
    want = judges["eager"].logits(premises, hypotheses)
    captures = CudaGraph.captures
    with no_host_sync():
        got = judges["graph"].logits(premises, hypotheses)
        labels = judges["graph"](premises, hypotheses)
    require(got.shape == (NLI_PAIRS, 3) and bool(np.isfinite(got).all()), "nli: finite (16, 3) logits")
    require(np.array_equal(got, want) and np.array_equal(first, want), "nli: replayed logits bit-identical to eager")
    require(np.array_equal(labels, judges["eager"](premises, hypotheses)), "nli: replayed labels equal eager's")

    def window(route):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(NLI_CALLS):
            judges[route](premises, hypotheses)  # each call ends in the labels' copy to the host
        return (time.perf_counter() - start) / NLI_CALLS

    seconds = {"eager": [], "graph": []}
    for route in ("eager", "graph", "graph", "eager", "eager", "graph"):
        seconds[route].append(window(route))
    steady_captures = CudaGraph.captures - captures
    enc = tok(premises, hypotheses, max_length=NLI_LEN)
    inputs = {"input_ids": np.zeros((NLI_PAIRS, NLI_LEN), np.int64), "attention_mask": np.zeros((NLI_PAIRS, NLI_LEN),
                                                                                               np.int64)}
    for name in inputs:
        inputs[name][:, : enc[name].shape[1]] = enc[name]
    inputs = {name: upload(v, device) for name, v in inputs.items()}
    graph = CudaGraph(model, inputs)
    replay_ms = cuda_time_ms(graph.replay, iters=10, warmup=2)
    eager_ms = cuda_time_ms(lambda: model(**inputs), iters=5, warmup=1)
    del graph
    busy = device_profile(lambda: [judges["graph"](premises, hypotheses) for _ in range(5)], 5, nli_category)
    work = deberta_work(NLI_XXLARGE, NLI_PAIRS, NLI_LEN)
    record = {
        "phase": "nli", "config": NLI_XXLARGE, "dtype": "bfloat16", "pairs": NLI_PAIRS, "tokens": NLI_LEN,
        "valid_tokens_per_pair": 3 + 2 * NLI_IDS,
        "params": sum(p.numel() for p in model.parameters()),
        "replay_vs_eager": {"logits_bit_identical": True, "labels_identical": True},
        "pairs_per_s": {route: NLI_PAIRS / statistics.median(secs) for route, secs in seconds.items()},
        "call_s": seconds, "first_call_ms": first_ms, "captures_first_call": first_captures,
        "captures_per_call_after": steady_captures / (6 * NLI_CALLS + 2),
        "replay_ms": replay_ms, "eager_forward_ms": eager_ms,
        "TFLOPs_replay": work["operations"] / (replay_ms * 1e-3) / 1e12,
        "share_of_bf16_peak": work["operations"] / (replay_ms * 1e-3) / H100_BF16_OPS_PER_S,
        **with_share(work, replay_ms),
        "kernel_share_of_call": busy["device_busy_share"], "kernels_per_call": busy["kernels_per_unit"],
        "device_ms_per_call_profiled": busy["device_busy_ms_per_unit"], "device_time_seen": busy["device_time_seen"],
        "device_ms_per_call_by_category": busy["device_ms_per_unit_by_category"],
        "kernels_per_call_by_category": busy["kernels_per_unit_by_category"],
    }
    del judges, model
    torch.cuda.empty_cache()

    # ---- f32 cross-check: 2 layers at full width, card against CPU ----
    cfg = dict(NLI_XXLARGE, num_layers=NLI_XCHECK_LAYERS)
    card = DebertaV2Classifier(**cfg).eval()
    card.init_weights(torch.Generator(device=device).manual_seed(SEED + 7))
    cpu = DebertaV2Classifier(**cfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    ids, mask = torch.from_numpy(enc["input_ids"]), torch.from_numpy(enc["attention_mask"])
    got = card(ids.to(device), mask.to(device)).cpu()
    want = cpu(ids, mask)
    rel = float((got - want).abs().max() / want.abs().max())
    require(rel <= NLI_XCHECK_REL, f"nli card vs CPU f32: rel err {rel} > {NLI_XCHECK_REL}")
    record["xcheck_f32_cpu"] = {"layers": NLI_XCHECK_LAYERS, "max_rel_err": rel, "bound": NLI_XCHECK_REL}
    del card, cpu
    torch.cuda.empty_cache()
    emit(record)
    return record


SEMANTIC_REQUESTS = [  # bench.py:1066-1074, the six methods
    {"method_name": "perplexity"}, {"method_name": "generation_entropy"},
    {"method_name": "RAUQ", "token_aggregation": "original", "head_aggregation": "original"},
    {"method_name": "normalized_entropy"}, {"method_name": "eigen_score", "layer_index": 15},
    {"method_name": "semantic_entropy"},
]


def llm_semantic_phase(device, model) -> dict:
    """``compute_uncertainties`` with all six methods on the production
    Llama (bf16, graph route), semantic entropy judged by a DeBERTa at the
    deberta-v2-large geometry (``wrap_torch_nli``, 96-token pairs in
    batches of 16): s per prompt with and without semantic entropy on six
    prompts of 150-350 tokens, in turns, and the judge's share of the time.
    The main path of kernels 3 and 4 counted from zero."""
    from runia_core_tpu_torch.llm import TorchGenerator, compute_uncertainties
    from runia_core_tpu_torch.models import DebertaV2Classifier, wrap_torch_nli
    from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention
    from runia_core_tpu_torch.ops.quant_matmul import quant_matmul

    nli = DebertaV2Classifier(**NLI_LARGE, dtype=torch.bfloat16).eval()
    nli.init_weights(torch.Generator(device=device).manual_seed(SEED + 8))
    judge = wrap_torch_nli(nli, PairTok(NLI_LARGE["vocab_size"]), max_len=96, len_buckets=(96,), batch_bucket=16)
    judged = []  # (seconds, texts seen) per judge call

    def timed_judge(premises, hypotheses):
        start = time.perf_counter()
        labels = judge(premises, hypotheses)
        judged.append((time.perf_counter() - start, {tuple(p) for p in premises}))
        return labels

    timed_judge.is_batch_labels = True
    gen = TorchGenerator(model, max_new_tokens=UQ_NEW)
    rng = torch.Generator().manual_seed(SEED + 9)
    prompts = [torch.randint(1, LLM_CFG["vocab_size"], (n,), generator=rng).tolist() for n in UQ_MIXED_LENGTHS]
    without = SEMANTIC_REQUESTS[:-1]
    quant_matmul.launches = 0
    flash_prefix_attention.launches = flash_prefix_attention.kv8_launches = 0
    seconds = {"six_methods": [], "without_semantic_entropy": []}
    nli_seconds, scores_seen = [], []
    for i, prompt in enumerate(prompts):
        order = (("six_methods", SEMANTIC_REQUESTS), ("without_semantic_entropy", without))
        for label, requests in order if i % 2 == 0 else order[::-1]:
            judged.clear()
            start = time.perf_counter()
            with no_host_sync():
                _, scores = compute_uncertainties(gen, None, prompt, requests, num_samples=UQ_SAMPLES,
                                                  entailment_model=timed_judge)
            seconds[label].append(time.perf_counter() - start)
            if label == "six_methods":
                require(len(judged) == 1, f"llm_semantic: one batched judge call a prompt, got {len(judged)}")
                nli_seconds.append(judged[0][0])
                require(set(scores["clusters"]) == judged[0][1], "llm_semantic: clusters cover every sample")
                scores_seen.append({k: v for k, v in scores.items() if k != "clusters"})
            require(all(np.isfinite(v) for k, v in scores.items() if k != "clusters"),
                    f"llm_semantic: every score finite: {scores}")
    launches = {"quant_matmul": quant_matmul.launches, "flash_prefix_attention": flash_prefix_attention.launches,
                "flash_prefix_attention_kv8": flash_prefix_attention.kv8_launches}
    require(launches["flash_prefix_attention"] > 0, f"llm_semantic: kernel 4 launched: {launches}")
    record = {
        "phase": "llm_semantic", "methods": [r["method_name"] for r in SEMANTIC_REQUESTS],
        "judge": {"geometry": "deberta-v2-large (bench.py _NLI_LARGE)", "max_len": 96, "batch_bucket": 16},
        "prompt_lengths": list(UQ_MIXED_LENGTHS), "samples": UQ_SAMPLES, "new_tokens": UQ_NEW,
        "s_per_prompt": seconds, "mean_s": {k: statistics.mean(v) for k, v in seconds.items()},
        "nli_s_per_prompt": nli_seconds,
        "nli_share_of_six_methods": sum(nli_seconds) / sum(seconds["six_methods"]),
        "semantic_entropy": [s_["semantic_entropy"] for s_ in scores_seen], "launches": launches,
    }
    emit(record)
    del judge, nli
    torch.cuda.empty_cache()
    return launches


def spec_models(dense):
    """The two drafts of the production Llama's speculative cells, from its
    bf16 state on the card: the int8 self-draft (``quantize_llama_params``;
    bench.py:747-764) with the target itself, and the distilled pair
    (bench.py:810-871): a target whose o / down kernels of blocks 4-21 are
    scaled by 0.03 (every other tensor is ``dense``'s) and a draft of its
    first 4 blocks, ``norm_f`` and ``lm_head`` holding the same tensors."""
    from runia_core_tpu_torch.models import LlamaLM, quantize_llama_params

    cfg = {k: getattr(dense, k) for k in LLM_CFG}
    self_draft = LlamaLM(**cfg, dtype=dense.dtype, quantized=True).eval()
    self_draft.load_state_dict(quantize_llama_params(dense.state_dict()))
    state = dict(dense.state_dict())
    for i in range(SPEC_DRAFT_LAYERS, cfg["num_layers"]):
        for proj in ("o", "down"):
            state[f"block_{i}.{proj}.kernel"] = state[f"block_{i}.{proj}.kernel"] * SPEC_EPS
    target = LlamaLM(**cfg, dtype=dense.dtype, use_flash=True).eval()
    target.load_state_dict(state, assign=True)
    draft = LlamaLM(**dict(cfg, num_layers=SPEC_DRAFT_LAYERS), dtype=dense.dtype).eval()
    draft.load_state_dict({k: v for k, v in state.items() if k.split(".")[0] in ("embed", "norm_f", "lm_head")
                           or (k.startswith("block_") and int(k.split(".")[0][6:]) < SPEC_DRAFT_LAYERS)},
                          assign=True)
    return {"int8_self": (dense, self_draft), "distilled": (target, draft)}


def _read_bytes(model) -> int:
    """Bytes a decode step reads: every parameter but the embedding (a
    gather of one row), as bench.py's cost ratio counts them."""
    return sum(p.numel() * p.element_size() for name, p in model.named_parameters() if not name.startswith("embed"))


def _first_divergence(a, b) -> int:
    """The first index where two token rows differ; their length if none."""
    n = min(len(a), len(b))
    differ = np.flatnonzero(np.asarray(a[:n]) != np.asarray(b[:n]))
    return int(differ[0]) if len(differ) else n


def _timed_turns(calls: dict, windows: int, per_window: int, eager=()) -> dict:
    """Host seconds of ``per_window`` calls of each function, in windows in
    turns (a, b, b, a, ...), each call under ``no_host_sync`` but those
    named in ``eager`` (eager loops, which wait for the card by design)."""
    names = list(calls)
    order = [names[(w // 2 + w) % 2] if len(names) == 2 else names[w % len(names)] for w in range(2 * windows)]
    seconds = {name: [] for name in names}
    for name in order:
        torch.cuda.synchronize()
        start = time.perf_counter()
        with contextlib.nullcontext() if name in eager else no_host_sync():
            for _ in range(per_window):
                calls[name]()
        torch.cuda.synchronize()
        seconds[name].append((time.perf_counter() - start) / per_window)
    return seconds


def _greedy_rounds_reading_every(spec, prompt, every: int):
    """A greedy call on ``spec``'s captured program for ``prompt`` whose
    host reads the all-done flag every ``every`` rounds, where the
    generator reads it after each: the measurement behind that choice.
    Returns the tokens and the flag reads."""
    from runia_core_tpu_torch.utils.graphs import copy_to_host, host_sync, upload

    prog, syncs = spec._run_cache.get((1, len(prompt))), 0
    with torch.no_grad():
        prog.prefill(upload(np.asarray(prompt, np.int64)[None, :], prog.device))
        for i in range(prog.max_new - 1):
            prog.graph.replay()
            if (i + 1) % every == 0 and i + 1 < prog.max_new - 1:
                syncs += 1
                with host_sync(prog.device):
                    if bool(prog.done):
                        break
        buf, n_gen = copy_to_host(prog.buf, prog.n_gen)
    return buf[0, : int(n_gen[0])], syncs


def spec_slice_phase(device, dense) -> dict:
    """Speculative decoding on the production Llama (bf16, ``use_flash``),
    the main path counted from zero: for the int8 self-draft and the
    distilled pair, ``generate`` on the 32-token prompt and on a 256-token
    one (kernel 4 in the target's prefill), ``generate_samples`` of 5 x 32,
    and ``compute_uncertainties`` through the speculative backend (every
    method but eigen_score). Then, per draft: tok/s against plain greedy
    ``TorchGenerator`` (graph) in interleaved windows, speedup, acceptance,
    rounds, the round replay's ms (events), host syncs a generation, the
    kernel share of a call, greedy agreement with plain greedy at bf16; the
    round replay against the eager round (tokens identical, log-probs
    1e-5); and a 2-layer f32 copy whose speculative tokens must equal plain
    greedy's and the eager round's."""
    from runia_core_tpu_torch.llm import SpeculativeGenerator, TorchGenerator, compute_uncertainties
    from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention
    from runia_core_tpu_torch.ops.quant_matmul import quant_matmul
    from runia_core_tpu_torch.utils import cuda_time_ms, device_profile

    pairs = spec_models(dense)
    vocab = LLM_CFG["vocab_size"]
    prompt = [int(t) for t in np.random.RandomState(2).randint(1, vocab, SPEC_PROMPT)]  # bench.py:791
    long_prompt = [int(t) for t in np.random.RandomState(3).randint(1, vocab, SPEC_LONG_PROMPT)]
    uq_prompt = [int(t) for t in np.random.RandomState(4).randint(1, vocab, UQ_PROMPT)]
    kw = dict(gamma=SPEC_GAMMA, max_new_tokens=SPEC_NEW)
    specs = {name: SpeculativeGenerator(t, d, **kw) for name, (t, d) in pairs.items()}
    sampled = {name: SpeculativeGenerator(t, d, do_sample=True, **kw) for name, (t, d) in pairs.items()}
    plain = {name: TorchGenerator(t, max_new_tokens=SPEC_NEW) for name, (t, _) in pairs.items()}

    def greedy(name, p):
        return plain[name].generate(p, output_attentions=False, output_hidden_states=False)

    def equivalence(a, b):
        return a == b

    # ---- the main path, counted ----
    quant_matmul.launches = 0
    flash_prefix_attention.launches = flash_prefix_attention.kv8_launches = 0
    out, long_out, samples = {}, {}, {}
    with no_host_sync():
        for name in pairs:
            out[name] = specs[name].generate(prompt)
            long_out[name] = specs[name].generate(long_prompt)
            samples[name] = sampled[name].generate_samples(prompt, SPEC_SAMPLES)
        uq_text, uq_scores = compute_uncertainties(sampled["int8_self"], None, uq_prompt, SPEC_REQUESTS,
                                                   num_samples=SPEC_SAMPLES, entailment_model=equivalence)
    torch.cuda.synchronize()
    launches = {"quant_matmul": quant_matmul.launches, "flash_prefix_attention": flash_prefix_attention.launches,
                "flash_prefix_attention_kv8": flash_prefix_attention.kv8_launches}
    require(launches["quant_matmul"] > 0, f"spec: kernel 3 launched by the int8 self-draft: {launches}")
    require(launches["flash_prefix_attention"] - launches["flash_prefix_attention_kv8"] > 0,
            f"spec: kernel 4 launched by the target's 256-token prefill: {launches}")
    for name in pairs:
        for label, o, p in (("prompt", out[name], SPEC_PROMPT), ("long_prompt", long_out[name], SPEC_LONG_PROMPT)):
            require(o["sequences"].shape == (1, p + SPEC_NEW) and bool(np.isfinite(o["log_probs"]).all())
                    and o["rounds"] >= 1, f"spec {name} {label}: {SPEC_NEW} tokens, finite log-probs")
        s_ = samples[name]
        require(s_["tokens"].shape == (SPEC_SAMPLES, SPEC_NEW) and (s_["lengths"] == SPEC_NEW).all()
                and bool(np.isfinite(s_["log_probs"]).all()), f"spec {name}: generate_samples shapes, finite")
    require(all(np.isfinite(v) for k, v in uq_scores.items() if k != "clusters") and "eigen_score" not in uq_scores,
            f"spec: every uncertainty score finite: {uq_scores}")

    # ---- per draft: rates, round replay, syncs, kernel share, agreement ----
    record = {}
    for name, (target, draft) in pairs.items():
        cell = {"draft_layers": draft.num_layers, "draft_quantized": draft.quantized,
                "cost_ratio_read_bytes": _read_bytes(draft) / _read_bytes(target)}
        for label, p in (("prompt_32", prompt), ("prompt_256", long_prompt)):
            want = greedy(name, p)  # captures the plain program of this length
            got = specs[name].generate(p)
            syncs = specs[name].last_syncs + 1  # flag reads and the results' copy
            seconds = _timed_turns({"speculative": lambda: specs[name].generate(p),
                                    "greedy": lambda: greedy(name, p)}, SPEC_WINDOWS, SPEC_CALLS)
            spec_s, greedy_s = sum(seconds["speculative"]), sum(seconds["greedy"])
            program = specs[name]._run_cache.get((1, len(p)))
            replay_ms = cuda_time_ms(program.graph.replay, iters=10, warmup=2)  # rounds after the last: the same kernels
            launch_ms = []  # the host's time to enqueue one replay from an idle card: the gap after a flag read
            for _ in range(10):
                torch.cuda.synchronize()
                start = time.perf_counter()
                program.graph.replay()
                launch_ms.append((time.perf_counter() - start) * 1e3)
            torch.cuda.synchronize()
            prof = device_profile(lambda: specs[name].generate(p), 1)
            cell[label] = {
                "tokens_per_s": {"speculative": SPEC_NEW / (spec_s / len(seconds["speculative"])),
                                 "greedy": SPEC_NEW / (greedy_s / len(seconds["greedy"]))},
                "seconds_per_call": seconds,
                "speedup_vs_greedy": greedy_s / spec_s,
                "acceptance_rate": got["acceptance_rate"], "rounds": got["rounds"],
                "round_replay_ms": replay_ms, "host_syncs_per_generation": syncs,
                "replay_enqueue_ms_host": statistics.median(launch_ms),
                "kernel3_launches_per_replay": program.graph.launches.get((quant_matmul, "launches"), 0),
                "kernel_share_of_call": prof["device_busy_share"], "kernels_per_call": prof["kernels_per_unit"],
                "device_time_seen": prof["device_time_seen"],
                "greedy_first_divergence": _first_divergence(got["tokens"], want["sequences"][0, len(p):]),
                "greedy_token_agreement": float((got["tokens"] == want["sequences"][0, len(p):]).mean()),
            }
        # the host's flag reads: after every round (the generator's loop),
        # every 2 and every 4 rounds (the same program, driven here)
        calls, syncs = {"every_1": lambda: specs[name].generate(prompt)}, {"every_1": specs[name].last_syncs}
        with no_host_sync():
            want = specs[name].generate(prompt)["tokens"]
            for r in (2, 4):
                tokens, syncs[f"every_{r}"] = _greedy_rounds_reading_every(specs[name], prompt, r)
                require(np.array_equal(tokens, want), f"spec {name}: flag read every {r} rounds, same tokens")
                calls[f"every_{r}"] = lambda r=r: _greedy_rounds_reading_every(specs[name], prompt, r)
        seconds = _timed_turns(calls, SPEC_WINDOWS, SPEC_CALLS)
        cell["flag_reads"] = {k: {"ms_per_call": 1e3 * sum(v) / len(v), "host_syncs": syncs[k] + 1}
                              for k, v in seconds.items()}
        # generate_samples (5 x 32) against plain sampling of 5 sequences
        seconds = _timed_turns({
            "speculative": lambda: sampled[name].generate_samples(prompt, SPEC_SAMPLES),
            "plain": lambda: plain[name].generate(prompt, num_return_sequences=SPEC_SAMPLES, do_sample=True,
                                                  output_attentions=False, output_hidden_states=False),
        }, SPEC_WINDOWS // 2, SPEC_CALLS)
        spec_s, plain_s = (sum(seconds[k]) / len(seconds[k]) for k in ("speculative", "plain"))
        cell["samples_5x32"] = {"tokens_per_s": {"speculative": SPEC_SAMPLES * SPEC_NEW / spec_s,
                                                 "plain": SPEC_SAMPLES * SPEC_NEW / plain_s},
                                "speedup_vs_plain": plain_s / spec_s, "seconds_per_call": seconds,
                                "acceptance_rate": samples[name]["acceptance_rate"],
                                "rounds": samples[name]["rounds"]}
        # the round replay against the eager round, bf16
        eager = SpeculativeGenerator(target, draft, use_graph=False, **kw).generate(prompt)
        same = bool((eager["sequences"] == out[name]["sequences"]).all())
        lp_err = float(np.abs(eager["log_probs"] - out[name]["log_probs"]).max())
        require(same and lp_err <= GRAPH_LOGPROB_ATOL and eager["rounds"] == out[name]["rounds"],
                f"spec {name}: replay vs eager round, tokens identical {same}, log-prob err {lp_err}")
        cell["replay_vs_eager"] = {"tokens_identical": same, "max_abs_err_log_probs": lp_err}
        record[name] = cell

    # ---- compute_uncertainties: the speculative backend against TorchGenerator's ----
    backends = {"speculative": sampled["int8_self"], "torch_generator": TorchGenerator(dense, max_new_tokens=SPEC_NEW)}
    uq_seconds = _timed_turns({k: (lambda g=g: compute_uncertainties(g, None, uq_prompt, SPEC_REQUESTS,
                                                                      num_samples=SPEC_SAMPLES,
                                                                      entailment_model=equivalence))
                               for k, g in backends.items()}, 2, 1)
    xcheck = spec_xcheck(device, prompt)
    emit({"phase": "spec_slice", "config": LLM_CFG, "gamma": SPEC_GAMMA, "new_tokens": SPEC_NEW,
          "prompts": [SPEC_PROMPT, SPEC_LONG_PROMPT], "flag_read": "after every round",
          "distilled": {"draft_layers": SPEC_DRAFT_LAYERS, "eps": SPEC_EPS}, "launches": launches,
          "drafts": record, "uncertainty": {"methods": [r["method_name"] for r in SPEC_REQUESTS],
                                            "prompt": UQ_PROMPT, "samples": SPEC_SAMPLES,
                                            "scores": {k: v for k, v in uq_scores.items() if k != "clusters"},
                                            "s_per_prompt": uq_seconds, "text_tokens": len(uq_text[0])},
          "xcheck_f32": xcheck, "bound_log_probs": GRAPH_LOGPROB_ATOL})
    del pairs, specs, sampled, plain, backends
    _drop_programs()
    torch.cuda.empty_cache()
    return launches


def spec_xcheck(device, prompt) -> dict:
    """The production width at 2 layers in f32 (TF32 off) with its int8
    self-draft: speculative greedy tokens equal plain greedy's (exact only
    in f32: the batched verify and the one-token forwards break bf16 ties
    differently) and the eager round's, on the 32- and 256-token prompts."""
    from runia_core_tpu_torch.llm import SpeculativeGenerator, TorchGenerator
    from runia_core_tpu_torch.models import LlamaLM, quantize_llama_params

    cfg = dict(LLM_CFG, num_layers=SPEC_XCHECK_LAYERS)
    target = LlamaLM(**cfg, use_flash=True).eval()
    target.init_weights(torch.Generator(device=device).manual_seed(SEED + 20))
    draft = LlamaLM(**cfg, quantized=True).eval()
    draft.load_state_dict(quantize_llama_params(target.state_dict()))
    long_prompt = [int(t) for t in np.random.RandomState(5).randint(1, LLM_CFG["vocab_size"], SPEC_LONG_PROMPT)]
    result = {}
    for label, p in (("prompt_32", prompt), ("prompt_256", long_prompt)):
        kw = dict(gamma=SPEC_GAMMA, max_new_tokens=SPEC_NEW)
        with no_host_sync():
            got = SpeculativeGenerator(target, draft, **kw).generate(p)
            want = TorchGenerator(target, max_new_tokens=SPEC_NEW).generate(
                p, output_attentions=False, output_hidden_states=False)
        eager = SpeculativeGenerator(target, draft, use_graph=False, **kw).generate(p)
        same_plain = bool((got["sequences"] == want["sequences"]).all())
        same_eager = bool((got["sequences"] == eager["sequences"]).all())
        lp_err = float(np.abs(got["log_probs"] - eager["log_probs"]).max())
        require(same_plain and same_eager and lp_err <= GRAPH_LOGPROB_ATOL,
                f"spec f32 {label}: tokens = plain greedy {same_plain}, = eager round {same_eager}, "
                f"log-prob err {lp_err}")
        result[label] = {"tokens_equal_plain_greedy": same_plain, "tokens_equal_eager_round": same_eager,
                         "max_abs_err_log_probs_vs_eager": lp_err, "acceptance_rate": got["acceptance_rate"],
                         "rounds": got["rounds"]}
    del target, draft
    _drop_programs()
    return {"layers": SPEC_XCHECK_LAYERS, **result}


def _hf_family(family: str, device, layers=None):
    """A ``transformers`` model at the published width with random weights
    from the seed, f32, on the card: GPT-2 or Pythia-1.4b (``layers`` cuts
    the depth)."""
    import transformers

    torch.manual_seed(SEED + 30)
    if family == "gpt2":
        cfg = transformers.GPT2Config(**GPT2_HF if layers is None else dict(GPT2_HF, n_layer=layers))
        model = transformers.GPT2LMHeadModel(cfg)
    else:
        cfg = transformers.GPTNeoXConfig(**PYTHIA_HF if layers is None else dict(PYTHIA_HF, num_hidden_layers=layers))
        model = transformers.GPTNeoXForCausalLM(cfg)
    return model.to(device=device, dtype=torch.float32).eval()


def family_slice_phase(device, family: str) -> dict:
    """GPT-2 (``CausalLM``, openai-community/gpt2 width) or GPT-NeoX
    (``NeoXLM``, EleutherAI/pythia-1.4b width), f32, random weights from a
    seeded HF model through the port's converter: ``generate_batch`` 16 x 64
    + 64 greedy, graph against eager (tokens identical, log-probs 1e-5) and
    tok/s of both routes in turns; the HF model's logits against the port's
    on the card (the JAX tests' bounds); then 2 layers, card against CPU."""
    from runia_core_tpu_torch.llm import TorchGenerator
    from runia_core_tpu_torch.models import convert_hf_gpt2, convert_hf_gpt_neox, init_cache
    from runia_core_tpu_torch.models.neox import _rope_setting

    convert = convert_hf_gpt2 if family == "gpt2" else convert_hf_gpt_neox
    start = time.perf_counter()
    hf = _hf_family(family, device)
    build_s = time.perf_counter() - start
    if family == "neox":
        rope = (_rope_setting(hf.config, "partial_rotary_factor", "rotary_pct", -1.0),
                _rope_setting(hf.config, "rope_theta", "rotary_emb_base", -1.0))
        require(rope == (PYTHIA_HF["rotary_pct"], float(PYTHIA_HF["rotary_emb_base"])),
                f"neox: the HF config holds Pythia's rotary settings: {rope}")
    model, _ = convert(hf)  # no device given: the card
    require(model.embed.embedding.device == device, f"{family}: the converter's default device is the card")
    vocab = model.vocab_size
    rng = torch.Generator().manual_seed(SEED + 31)
    ids = torch.randint(0, vocab, FAMILY_HF_SHAPE, generator=rng)
    with torch.no_grad():
        want = hf(ids.to(device)).logits.float()
    got = model(ids.to(device), need_attentions=False, need_hiddens=False)[0]
    rtol, atol = FAMILY_HF_TOL[family]
    excess = float(((got - want).abs() - (atol + rtol * want.abs())).max())
    require(excess <= 0, f"{family}: HF logits against the port's beyond rtol {rtol} / atol {atol} ({excess})")
    hf_err = float((got - want).abs().max())
    del hf, want, got
    torch.cuda.empty_cache()

    prompts = torch.randint(1, vocab, (FAMILY_BATCH, FAMILY_PROMPT), generator=rng).tolist()
    gens = {route: TorchGenerator(model, max_new_tokens=FAMILY_NEW, use_scan=route == "graph")
            for route in ("eager", "graph")}
    out = {}
    for route, gen in gens.items():
        with no_host_sync() if route == "graph" else contextlib.nullcontext():
            out[route] = gen.generate_batch(prompts, output_scores=False)  # the graph route captures here
    same = bool((out["graph"]["sequences"] == out["eager"]["sequences"]).all())
    lp_err = float(np.abs(out["graph"]["log_probs"] - out["eager"]["log_probs"]).max())
    require(same and lp_err <= GRAPH_LOGPROB_ATOL and bool(np.isfinite(out["graph"]["log_probs"]).all()),
            f"{family}: graph vs eager, tokens identical {same}, log-prob err {lp_err}")
    seconds = _timed_turns({route: (lambda g=g: g.generate_batch(prompts, output_scores=False))
                            for route, g in gens.items()}, 2, 1, eager=("eager",))
    rates = {route: FAMILY_BATCH * FAMILY_NEW / (sum(s) / len(s)) for route, s in seconds.items()}
    weights = _weight_bytes(model)

    # 2 layers at the same width: the card route against the CPU route
    small, _ = convert(_hf_family(family, device, FAMILY_XCHECK_LAYERS))
    cpu = type(small)(**_family_config(small), device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in small.state_dict().items()})
    tokens = torch.randint(1, vocab, (2, FAMILY_PROMPT + FAMILY_XCHECK_STEPS), generator=rng)
    n = FAMILY_PROMPT + FAMILY_XCHECK_STEPS
    card_cache, cpu_cache = init_cache(small, 2, n), init_cache(cpu, 2, n, "cpu")
    worst = 0.0
    calls = [(tokens[:, :FAMILY_PROMPT], 0)] + [(tokens[:, FAMILY_PROMPT + i: FAMILY_PROMPT + i + 1],
                                                 torch.full((2,), FAMILY_PROMPT + i)) for i in range(FAMILY_XCHECK_STEPS)]
    for chunk, index in calls:
        card_index = index.to(device) if isinstance(index, torch.Tensor) else index
        g = small(chunk.to(device), card_cache, card_index, need_attentions=False, need_hiddens=False)[0].cpu()
        w = cpu(chunk, cpu_cache, index, need_attentions=False, need_hiddens=False)[0]
        worst = max(worst, float((g - w).abs().max() / w.abs().max()))
    require(worst <= LLM_XCHECK_REL["f32"], f"{family}: card vs CPU rel err {worst} > {LLM_XCHECK_REL['f32']}")
    emit({"phase": f"{family}_slice", "config": _family_config(model), "hf_config": GPT2_HF if family == "gpt2"
          else PYTHIA_HF, "dtype": "float32", "hf_build_s": build_s,
          "hf_logits": {"shape": list(FAMILY_HF_SHAPE), "max_abs_err": hf_err, "rtol": rtol, "atol": atol},
          "decode_shape": [FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW],
          "graph_vs_eager": {"tokens_identical": same, "max_abs_err_log_probs": lp_err},
          "tokens_per_s": rates, "seconds": seconds, "weight_bytes": weights,
          "decode_weight_GBps_graph": weights * FAMILY_NEW / (sum(seconds["graph"]) / len(seconds["graph"])) / 1e9,
          "xcheck_f32_cpu": {"layers": FAMILY_XCHECK_LAYERS, "max_rel_err": worst, "bound": LLM_XCHECK_REL["f32"]}})
    del model, small, cpu, gens
    _drop_programs()
    torch.cuda.empty_cache()
    return rates


def _family_config(model) -> dict:
    """The constructor arguments of a converted CausalLM or NeoXLM."""
    names = ("vocab_size", "num_layers", "num_heads", "d_model", "max_len")
    extra = (("ln_eps", "tie_embeddings") if model.__class__.__name__ == "CausalLM"
             else ("hidden_dim", "ln_eps", "rotary_pct", "rope_theta", "parallel_residual"))
    return {k: getattr(model, k) for k in names + extra}


def build_moe(device, num_layers: int, dtype):
    """The Mixtral-width LlamaLM (depth ``num_layers``) with seeded random
    weights, and its int8 + KV8 + fused qkv form made from it on the device."""
    from runia_core_tpu_torch.models import LlamaLM, fuse_quantized_llama_params, quantize_llama_params

    cfg = dict(MOE_CFG, num_layers=num_layers)
    dense = LlamaLM(**cfg, dtype=dtype, use_flash=True).eval()
    require(dense.embed.embedding.device == device, f"the default device is the card: {dense.embed.embedding.device}")
    dense.init_weights(torch.Generator(device=device).manual_seed(SEED + 10))
    int8 = LlamaLM(**cfg, dtype=dtype, use_flash=True, quantized=True, quantized_kv=True, fused_qkv=True).eval()
    int8.load_state_dict(fuse_quantized_llama_params(quantize_llama_params(dense.state_dict())))
    return {"bf16" if dtype == torch.bfloat16 else "f32": dense, "int8_kv8": int8}


def moe_slice_phase(device) -> dict:
    """The Mixtral-width MoE LlamaLM, 2 layers, bf16 (``use_flash``) and
    int8 + KV8 + fused qkv: the main path counted (a 4 x 512 prefill and a
    16 x 64 + 64 greedy decode per form, graph route), replays against the
    eager loop (tokens identical, log-probs within 1e-5), prefill and decode
    rates of both routes, decode HBM GB/s, and kernel 3 and 4 launches per
    replay and per prefill; then 1 layer in f32 against the CPU."""
    from runia_core_tpu_torch.llm import TorchGenerator
    from runia_core_tpu_torch.models import init_cache
    from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention
    from runia_core_tpu_torch.ops.quant_matmul import quant_matmul
    from runia_core_tpu_torch.utils import cuda_time_ms

    models = build_moe(device, MOE_CFG["num_layers"], torch.bfloat16)
    rng = torch.Generator().manual_seed(SEED + 11)
    vocab = MOE_CFG["vocab_size"]
    long_prompts = torch.randint(1, vocab, (MOE_PREFILL_BATCH, MOE_PREFILL_LEN), generator=rng).tolist()
    prompts = torch.randint(1, vocab, (MOE_DECODE_BATCH, MOE_DECODE_PROMPT), generator=rng).tolist()
    gens = {name: TorchGenerator(m, max_new_tokens=MOE_DECODE_NEW) for name, m in models.items()}

    # ---- the main path, counted ----
    quant_matmul.launches = 0
    flash_prefix_attention.launches = flash_prefix_attention.kv8_launches = 0
    greedy = {}
    with no_host_sync():
        for name, gen in gens.items():
            out = gen.generate_batch(long_prompts, max_new_tokens=MOE_PREFILL_NEW)
            require(out["sequences"].shape == (MOE_PREFILL_BATCH, MOE_PREFILL_LEN + MOE_PREFILL_NEW)
                    and bool(np.isfinite(out["log_probs"]).all()), f"moe {name}: prefill run finite")
            greedy[name] = gen.generate_batch(prompts, output_scores=False)
    torch.cuda.synchronize()
    launches = {"quant_matmul": quant_matmul.launches, "flash_prefix_attention": flash_prefix_attention.launches,
                "flash_prefix_attention_kv8": flash_prefix_attention.kv8_launches}
    require(launches["quant_matmul"] > 0 and launches["flash_prefix_attention_kv8"] > 0
            and launches["flash_prefix_attention"] > launches["flash_prefix_attention_kv8"],
            f"moe: kernels 3 and 4 (bf16 and KV8) launched on the main path: {launches}")

    # ---- replay against the eager loop ----
    record = {}
    for name, model in models.items():
        want = TorchGenerator(model, max_new_tokens=MOE_DECODE_NEW, use_scan=False).generate_batch(
            prompts, output_scores=False)
        same = bool((greedy[name]["sequences"] == want["sequences"]).all())
        lp_err = float(np.abs(greedy[name]["log_probs"] - want["log_probs"]).max())
        require(same and lp_err <= GRAPH_LOGPROB_ATOL,
                f"moe {name}: replay vs eager, tokens identical {same}, log-prob err {lp_err}")
        record[name] = {"greedy_tokens_identical": same, "max_abs_err_log_probs": lp_err}

    # ---- rates: prefill (events), decode (host clock, routes in turns) ----
    tokens = torch.randint(1, vocab, (MOE_PREFILL_BATCH, MOE_PREFILL_LEN), generator=rng).to(device)
    routes = {"eager": False, "graph": True}
    timed = {(name, route): TorchGenerator(m, max_new_tokens=MOE_DECODE_NEW, use_scan=scan)
             for name, m in models.items() for route, scan in routes.items()}
    for gen in timed.values():
        gen.generate_batch(prompts, output_scores=False, max_new_tokens=4)  # warm-up
    seconds = {key: [] for key in timed}
    for key in [("bf16", "eager"), ("bf16", "graph"), ("int8_kv8", "graph"), ("int8_kv8", "eager"),
                ("int8_kv8", "eager"), ("int8_kv8", "graph"), ("bf16", "graph"), ("bf16", "eager")]:
        torch.cuda.synchronize()
        start = time.perf_counter()
        timed[key].generate_batch(prompts, output_scores=False)
        torch.cuda.synchronize()
        seconds[key].append(time.perf_counter() - start)
    head_dim = MOE_CFG["d_model"] // MOE_CFG["num_heads"]
    avg_ctx = MOE_DECODE_PROMPT + MOE_DECODE_NEW / 2
    for name, model in models.items():
        cache = init_cache(model, MOE_PREFILL_BATCH, MOE_PREFILL_LEN)
        k3, k4 = quant_matmul.launches, flash_prefix_attention.launches
        prefill_ms = cuda_time_ms(lambda: model(tokens, cache, 0, need_attentions=False, need_hiddens=False,
                                                last_logits_only=True), iters=3, warmup=1)
        per_prefill = {"quant_matmul": (quant_matmul.launches - k3) / 4,
                       "flash_prefix_attention": (flash_prefix_attention.launches - k4) / 4}
        del cache
        program = _decode_program(model, MOE_DECODE_BATCH, MOE_DECODE_NEW)
        kv_item = 1 if model.quantized_kv else 2
        kv_read = MOE_DECODE_BATCH * MOE_CFG["num_layers"] * 2 * avg_ctx * MOE_CFG["num_kv_heads"] * (
            head_dim * kv_item + (4 if model.quantized_kv else 0))
        step_bytes = _weight_bytes(model) + kv_read
        replay_ms = decode_replay_ms(model, MOE_DECODE_BATCH, MOE_DECODE_NEW)
        record[name] |= {
            "prefill_ms": prefill_ms, "prefill_tokens_per_s": MOE_PREFILL_BATCH * MOE_PREFILL_LEN / (prefill_ms * 1e-3),
            "launches_per_prefill": per_prefill,
            "kernel3_launches_per_replay": program.graph.launches.get((quant_matmul, "launches"), 0),
            "kernel4_launches_per_replay": program.graph.launches.get((flash_prefix_attention, "launches"), 0),
            "weight_bytes": _weight_bytes(model), "decode_bytes_per_step": step_bytes,
            "replay_ms": replay_ms, "replay_hbm_GBps": step_bytes / (replay_ms * 1e-3) / 1e9,
            "replay_hbm_share_of_3.35TBps": step_bytes / (replay_ms * 1e-3) / H100_HBM_BYTES_PER_S,
            "decode_bound_ms": step_bytes / H100_HBM_BYTES_PER_S * 1e3,
        }
        for route in routes:
            secs = seconds[(name, route)]
            total, steps = sum(secs), MOE_DECODE_NEW * len(secs)
            record[name][f"decode_{route}"] = {
                "seconds": secs, "tokens_per_s": MOE_DECODE_BATCH * steps / total,
                "ms_per_step": total / steps * 1e3, "hbm_GBps": steps / total * step_bytes / 1e9,
            }
    require(record["int8_kv8"]["kernel3_launches_per_replay"] > 0, "moe: kernel 3 in every int8 decode replay")
    emit({"phase": "moe_slice", "config": MOE_CFG, "cut": "depth 2 of 32 layers (32 in bf16: 93 GB)",
          "prefill_shape": [MOE_PREFILL_BATCH, MOE_PREFILL_LEN],
          "decode_shape": [MOE_DECODE_BATCH, MOE_DECODE_PROMPT, MOE_DECODE_NEW], "launches": launches,
          "bound_log_probs": GRAPH_LOGPROB_ATOL, "models": record, "hbm_peak_GBps": H100_HBM_BYTES_PER_S / 1e9})
    del models, gens, timed
    _drop_programs()
    torch.cuda.empty_cache()
    moe_xcheck_phase(device)
    return launches


def moe_xcheck_phase(device) -> dict:
    """1 layer at the Mixtral width, f32 (TF32 off): card route against CPU
    route on the same weights, the float and the int8 + KV8 + fused form,
    a 128-token prefill (kernel 4 on the card) then teacher-forced decode
    steps."""
    from runia_core_tpu_torch.models import LlamaLM, init_cache

    card = build_moe(device, MOE_XCHECK_LAYERS, torch.float32)
    rng = torch.Generator().manual_seed(SEED + 12)
    tokens = torch.randint(1, MOE_CFG["vocab_size"], (1, MOE_XCHECK_PROMPT + MOE_XCHECK_STEPS), generator=rng)
    n = MOE_XCHECK_PROMPT + MOE_XCHECK_STEPS
    errors = {}
    for name, model in card.items():
        cpu = LlamaLM(**dict(MOE_CFG, num_layers=MOE_XCHECK_LAYERS), use_flash=True, quantized=model.quantized,
                      quantized_kv=model.quantized_kv, fused_qkv=model.fused_qkv, device="cpu").eval()
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        card_cache, cpu_cache = init_cache(model, 1, n), init_cache(cpu, 1, n, "cpu")
        calls = [(tokens[:, :MOE_XCHECK_PROMPT], 0)] + [
            (tokens[:, MOE_XCHECK_PROMPT + i: MOE_XCHECK_PROMPT + i + 1], MOE_XCHECK_PROMPT + i)
            for i in range(MOE_XCHECK_STEPS)]
        worst = 0.0
        for chunk, index in calls:
            got = model(chunk.to(device), card_cache, index, need_attentions=False, need_hiddens=False)[0].cpu()
            want = cpu(chunk, cpu_cache, index, need_attentions=False, need_hiddens=False)[0]
            worst = max(worst, float((got - want).abs().max() / want.abs().max()))
        errors[name] = worst
        require(worst <= LLM_XCHECK_REL[name], f"MoE card vs CPU ({name}): rel err {worst} > {LLM_XCHECK_REL[name]}")
        del cpu
    emit({"phase": "moe_xcheck_f32_cpu", "layers": MOE_XCHECK_LAYERS, "prompt": MOE_XCHECK_PROMPT,
          "steps": MOE_XCHECK_STEPS, "max_rel_err": errors, "bound": LLM_XCHECK_REL})
    del card
    torch.cuda.empty_cache()
    return errors


def _drop_programs() -> None:
    """Forget every cached decode program (their buffers and graphs)."""
    from runia_core_tpu_torch.llm.generate import _PROGRAM_CACHE

    _PROGRAM_CACHE.discard(lambda key: True)


def main() -> None:
    sys.path.insert(0, str(REPO))
    import runia_core_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = device_phase()
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(SEED)
    build_phase()
    k1 = entropy_phase(device, gen)
    k2 = fused_phase(device, gen)
    k3 = quant_matmul_phase(device, gen)
    k4 = flash_phase(device, gen)
    launches = slice_phase(device, gen)
    dense, int8 = build_llms(device, LLM_CFG["num_layers"], torch.bfloat16)
    models = {"bf16": dense, "int8_kv8": int8}
    launches.update(llm_slice_phase(device, models))
    llm_graph_phase(device, models)
    llm_xcheck_phase(device)
    llm_throughput_phase(device, models)
    semantic = llm_semantic_phase(device, models["bf16"])
    speculative = spec_slice_phase(device, models["bf16"])
    del models, dense, int8
    _drop_programs()
    torch.cuda.empty_cache()
    nli_phase(device)
    moe = moe_slice_phase(device)
    family_slice_phase(device, "gpt2")
    family_slice_phase(device, "neox")
    for counts in (semantic, speculative, moe):
        for name, n in counts.items():
            if name in launches:
                launches[name] += n
    emit({"kernels": [
        {"name": "marginal_entropy", "route": "cuda",
         "source": "runia_core_tpu_torch/csrc/marginal_entropy.cu",
         "replaces": "runia_core_tpu/ops/entropy_pallas.py:96",
         "launches": launches["marginal_entropy"], **k1},
        {"name": "fused_mc_entropy", "route": "cuda",
         "source": "runia_core_tpu_torch/csrc/fused_mc_entropy.cu",
         "replaces": "runia_core_tpu/ops/mc_entropy_pallas.py:138",
         "launches": launches["fused_mc_entropy"], **k2},
        {"name": "quant_matmul", "route": "cuda",
         "source": "runia_core_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "runia_core_tpu/ops/quant_matmul.py:122",
         "launches": launches["quant_matmul"], **k3},
        {"name": "flash_prefix_attention", "route": "cuda",
         "source": "runia_core_tpu_torch/csrc/flash_prefill.cu",
         "replaces": "runia_core_tpu/ops/flash_prefill.py:333",
         "launches": launches["flash_prefix_attention"], **k4},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
