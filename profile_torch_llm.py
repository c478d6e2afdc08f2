#!/usr/bin/env python3
"""Where the PyTorch port's LLM time goes on the GPU: a ``torch.profiler``
pass over one greedy decode window and one prefill of the production Llama
(``chip_smoke.py``'s configuration, bf16 and int8 + KV8).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 profile_torch_llm.py [--steps 32] [--layers 22]

For each model form it prints one JSON line for the decode window (16 prompts
of 64 tokens, ``--steps`` greedy tokens, after a warm-up window) and one for
the 8 x 1024 prefill: wall milliseconds with the profiler on, kernels
launched, device-busy milliseconds (the sum of the kernels' durations: they
run on one stream), the busy share, and device milliseconds by category with
the port's own kernels named. The profiler stretches the wall time, so the
shares matter more than the milliseconds. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the production configuration and build_llms)

CATEGORIES = (  # first match wins, on the kernel's name
    ("quant_matmul (kernel 3)", ("quant_matmul_kernel",)),
    ("flash_prefix_attention (kernel 4)", ("flash_mma_kernel", "flash_kernel")),
    ("library GEMM", ("gemm", "cutlass", "cublas", "gemv", "sm90_xmma", "sm80_xmma", "nvjet")),
    ("softmax", ("softmax",)),
    ("cat / copy / cast", ("CatArray", "copy", "Memcpy", "Memset", "index", "gather", "scatter")),
    ("reductions", ("reduce", "argmax", "sort")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def category(name: str) -> str:
    for label, needles in CATEGORIES:
        if any(needle in name for needle in needles):
            return label
    return "other"


def profiled(fn, units: int) -> dict:
    """Run fn() under the profiler; per-unit wall, kernel count and device
    milliseconds by category (a unit is a decode step or a prefill)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    by_category = collections.defaultdict(float)
    by_kernel = collections.defaultdict(lambda: [0, 0.0])
    kernels, busy_us = 0, 0.0
    for event in prof.events():
        if str(event.device_type).endswith("CUDA") and event.name and not event.name.startswith("Memcpy HtoD (Pageable"):
            micros = float(getattr(event, "device_time", 0.0) or getattr(event, "cuda_time", 0.0) or 0.0)
            if micros <= 0.0:
                continue
            kernels += 1
            busy_us += micros
            by_category[category(event.name)] += micros
            if category(event.name).startswith(("quant_matmul", "flash_prefix")):
                by_kernel[category(event.name)][0] += 1
                by_kernel[category(event.name)][1] += micros
    return {
        "device_time_seen": busy_us > 0.0,
        "wall_ms_per_unit": wall_ms / units,
        "kernels_per_unit": kernels / units,
        "device_busy_ms_per_unit": busy_us / 1e3 / units,
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "device_ms_per_unit_by_category": {k: v / 1e3 / units for k, v in sorted(by_category.items(), key=lambda kv: -kv[1])},
        "port_kernels_per_unit": {k: {"launches": n / units, "ms_each": us / 1e3 / n} for k, (n, us) in by_kernel.items()},
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=32, help="greedy tokens in the profiled decode window")
    parser.add_argument("--layers", type=int, default=chip_smoke.LLM_CFG["num_layers"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_llm: no CUDA device; nothing was run")
    from runia_core_tpu_torch.llm import TorchGenerator
    from runia_core_tpu_torch.models import init_cache

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    dense, int8 = chip_smoke.build_llms(device, args.layers, torch.bfloat16)
    rng = torch.Generator().manual_seed(chip_smoke.SEED + 3)
    vocab = chip_smoke.LLM_CFG["vocab_size"]
    prompts = torch.randint(1, vocab, (chip_smoke.DECODE_BATCH, chip_smoke.DECODE_PROMPT), generator=rng).tolist()
    tokens = torch.randint(1, vocab, (chip_smoke.PREFILL_BATCH, chip_smoke.PREFILL_LEN), generator=rng).to(device)
    for name, model in (("bf16", dense), ("int8_kv8", int8)):
        gen = TorchGenerator(model, max_new_tokens=args.steps)
        gen.generate_batch(prompts, output_scores=False)  # warm-up: builds, allocations
        record = profiled(lambda: gen.generate_batch(prompts, output_scores=False), args.steps)
        print(json.dumps({"phase": "decode", "model": name, "layers": args.layers, "steps": args.steps,
                          "shape": [chip_smoke.DECODE_BATCH, chip_smoke.DECODE_PROMPT], "nvidia_smi": smi,
                          "note": "the window holds one 64-token prefill beside its decode steps", **record}), flush=True)
        cache = init_cache(model, chip_smoke.PREFILL_BATCH, chip_smoke.PREFILL_LEN)

        def prefill():
            model(tokens, cache, 0, need_attentions=False, need_hiddens=False, last_logits_only=True)

        prefill()
        record = profiled(prefill, 1)
        print(json.dumps({"phase": "prefill", "model": name, "layers": args.layers,
                          "shape": [chip_smoke.PREFILL_BATCH, chip_smoke.PREFILL_LEN], "nvidia_smi": smi, **record}),
              flush=True)
        del cache


if __name__ == "__main__":
    main()
