#!/usr/bin/env python3
"""Where the PyTorch port's LLM time goes on the GPU: a ``torch.profiler``
pass over one greedy decode window and one prefill of the production Llama
(``chip_smoke.py``'s configuration, bf16 and int8 + KV8).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 profile_torch_llm.py [--steps 32] [--layers 22]

For each model form it prints one JSON line for each decode route (16
prompts of 64 tokens, ``--steps`` greedy tokens, after a warm-up window): the
eager loop (``TorchGenerator(use_scan=False)``) and the decode step as a
CUDA graph replay (``use_scan=True``); and one for the 8 x 1024 prefill: wall
milliseconds with the profiler on, kernels launched, device-busy
milliseconds (the sum of the kernels' durations: they run on one stream),
the busy share, and device milliseconds by category with the port's own
kernels named (``utils/timing.py::device_profile``). The profiler stretches
the eager route's wall time, so the shares matter more than the
milliseconds. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the production configuration, build_llms and the kernel categories)

category = chip_smoke.kernel_category


def replay_floor(model, steps: int, kernels: int) -> dict:
    """The decode step's device time at the profiled shape
    (``chip_smoke.decode_replay_ms``) beside a graph of ``kernels``
    one-element kernels: what that many graph nodes cost without their
    work."""
    from runia_core_tpu_torch.utils import CudaGraph, cuda_time_ms

    step_ms = chip_smoke.decode_replay_ms(model, chip_smoke.DECODE_BATCH, steps)
    flag = torch.zeros((), device="cuda")

    def tiny():
        for _ in range(kernels):
            flag.add_(1)

    tiny_ms = cuda_time_ms(CudaGraph(tiny).replay, iters=50, warmup=5)
    return {"step_ms": step_ms, "tiny_kernels": kernels, "tiny_kernel_graph_ms": tiny_ms,
            "us_per_tiny_kernel": tiny_ms * 1e3 / kernels}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=32, help="greedy tokens in the profiled decode window")
    parser.add_argument("--layers", type=int, default=chip_smoke.LLM_CFG["num_layers"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_llm: no CUDA device; nothing was run")
    from runia_core_tpu_torch.llm import TorchGenerator
    from runia_core_tpu_torch.models import init_cache
    from runia_core_tpu_torch.utils import device_profile

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
        for route, use_scan in (("eager", False), ("graph", True)):
            gen = TorchGenerator(model, max_new_tokens=args.steps, use_scan=use_scan)
            gen.generate_batch(prompts, output_scores=False)  # warm-up: builds, allocations, the capture
            record = device_profile(lambda: gen.generate_batch(prompts, output_scores=False), args.steps, category)
            if use_scan:
                record["replay"] = replay_floor(model, args.steps, round(record["kernels_per_unit"]))
            print(json.dumps({"phase": "decode", "model": name, "route": route, "layers": args.layers,
                              "steps": args.steps, "shape": [chip_smoke.DECODE_BATCH, chip_smoke.DECODE_PROMPT],
                              "nvidia_smi": smi,
                              "note": "the window holds one 64-token prefill beside its decode steps", **record}),
                  flush=True)
        cache = init_cache(model, chip_smoke.PREFILL_BATCH, chip_smoke.PREFILL_LEN)

        def prefill():
            model(tokens, cache, 0, need_attentions=False, need_hiddens=False, last_logits_only=True)

        prefill()
        record = device_profile(prefill, 1, category)
        print(json.dumps({"phase": "prefill", "model": name, "layers": args.layers,
                          "shape": [chip_smoke.PREFILL_BATCH, chip_smoke.PREFILL_LEN], "nvidia_smi": smi, **record}),
              flush=True)
        del cache


if __name__ == "__main__":
    main()
