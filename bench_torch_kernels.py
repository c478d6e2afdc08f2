#!/usr/bin/env python3
"""Microbenchmarks of the PyTorch port's two LLM kernels on one NVIDIA GPU,
for tuning them: what ``chip_smoke.py`` does not sweep.

Run from the root of a checkout:

    python3 bench_torch_kernels.py [--targets 132 264 330 528]

* ``quant_matmul`` at the production Llama's decode shapes (16 rows) and at
  100 and 512 rows, weights cold (copies cycled past the L2), timed as
  replays of a CUDA graph, once for every ``--targets`` value of the split-K
  planner's ``TARGET_BLOCKS``; beside it the same call with its weights warm
  in the L2, and the host's time to enqueue one call through the wrapper.
* ``flash_prefix_attention`` at the bf16 and KV8 8 x 1024 prefill and the
  chunk case, graph-timed, with ``scaled_dot_product_attention`` beside the
  bf16 prefill.

One JSON line per measurement; the card's name and power limit first. It
imports nothing of JAX and fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

import runia_core_tpu_torch.ops.quant_matmul as qm  # noqa: E402
from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention  # noqa: E402
from runia_core_tpu_torch.utils import cuda_graph_time_ms  # noqa: E402

QMM_SHAPES = {  # (rows, K, N)
    "qkv": (16, 2048, 4096), "gate_up": (16, 2048, 11264), "o": (16, 2048, 2048), "down": (16, 5632, 2048),
    "lm_head": (16, 2048, 32000), "rows100_down": (100, 5632, 2048), "rows512_o": (512, 2048, 2048),
}
FLASH_CASES = {  # (B, Tq, K, q_start, kv8), 16/8 heads of 128
    "prefill": (8, 1024, 1280, [0] * 8, False), "kv8_prefill": (8, 1024, 1280, [0] * 8, True),
    "chunked": (2, 256, 2048, [0, 700], False),
}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def quant_matmul_bench(device, gen, targets) -> None:
    data = {}
    for name, (rows, k, n) in QMM_SHAPES.items():
        x = torch.randn((rows, k), generator=gen, device=device).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (k, n), generator=gen, device=device, dtype=torch.int8)
        scale = torch.rand((n,), generator=gen, device=device) * 1e-2 + 1e-3
        data[name] = [(x, wq, scale)] + [(x, wq.clone(), scale) for _ in range(max(0, -(-64 * 2**20 // (k * n)) - 1))]
    for target in targets:
        qm.TARGET_BLOCKS = target
        qm.plan_split_k.cache_clear()
        for name, copies in data.items():
            rows, k, n = QMM_SHAPES[name]
            turns = itertools.cycle(copies)
            cold = min(cuda_graph_time_ms(lambda: qm.quant_matmul(*next(turns)), 30) for _ in range(3))
            warm = cuda_graph_time_ms(lambda: qm.quant_matmul(*copies[0]), 30)
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(200):
                qm.quant_matmul(*copies[0])
            host = (time.perf_counter() - start) / 200 * 1e3
            torch.cuda.synchronize()
            plan = qm.plan_split_k(rows, k, n)
            emit({"kernel": "quant_matmul", "shape": name, "target_blocks": target,
                  "grid": [plan.n_tiles, plan.splits, plan.row_blocks], "cold_ms": cold, "warm_ms": warm,
                  "int8_GBps": k * n / (cold * 1e-3) / 1e9, "host_enqueue_ms_per_call": host})


def flash_bench(device, gen) -> None:
    for name, (b, tq, kk, q_start, kv8) in FLASH_CASES.items():
        q = torch.randn((b, 16, tq, 128), generator=gen, device=device).to(torch.bfloat16)
        if kv8:
            k = torch.randint(-127, 128, (b, 8, kk, 128), generator=gen, device=device, dtype=torch.int8)
            v = torch.randint(-127, 128, (b, 8, kk, 128), generator=gen, device=device, dtype=torch.int8)
            ks = torch.rand((b, kk, 8), generator=gen, device=device) * 0.02 + 0.005
            vs = torch.rand((b, kk, 8), generator=gen, device=device) * 0.02 + 0.005
        else:
            k = torch.randn((b, 8, kk, 128), generator=gen, device=device).to(torch.bfloat16)
            v = torch.randn((b, 8, kk, 128), generator=gen, device=device).to(torch.bfloat16)
            ks = vs = None
        qs = torch.tensor(q_start, dtype=torch.int32, device=device)
        ms = min(cuda_graph_time_ms(lambda: flash_prefix_attention(q, k, v, qs, None, ks, vs), 20) for _ in range(3))
        flops = 4 * 128 * 16 * sum(min(kk - 1, s + i) + 1 for s in q_start for i in range(tq))
        record = {"kernel": "flash_prefix_attention", "case": name, "ms": ms, "in_window_TFLOPs": flops / ms / 1e9}
        if name == "prefill":
            record["sdpa_ms"] = min(cuda_graph_time_ms(lambda: F.scaled_dot_product_attention(
                q, k[:, :, :tq], v[:, :, :tq], is_causal=True, enable_gqa=True), 20) for _ in range(3))
        emit(record)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--targets", type=int, nargs="+", default=[qm.TARGET_BLOCKS],
                        help="values of the split-K planner's TARGET_BLOCKS to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_kernels: no CUDA device; nothing was run")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    quant_matmul_bench(device, gen, args.targets)
    flash_bench(device, gen)


if __name__ == "__main__":
    main()
