#!/usr/bin/env python3
"""Microbenchmarks of the PyTorch port's four CUDA kernels on one NVIDIA GPU,
for tuning them: what ``chip_smoke.py`` does not sweep.

Run from the root of a checkout:

    python3 bench_torch_kernels.py [--kernels entropy fused quant_matmul flash]
                                   [--targets 132 264 330 528]

* ``marginal_entropy`` at (512, n, 512) for n = 16, 32, 64 and (64, 512, 512),
  and ``fused_mc_entropy`` at the (512, 4, 4, 512) tap in f32 and bf16, the
  (128, 7, 7, 2048) tap, and 64, 100 and 300 samples (with the kernel's and
  the plain version's distance from samples formed in f64): timed as replays
  of a CUDA graph, cold (copies of the input cycled past the L2) and warm
  (one input, which fits the L2), with every block width the plan could take
  beside the planned one and k taken at run time where the plan compiles it
  in, and the host's time to enqueue one call through the wrapper.
* ``quant_matmul`` at the production Llama's decode shapes (16 rows) and at
  100 and 512 rows, weights cold (copies cycled past the L2), timed as
  replays of a CUDA graph, once for every ``--targets`` value of the split-K
  planner's ``TARGET_BLOCKS``; beside it the same call with its weights warm
  in the L2, and the host's time to enqueue one call through the wrapper.
* ``flash_prefix_attention`` at the bf16 and KV8 8 x 1024 prefill and the
  chunk case, graph-timed, with ``scaled_dot_product_attention`` beside the
  bf16 prefill.

One JSON line per measurement; the card's name and power limit first. It
imports nothing of JAX and fails without a CUDA device. The package it
times is the one beside it: a copy of this file in another checkout times
that checkout's kernels (shapes or types its wrappers refuse are reported
as refused).
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

import runia_core_tpu_torch.ops.entropy_cuda as ec  # noqa: E402
from runia_core_tpu_torch.evaluation.entropy import neighbors_for  # noqa: E402
import runia_core_tpu_torch.ops.mc_entropy_cuda as mc  # noqa: E402
import runia_core_tpu_torch.ops.quant_matmul as qm  # noqa: E402
from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention  # noqa: E402
from runia_core_tpu_torch.utils import cuda_graph_time_ms  # noqa: E402

QMM_SHAPES = {  # (rows, K, N)
    "qkv": (16, 2048, 4096), "gate_up": (16, 2048, 11264), "o": (16, 2048, 2048), "down": (16, 5632, 2048),
    "lm_head": (16, 2048, 32000), "rows100_down": (100, 5632, 2048), "rows512_o": (512, 2048, 2048),
}
ENTROPY_SHAPES = {  # (B, n, d, k)
    "n16": (512, 16, 512, 5), "n32": (512, 32, 512, 5), "n64": (512, 64, 512, 5), "n512": (64, 512, 512, 5),
}
FUSED_SHAPES = {  # (B, H, W, C, S, map dtype)
    "rn18_f32": (512, 4, 4, 512, 16, torch.float32), "rn18_bf16": (512, 4, 4, 512, 16, torch.bfloat16),
    "rn50_f32": (128, 7, 7, 2048, 16, torch.float32), "rn18_s32": (512, 4, 4, 512, 32, torch.float32),
    "rn18_s64": (512, 4, 4, 512, 64, torch.float32), "s64_14x14": (2, 14, 14, 64, 64, torch.float32),
    "s300": (4, 4, 4, 300, 300, torch.float32), "s100_7x7": (16, 7, 7, 300, 100, torch.float32),
}
COLD_BYTES = 96 * 2**20  # copies of an input that together pass the 50 MB L2 about twice
FLASH_CASES = {  # (B, Tq, K, q_start, kv8), 16/8 heads of 128
    "prefill": (8, 1024, 1280, [0] * 8, False), "kv8_prefill": (8, 1024, 1280, [0] * 8, True),
    "chunked": (2, 256, 2048, [0, 700], False),
}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def graph_times(fn, copies) -> dict:
    """Device ms of one ``fn(*inputs)``: cold (the copies in turns, each read
    from device memory) and warm (one copy, read from the L2 where it fits),
    the least of three graph timings each; and the host's ms to enqueue one
    call eagerly."""
    turns = itertools.cycle(copies)
    calls = len(copies) * max(1, 24 // len(copies))
    cold = min(cuda_graph_time_ms(lambda: fn(*next(turns)), calls) for _ in range(3))
    warm = min(cuda_graph_time_ms(lambda: fn(*copies[0]), calls) for _ in range(3))
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(200):
        fn(*copies[0])
    host = (time.perf_counter() - start) / 200 * 1e3
    torch.cuda.synchronize()
    return {"cold_ms": cold, "warm_ms": warm, "host_enqueue_ms_per_call": host}


def cold_copies(tensors, read_bytes):
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(max(3, -(-COLD_BYTES // read_bytes) - 1))]


def with_variants(module, plan_name, key, rows, record, fn, copies) -> None:
    """Time ``fn`` again with the launch plan varied: every other block width
    that fits, and k taken at run time where the plan compiles it in
    (checkouts whose wrappers have no launch plan: skipped)."""
    plan_fn = getattr(module, plan_name, None)
    if plan_fn is None:
        return
    plan = plan_fn(*key)
    record["plan"] = plan._asdict()
    variants = {}
    if plan.static_k:
        variants["runtime_k"] = plan_fn(*key[:-1], 0)  # what any k but 5 gets
    fixed = plan.smem_bytes - (0 if plan.static_k else rows * plan.width * 4)
    for width in (32, 64, 128):
        smem = fixed + (0 if plan.static_k else rows * width * 4)
        if width != plan.width and smem <= ec.MAX_SMEM:
            variants[f"width{width}"] = plan._replace(width=width, smem_bytes=smem)
    for label, variant in variants.items():
        setattr(module, plan_name, lambda *a, _v=variant: _v)
        try:
            turns = itertools.cycle(copies)
            calls = len(copies) * max(1, 24 // len(copies))
            record[f"cold_ms_{label}"] = min(cuda_graph_time_ms(lambda: fn(*next(turns)), calls) for _ in range(3))
        finally:
            setattr(module, plan_name, plan_fn)


def entropy_bench(device, gen) -> None:
    for name, (b, n, d, k) in ENTROPY_SHAPES.items():
        clouds = torch.randn((b, n, d), generator=gen, device=device)
        copies = cold_copies((clouds,), clouds.numel() * 4)
        fn = lambda x: ec.marginal_entropy_cuda(x, k)  # noqa: E731
        err = float((fn(clouds) - ec.marginal_entropy_plain(clouds, k)).abs().max())
        record = {"kernel": "marginal_entropy", "shape": name, "B_n_d_k": [b, n, d, k], "copies": len(copies),
                  "max_abs_err": err, **graph_times(fn, copies)}
        record["read_GBps_cold"] = clouds.numel() * 4 / (record["cold_ms"] * 1e-3) / 1e9
        with_variants(ec, "entropy_plan", (n, k), n, record, fn, copies)
        emit(record)
        del copies


def fused_bench(device, gen) -> None:
    for name, (b, h, w, c, s, dtype) in FUSED_SHAPES.items():
        fmap = torch.rand((b, h, w, c), generator=gen, device=device).to(dtype)
        weights = mc.mc_dropblock_weights(b, h, w, s, 3, 0.5, gen, device)
        record = {"kernel": "fused_mc_entropy", "shape": name, "B_H_W_C_S": [b, h, w, c, s],
                  "map": str(dtype).replace("torch.", "")}
        try:
            got = mc.fused_mc_entropy(weights, fmap)
        except ValueError as exc:
            emit({**record, "refused": str(exc)[:160]})
            continue
        plain = mc.fused_mc_entropy_plain(weights, fmap)
        record["max_abs_err"] = float((got - plain).abs().max())
        # How far the f32 products themselves are from the truth: the same entropy of samples
        # formed in f64. Many samples on few positions lie so close that it is far.
        exact = torch.bmm(weights.double(), fmap.reshape(b, h * w, c).double()) / (h * w)
        exact = ec.marginal_entropy_plain(exact.float(), neighbors_for(s))
        record["err_vs_f64_products"] = {"kernel": float((got - exact).abs().max()),
                                         "plain": float((plain - exact).abs().max())}
        read = fmap.numel() * fmap.element_size() + weights.numel() * 4
        copies = cold_copies((weights, fmap), read)
        record.update(copies=len(copies), **graph_times(mc.fused_mc_entropy, copies))
        record["read_GBps_cold"] = read / (record["cold_ms"] * 1e-3) / 1e9
        with_variants(mc, "fused_plan", (s, h * w, neighbors_for(s)), s, record, mc.fused_mc_entropy, copies)
        emit(record)
        del copies


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
    parser.add_argument("--kernels", nargs="+", default=["entropy", "fused", "quant_matmul", "flash"],
                        choices=["entropy", "fused", "quant_matmul", "flash"], help="which kernels to time")
    parser.add_argument("--targets", type=int, nargs="+", default=[qm.TARGET_BLOCKS],
                        help="values of the split-K planner's TARGET_BLOCKS to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_kernels: no CUDA device; nothing was run")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    if "entropy" in args.kernels:
        entropy_bench(device, gen)
    if "fused" in args.kernels:
        fused_bench(device, gen)
    if "quant_matmul" in args.kernels:
        quant_matmul_bench(device, gen, args.targets)
    if "flash" in args.kernels:
        flash_bench(device, gen)


if __name__ == "__main__":
    main()
