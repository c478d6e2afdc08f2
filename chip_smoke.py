#!/usr/bin/env python3
"""Drive the PyTorch port's LaREx scoring path once on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``runia_core_tpu_torch/csrc`` (into
``build/torch_kernels/``), holds each kernel against its plain PyTorch
version on the card, then fits and scores the full-width ``bench.py``
headline configuration through ``runia_core_tpu_torch`` alone: ResNet-18
with the CIFAR stem (64 filters, 10 classes, random weights from a seed),
32x32x3 images in batches of 512, a bf16 forward, 16 MC-DropBlock samples
(p=0.5, block 3, k=5) of the (512, 4, 4, 512) ``pre_pool`` tap, PCA-256
fitted on 512 images, LaREM. Both routes of the scorer run: ``fused=False``
(kernel 1, marginal entropy) and ``fused=True`` (kernel 2, fused channel
means + entropy).

Every phase prints one JSON line. Any failed check raises, so the script
exits non-zero and never prints its last line, which on success is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
before doing anything. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
ROUTE_PAIRS = 10  # timed windows of 30 scorer calls per route
XCHECK_IMAGES = 8
SEED = 0

# Kernel 1 selects the same f32 differences as the sorted-window plain
# version; only the order of the final sum of n logs differs.
ENTROPY_ATOL = 1e-5
# Kernel 2 sums each (S, HW) @ (HW, C) product in another order than bmm:
# the bound of tests/test_mc_entropy_fused.py for the TPU kernel.
FUSED_RTOL, FUSED_ATOL = 1e-4, 1e-5
# Card (cuDNN, TF32 off) against CPU, both f32, same weights and keep-weights.
# The conv sums run in other orders (about 1e-6 relative per layer over 18
# layers); each entropy is a mean of logs of distances between channel means
# and carries their relative error; PCA whitening divides by the smallest of
# 256 explained variances. Relative to max(|score|, 1).
XCHECK_RTOL = 2e-3


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


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


def timed_pair(kernel_fn, plain_fn, iters: int = 50):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    from runia_core_tpu_torch.utils import cuda_time_ms

    p1 = cuda_time_ms(plain_fn, iters)
    k1 = cuda_time_ms(kernel_fn, iters)
    k2 = cuda_time_ms(kernel_fn, iters)
    p2 = cuda_time_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def entropy_phase(device, gen) -> dict:
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda, marginal_entropy_plain

    cases = {
        "headline": (torch.randn((BATCH, MC_SAMPLES, 512), generator=gen, device=device), K),
        "ties": (torch.randint(-3, 4, (64, MC_SAMPLES, 256), generator=gen, device=device).float(), K),
        "n4_k3": (torch.randn((256, 4, 300), generator=gen, device=device), 3),
        "ragged_d": (torch.randn((64, MC_SAMPLES, 300), generator=gen, device=device), K),
        "b1": (torch.randn((1, MC_SAMPLES, 512), generator=gen, device=device), K),
    }
    errors = {}
    for name, (clouds, k) in cases.items():
        got = marginal_entropy_cuda(clouds, k)
        want = marginal_entropy_plain(clouds, k)
        torch.cuda.synchronize()
        require(got.shape == want.shape and bool(torch.isfinite(got).all()), f"entropy {name}: finite, shape")
        errors[name] = float((got - want).abs().max())
        require(errors[name] <= ENTROPY_ATOL, f"entropy {name}: max abs err {errors[name]} > {ENTROPY_ATOL}")
    clouds = cases["headline"][0]
    ms, plain_ms = timed_pair(
        lambda: marginal_entropy_cuda(clouds, K), lambda: marginal_entropy_plain(clouds, K)
    )
    record = {
        "phase": "kernel_marginal_entropy", "max_abs_err": errors, "bound": ENTROPY_ATOL,
        "shape": list(clouds.shape), "ms": ms, "plain_ms": plain_ms,
        "read_GBps": clouds.numel() * 4 / (ms * 1e-3) / 1e9,
    }
    emit(record)
    return {"max_abs_err": max(errors.values()), "ms": ms, "plain_ms": plain_ms}


def fused_phase(device, gen) -> dict:
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda
    from runia_core_tpu_torch.ops.mc_entropy_cuda import (
        fused_mc_entropy, fused_mc_entropy_plain, mc_dropblock_weights,
    )
    from runia_core_tpu_torch.utils import cuda_time_ms

    errors, inputs = {}, {}
    for name, (b, h, w, c) in {"headline": (BATCH, 4, 4, 512), "rn50_224": (8, 7, 7, 2048)}.items():
        fmap = torch.rand((b, h, w, c), generator=gen, device=device)
        weights = mc_dropblock_weights(b, h, w, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, gen, device)
        got = fused_mc_entropy(weights, fmap, K)
        want = fused_mc_entropy_plain(weights, fmap, K)
        torch.cuda.synchronize()
        require(got.shape == (b, c) and bool(torch.isfinite(got).all()), f"fused {name}: finite, shape")
        errors[name] = float((got - want).abs().max())
        within = (got - want).abs() <= FUSED_ATOL + FUSED_RTOL * want.abs()
        require(bool(within.all()), f"fused {name}: max abs err {errors[name]} beyond rtol/atol")
        inputs[name] = (weights, fmap)
    weights, fmap = inputs["headline"]
    ms, plain_ms = timed_pair(
        lambda: fused_mc_entropy(weights, fmap, K), lambda: fused_mc_entropy_plain(weights, fmap, K)
    )
    flat = fmap.reshape(BATCH, 16, 512)
    two_step_ms = cuda_time_ms(lambda: marginal_entropy_cuda(torch.bmm(weights, flat) / 16, K), 50)
    emit({
        "phase": "kernel_fused_mc_entropy", "max_abs_err": errors,
        "bound": {"rtol": FUSED_RTOL, "atol": FUSED_ATOL}, "shape": list(fmap.shape),
        "ms": ms, "plain_ms": plain_ms, "two_step_bmm_plus_kernel1_ms": two_step_ms,
        "read_GBps": fmap.numel() * 4 / (ms * 1e-3) / 1e9,
    })
    return {"max_abs_err": max(errors.values()), "ms": ms, "plain_ms": plain_ms}


def build_model(dtype, device):
    from runia_core_tpu_torch.models import ResNet18

    model = ResNet18(num_classes=NUM_CLASSES, cifar_stem=True, num_filters=NUM_FILTERS, dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(SEED))
    return model.to(device=device, memory_format=torch.channels_last).eval()


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
    from runia_core_tpu_torch.utils import cuda_time_ms

    model = build_model(torch.bfloat16, device)
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
            logits, scores = scorer(images(BATCH), generator=gen)
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
    model32 = build_model(torch.float32, device)
    model_cpu = build_model(torch.float32, "cpu")
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

    # ---- throughput and per-stage times (CUDA events, after warm-up) ----
    # Pairs of windows, the route that goes first alternating, so that a
    # drift of the shared host shows in both routes alike.
    x = images(BATCH)
    times = {False: [], True: []}
    for pair in range(ROUTE_PAIRS):
        for fused in ((False, True) if pair % 2 == 0 else (True, False)):
            times[fused].append(cuda_time_ms(lambda: scorers[fused](x, generator=gen), iters=30, warmup=5))
    ips = {("fused" if f else "two_step"): BATCH / (statistics.median(ms) * 1e-3) for f, ms in times.items()}
    fused_wins = sum(f < t for f, t in zip(times[True], times[False]))
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
        "pca_md": cuda_time_ms(
            lambda: mahalanobis_quadform(pca_transform(pca_state, h), larem.feats_mean, larem.precision)
        ),
    }
    emit({"phase": "throughput", "batch": BATCH, "img_per_s_median": ips,
          "scorer_ms": {("fused" if f else "two_step"): ms for f, ms in times.items()},
          "fused_faster_in_pairs": f"{fused_wins}/{ROUTE_PAIRS}", "stage_ms": stages})
    return launches


def main() -> None:
    sys.path.insert(0, str(REPO))
    import runia_core_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = device_phase()
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(SEED)
    build_phase()
    k1 = entropy_phase(device, gen)
    k2 = fused_phase(device, gen)
    launches = slice_phase(device, gen)
    emit({"kernels": [
        {"name": "marginal_entropy", "route": "cuda",
         "source": "runia_core_tpu_torch/csrc/marginal_entropy.cu",
         "replaces": "runia_core_tpu/ops/entropy_pallas.py:96",
         "launches": launches["marginal_entropy"], **k1},
        {"name": "fused_mc_entropy", "route": "cuda",
         "source": "runia_core_tpu_torch/csrc/fused_mc_entropy.cu",
         "replaces": "runia_core_tpu/ops/mc_entropy_pallas.py:138",
         "launches": launches["fused_mc_entropy"], **k2},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
