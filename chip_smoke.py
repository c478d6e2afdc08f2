#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU: LaREx image
scoring (served over a dataset, and split over a one-process world), the
Llama LLM-uncertainty slice with semantic entropy on a DeBERTa NLI judge,
the Mixtral sparse-MoE LlamaLM, and object-level scoring.

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
* LaREx user flow (``image_flow_rn50``): ``bench.py``'s ResNet-50 @224 leg
  (10 classes, random bf16 weights from a seed, channels_last, batches of
  128, the (128, 7, 7, 2048) ``pre_pool`` tap) through the entry points a
  user calls: ``extraction.tap_torch_model`` (a forward hook; the tap
  equals ``build_tapped_forward``'s bit for bit), ``FastMCDSamplesExtractor``
  over 384 fit images, ``get_dl_h_z`` (kernel 1), PCA-256, the five latent
  scorers (MD, KDE, cMD, KNN, GMM) and their thresholds, then two
  out-of-distribution batches through ``LaRExInference(mcd_sampler=)`` and
  both scorer routes (kernels 1 and 2), ``MCDSamplesExtractor`` with 16
  stochastic forwards, and the flow in f32 at batch 8 against the CPU.
* Evaluation layer (``eval_rn50``), at the same width: features, logits and
  16 MC samples of 4,096 train, 1,024 valid and two 1,024-image
  out-of-distribution sets, ``get_dl_h_z`` (kernel 1) on each,
  ``calculate_all_baselines`` with all twelve baselines (vim, msp, raw, knn,
  energy, ash, gen, react, dice, dice_react, mdist, ddu) and pred_h / mi
  from ``get_mcd_pred_uncertainty_score``, ``log_evaluate_larex`` (LaRED,
  LaREM, LaREK at PCA 64 and 256), ``torch_auroc`` on the card against every
  row's numpy AUROC, and every baseline card against CPU in f32.
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

* Serving (``serve_mixed_96``, ``serve_check``, ``serve_7b_int8``):
  ``llm.ContinuousBatchingEngine`` on two ``bench.py`` legs at full width.
  Cell 1, the 7B-class int8 leg (``bench.py`` ``_7B_CFG``: 32 layers, d
  4,096, 32/8 heads of 128, SwiGLU 11,008, vocab 32,000; int8 weights + KV8
  + fused qkv / gate|up, bf16, ``use_flash``): 24 requests (prompts 128-448,
  budgets 24-56) over 8 slots with chunked prefill of 128 in lanes of 4,
  through the open-loop drain (``defer_fetch``) and the lookahead drain in
  turns; kernel 3 carries every projection, kernel 4's KV8 variant every
  prefill lane, and the decode chunk and the lane programs replay as CUDA
  graphs. Cell 2: the production Llama in bf16 serving 96 requests
  (prompts 16-192, budgets 8-64) over 32 slots with bucketed prefill,
  against static batching (``generate_batch``, 3 x 32, ``pad_to=192``).
  ``serve_check`` holds the replays against the eager programs, the card
  against the CPU (f32, 2 layers at cell 1's width, prefix cache and lanes)
  and the engine against ``TorchGenerator.generate``.
* Speculative serving and the fused drain: ``spec_engine_7b_int8`` (cell
  1's model as the distilled pair of ``bench.py:810-871``, its first 4 of
  32 blocks the draft, the upper blocks' o / down scales times 0.03; the
  shared-system-prompt traffic of ``bench.py:887-901``; gamma 4, chunks of
  15 tokens, chunked prefill of 128 in lanes of 4, prefix cache, the
  break-even guard armed) against the plain engine on the same target, in
  turns; ``spec_engine_1b`` (the bench's own leg on the production Llama
  in bf16, its 4-of-22 draft, chunks of 64, no hand kernel);
  ``generate_all_fused`` on cell 2 (chunks of 64, 8 lanes, 4-step
  iterations, in turns with the interactive drains and static batching)
  and on cell 1 (``fused_7b``: lanes of 4 x 128 chosen on the device);
  ``uncertainty_serving`` (``UncertaintyServer``, all six methods,
  ``bench.py:1048-1125``) and ``generation_service`` (32 requests from 4
  threads); ``spec_serve_check`` holds the round chunk, the spec lanes and
  both fused iterations against their eager programs, the card against the
  CPU at 2 layers, spec greedy against plain, one fused lane against
  ``generate_all``, and, once the break-even guard has fired, the prefix
  cache hitting slot 0 as often as the ``use_graph=False`` engine.

* Image level C (``int8_rn18``, ``vit_b16``, ``train_rn18``): the int8 PTQ
  leg of ``bench.py`` (``larex_resnet18_32px_int8``: the headline ResNet-18
  at batch 512 with weights and statistics randomised from the seed,
  ``quantize_resnet_params`` on 256 images on the card and on the CPU, the
  int32 sums, logits and taps card against CPU, the fit on 512 images
  through the int8 forward, both scorer routes under the graph,
  ``save_larex_pipeline`` and the qparams reloaded into a fresh scorer
  equal bit for bit, int8 against the f32 forward, and the int8, bf16 and
  f32 forwards and scorers timed in turns with the int8 call's kernels by
  category); LaREx on a ViT-B/16 @224 at batch 64 (the (64, 14, 14, 768)
  ``encoder_tokens`` tap, both routes); ``fit_classifier`` on the headline
  ResNet-18 (40 Adam steps at batch 128, one SGD step card against CPU,
  then train -> tap -> LaREx).
* Object level (``kernel_nms``, ``kernel_roi_align``, ``object_scorer_rn18``,
  ``yolov8m_flow``): the NMS kernel against its plain version at N = 1,000,
  8,400 and 30,000 (keep masks identical) and the ROIAlign kernel at the
  scorer's and YOLOv8m's maps, both modes, f32 and bf16; the bench leg
  ``object_scorer_256px_20det`` (ResNet-18 with the ImageNet stem, bf16,
  256 px, batch 128, 20 detections an image, ``build_object_scorer`` under
  its graph, graph = eager bit for bit, f32 card against CPU); YOLOv8m @640
  (ultralytics' yolov8m.yaml widths, 80 classes, seeded weights and
  BatchNorm statistics): ``YoloV8JaxAdapter`` (its forward, selection and
  NMS kernel one graph replay an image) -> ``BoxFeaturesExtractor`` on
  ``backbone_p5`` (ROIAlign kernel) over 32 images -> ``MDLatentSpace`` ->
  ``ObjectLevelInference`` and ``BoxInferenceYolo`` on 16 in-distribution
  and 16 noise images -> the MC-DropBlock route (kernel 1) on 8.
* DETR and segmentation (``detr_r50_flow``, ``deeplabv3p_r50_seg``): DETR-R50
  (facebook/detr-resnet-50's config, 91 labels, seeded random weights from a
  local ``transformers.DetrConfig``) at 800 x 1216, f32: ``convert_hf_detr``
  -> ``DetrAdapter`` (held to HF's forward and to ``HFDetrAdapter`` on the
  card) -> ``BoxFeaturesExtractor`` on the backbone map (ROIAlign kernel) and
  its MC route (kernel 1) over 32 images -> MD and LaREM -> the open-set
  evaluation (``get_overall_open_set_results``, ``get_gtu_uu_metrics``, the
  native matcher held to the numpy loops) against a seeded synthetic COCO
  ground truth; DeepLabV3+-R50 OS16 (VOC defaults, 21 classes) at 512 x 512,
  f32: ``build_pixel_uncertainty_scorer`` at batch 4 and S = 8 under its
  graph, then LaREx over the (4, 32, 32, 256) ``pre_pool`` tap
  (``FastMCDSamplesExtractor`` -> ``get_dl_h_z`` (kernel 1) -> MD ->
  ``build_larex_scorer`` fused (kernel 2) and two-step (kernel 1)).
* The dataset scoring service and data parallelism (``score_dataset_rn18``,
  ``dp_world1``): ``ScoringService.score_dataset`` over 10,000 seeded uint8
  CIFAR-shaped images (the native gather of ``data.PrefetchLoader`` into
  pinned memory, 19 batches of 512 and a tail of 272 padded to 512, 8 in
  flight) into the headline LaREx scorer, both routes under the graph (kernels
  1 and 2), its outputs equal bit for bit to the scorer called batch by batch
  with the service's generators and to the numpy gather's run; img/s against
  the scorer's replay rate and the loader's, and ``device_healthcheck``. Then,
  in a one-process NCCL world, ``parallel.data_parallel_scorer`` (both
  routes), ``fit_md_sharded``, the sharded KNN and KDE and one
  ``sharded_train_step`` of the headline ResNet-18 in f32 against their
  single-device counterparts, and each one's overhead.
* The model-parallel layer (``mp_world1``), in a one-process NCCL world:
  the production Llama (bf16 ``use_flash`` and int8 + KV8 + fused qkv) made
  tensor-parallel by ``parallel.shard_llama_params`` and served by
  ``ContinuousBatchingEngine`` to 8 prompts of 150-300 tokens (kernel 3 for
  the int8 projections, kernel 4 for the chunked prefills of 128), greedy
  tokens equal to the unsharded engine's; ``ring_attention`` on (1, 16,
  4096, 128) bf16 against dense attention; ``sharded_moe_ffn`` at Mixtral's
  FFN width against ``moe_ffn``; ``pipeline_apply`` against its block; and
  ``fsdp_train_step`` on the headline ResNet-18 and the Llama cut to 2
  layers against plain Adam steps; each one's overhead.

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
main paths launched (the LaREx slice, user flow and evaluation layer, the int8 leg, the
ViT and the trained model's LaREx, the object scorer, the YOLOv8m and DETR flows, the
DeepLab segmentation path, the dataset scoring service and the data-parallel scorer, the tensor-parallel
serving engine, the Llama slice,
semantic entropy, speculative decoding, the two serving cells and the MoE
slice, each counted from zero just before it runs), the kernels inside each
graph replay included.

Every phase prints one JSON line. Any failed check raises, so the script
exits non-zero and never prints its last line, which on success is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
before doing anything. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
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
# The LaREx user flow at bench.py's larex_resnet50_224px width (bench.py:
# 111-169, 1192-1198): ResNet-50, 10 classes, bf16, channels_last, 224 x 224
# x 3 images in batches of 128, the (128, 7, 7, 2048) pre_pool tap, the
# headline's S, p, block, k and PCA-256; 384 in-distribution images to fit
# (the bench's n_fit), two out-of-distribution batches to score.
RN50_IMG, RN50_BATCH, RN50_FIT, RN50_OOD = 224, 128, 384, 2
FLOW_DETECTORS = ("MD", "KDE", "cMD", "KNN", "GMM")
FLOW_WINDOWS, FLOW_CALLS = 6, 10  # timed windows of calls per variant, in turns
# The scorer against LaRExInference.get_score with the same keep-weights,
# relative to max|score|, on every route: the two-step routes run the same
# f32 operations on the same device; the fused routes' entropies sum each
# product in another order (within FUSED_RTOL / FUSED_ATOL of the two-step
# ones), which PCA and the Mahalanobis score leave near 1e-6 (PERF.md §6).
FLOW_SCORER_REL = 1e-5
# The flow in f32 at batch 8, card (TF32 off) against CPU, with the card's
# PCA and detector states: relative to the largest magnitude of each output.
FLOW_XCHECK_IMAGES, FLOW_XCHECK_REL = 8, 1e-4
# The evaluation layer at the same width (eval_rn50): in-distribution train
# and valid images (uniform in [0, 1)) and two out-of-distribution sets,
# |N(0, 1)| and uniform in [0, 4), made at the flow's batch; every baseline
# of calculate_all_baselines with the reference's hyperparameters, pred_h /
# mi from MC_SAMPLES stochastic forwards, the LaRED / LaREM / LaREK sweep at
# two PCA widths.
EVAL_SPLITS = {"train": 4096, "valid": 1024, "noise_abs": 1024, "uniform_x4": 1024}
EVAL_BASELINES = ("vim", "msp", "raw", "knn", "energy", "ash", "gen", "react", "dice", "dice_react", "mdist", "ddu")
EVAL_CFG = dict(num_classes=NUM_CLASSES, k_neighbors=50, ash_percentile=85, gen_gamma=0.1, react_percentile=90,
                dice_percentile=90, n_pca_components=[64, 256])
EVAL_POSTPROCESSORS = ("LaRED", "LaREM", "LaREK")
# Card (TF32 off) against CPU, both f32, relative to max(largest score, 1):
# the logit and shaping scorers sum 10- and 2048-long products in other
# orders; vim and ddu go through an eigenbasis or Cholesky factors of 2048 x
# 2048 covariances from other solvers. mdist's scores are differences of
# quadratic forms about 200 times larger than themselves (the precision's
# kept eigenvalues span 410x): its rounding is that ratio times f32's eps,
# several times over (PERF.md §6, eval_rn50).
EVAL_XCHECK_REL = {"mdist": 1e-3, "vim": 1e-4, "ddu": 1e-4}
EVAL_XCHECK_REL_DEFAULT = 1e-5
# Where the random network's features leave the fit undetermined in f32
# (ViM's subspace boundary among eigenvalues at 1e-8 of the largest, DDU's
# jitter rung on singular class covariances; PERF.md §6), each side's own
# fit is recorded, and what is held is the card's state scored on the CPU
# and the parts of the fit the data determine (ViM's u, DDU's means).
EVAL_STATE_SHARED = ("vim", "ddu")
EVAL_MAIN_PATH_REL = 1e-6  # calculate_all_baselines against the same detector fitted alone, on the card
AUROC_ATOL = 1e-6  # torch_auroc (float32 ranks) against the numpy curve's area
# The int8 PTQ leg (bench.py:1182-1190, larex_resnet18_32px_int8): the
# headline ResNet-18 at batch 512, weights and statistics randomised from
# the seed, calibrated on 256 images at the 99.9th percentile, fitted on the
# bench's n_fit = 512 images. Card against CPU: w_q, w_scale and bias bit
# for bit; x_scale equal at the stem (its input is the images) and within
# INT8_XSCALE_REL elsewhere (the f32 mirror's convolutions sum in other
# orders, about 1e-6 relative a layer); on the same qparams the int32 sums
# are exact on both devices and the elementwise passes the same IEEE f32
# operations, so only the mean pool and the head sum in other orders:
# logits and taps within INT8_XCHECK_REL of their largest magnitude. The
# int8-vs-f32 bars are tests/test_quant_vision.py's: the pre_pool taps'
# correlation > 0.99 (:110) and AUROC within 0.05 (:136-137). The LaREM
# scores' correlation is recorded beside it, not held to 0.99: whitening 256
# entropy dimensions magnifies the codes' rounding (0.96 on an H100 80GB
# HBM3 at 700 W, where the taps correlate to 0.996).
INT8_CALIB, INT8_FIT, INT8_QUANTILE, INT8_XCHECK = 256, 512, 99.9, 32
INT8_XSCALE_REL, INT8_XCHECK_REL, INT8_CORR, INT8_AUROC_DELTA = 1e-5, 1e-5, 0.99, 0.05
INT8_WINDOWS, INT8_CALLS = 6, 20  # scorer windows per variant (in turns) and calls a window
# ViT-B/16 @224 (google/vit-base-patch16-224's config.json: hidden 768, 12
# layers, 12 heads, patch 16, 1,000 labels, layer_norm_eps 1e-12, exact
# GELU, CLS pooling), batch 64, 512 images to fit PCA-256 and LaREM.
VIT_CFG = dict(num_classes=1000, patch_size=16, d_model=768, num_layers=12, num_heads=12, use_cls_token=True,
               pool="cls", exact_gelu=True, ln_eps=1e-12)
VIT_IMG, VIT_BATCH, VIT_FIT = 224, 64, 512
# Training: fit_classifier on the headline ResNet-18, one fixed batch of
# 128, Adam 1e-3, 20 steps then 20 more; one SGD step card against CPU on 32
# images (f32, TF32 off): the loss to 1e-5 relative; every gradient to 1e-3
# of its tensor's largest magnitude (cuDNN's backward algorithms and
# BatchNorm's backward, which subtracts two near-equal sums over 32 x 32 x
# 32 values, in other orders); the running statistics to 1e-5 absolute.
TRAIN_BATCH, TRAIN_STEPS, TRAIN_XCHECK, TRAIN_PCA = 128, 20, 32, 64
TRAIN_XCHECK_REL = {"loss": 1e-5, "grads": 1e-3, "stats_abs": 1e-5}
# The object level (object_scorer_rn18, bench.py:197-238, the leg
# object_scorer_256px_20det): ResNet-18 with the ImageNet stem, 10 classes,
# bf16, channels_last, 256 px images in batches of 128, 20 detections an
# image made as bench.py's make_dets makes them, MDLatentSpace on 1,024 x 512
# seeded rows, ROIAlign out 7 on the (128, 8, 8, 512) pre_pool tap. The f32
# scorer at batch 4, card (TF32 off) against CPU: OBJ_XCHECK_REL of the
# largest |score| (the convolutions sum in other orders).
OBJ_IMG, OBJ_BATCH, OBJ_MAX_DET, OBJ_FIT, OBJ_XCHECK = 256, 128, 20, 1024, 4
OBJ_XCHECK_REL = 1e-4
OBJ_WINDOWS, OBJ_CALLS = 5, 10  # timed windows of scorer calls, graph and eager in turns
# YOLOv8m at 640 px (ultralytics' yolov8m.yaml: widths 48 / 96 / 192 / 384 /
# 576, repeats 2 / 4, 80 classes, 8,400 anchors), seeded weights and
# randomised BatchNorm statistics: the adapter's NMS (iou 0.7, max_det 300,
# ultralytics' defaults) at predict_conf 0.25, ROIAlign out 7 on backbone_p5,
# 32 fit images, 16 in-distribution and 16 noise images scored, the MC route
# (S = 16, DropBlock p 0.5, block 3) on 8 images. One image's f32 forward,
# card (TF32 off) against CPU, within YOLO_XCHECK_REL of the largest value.
YOLO_IMG, YOLO_FIT, YOLO_SCORE, YOLO_MC, YOLO_CONF = 640, 32, 16, 8, 0.25
YOLO_XCHECK_REL = 1e-4
# DETR-R50 (facebook/detr-resnet-50's config: d_model 256, 8 heads, 6 + 6
# layers, FFN 2,048, 100 queries, 91 labels, the HF-native ResNet-50
# backbone), built from a local DetrConfig with random weights from the seed
# and randomised frozen-BatchNorm statistics, f32: 32 images at 800 x 1216
# (COCO's short side 800, the long side held to a multiple of 32), a (1, 2048,
# 25, 38) backbone map and 950 encoder tokens. predict_conf 0.0 keeps all 100
# queries: with random weights the best class score is near 1 / 92, below the
# adapter's default 0.25. ROIAlign out 7 on the backbone map, the MC route on
# every image; MD on the ROI means and LaREM on the MC entropies fitted on the
# first 16 images; the other 8 in-distribution and 8 noise images scored and
# evaluated open-set against a seeded synthetic COCO ground truth built around
# the detections (91 known classes; an unknown class on the noise images).
# The port's forward against HF's on the card: logits within DETR_LOGITS_REL of
# their largest magnitude, boxes within DETR_BOXES_ATOL.
DETR_IMG, DETR_IMAGES, DETR_FIT, DETR_CONF = (800, 1216), 32, 16, 0.0
DETR_LOGITS_REL, DETR_BOXES_ATOL = 1e-4, 1e-4
# DeepLabV3+ with the JAX package's defaults, the paper's VOC setting (Chen et
# al. 2018): 21 classes, ResNet-50 (3, 4, 6, 3) bottleneck, output stride 16,
# ASPP 256 at rates 6 / 12 / 18, low-level 48, decoder dropout 0.5; seeded
# lecun-normal kernels and randomised BatchNorm statistics; f32 at 512 x 512.
# The pixel scorer at batch 4 and S = 8; LaREx over the (4, 32, 32, 256)
# pre_pool tap: S = 16 DropBlock samples (p 0.5, block 3) of SEG_FIT images
# in batches of 4, MD, both scorer routes at batch 4. One image's
# f32 forward, card (TF32 off) against CPU, within SEG_XCHECK_REL of the
# largest logit.
SEG_IMG, SEG_BATCH, SEG_PIXEL_MC, SEG_FIT, SEG_XCHECK_REL = 512, 4, 8, 384, 1e-4
# The fused scorer against the two-step one on the same keep-weights,
# relative to max |score|: the fused entropies sum each product in another
# order (within FUSED_RTOL / FUSED_ATOL), and LaREM on the 256 unreduced
# entropies (no PCA) magnifies that more than FLOW_SCORER_REL allows after
# PCA-256 (2.5e-5 on an H100 80GB HBM3 at 700 W).
SEG_ROUTES_REL = 1e-4
# The dataset scoring service on the headline scorer (both routes, under its
# graph): CIFAR-10's test-split size of seeded uint8 32x32x3 images, 19
# batches of BATCH and a tail of 272 padded to BATCH, a window of 8 batches
# in flight; the timed runs of the two routes in SERVE_TURNS. The loader
# alone is timed over the same images, into pinned host memory and to the card.
SERVE_IMAGES, SERVE_WINDOW = 10_000, 8
SERVE_TURNS = ("two_step", "fused", "fused", "two_step", "two_step", "fused")
# The data-parallel helpers in a one-process NCCL world: the sharded LaREM
# fit against MDLatentSpace on the same rows (means 1e-6; scores within
# DP_MD_REL of max |score|: E[x x^T] - m m^T against the centred product,
# through a pseudo-inverse), KNN (k = DP_KNN_K) and KDE against the dense
# scores (KDE 1e-5 relative), and one sharded SGD step of the headline
# ResNet-18 in f32 at DP_TRAIN_BATCH images against a plain autograd step
# (loss 1e-6 relative; each parameter's update within DP_STEP_REL of its
# largest entry: two runs read 4.5e-5 and 2.1e-5 on an H100 80GB HBM3 at
# 700 W).
DP_MD_REL, DP_KNN_K, DP_TRAIN_BATCH, DP_STEP_REL, DP_LR = 1e-3, 50, 128, 2e-4, 0.1
# The model-parallel layer in a one-process NCCL world (mp_world1). tp +
# engine: the production Llama at full width (LLM_CFG), bf16 use_flash and
# int8 + KV8 + fused qkv, made tensor-parallel on a model axis of 1 and
# served by ContinuousBatchingEngine (chunked prefill of 128: kernel 4) to 8
# prompts of 150-300 tokens from RandomState(17), 16 greedy tokens each.
# sp: ring attention on (1, 16, 4096, 128) bf16 against dense causal
# attention in f32, within MP_RING_REL of max |dense| (the bf16 output's
# one rounding, 2^-9 relative, twice). ep: sharded_moe_ffn at Mixtral's FFN
# width (d 4,096, h 14,336, 8 experts, top-2) on 2,048 f32 tokens against
# moe_ffn, MP_MOE_REL of max (the same einsums at world 1). pp: a one-stage
# pipeline of x + tanh(x @ w), w (2048, 2048), a (4096, 2048) batch in 8
# microbatches against the block on the whole batch, MP_PIPE_REL of max
# (products of 512 rows against 4,096). fsdp: one Adam step (lr MP_LR) of the
# headline ResNet-18 in f32 on 128 images and of LLM_CFG cut to 2 layers in
# f32 on (4, 512) tokens, against a plain autograd step of the same
# arithmetic: loss 1e-6 relative, every update within MP_ADAM_REL of the
# rate (deterministic cuDNN in the leg).
MP_TRAFFIC = dict(seed=17, requests=8, prompts=(150, 301), budgets=(16, 17))
MP_ENGINE = dict(num_slots=8, max_ctx=384, max_new_tokens=16, chunk_tokens=8, prefill_chunk=128)
MP_RING, MP_RING_REL = (1, 16, 4096, 128), 2**-8
MP_MOE, MP_MOE_REL = dict(d_model=4096, d_hidden=14336, num_experts=8, top_k=2, tokens=2048), 1e-6
MP_PIPE, MP_PIPE_REL = dict(d=2048, batch=4096, micro=8), 1e-5
MP_FSDP_IMAGES, MP_FSDP_LM_LAYERS, MP_FSDP_LM_TOKENS = 128, 2, (4, 512)
MP_LR, MP_ADAM_REL = 1e-3, 1e-3
# NMS kernel against plain: random boxes at 640 px, sides 8-200 px.
NMS_SIZES, NMS_THRESHOLDS = (1000, 8400, 30000), (0.45, 0.7)
NMS_IOU_OPERATIONS = 13  # f32 operations an IoU and its compare (csrc/nms.cu)
# YOLOv8's NMS input as YoloV8JaxAdapter builds it: all 8,400 anchors at
# 640 px, each moved by class * max_wh (80 classes, 7,680), the candidates
# (a share of them) first by score, the rest after them at -inf; IoU 0.7.
NMS_YOLO = dict(anchors=8400, classes=80, max_wh=7680.0, candidates=0.3, iou=0.7)
# The scan's serial floor: a column block of 64 boxes waits for the one
# before, one hand-off between threads (a barrier or a shared counter) and
# one shared-memory round trip a block (and, walking kept boxes one at a
# time, one shuffle a kept box); cycles each, assumed, not measured, at the
# card's largest SM clock.
NMS_FLOOR_CYCLES = dict(hand_off=30, shared=30, shuffle=30)
# ROIAlign kernel against plain: f32 within 1e-5 of max |feature|; bf16
# within ROI_BF16_REL of it (the plain form rounds its weights and its
# intermediate to bf16, the kernel sums f32 products of the bf16 map).
ROI_F32_REL, ROI_BF16_REL = 1e-5, 1e-2

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
# JetBrains/Mellum2-12B-A2.5B-Instruct config.json, at the shapes of the
# benchmark cell mellum2_a2.5b.complete8: 64 experts of 896 over 2,304, top
# 8; 32 / 4 heads of 128, a window of 1,024 on three layers of four; four
# 512-token prefill lanes at once, their q_start over the engine's
# 12,800-slot cache.
MELLUM = dict(d_model=2304, expert_width=896, num_experts=64, top_k=8, num_heads=32, num_kv_heads=4, head_dim=128,
              window=1024, lane=512, max_ctx=12800)
MELLUM_LANE_STARTS = [0, 512, 4096, 11776]
# The grouped experts' cases (kernel_moe_grouped): Mellum's decode step and
# one to four prefill lanes; Mixtral's 16-token decode step and 2,048-token
# prefill (4 x 512; both the moe_slice phase's) at its expert widths.
MOE_GROUPED_TOKENS = {"decode_8": 8, "lane_512": 512, "lanes_1024": 1024, "lanes_1536": 1536, "lanes_2048": 2048}
MIXTRAL_EXPERTS = dict(d_model=4096, expert_width=14336, num_experts=8, top_k=2, tokens=[16, 2048])
# The grouped experts against their twin, relative to the output's RMS: both
# round the f32 hidden product to bf16 before the down projection, and a sum
# in another order rounds a hidden value to the neighbouring bf16 now and
# then. A pair sent to the wrong expert or a tile left out moves its row by
# about its RMS.
MOE_GROUPED_REL = 2e-2
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
# Pythia's depth is cut from 24 layers to 12, so that the run keeps its time
# with the serving phases; the width stays Pythia-1.4b's.
PYTHIA_LAYERS = 12
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW = 16, 64, 64
FAMILY_HF_SHAPE = (2, 64)  # tokens of the HF-against-port logits check
FAMILY_XCHECK_LAYERS, FAMILY_XCHECK_STEPS = 2, 4
# Serving through ContinuousBatchingEngine. Cell 1, the 7B-class int8
# serving leg (bench.py:377-378 _7B_CFG, :469-537): int8 weights + KV8 +
# fused qkv / gate|up, bf16, use_flash; 24 requests from RandomState(11),
# prompts 128-448, budgets 24-56; random int8 weights, the other tensors
# 0.01 + 0.005 N(0, 1), as bench.py:384-418 fills them.
SERVE7B_CFG = dict(vocab_size=32000, num_layers=32, num_heads=32, num_kv_heads=8, d_model=4096, hidden_dim=11008,
                   max_len=2048)
SERVE7B_ENGINE = dict(num_slots=8, max_ctx=512, max_new_tokens=64, chunk_tokens=8, prefill_chunk=128,
                      prefill_lanes=4, admission="lpt")
SERVE7B_TRAFFIC = dict(seed=11, requests=24, prompts=(128, 449), budgets=(24, 57))
# Cell 2, 96 requests of mixed traffic against static batching (bench.py:
# 627-744): the production Llama in bf16, dense attention; RandomState(5),
# prompts 16-192, budgets 8-64; the baseline three generate_batch calls of
# 32 rows with pad_to=192.
MIXED_ENGINE = dict(num_slots=32, max_ctx=320, max_new_tokens=64, chunk_tokens=8, prompt_bucket=64, admission="lpt",
                    defer_fetch=True)
MIXED_TRAFFIC = dict(seed=5, requests=96, prompts=(16, 193), budgets=(8, 65))
MIXED_STATIC_PAD = 192
SERVE_PASSES = 3  # timed passes per drain, in turns
SERVE_CHECK_LAYERS, SERVE_CHECK_REQUESTS = 2, 8
# Card against CPU (serve_check): a 256-token system prompt shared by every
# request (so the prefix cache hits), suffixes of 20-120 tokens, 4 new tokens.
SERVE_XCHECK = dict(system=256, suffix=(20, 121), requests=4, new=4)
# The speculative engine (bench.py:874-950): the distilled pair (the
# target's o / down of blocks 4.. scaled by 0.03, the draft its first 4
# blocks, norm_f and lm_head), gamma 4, shared-system-prompt traffic from
# RandomState(7): a 256-token system prompt, suffixes of 8-64 tokens,
# budgets 16-48, 24 requests. Cell 1 runs it on the 7B int8 model with
# chunked prefill of 128 in lanes of 4 (the bench's 64 never reaches kernel
# 4); the bench's own leg on the production Llama in bf16 keeps its 64.
SPEC_TRAFFIC = dict(seed=7, system=256, suffixes=(8, 65), budgets=(16, 49), requests=24)
SPEC7B_ENGINE = dict(num_slots=8, max_ctx=512, max_new_tokens=48, chunk_tokens=15, prefill_chunk=128,
                     prefill_lanes=4, prefix_cache=True)
SPEC1B_ENGINE = dict(num_slots=8, max_ctx=448, max_new_tokens=48, chunk_tokens=15, prefill_chunk=64,
                     prefix_cache=True)
SPEC_ENGINE_PASSES = 2  # timed passes per engine, in turns
# The fused offline drain: cell 2 as bench.py:708-731 runs it (chunked
# prefill of 64, 4 decode steps an iteration, 8 lanes, lpt), cell 1 in lanes
# of 4 x 128 (kernel 4's KV8 variant in lanes chosen on the device, kernel 3
# at 512 rows).
FUSED_MIXED_ENGINE = dict(num_slots=32, max_ctx=320, max_new_tokens=64, prompt_bucket=64, prefill_chunk=64,
                          chunk_tokens=4, admission="lpt")
FUSED_MIXED_LANES, FUSED_7B_LANES = 8, 4
# UncertaintyServer (bench.py:1048-1125): the production Llama in bf16 with
# dense attention, all six methods, 16 prompts of 24-64 tokens (a fresh set
# a pass), 4 samples of 32 tokens at temperature 0.9, 24 slots, chunks of
# 16, bucketed prefill of 64, max_ctx 128; the deberta-v2-large judge.
UNC_PROMPTS, UNC_SAMPLES, UNC_NEW, UNC_PASSES = 16, 4, 32, 2
UNC_ENGINE = dict(num_slots=24, max_ctx=128, chunk_tokens=16, prefill_chunk=None, prompt_bucket=64)
# GenerationService: 32 requests of 16-160 tokens from 4 threads, batches
# of up to 8, 16 new tokens.
SERVICE_REQUESTS, SERVICE_THREADS, SERVICE_BATCH, SERVICE_NEW = 32, 4, 8, 16
SPEC_CHECK_LAYERS = 2
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
        # the RN50 flow's get_dl_h_z over the fit set and its scorer's batch
        "rn50_fit": (torch.randn((RN50_FIT, MC_SAMPLES, 2048), generator=gen, device=device), K),
        "rn50_score": (torch.randn((RN50_BATCH, MC_SAMPLES, 2048), generator=gen, device=device), K),
        # eval_rn50's get_dl_h_z over its train split and each 1,024-image split
        "eval_train": (torch.randn((EVAL_SPLITS["train"], MC_SAMPLES, 2048), generator=gen, device=device), K),
        "eval_split": (torch.randn((EVAL_SPLITS["valid"], MC_SAMPLES, 2048), generator=gen, device=device), K),
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
                            "n64": (BATCH, 64, 512), "n512": (64, 512, 512),
                            # the RN50 flow's get_dl_h_z over the fit set and its scorer's batch
                            "rn50_fit": (RN50_FIT, MC_SAMPLES, 2048),
                            "rn50_score": (RN50_BATCH, MC_SAMPLES, 2048),
                            # eval_rn50's train split and each 1,024-image split
                            "eval_train": (EVAL_SPLITS["train"], MC_SAMPLES, 2048),
                            "eval_split": (EVAL_SPLITS["valid"], MC_SAMPLES, 2048),
                            # vit_b16's encoder_tokens (the int8 leg's fit and scorer are the headline's shape)
                            "vit_b16": (VIT_BATCH, MC_SAMPLES, VIT_CFG["d_model"])}.items():
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
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda, marginal_entropy_plain
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
        # the RN50 flow's fused scorer: the bf16 tap as the forward leaves it
        "rn50_224_b128_bf16": (RN50_BATCH, 7, 7, 2048, MC_SAMPLES, bf16),
        # vit_b16's fused scorer on the f32 (64, 14, 14, 768) encoder_tokens
        "vit_b16": (VIT_BATCH, VIT_IMG // 16, VIT_IMG // 16, VIT_CFG["d_model"], MC_SAMPLES, f32),
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
        if name == "rn50_224_b128_bf16":
            # Recorded, not required: on uniform maps at 262,144 columns a few
            # dozen columns hold near-tied samples, and there both f32 routes
            # stray from samples formed in f64 by up to a few 1e-3, the kernel
            # no more than bmm. The bound is required on the flow's own tap
            # (image_flow_rn50_phase).
            wt, fm = copies[0]
            got, plain = fused_mc_entropy(wt, fm, K), fused_mc_entropy_plain(wt, fm, K)
            exact = marginal_entropy_plain(torch.bmm(wt.double(), fm.reshape(b, h * w, c).double()) / (h * w), K)
            beyond = lambda x, ref: int(((x - ref).abs() > FUSED_ATOL + FUSED_RTOL * ref.abs()).sum())
            timing[name]["conditioning"] = {
                "columns": b * c, "kernel_vs_plain_max_abs_err": float((got - plain).abs().max()),
                "columns_beyond_bound_vs_plain": beyond(got, plain),
                "kernel_vs_f64_max_abs_err": float((got - exact).abs().max()),
                "plain_vs_f64_max_abs_err": float((plain - exact).abs().max()),
                "columns_beyond_bound_vs_f64": {"kernel": beyond(got, exact), "plain": beyond(plain, exact)}}
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


def rn50_model(dtype, weights_of=None, device=None):
    """bench.py's ResNet-50 (10 classes) with seeded random weights, built
    where the port builds by default (the GPU); or, given such a model, a
    copy of its weights in ``dtype`` on ``device``."""
    from runia_core_tpu_torch.models import ResNet50

    model = ResNet50(num_classes=NUM_CLASSES, dtype=dtype, device=device)
    if weights_of is None:
        model.init_weights(torch.Generator(device=model.head.weight.device).manual_seed(SEED + 50))
    else:
        model.load_state_dict({name: t.to(model.head.weight.device) for name, t in weights_of.state_dict().items()})
    return model.to(memory_format=torch.channels_last).eval()


def rn50_forward(model, device=None):
    """``images -> (logits, {"pre_pool": NHWC tap})`` through
    ``tap_torch_model``: a forward hook on the last bottleneck block
    (NCHW in channels_last memory, so the NHWC view is contiguous)."""
    from runia_core_tpu_torch.extraction import tap_torch_model

    tapped = tap_torch_model(model, ("stage4_block2",), tap_aliases={"pre_pool": "stage4_block2"}, device=device)

    def forward(images):
        (logits, _), taps = tapped(images)
        return logits, {"pre_pool": taps["pre_pool"].permute(0, 2, 3, 1)}

    return forward


def flow_category(name: str) -> str:
    """``kernel_category`` with the two entropy kernels and the convolutions apart."""
    for label, needle in (("marginal_entropy (kernel 1)", "marginal_entropy_kernel"),
                          ("fused_mc_entropy (kernel 2)", "fused_mc_entropy_kernel"),
                          ("convolution", "conv"), ("convolution", "fprop")):
        if needle in name:
            return label
    return kernel_category(name)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (got moved to want's device)."""
    return float((got.to(want.device) - want).abs().max() / want.abs().max())


def image_flow_rn50_phase(device, gen, smi: str) -> dict:
    """The LaREx user flow at the RN50 @224 width, through the port's entry
    points: (1) tap_torch_model's pre_pool equals build_tapped_forward's bit
    for bit; (2) FastMCDSamplesExtractor over the 384 fit images ->
    get_dl_h_z (kernel 1) -> PCA-256 -> MD, KDE, cMD, KNN and GMM ->
    thresholds; (3) two OoD batches through LaRExInference(mcd_sampler=) under
    each detector and build_larex_scorer on both routes, graph and eager
    (kernel 1 and kernel 2), the scorer equal to get_score on injected
    keep-weights; (4) MCDSamplesExtractor, 16 stochastic forwards; (5) the
    flow in f32 at batch 8, card against CPU. Kernel launches are counted
    over (2)-(3), then the times are taken."""
    import warnings

    from runia_core_tpu_torch.detectors import postprocessors_dict
    from runia_core_tpu_torch.evaluation import get_dl_h_z
    from runia_core_tpu_torch.extraction import FastMCDSamplesExtractor, Hook, MCDSamplesExtractor
    from runia_core_tpu_torch.inference import LaRExInference, build_larex_scorer, get_baselines_thresholds
    from runia_core_tpu_torch.models import build_tapped_forward
    from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue
    from runia_core_tpu_torch.ops.entropy import marginal_entropy
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda, marginal_entropy_plain
    from runia_core_tpu_torch.ops.mc_entropy_cuda import fused_mc_entropy, fused_mc_entropy_plain, mc_dropblock_weights
    from runia_core_tpu_torch.reduction import apply_pca_ds_split, pca_transform
    from runia_core_tpu_torch.sampling import MCSamplerModule, mc_dropblock_samples
    from runia_core_tpu_torch.utils import CudaGraph, cuda_time_ms, device_profile

    def images(n):
        return torch.rand((n, RN50_IMG, RN50_IMG, 3), generator=gen, device=device)

    side = RN50_IMG // 32  # the pre_pool tap's height and width
    model = rn50_model(torch.bfloat16)
    require(model.head.weight.device == device, f"the default device is the card: {model.head.weight.device}")
    forward = rn50_forward(model)
    record = {"card": smi}

    # ---- (1) the tap ----
    x = images(RN50_BATCH)
    logits, taps = forward(x)
    want_logits, want = build_tapped_forward(model)(x)
    hook = Hook("pre_pool").capture(taps)
    require(tuple(taps["pre_pool"].shape) == (RN50_BATCH, side, side, 2048),
            f"the pre_pool tap {tuple(taps['pre_pool'].shape)}")
    require(torch.equal(taps["pre_pool"], want["pre_pool"]) and torch.equal(logits, want_logits),
            "tap_torch_model's pre_pool and logits equal build_tapped_forward's bit for bit")
    require(torch.equal(hook.output, want["pre_pool"]) and hook.output.data_ptr() != taps["pre_pool"].data_ptr(),
            "Hook.capture keeps a copy")
    del hook, taps, want

    # ---- (2) fit, counted from here ----
    marginal_entropy_cuda.launches = fused_mc_entropy.launches = conv_epilogue.launches = 0
    fit_loader = [(images(RN50_BATCH), torch.randint(0, NUM_CLASSES, (RN50_BATCH,), generator=gen, device=device))
                  for _ in range(RN50_FIT // RN50_BATCH)]
    extractor = FastMCDSamplesExtractor(
        forward, "Conv", "fullmean", mcd_nro_samples=MC_SAMPLES, dropblock_probs=DROP_PROB,
        dropblock_sizes=BLOCK_SIZE, return_stds=True, return_raw_predictions=True, return_gt_labels=True,
        generator=gen)
    torch.cuda.synchronize()
    start = time.perf_counter()
    samples = extractor.get_ls_samples(fit_loader)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - start
    for key, shape in (("latent_space_means", (RN50_FIT * MC_SAMPLES, 2048)), ("stds", (RN50_FIT * MC_SAMPLES, 2048)),
                       ("raw_preds", (RN50_FIT, NUM_CLASSES)), ("gt_labels", (RN50_FIT,))):
        require(tuple(samples[key].shape) == shape and samples[key].device == device
                and bool(torch.isfinite(samples[key].float()).all()), f"extractor {key}: finite {shape} on the card")
    h_joint, h = get_dl_h_z(samples["latent_space_means"], MC_SAMPLES)
    launches = {"marginal_entropy_get_dl_h_z": marginal_entropy_cuda.launches}
    require(launches["marginal_entropy_get_dl_h_z"] > 0 and h.is_cuda, "get_dl_h_z runs kernel 1 on the card")
    h_pca, pca_state = apply_pca_ds_split(h, PCA_DIMS)
    labels = samples["raw_preds"].argmax(dim=1)
    detectors = {}
    with warnings.catch_warnings(record=True) as empty:  # classes no fit image was predicted as
        warnings.simplefilter("always")
        for name in FLOW_DETECTORS:
            detectors[name] = postprocessors_dict[name]()
            detectors[name].setup(h_pca, ind_train_labels=labels)
    ind_scores = {name: det.postprocess(h_pca, pred_labels=labels) for name, det in detectors.items()}
    thresholds = get_baselines_thresholds(["raw", *FLOW_DETECTORS], ind_scores)
    for name, scores in ind_scores.items():
        require(tuple(scores.shape) == (RN50_FIT,) and bool(torch.isfinite(scores).all()),
                f"{name}: finite in-distribution scores")
    record["fit"] = {"images": RN50_FIT, "extract_s": extract_s, "h_shape": list(h.shape),
                     "h_joint_mean": float(h_joint.mean()), "pca_dims": PCA_DIMS,
                     "class_counts": torch.bincount(labels, minlength=NUM_CLASSES).tolist(),
                     "empty_class_warnings": len(empty), "gmm_jitter_rung": float(detectors["GMM"].gmm.jitter.max()),
                     "thresholds": thresholds}

    # ---- (3) score two OoD batches, each detector, both scorer routes ----
    ood = [torch.randn((RN50_BATCH, RN50_IMG, RN50_IMG, 3), generator=gen, device=device).abs()
           for _ in range(RN50_OOD)]
    inference = {name: LaRExInference(forward, det, DROP_PROB, BLOCK_SIZE, MC_SAMPLES, mcd_sampler=MCSamplerModule,
                                      pca_transform=pca_state, generator=gen)
                 for name, det in detectors.items()}
    flagged = {}
    for name, inf in inference.items():
        got = []
        for batch in ood:
            if name == "cMD":  # get_score passes no predicted labels (nor does JAX's): the pieces by hand
                mc, _ = inf.get_layer_mc_samples(batch)
                got.append(detectors[name].postprocess(pca_transform(pca_state, marginal_entropy(mc, K)),
                                                       pred_labels=forward(batch)[0].argmax(dim=1)))
            else:
                got.append(inf.get_score(batch)[1])
        scores = torch.cat(got)
        require(tuple(scores.shape) == (RN50_OOD * RN50_BATCH,) and bool(torch.isfinite(scores).all()),
                f"LaRExInference {name}: finite OoD scores")
        flagged[name] = float((scores < thresholds[name]).float().mean())
    launches["marginal_entropy_larex_inference"] = marginal_entropy_cuda.launches - launches[
        "marginal_entropy_get_dl_h_z"]
    scorers = {(mode, fused): build_larex_scorer(forward, pca_state, detectors["MD"].state, MC_SAMPLES, DROP_PROB,
                                                 BLOCK_SIZE, fused=fused, use_graph=mode == "graph")
               for mode in ("graph", "eager") for fused in (False, True)}
    k1, k2 = marginal_entropy_cuda.launches, fused_mc_entropy.launches
    for batch in ood:
        for (mode, fused), scorer in scorers.items():
            with no_host_sync() if mode == "graph" else contextlib.nullcontext():
                out, scores = scorer(batch, generator=gen)
            require(tuple(scores.shape) == (RN50_BATCH,) and bool(torch.isfinite(scores).all())
                    and tuple(out.shape) == (RN50_BATCH, NUM_CLASSES), f"scorer {mode} fused={fused}: finite")
    weights = mc_dropblock_weights(RN50_BATCH, side, side, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, gen, device)
    want = inference["MD"].get_score(ood[0], weights=weights)[1]
    scorer_rel = {}
    for (mode, fused), scorer in scorers.items():
        with no_host_sync() if mode == "graph" else contextlib.nullcontext():
            got = scorer(ood[0], weights=weights)[1]
        scorer_rel[f"{mode}_{'fused' if fused else 'two_step'}"] = _rel(got, want)
    for route in scorer_rel:
        require(scorer_rel[route] <= FLOW_SCORER_REL,
                f"{route} scorer vs LaRExInference.get_score: rel err {scorer_rel[route]} > {FLOW_SCORER_REL}")
    launches["marginal_entropy_scorer"] = marginal_entropy_cuda.launches - k1
    launches["fused_mc_entropy_scorer"] = fused_mc_entropy.launches - k2
    totals = {"marginal_entropy": marginal_entropy_cuda.launches, "fused_mc_entropy": fused_mc_entropy.launches,
              "conv_epilogue": conv_epilogue.launches}
    launches["conv_epilogue"] = totals["conv_epilogue"]
    require(launches["marginal_entropy_scorer"] > 0 and launches["fused_mc_entropy_scorer"] > 0
            and launches["conv_epilogue"] > 0,
            f"the scorer's routes launched kernels 1 and 2, the forwards the conv-norm epilogue: {launches}")
    # Outside the count: each kernel against its plain version on the flow's
    # own inputs (the fit set's samples, an OoD batch's tap and keep-weights),
    # and the routes' entropies against each other.
    fit_clouds = samples["latent_space_means"].reshape(RN50_FIT, MC_SAMPLES, 2048)
    _, batch_taps = forward(ood[0])
    tap = batch_taps["pre_pool"].contiguous()
    h_two_step = marginal_entropy(mc_dropblock_samples(tap.float(), MC_SAMPLES, BLOCK_SIZE, DROP_PROB, "Conv",
                                                       channel_axis=3, weights=weights), K)
    h_fused = fused_mc_entropy(weights, tap, K)
    flow_errors = {
        "marginal_entropy_fit_vs_plain": float((marginal_entropy_cuda(fit_clouds, K)
                                                - marginal_entropy_plain(fit_clouds, K)).abs().max()),
        "fused_mc_entropy_vs_plain": float((h_fused - fused_mc_entropy_plain(weights, tap, K)).abs().max()),
        "fused_vs_two_step": float((h_fused - h_two_step).abs().max()),
    }
    require(flow_errors["marginal_entropy_fit_vs_plain"] <= ENTROPY_ATOL,
            f"kernel 1 vs plain on the fit set's samples: {flow_errors}")
    for plain, what in ((fused_mc_entropy_plain(weights, tap, K), "kernel 2 vs plain"),
                        (h_two_step, "fused vs two-step entropies")):
        within = (h_fused - plain).abs() <= FUSED_ATOL + FUSED_RTOL * plain.abs()
        require(bool(within.all()), f"{what} on the RN50 tap: {flow_errors}")
    record["score"] = {"ood_batches": RN50_OOD, "flagged_share": flagged, "scorer_vs_get_score_rel": scorer_rel,
                       "bound_rel": FLOW_SCORER_REL, "kernel_max_abs_err": flow_errors, "launches": launches}
    del h_two_step, h_fused, tap, batch_taps, fit_clouds

    # ---- (4) classic MC dropout: 16 stochastic forwards of one batch ----
    def stochastic(batch, generator):
        return forward(batch + 0.01 * torch.randn(batch.shape, generator=generator, device=batch.device))

    mcd = MCDSamplesExtractor(stochastic, "Conv", "fullmean", mcd_nro_samples=MC_SAMPLES,
                              return_raw_predictions=True, generator=gen)
    mcd_samples, mcd_raw = mcd.get_ls_samples([(ood[1], None)])
    spread = mcd_samples.reshape(RN50_BATCH, MC_SAMPLES, -1).std(dim=1)
    require(tuple(mcd_samples.shape) == (RN50_BATCH * MC_SAMPLES, 2048) and bool(torch.isfinite(mcd_samples).all())
            and tuple(mcd_raw.shape) == (RN50_BATCH * MC_SAMPLES, NUM_CLASSES), "MCDSamplesExtractor: finite shapes")
    require(bool((spread.amax(dim=1) > 0).all()), "MCDSamplesExtractor: every image's 16 samples differ")
    record["mcd"] = {"forwards": MC_SAMPLES, "shape": list(mcd_samples.shape), "mean_std_across_samples":
                     float(spread.mean())}
    del mcd_samples, mcd_raw, spread

    # ---- (5) the flow in f32 at batch 8: card against CPU ----
    x8 = images(FLOW_XCHECK_IMAGES)
    y8 = torch.zeros(FLOW_XCHECK_IMAGES, dtype=torch.int64, device=device)
    w8 = mc_dropblock_weights(FLOW_XCHECK_IMAGES, side, side, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, gen, device)
    kw = dict(mcd_nro_samples=MC_SAMPLES, dropblock_probs=DROP_PROB, dropblock_sizes=BLOCK_SIZE, return_stds=True,
              return_raw_predictions=True)
    sides = {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        m32 = rn50_model(torch.float32, weights_of=model, device=dev)
        out = FastMCDSamplesExtractor(rn50_forward(m32, device=dev), "Conv", "fullmean", device=dev, **kw)
        got = out.get_ls_samples([(x8.to(dev), y8.to(dev))], draws=[[w8.to(dev)]])
        h8 = get_dl_h_z(got["latent_space_means"], MC_SAMPLES)[1]
        p8 = pca_transform(pca_state.to(dev), h8)
        scores = {}
        for name in ("MD", "KNN", "GMM"):
            det = type(detectors[name])()
            det.load_state({k: v.to(dev) if isinstance(v, torch.Tensor) else v
                            for k, v in detectors[name].state.items()})
            scores[name] = det.postprocess(p8)
        sides[where] = {"samples": got["latent_space_means"], "stds": got["stds"], "logits": got["raw_preds"],
                        "entropies": h8, **scores}
        del m32
    xcheck = {key: _rel(sides["card"][key], sides["cpu"][key]) for key in sides["cpu"]}
    for key in ("MD", "KNN", "GMM"):
        require(xcheck[key] <= FLOW_XCHECK_REL, f"flow card vs CPU, {key}: rel err {xcheck[key]} > {FLOW_XCHECK_REL}")
    print(f"image_flow_rn50 card vs CPU (f32, batch {FLOW_XCHECK_IMAGES}): largest rel err "
          f"{max(xcheck[k] for k in ('MD', 'KNN', 'GMM')):.3e}", flush=True)
    record["xcheck_f32_cpu"] = {"images": FLOW_XCHECK_IMAGES, "max_rel_err": xcheck, "bound": FLOW_XCHECK_REL}
    del sides

    # ---- (6) times: extractor, get_score eager, the scorer's routes under the graph ----
    x = ood[0]
    torch.cuda.synchronize()
    start = time.perf_counter()
    extractor.get_ls_samples(fit_loader)
    torch.cuda.synchronize()
    warm_extract_s = time.perf_counter() - start
    variants = {
        "graph_two_step": lambda i: scorers[("graph", False)](x, generator=torch.Generator(device=device).manual_seed(i)),
        "graph_fused": lambda i: scorers[("graph", True)](x, generator=torch.Generator(device=device).manual_seed(i)),
        "eager_get_score": lambda i: inference["MD"].get_score(x),
    }
    names = list(variants)
    times = {name: [] for name in names}
    captures = CudaGraph.captures
    for window in range(FLOW_WINDOWS):
        for name in names[window % 3:] + names[: window % 3]:
            calls = itertools.count(window * 1000)
            times[name].append(cuda_time_ms(lambda: variants[name](next(calls)), iters=FLOW_CALLS, warmup=2))
    captures = CudaGraph.captures - captures
    fresh = build_larex_scorer(forward, pca_state, detectors["MD"].state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE)
    torch.cuda.synchronize()
    start = time.perf_counter()
    fresh(x, generator=gen)
    torch.cuda.synchronize()
    first_call_ms = (time.perf_counter() - start) * 1e3
    busy = {name: device_profile(lambda name=name: [variants[name](i) for i in range(5)], 5, category=flow_category)
            for name in names}
    record["times"] = {
        "card": smi, "extractor_img_per_s": {"first_pass": RN50_FIT / extract_s, "warm_pass": RN50_FIT / warm_extract_s},
        "img_per_s_median": {name: RN50_BATCH / (statistics.median(ms) * 1e-3) for name, ms in times.items()},
        "ms_per_call": times, "generator": "a new one per scorer call", "captures_in_timed_windows": captures,
        "first_call_ms_graph_two_step": first_call_ms,
        "device_busy": {name: {"share": r["device_busy_share"], "device_ms_per_call": r["device_busy_ms_per_unit"],
                               "kernels_per_call": r["kernels_per_unit"],
                               "ms_by_category": r["device_ms_per_unit_by_category"]}
                        for name, r in busy.items()},
    }
    emit({"phase": "image_flow_rn50", "batch": RN50_BATCH, "img": RN50_IMG, **record})
    del scorers, fresh, extractor, inference, detectors, model
    torch.cuda.empty_cache()
    return totals


def _baseline_fit(name: str, data: dict, fc: dict):
    """One baseline detector fitted as ``calculate_all_baselines`` fits it
    (None for 'raw', MSP with no detector)."""
    from runia_core_tpu_torch import detectors

    if name == "raw":
        return None
    det = {
        "vim": lambda: detectors.ViM(), "msp": lambda: detectors.MSP(), "energy": lambda: detectors.Energy(),
        "gen": lambda: detectors.GEN(gamma=EVAL_CFG["gen_gamma"], num_classes=NUM_CLASSES),
        "knn": lambda: detectors.KNN(k_neighbors=EVAL_CFG["k_neighbors"]),
        "ash": lambda: detectors.ASH(ash_percentile=EVAL_CFG["ash_percentile"]),
        "react": lambda: detectors.ReAct(react_percentile=EVAL_CFG["react_percentile"]),
        "dice": lambda: detectors.DICE(dice_percentile=EVAL_CFG["dice_percentile"], num_classes=NUM_CLASSES),
        "dice_react": lambda: detectors.DICEReAct(dice_percentile=EVAL_CFG["dice_percentile"],
                                                  react_percentile=EVAL_CFG["react_percentile"],
                                                  num_classes=NUM_CLASSES),
        "mdist": lambda: detectors.Mahalanobis(num_classes=NUM_CLASSES),
        "ddu": lambda: detectors.DDU(num_classes=NUM_CLASSES),
    }[name]()
    train, valid = data["train"], data["valid"]
    if name in ("msp", "energy", "gen"):
        det.setup(train["logits"])
        return det
    kw = {"valid_feats": valid["features"]}
    if name in ("mdist", "ddu"):
        kw["train_labels"] = train["logits"].argmax(dim=1)
    else:
        kw["final_linear_layer_params"] = fc
    if name == "vim":
        kw.update(train_logits=train["logits"], valid_logits=valid["logits"])
    det.setup(train["features"], **kw)
    return det


def _baseline_score(name: str, det, split: dict):
    """A fitted baseline's scores of one split ({"features", "logits"})."""
    from runia_core_tpu_torch.detectors.logits import msp_score

    if name == "raw":
        return msp_score(split["logits"])
    if name in ("msp", "energy", "gen"):
        return det.postprocess(split["logits"])
    if name == "vim":
        return det.postprocess(split["features"], logits=split["logits"])
    return det.postprocess(split["features"])


def _rel1(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(max |want|, 1), over the finite entries of
    want (got moved to want's device)."""
    got, want = got.to(want.device).float(), want.float()
    finite = torch.isfinite(want)
    return float((got[finite] - want[finite]).abs().max() / want[finite].abs().max().clamp_min(1.0))


def eval_rn50_phase(device, gen, smi: str) -> dict:
    """The evaluation layer at the RN50 @224 width, through the port's entry
    points: (1) features, logits and FastMCDSamplesExtractor's 16 samples
    of every split, get_dl_h_z (kernel 1, held against its plain version on
    the train and a 1,024-image split's samples); (2) calculate_all_baselines
    with all twelve baselines and pred_h / mi from
    get_mcd_pred_uncertainty_score; (3) log_evaluate_larex (LaRED, LaREM,
    LaREK; PCA 64 and 256); (4) torch_auroc on the card against the numpy
    AUROC of every row; (5) every baseline timed alone (setup, 1,024 rows
    scored) and held against the same calls on CPU f32 copies. Kernel 1's
    launches are counted over (1)-(3)."""
    import types

    import pandas

    from runia_core_tpu_torch.detectors import get_mcd_pred_uncertainty_score, postprocessors_dict
    from runia_core_tpu_torch.evaluation import (
        calculate_all_baselines,
        get_auroc_results,
        get_dl_h_z,
        log_evaluate_larex,
        torch_auroc,
    )
    from runia_core_tpu_torch.extraction import FastMCDSamplesExtractor
    from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda, marginal_entropy_plain
    from runia_core_tpu_torch.ops.linalg import class_means, classwise_center, empirical_covariance
    from runia_core_tpu_torch.reduction import apply_pca_ds_split, apply_pca_transform
    from runia_core_tpu_torch.utils import cuda_time_ms

    start_phase = time.perf_counter()
    ood_names = [name for name in EVAL_SPLITS if name not in ("train", "valid")]
    makers = {
        "train": lambda n: torch.rand((n, RN50_IMG, RN50_IMG, 3), generator=gen, device=device),
        "valid": lambda n: torch.rand((n, RN50_IMG, RN50_IMG, 3), generator=gen, device=device),
        "noise_abs": lambda n: torch.randn((n, RN50_IMG, RN50_IMG, 3), generator=gen, device=device).abs(),
        "uniform_x4": lambda n: 4.0 * torch.rand((n, RN50_IMG, RN50_IMG, 3), generator=gen, device=device),
    }
    model = rn50_model(torch.bfloat16)
    forward = rn50_forward(model)
    fc = {"weight": model.head.weight.detach().float(), "bias": model.head.bias.detach().float()}
    cfg = types.SimpleNamespace(**EVAL_CFG, ood_datasets=ood_names, ind_dataset="rn50_random",
                                mlflow_experiment_name="chip_smoke")
    record = {"card": smi, "pandas": pandas.__version__, "splits": EVAL_SPLITS, "cfg": EVAL_CFG}

    def stochastic(generator, batch):  # dropout stands in as input noise, as image_flow_rn50's
        return forward(batch + 0.01 * torch.randn(batch.shape, generator=generator, device=batch.device))[0].float()

    # ---- (1) features, logits, MC samples and entropies of every split; counted from here ----
    marginal_entropy_cuda.launches = conv_epilogue.launches = 0
    extractor = FastMCDSamplesExtractor(forward, "Conv", "fullmean", mcd_nro_samples=MC_SAMPLES,
                                        dropblock_probs=DROP_PROB, dropblock_sizes=BLOCK_SIZE, generator=gen)
    data, entropies, predictive, kernel_errors, stage_s = {}, {}, {}, {}, {}
    for split, n in EVAL_SPLITS.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = [makers[split](RN50_BATCH) for _ in range(n // RN50_BATCH)]
        feats, logits = [], []
        for batch in batches:
            out, taps = forward(batch)
            feats.append(taps["pre_pool"].float().mean(dim=(1, 2)))
            logits.append(out.float())
        samples = extractor.get_ls_samples([(batch, None) for batch in batches])
        _, h = get_dl_h_z(samples["latent_space_means"], MC_SAMPLES)
        data[split] = {"features": torch.cat(feats), "logits": torch.cat(logits)}
        entropies[split] = h
        if split in ("train", "valid"):  # outside the count: kernel 1 against plain on the split's own samples
            k1 = marginal_entropy_cuda.launches
            clouds = samples["latent_space_means"].reshape(n, MC_SAMPLES, -1)
            kernel_errors[split] = float((marginal_entropy_cuda(clouds, K) - marginal_entropy_plain(clouds, K))
                                         .abs().max())
            marginal_entropy_cuda.launches = k1
            del clouds
        if split != "train":
            mc = [get_mcd_pred_uncertainty_score(stochastic, batch, gen, MC_SAMPLES) for batch in batches]
            predictive[split] = {"pred_h": torch.cat([m[1] for m in mc]), "mi": torch.cat([m[2] for m in mc])}
        del batches, samples
        torch.cuda.synchronize()
        stage_s[f"extract_{split}"] = time.perf_counter() - t0
        for key, shape in (("features", (n, 2048)), ("logits", (n, NUM_CLASSES))):
            require(tuple(data[split][key].shape) == shape and bool(torch.isfinite(data[split][key]).all()),
                    f"{split} {key}: finite {shape}")
        require(tuple(h.shape) == (n, 2048) and h.is_cuda and bool(torch.isfinite(h).all()),
                f"{split}: finite entropies on the card")
    for split, err in kernel_errors.items():
        require(err <= ENTROPY_ATOL, f"kernel 1 vs plain on the {split} split's samples: {kernel_errors}")

    # ---- (2) every baseline ----
    ind = {f"{split} {key}": data[split][key] for split in ("train", "valid") for key in ("features", "logits")}
    ood = {f"{name} {key}": data[name][key] for name in ood_names for key in ("features", "logits")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ind, ood, scores = calculate_all_baselines(list(EVAL_BASELINES), ind, ood, fc, cfg, NUM_CLASSES)
    torch.cuda.synchronize()
    stage_s["calculate_all_baselines"] = time.perf_counter() - t0
    ind["pred_h"], ind["mi"] = predictive["valid"]["pred_h"], predictive["valid"]["mi"]
    for name in ood_names:
        scores[f"{name} pred_h"], scores[f"{name} mi"] = predictive[name]["pred_h"], predictive[name]["mi"]
    baselines = [*EVAL_BASELINES, "pred_h", "mi"]
    for name in baselines:
        for got in (ind[name], *(scores[f"{o} {name}"] for o in ood_names)):
            require(got.is_cuda and tuple(got.shape) == (EVAL_SPLITS["valid"],) and bool(torch.isfinite(got).all()),
                    f"baseline {name}: finite scores on the card")

    # ---- (3) the LaREx sweep ----
    for split, h in entropies.items():
        (ind if split in ("train", "valid") else ood)[f"{split} latent_space_means"] = h
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table, best, thresholds, ood_out = log_evaluate_larex(
        cfg, baselines, scores, ind, ood, mlflow_run_name="eval_rn50", mlflow_logging=False,
        postprocessors=list(EVAL_POSTPROCESSORS))
    torch.cuda.synchronize()
    stage_s["log_evaluate_larex"] = time.perf_counter() - t0
    launches = {"marginal_entropy": marginal_entropy_cuda.launches, "conv_epilogue": conv_epilogue.launches}
    require(launches["marginal_entropy"] >= len(EVAL_SPLITS) and launches["conv_epilogue"] > 0,
            f"get_dl_h_z ran kernel 1 on every split, the forwards the conv-norm epilogue: {launches}")
    rows = [f"{o} {b}" for b in baselines for o in ood_names]
    rows += [f"{o} {p}{ext}" for ext in ["", *(f" PCA {n}" for n in EVAL_CFG["n_pca_components"])]
             for o in ood_names for p in EVAL_POSTPROCESSORS]
    require(sorted(table.index) == sorted(rows), f"log_evaluate_larex rows: {list(table.index)}")
    for name in EVAL_POSTPROCESSORS:
        config = best[name]["best_comp"]
        require(config in thresholds and all(f"{o} {config}" in ood_out for o in ood_names),
                f"{name}: best configuration {config} thresholded and scored")

    # ---- (4) torch_auroc on the card against every row's numpy AUROC ----
    row_scores = {}
    for b in baselines:
        sign = -1.0 if b in ("pred_h", "mi") else 1.0
        for o in ood_names:
            row_scores[f"{o} {b}"] = (sign * ind[b], sign * scores[f"{o} {b}"])
    for n_comp in [None, *EVAL_CFG["n_pca_components"]]:
        latent = {split: h for split, h in entropies.items()}
        if n_comp is not None:
            latent["train"], pca = apply_pca_ds_split(latent["train"], n_comp)
            latent.update({split: apply_pca_transform(h, pca) for split, h in entropies.items() if split != "train"})
        for p in EVAL_POSTPROCESSORS:
            det = postprocessors_dict[p](cfg=cfg)
            det.setup(latent["train"])
            valid_scores = det.postprocess(latent["valid"])
            for o in ood_names:
                row_scores[f"{o} {p}{'' if n_comp is None else f' PCA {n_comp}'}"] = (valid_scores,
                                                                                     det.postprocess(latent[o]))
    auroc_err, table_err = {}, {}
    for row, (ind_s, ood_s) in row_scores.items():
        on_card = float(torch_auroc(ind_s, ood_s))
        numpy_auroc = float(get_auroc_results(row, ind_s, ood_s).loc[row, "auroc"])
        auroc_err[row] = abs(on_card - numpy_auroc)
        table_err[row] = abs(on_card - float(table.loc[row, "auroc"]))
    require(max(auroc_err.values()) <= AUROC_ATOL, f"torch_auroc vs the numpy AUROC: {auroc_err}")
    record["sweep"] = {
        "rows": len(table), "auroc": {row: float(table.loc[row, "auroc"]) for row in table.index},
        "fpr95": {row: float(table.loc[row, "fpr@95"]) for row in table.index},
        "best": {name: best[name] for name in EVAL_POSTPROCESSORS}, "thresholds": thresholds,
        "torch_auroc_vs_numpy_max_abs": max(auroc_err.values()), "bound": AUROC_ATOL,
        "torch_auroc_vs_table_max_abs": max(table_err.values()),
    }
    record["launches"] = launches
    record["kernel1_vs_plain_max_abs_err"] = kernel_errors
    record["stage_s"] = stage_s
    record["main_path_s"] = time.perf_counter() - start_phase

    # ---- (5) each baseline alone: times on the card, then the CPU's f32 copies ----
    timing, xcheck, state = {}, {}, {}
    cpu = {split: {key: t.cpu() for key, t in d.items()} for split, d in data.items()}
    fc_cpu = {key: t.cpu() for key, t in fc.items()}
    scored = ("valid", *ood_names)
    for name in EVAL_BASELINES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = _baseline_fit(name, data, fc)
        torch.cuda.synchronize()
        timing[name] = {"setup_ms": (time.perf_counter() - t0) * 1e3,
                        "ms_per_1024_rows": cuda_time_ms(lambda: _baseline_score(name, det, data["valid"]), 5, 1)
                        * 1024 / EVAL_SPLITS["valid"]}
        card = {split: _baseline_score(name, det, data[split]) for split in scored}
        main = dict(zip(scored, [ind[name], *(scores[f"{o} {name}"] for o in ood_names)]))
        xcheck[f"{name}_main_path_vs_alone"] = max(_rel1(main[s], card[s]) for s in scored)
        t0 = time.perf_counter()
        cpu_det = _baseline_fit(name, cpu, fc_cpu)
        xcheck[name] = max(_rel1(card[s], _baseline_score(name, cpu_det, cpu[s])) for s in scored)
        timing[name]["cpu_s"] = time.perf_counter() - t0
        if name in EVAL_STATE_SHARED:
            # The card's fitted state scored on the CPU, and the parts of the
            # fit the data determine in f32 (means, ViM's origin u).
            shared = type(det)()
            shared.load_state({k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in det.state.items()})
            xcheck[f"{name}_state_shared"] = max(_rel1(card[s], _baseline_score(name, shared, cpu[s]))
                                                 for s in scored)
            determined = {"vim": lambda d: d.u, "ddu": lambda d: d.gmm.means}[name]
            xcheck[f"{name}_fit_determined"] = _rel1(determined(det), determined(cpu_det))
        if name == "mdist":
            valid_x = data["valid"]["features"]
            terms = ((valid_x @ det.precision) * valid_x).sum(dim=-1).max()
            finite = torch.isfinite(det.class_mean).all(dim=1)
            means = det.class_mean[finite]
            terms = terms + ((means @ det.precision) * means).sum(dim=-1).max()
            state["mdist_quadform_terms_over_score"] = float(terms / card["valid"].abs().max())
        if name == "ddu":
            state["ddu_jitter_rung"] = {"card": float(det.gmm.jitter.max()), "cpu": float(cpu_det.gmm.jitter.max())}
            state["ddu_classes_kept"] = int(det.gmm.means.shape[0])
    for name in EVAL_BASELINES:
        checks = ([f"{name}_state_shared", f"{name}_fit_determined"] if name in EVAL_STATE_SHARED
                  else [name]) + [f"{name}_main_path_vs_alone"]
        for check in checks:
            bound = (EVAL_MAIN_PATH_REL if check.endswith("main_path_vs_alone")
                     else EVAL_XCHECK_REL.get(name, EVAL_XCHECK_REL_DEFAULT))
            require(xcheck[check] <= bound, f"baseline {check}: rel err {xcheck[check]} > {bound}")
    # ViM's boundary and eigh, mdist's pseudo-inverse cutoff: where card and CPU could part
    x = data["train"]["features"]
    vim = _baseline_fit("vim", data, fc)
    covariance = empirical_covariance(x - vim.u, assume_centered=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eigvals = torch.linalg.eigh(covariance)[0]
    torch.cuda.synchronize()
    state["vim_eigh_ms"] = (time.perf_counter() - t0) * 1e3
    boundary = x.shape[1] - vim.DIM  # the smallest principal eigenvalue's index (ascending)
    state["vim_dim"] = vim.DIM
    state["vim_boundary_eigvals"] = [float(eigvals[boundary - 1]), float(eigvals[boundary])]
    state["vim_boundary_gap_rel"] = float((eigvals[boundary] - eigvals[boundary - 1]) / eigvals[boundary])
    state["vim_boundary_over_largest"] = float(eigvals[boundary] / eigvals[-1])
    labels = data["train"]["logits"].argmax(dim=1)
    centred = classwise_center(x, labels, class_means(x, labels, NUM_CLASSES))
    md_eig = torch.linalg.eigvalsh(empirical_covariance(centred))
    cutoff = 10.0 * x.shape[1] * torch.finfo(torch.float32).eps * md_eig[-1]  # ops.linalg.pinvh's
    state["mdist_class_counts"] = torch.bincount(labels, minlength=NUM_CLASSES).tolist()
    state["mdist_pinv_cutoff"] = float(cutoff)
    state["mdist_largest_eigval"] = float(md_eig[-1])
    kept = md_eig > cutoff
    state["mdist_eigvals_kept"] = int(kept.sum())
    state["mdist_nearest_kept_over_cutoff"] = float(md_eig[kept].min() / cutoff)
    state["mdist_cutoff_over_nearest_dropped"] = float(cutoff / md_eig[~kept].max()) if bool((~kept).any()) else None
    record["baselines"] = {"timing": timing, "card_vs_cpu_rel": xcheck, "state_shared": list(EVAL_STATE_SHARED),
                           "bounds": {name: EVAL_XCHECK_REL.get(name, EVAL_XCHECK_REL_DEFAULT)
                                      for name in EVAL_BASELINES}, "state": state}
    record["seconds"] = time.perf_counter() - start_phase
    emit({"phase": "eval_rn50", "batch": RN50_BATCH, "img": RN50_IMG, **record})
    del data, cpu, entropies, ind, ood, scores, model
    torch.cuda.empty_cache()
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
    s7d, s7h, s7g = SERVE7B_CFG["d_model"], SERVE7B_CFG["hidden_dim"], SERVE7B_CFG["num_kv_heads"]
    s7hd = s7d // SERVE7B_CFG["num_heads"]
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
        # the 7B int8 serving cell: a decode chunk's steps at 8 rows (the
        # slots) and a prefill lane group at 4 x 128 rows
        **{f"serve7b_rows{rows}_{name}": (rows, k, n) for rows in (SERVE7B_ENGINE["num_slots"], 4 * 128)
           for name, (k, n) in (("qkv", (s7d, s7d + 2 * s7g * s7hd)), ("o", (s7d, s7d)), ("gate_up", (s7d, 2 * s7h)),
                                ("down", (s7h, s7d)), ("lm_head", (s7d, SERVE7B_CFG["vocab_size"])))},
        # the speculative engine on cell 1: the verify forward's S (gamma + 1)
        # = 8 x 5 rows through every projection and the head (the draft's
        # steps are serve7b_rows8, its lanes serve7b_rows512)
        **{f"spec7b_rows40_{name}": (SPEC7B_ENGINE["num_slots"] * (SPEC_GAMMA + 1), k, n)
           for name, (k, n) in (("qkv", (s7d, s7d + 2 * s7g * s7hd)), ("o", (s7d, s7d)), ("gate_up", (s7d, 2 * s7h)),
                                ("down", (s7h, s7d)), ("lm_head", (s7d, SERVE7B_CFG["vocab_size"])))},
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
        timed_names = ("rows", "moe", "spec", "serve7b")
        if name in decode_names or name == "lm_head" or name.startswith(timed_names):
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
            if name in decode_names or name == "lm_head" or name.startswith(timed_names):
                # A different function, as a reference point only: cuBLAS on
                # the dequantized bf16 weight, twice the bytes.
                dense = [(x, copies[i % len(copies)][1].to(torch.bfloat16))
                         for i in range(-(-64 * 2**20 // (2 * k * n)))]
                dense_turns = itertools.cycle(dense)
                timings[name]["bf16_matmul_ms"] = cuda_graph_time_ms(lambda: torch.matmul(*next(dense_turns)), 30)
                # At the lanes' 512 rows torch._weight_int8pack_mm takes 28-146
                # ms a call on an H100: about 70 s of the run for a reference
                # point, so the serving shapes time it at the decode rows only.
                if not name.startswith(("serve7b_rows512", "rows", "spec7b")):
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


def _lowest_key(kvs: int, pos: int, window: int) -> int:
    return max(kvs, pos - window + 1) if window else kvs


def _window_pairs(q_start, kv_start, tq, kk, window: int = 0) -> int:
    """Query-key pairs inside the windows kv_start <= j <= q_start + i < K
    (and, with a sliding ``window``, j > q_start + i - window)."""
    total = 0
    for qs, kvs in zip(q_start, kv_start):
        for i in range(tq):
            total += max(0, min(kk - 1, qs + i) - _lowest_key(kvs, qs + i, window) + 1)
    return total


def _keys_read(q_start, kv_start, tq, kk, window: int = 0) -> int:
    """Keys some query of its batch row attends, summed over the rows."""
    return sum(max(0, min(kk - 1, qs + tq - 1) - _lowest_key(kvs, qs, window) + 1)
               for qs, kvs in zip(q_start, kv_start))


def rounding_spread(q, k, v, q_start, kv_start, k_scale, v_scale, window: int = 0):
    """sqrt(sum_j p_j^2 v_j^2) per output element of the (B, Hq, Tq, D)
    attention, from its f32 probabilities (v_j * v_scale_j in KV8), the
    keys masked as the kernel's with its sliding ``window``."""
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
    if window:
        mask &= rows - keys < window
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
    s7hq, s7g = SERVE7B_CFG["num_heads"], SERVE7B_CFG["num_kv_heads"]
    s7hd = SERVE7B_CFG["d_model"] // s7hq
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
        # the 7B serving cell's prefill lanes: 4 slots x 128 queries, each at
        # its own q_start, over the gathered 512-slot rows, 32 / 8 heads of
        # 128; KV8 (the cell's) and a bf16 counterpart
        **{name: (4, s7hq, s7g, 128, SERVE7B_ENGINE["max_ctx"], s7hd, [0, 128, 256, 384], None, bf16, kv8, "transposed")
           for name, kv8 in (("serve7b_lanes_kv8", True), ("serve7b_lanes", False))},
        # the speculative cell's lanes, the draft's as the target's (the
        # draft has the target's heads): chunks of the shared-prompt traffic
        # at 0, 128 and 256 over 512 slots; and the fused drain's lanes
        # chosen on the device, rows 2 and 3 duplicates of row 0 (fewer
        # pending slots than lanes), which must come out identical
        "spec7b_draft_lanes_kv8": (4, s7hq, s7g, 128, SPEC7B_ENGINE["max_ctx"], s7hd, [0, 128, 256, 256], None, bf16,
                                   True, "transposed"),
        "fused7b_dup_lanes_kv8": (4, s7hq, s7g, 128, SERVE7B_ENGINE["max_ctx"], s7hd, [256, 128, 256, 256], None,
                                  bf16, True, "duplicates"),
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
        if layout == "duplicates":
            for t in (q, k, v) + ((ks, vs) if kv8 else ()):
                t[2:] = t[:1]
            layout = "transposed"
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
        if name == "fused7b_dup_lanes_kv8":
            require(torch.equal(got[2:], got[:1].expand_as(got[2:])), f"flash {name}: duplicate lanes are identical")
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
                    "d256_prefill", "serve7b_lanes_kv8", "serve7b_lanes", "spec7b_draft_lanes_kv8",
                    "fused7b_dup_lanes_kv8"):
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


def flash_window_phase(device, gen) -> dict:
    """Kernel 4 at Mellum's prefill lanes: 4 lanes of 512 queries at q_start
    0 / 512 / 4,096 / 11,776 over the 12,800-slot cache (the model's
    transposed view, NaN past the written prefix), 32 / 4 heads of 128,
    bf16, with the sliding layers' window of 1,024 and with none (the full
    layers): against the twin with the same window, lane by lane, at the
    flash phase's bf16 bound with the window in its mask; two runs
    bit-identical; the device's work counts equal to the pairs, keys and
    queries counted here; timed by CUDA-graph replays against the larger of
    the attended pairs' operations and q / out and the attended keys' k / v
    bytes. Launches counted from zero over the phase."""
    from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention, reference_prefix_attention
    from runia_core_tpu_torch.utils import cuda_graph_time_ms, cuda_time_ms

    hq, g, d, tq, kk = MELLUM["num_heads"], MELLUM["num_kv_heads"], MELLUM["head_dim"], MELLUM["lane"], MELLUM["max_ctx"]
    starts = MELLUM_LANE_STARTS
    b = len(starts)
    q = torch.randn((b, hq, tq, d), generator=gen, device=device).to(torch.bfloat16)
    k = torch.randn((b, g, kk, d), generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn((b, g, kk, d), generator=gen, device=device).to(torch.bfloat16)
    k_in, v_in = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    written = max(starts) + tq
    k_in[:, written:], v_in[:, written:] = float("nan"), float("nan")
    k_in, v_in = k_in.transpose(1, 2), v_in.transpose(1, 2)
    qs = torch.tensor(starts, dtype=torch.int32, device=device)
    flash_prefix_attention.launches = flash_prefix_attention.window_launches = 0
    errors, err_over_bound, timing = {}, {}, {}
    for window in (MELLUM["window"], 0):
        name = f"window_{window}" if window else "full"
        work = flash_prefix_attention.work.get(device)
        before = [0, 0, 0] if work is None else work.tolist()
        got = flash_prefix_attention(q, k_in, v_in, qs, window=window)
        counted = [a - b_ for a, b_ in zip(flash_prefix_attention.work[device].tolist(), before)]
        again = flash_prefix_attention(q, k_in, v_in, qs, window=window)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"flash {name}: finite past a NaN tail")
        require(torch.equal(got, again), f"flash {name}: two runs on the same inputs are bit-identical")
        pairs = _window_pairs(starts, [0] * b, tq, kk, window)
        keys = _keys_read(starts, [0] * b, tq, kk, window)
        require(counted == [pairs, keys, b * tq],
                f"flash {name}: the device's work counts {counted} are the pairs, keys and queries {pairs, keys, b * tq}")
        worst_abs, worst_rel = 0.0, 0.0
        for row in range(b):  # the twin's logits take (Hq, Tq, K) f32 a lane
            sl = slice(row, row + 1)
            want = reference_prefix_attention(q[sl], k[sl], v[sl], qs[sl], None, None, None, None, window)
            diff = (got[sl].float() - want.float()).abs()
            tol = FLASH_BF16_RTOL * want.float().abs() + FLASH_BF16_ATOL_OF_S * rounding_spread(
                q[sl], k[sl], v[sl], qs[sl], None, None, None, window)
            worst_abs = max(worst_abs, float(diff.max()))
            worst_rel = max(worst_rel, float((diff / tol.clamp_min(1e-30)).max()))
            del want, diff, tol
        errors[name], err_over_bound[name] = worst_abs, worst_rel
        require(worst_rel <= 1.0, f"flash {name}: max abs err {worst_abs} beyond its bound ({worst_rel:.3f} of it)")
        ms = cuda_graph_time_ms(lambda: flash_prefix_attention(q, k_in, v_in, qs, window=window), 20)
        plain_ms = cuda_time_ms(lambda: [reference_prefix_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], qs[i:i + 1],
                                                                    None, None, None, None, window)
                                         for i in range(b)], 2, warmup=1)
        bound = roofline(4.0 * b * tq * hq * d + 4.0 * keys * g * d, 4.0 * pairs * hq * d, H100_BF16_OPS_PER_S)
        timing[name] = {"window": window, "pairs_a_head": pairs, "keys": keys, "ms": ms, "plain_ms": plain_ms,
                        "in_window_TFLOPs": 4.0 * pairs * hq * d / (ms * 1e-3) / 1e12, **with_share(bound, ms)}
        require(timing[name]["share_of_bound"] <= 1.0, f"flash {name}: faster than its bound: {timing[name]}")
    launches = {"flash_prefix_attention": flash_prefix_attention.launches,
                "flash_prefix_attention_window": flash_prefix_attention.window_launches}
    require(launches["flash_prefix_attention_window"] > 0, f"the windowed kernel 4 launched: {launches}")
    emit({"phase": "kernel_flash_window", "config": MELLUM, "q_start": starts, "max_abs_err": errors,
          "max_err_over_bound": err_over_bound,
          "bound": {"bf16_rtol": FLASH_BF16_RTOL, "bf16_atol": f"{FLASH_BF16_ATOL_OF_S} * sqrt(sum_j p_j^2 v_j^2)"},
          "timing": timing, "launches": launches, "deterministic": True,
          "timed_with": "CUDA-graph replays of 20 calls; plain: the twin lane by lane, events",
          "library": "none: scaled_dot_product_attention has no sliding window"})
    top = timing[f"window_{MELLUM['window']}"]
    return {"max_abs_err": max(errors.values()), "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"], "window_launches": launches[
                "flash_prefix_attention_window"], "full_ms": timing["full"]["ms"], "full_bound_ms": timing["full"]["bound_ms"]}


def moe_grouped_phase(device, gen) -> dict:
    """The grouped experts at Mellum's widths (64 experts of 896 over 2,304,
    top 8, softmax renormalised) on a decode step's 8 tokens, one to four
    prefill lanes' 512-2,048, four lanes with one expert given no token, and
    at Mixtral's (8 experts of 14,336 over 4,096, top 2) on a 16-token
    decode step and its 2,048-token prefill: ``routed_experts`` (the
    counting sort, the kernels, the combine) and ``moe_grouped`` alone
    against the twin (``reference_moe_grouped`` over the pairs sorted by
    ``argsort``, combined by hand), within MOE_GROUPED_REL of the output's
    RMS; two routed calls bit-identical; the device's work counts equal to
    the pairs and the touched experts, once a routed call. The kernels timed
    by CUDA-graph replays against the larger of pairs x 6 d I operations and
    the touched experts' bytes with each pair's row in (bf16) and out (f32).
    Launches counted from zero over the phase."""
    from runia_core_tpu_torch.ops import moe_grouped as mg
    from runia_core_tpu_torch.utils import cuda_graph_time_ms, cuda_time_ms

    moe_grouped = mg.moe_grouped
    widths = {"mellum": (MELLUM["num_experts"], MELLUM["top_k"], MELLUM["d_model"], MELLUM["expert_width"]),
              "mixtral": (MIXTRAL_EXPERTS["num_experts"], MIXTRAL_EXPERTS["top_k"], MIXTRAL_EXPERTS["d_model"],
                          MIXTRAL_EXPERTS["expert_width"])}
    weights = {}
    for name, (e, _, d, width) in widths.items():
        w_gate, w_up = ((torch.randn((e, d, width), generator=gen, device=device) / d**0.5).to(torch.bfloat16)
                        for _ in range(2))
        weights[name] = (w_gate, w_up, (torch.randn((e, width, d), generator=gen, device=device)
                                        / width**0.5).to(torch.bfloat16))

    def routed(model, t, idle=None):
        e, top, d, _ = widths[model]
        x = torch.randn((t, d), generator=gen, device=device).to(torch.bfloat16)
        logits = torch.randn((t, e), generator=gen, device=device)
        if idle is not None:
            logits[:, idle] = float("-inf")
        top_v, top_i = torch.topk(torch.softmax(logits, -1), top, dim=-1)
        order = torch.argsort(top_i.reshape(-1), stable=True)
        counts = torch.bincount(top_i.reshape(-1), minlength=e)
        offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
        return x, top_i, top_v / top_v.sum(-1, keepdim=True), (order // top).to(torch.int32), offsets, order, counts

    cases = {**{name: ("mellum", t, None) for name, t in MOE_GROUPED_TOKENS.items()},
             "lanes_2048_expert_5_idle": ("mellum", 2048, 5),
             **{f"mixtral_{t}": ("mixtral", t, None) for t in MIXTRAL_EXPERTS["tokens"]}}
    moe_grouped.launches = 0
    errors, timing = {}, {}
    for name, (model, t, idle) in cases.items():
        e, top, d, width = widths[model]
        w = weights[model]
        x, top_i, top_w, tok, offsets, order, counts = routed(model, t, idle)
        inverse = torch.empty_like(order)
        inverse[order] = torch.arange(order.numel(), device=device)
        rows_want = mg.reference_moe_grouped(x, tok, offsets, *w)
        want = (rows_want[inverse].view(t, top, d) * top_w[:, :, None]).sum(1)
        rows = moe_grouped(x, tok, offsets, *w)
        work = moe_grouped.work.get(device)
        before = [0, 0] if work is None else work.tolist()
        got = mg.routed_experts(x, top_i, top_w, *w)
        counted = [a - b for a, b in zip(moe_grouped.work[device].tolist(), before)]
        again = mg.routed_experts(x, top_i, top_w, *w)
        torch.cuda.synchronize()
        touched = int((counts > 0).sum())
        require(torch.equal(got, again), f"moe_grouped {name}: two routed calls are bit-identical")
        require(counted == [t * top, touched], f"moe_grouped {name}: work counts {counted}, want {[t * top, touched]}")
        require(idle is None or int(counts[idle]) == 0, f"moe_grouped {name}: expert {idle} got no token")
        rms = float(rows_want.square().mean().sqrt())
        errors[name] = {"kernels": float((rows - rows_want).abs().max()) / rms,
                        "routed": float((got - want).abs().max()) / float(want.square().mean().sqrt())}
        require(max(errors[name].values()) <= MOE_GROUPED_REL,
                f"moe_grouped {name}: {errors[name]} of the RMS beyond {MOE_GROUPED_REL}")
        if idle is not None:
            continue
        bound = roofline(6.0 * d * width * touched + 6.0 * d * t * top, 6.0 * d * width * t * top, H100_BF16_OPS_PER_S)
        ms = cuda_graph_time_ms(lambda: moe_grouped(x, tok, offsets, *w), 10)
        timing[name] = {"tokens": t, "pairs": t * top, "experts_touched": touched, "ms": ms,
                        "routed_ms": cuda_graph_time_ms(lambda: mg.routed_experts(x, top_i, top_w, *w), 10),
                        "plain_ms": cuda_time_ms(lambda: mg.reference_moe_grouped(x, tok, offsets, *w), 3, warmup=1),
                        **with_share(bound, ms)}
        require(timing[name]["share_of_bound"] <= 1.0, f"moe_grouped {name}: faster than its bound: {timing[name]}")
        del x, rows, rows_want, want, got, again
    launches = moe_grouped.launches
    require(launches > 0, f"moe_grouped launched: {launches}")
    emit({"phase": "kernel_moe_grouped", "config": {"mellum": MELLUM, "mixtral": MIXTRAL_EXPERTS},
          "max_err_over_rms": errors, "bound": MOE_GROUPED_REL, "timing": timing, "launches": launches,
          "deterministic": True,
          "timed_with": "CUDA-graph replays of 10 calls (the two kernels); routed_ms: the counting sort, the kernels "
          "and the combine; plain: the twin, events",
          "library": "none: no grouped product the port may call"})
    top_case = timing["lanes_2048"]
    return {"max_err_over_rms": max(max(v.values()) for v in errors.values()), "ms": top_case["ms"],
            "plain_ms": top_case["plain_ms"], "bound_ms": top_case["bound_ms"], "bound_by": top_case["bound_by"],
            "library_ms": None, "phase_launches": launches,
            "ms_by_case": {n: c["ms"] for n, c in timing.items()},
            "bound_ms_by_case": {n: c["bound_ms"] for n, c in timing.items()}}


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
    hf = _hf_family(family, device, PYTHIA_LAYERS if family == "neox" else None)
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
          else PYTHIA_HF, "cut": "none" if family == "gpt2" else f"depth {PYTHIA_LAYERS} of 24 layers",
          "dtype": "float32", "hf_build_s": build_s,
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
    from runia_core_tpu_torch.ops.moe_grouped import moe_grouped
    from runia_core_tpu_torch.ops.quant_matmul import quant_matmul
    from runia_core_tpu_torch.utils import cuda_time_ms

    models = build_moe(device, MOE_CFG["num_layers"], torch.bfloat16)
    rng = torch.Generator().manual_seed(SEED + 11)
    vocab = MOE_CFG["vocab_size"]
    long_prompts = torch.randint(1, vocab, (MOE_PREFILL_BATCH, MOE_PREFILL_LEN), generator=rng).tolist()
    prompts = torch.randint(1, vocab, (MOE_DECODE_BATCH, MOE_DECODE_PROMPT), generator=rng).tolist()
    gens = {name: TorchGenerator(m, max_new_tokens=MOE_DECODE_NEW) for name, m in models.items()}

    # ---- the main path, counted ----
    quant_matmul.launches = moe_grouped.launches = 0
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
                "flash_prefix_attention_kv8": flash_prefix_attention.kv8_launches, "moe_grouped": moe_grouped.launches}
    require(launches["quant_matmul"] > 0 and launches["flash_prefix_attention_kv8"] > 0
            and launches["flash_prefix_attention"] > launches["flash_prefix_attention_kv8"]
            and launches["moe_grouped"] > 0,
            f"moe: kernels 3 and 4 (bf16 and KV8) and the grouped experts (bf16) launched on the main path: {launches}")

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


# ---------------------------------------------------------------------------------------------------------------------
# Serving: ContinuousBatchingEngine (llm/continuous.py)
def serve_traffic(traffic: dict, vocab: int):
    """(prompts, budgets) as the bench.py leg draws them: lengths, then
    budgets, then the prompts' tokens, from one RandomState."""
    rng = np.random.RandomState(traffic["seed"])
    lengths = rng.randint(*traffic["prompts"], traffic["requests"])
    budgets = rng.randint(*traffic["budgets"], traffic["requests"])
    prompts = [list(rng.randint(1, vocab, int(n))) for n in lengths]
    return prompts, [int(b) for b in budgets]


def build_serve7b(device, num_layers: int, seed: int = SEED + 20):
    """Cell 1's model at depth ``num_layers``: int8 weights drawn uniformly
    from [-127, 127], every other tensor 0.01 + 0.005 N(0, 1) (bench.py:
    384-418), made on the card from ``seed``."""
    from runia_core_tpu_torch.models import LlamaLM

    model = LlamaLM(**dict(SERVE7B_CFG, num_layers=num_layers), dtype=torch.bfloat16, use_flash=True,
                    quantized=True, quantized_kv=True, fused_qkv=True).eval()
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.dtype == torch.int8:
                p.copy_(torch.randint(-127, 128, p.shape, generator=gen, device=device, dtype=torch.int8))
            else:
                p.copy_(0.01 + 0.005 * torch.randn(p.shape, generator=gen, device=device))
    return model


def sharing(model, **overrides):
    """Another LlamaLM of ``model``'s configuration with ``overrides``,
    holding the same tensors."""
    from runia_core_tpu_torch.models import LlamaLM

    keys = ("vocab_size", "num_layers", "num_heads", "num_kv_heads", "d_model", "hidden_dim", "max_len", "dtype",
            "use_flash", "quantized", "quantized_kv", "fused_qkv")
    view = LlamaLM(**{**{k: getattr(model, k) for k in keys}, **overrides}).eval()
    view.load_state_dict(model.state_dict(), assign=True)
    return view


def serve_pass(engine, prompts, budgets) -> list:
    """Submit every request, drain, return the results in order."""
    ids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]
    engine.run_until_drained()
    results = [engine.result(i) for i in ids]
    engine.clear_results()
    return results


def check_served(results, budgets, what: str) -> None:
    require(all(len(r["tokens"]) == b for r, b in zip(results, budgets)), f"{what}: every request its budget")
    require(all(bool(np.isfinite(r["log_probs"]).all()) for r in results), f"{what}: finite log-probs")


class ProgramTimer:
    """CUDA events around an engine's program calls, by kind: decode chunks,
    prefill lanes, bucketed prefills. Read after a pass: the device time
    between each call's events (gaps while the host enqueued an eager call
    included) and the number of calls."""

    def __init__(self, engine):
        self.marks = {"decode": [], "lanes": [], "bucketed": []}
        engine._chunk_prog = self._timed("decode", engine._chunk_prog)
        engine._lane_progs = {w: self._timed("lanes", p) for w, p in engine._lane_progs.items()}
        engine._prefill_group = self._timed("bucketed", engine._prefill_group)

    def _timed(self, kind, fn):
        def call(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.marks[kind].append((start, end))
            return out

        return call

    def read(self) -> dict:
        torch.cuda.synchronize()
        out = {kind: {"calls": len(m), "device_ms": sum(a.elapsed_time(b) for a, b in m)}
               for kind, m in self.marks.items()}
        for m in self.marks.values():
            m.clear()
        return out


_STAT_KEYS = ("decode_chunks", "prefill_chunks", "tokens_emitted", "prefix_hits", "t_fetch_s", "t_dispatch_s",
              "t_prefill_s", "t_sched_s")


def timed_serve_pass(engine, timer, prompts, budgets, what: str) -> dict:
    """One pass under sync-debug "error" on the host clock, with its stats
    and program times."""
    from runia_core_tpu_torch.utils import CudaGraph

    before, captures = engine.stats(), CudaGraph.captures
    torch.cuda.synchronize()
    start = time.perf_counter()
    with no_host_sync():
        results = serve_pass(engine, prompts, budgets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    check_served(results, budgets, what)
    after = engine.stats()
    return {"seconds": seconds, "captures": CudaGraph.captures - captures,
            **{k: after[k] - before[k] for k in _STAT_KEYS}, "programs": timer.read() if timer else None}


def _mean(records, key):
    return statistics.mean(r[key] for r in records)


def _graph_launches(program) -> dict:
    from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention
    from runia_core_tpu_torch.ops.quant_matmul import quant_matmul

    got = program.graph.launches if program.graph is not None else {}
    return {"quant_matmul": got.get((quant_matmul, "launches"), 0),
            "flash_prefix_attention_kv8": got.get((flash_prefix_attention, "kv8_launches"), 0)}


def serve_7b_int8_phase(device, model, model_s: float) -> dict:
    """Cell 1 (bench.py:469-537): the 7B-class int8 + KV8 model served to
    24 requests by two engines, the open-loop drain (``defer_fetch``, the
    bench's) and the lookahead drain, each built once (its programs
    captured), a first pass each (the main path, counted), then timed passes
    in turns. Useful tok/s, decode and prefill chunks a pass, emission
    occupancy, the decode phase's HBM GB/s floor (bench.py:515-526's bytes),
    a decode chunk's replay ms against its byte bound, the lanes' row
    gather / scatter bytes, captures in a warm pass, kernel share."""
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine
    from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention
    from runia_core_tpu_torch.ops.quant_matmul import quant_matmul
    from runia_core_tpu_torch.utils import CudaGraph, device_profile

    cfg, eng_cfg = SERVE7B_CFG, SERVE7B_ENGINE
    weight_bytes = _weight_bytes(model)
    prompts, budgets = serve_traffic(SERVE7B_TRAFFIC, cfg["vocab_size"])
    useful = sum(budgets)
    engines, built = {}, {}
    for drain, defer in (("open_loop", True), ("lookahead", False)):
        captures, start = CudaGraph.captures, time.perf_counter()
        engines[drain] = ContinuousBatchingEngine(model, **eng_cfg, defer_fetch=defer)
        torch.cuda.synchronize()
        built[drain] = {"seconds": time.perf_counter() - start, "captures": CudaGraph.captures - captures}
    eng = engines["open_loop"]
    per_program = {"decode_chunk": _graph_launches(eng._chunk_prog),
                   **{f"lanes_{w}": _graph_launches(p) for w, p in eng._lane_progs.items()}}
    programs = {"decode_chunk": eng._chunk_prog.graph,
                f"lanes_{eng_cfg['prefill_lanes']}": eng._lane_progs[eng_cfg["prefill_lanes"]].graph}

    # ---- the main path, counted: the first pass of each engine ----
    quant_matmul.launches = 0
    flash_prefix_attention.launches = flash_prefix_attention.kv8_launches = 0
    first = {}
    for drain, engine in engines.items():
        first[drain] = timed_serve_pass(engine, None, prompts, budgets, f"serve_7b_int8 {drain}")
    launches = {"quant_matmul": quant_matmul.launches, "flash_prefix_attention": flash_prefix_attention.launches,
                "flash_prefix_attention_kv8": flash_prefix_attention.kv8_launches}
    require(launches["quant_matmul"] > 0 and launches["flash_prefix_attention_kv8"] > 0,
            f"serve_7b_int8: kernels 3 and 4 (KV8) launched on the main path: {launches}")

    # ---- timed passes, the drains in turns ----
    timers = {drain: ProgramTimer(engine) for drain, engine in engines.items()}
    passes = {drain: [] for drain in engines}
    k3, k4 = quant_matmul.launches, flash_prefix_attention.kv8_launches
    for drain in ["open_loop", "lookahead", "lookahead", "open_loop"] * ((SERVE_PASSES + 1) // 2):
        if len(passes[drain]) < SERVE_PASSES:
            passes[drain].append(timed_serve_pass(engines[drain], timers[drain], prompts, budgets,
                                                  f"serve_7b_int8 {drain}"))
    pass_launches = {"quant_matmul": (quant_matmul.launches - k3) / (2 * SERVE_PASSES),
                     "flash_prefix_attention_kv8": (flash_prefix_attention.kv8_launches - k4) / (2 * SERVE_PASSES)}
    require(pass_launches["quant_matmul"] > 0 and pass_launches["flash_prefix_attention_kv8"] > 0,
            f"serve_7b_int8: kernels 3 and 4 (KV8) in a warm pass: {pass_launches}")
    warm_captures = sum(p["captures"] for ps in passes.values() for p in ps)
    require(warm_captures == 0, f"serve_7b_int8: warm passes capture nothing, got {warm_captures}")

    head_dim = cfg["d_model"] // cfg["num_heads"]
    avg_ctx = float(np.mean([len(p) for p in prompts]) + np.mean(budgets) / 2)
    kv_read = eng_cfg["num_slots"] * cfg["num_layers"] * 2 * avg_ctx * cfg["num_kv_heads"] * head_dim
    step_bytes = weight_bytes + kv_read
    K, S = eng_cfg["chunk_tokens"], eng_cfg["num_slots"]
    row_bytes = cfg["num_layers"] * 2 * eng_cfg["max_ctx"] * cfg["num_kv_heads"] * (head_dim + 4)
    drains = {}
    for drain, ps in passes.items():
        tps = useful / _mean(ps, "seconds")
        d_chunks = _mean(ps, "decode_chunks")
        decode = [p["programs"]["decode"] for p in ps]
        lanes = [p["programs"]["lanes"] for p in ps]
        chunk_ms = sum(d["device_ms"] for d in decode) / sum(d["calls"] for d in decode)
        lane_ms = sum(d["device_ms"] for d in lanes) / max(1, sum(d["calls"] for d in lanes))
        decode_bytes_per_s = tps / useful * d_chunks * K * step_bytes
        drains[drain] = {
            "useful_tok_s": tps, "seconds": [p["seconds"] for p in ps],
            "decode_chunks_per_pass": d_chunks, "prefill_chunks_per_pass": _mean(ps, "prefill_chunks"),
            "emit_occupancy": useful / (d_chunks * K * S),
            "hbm_GBps_floor": decode_bytes_per_s / 1e9, "hbm_share_floor": decode_bytes_per_s / H100_HBM_BYTES_PER_S,
            "decode_chunk_ms": chunk_ms, "decode_step_ms": chunk_ms / K,
            "decode_step_bound_ms": step_bytes / H100_HBM_BYTES_PER_S * 1e3,
            "decode_step_share_of_bound": step_bytes / H100_HBM_BYTES_PER_S * 1e3 / (chunk_ms / K),
            "lane_call_ms": lane_ms,
            "decode_device_share_of_pass": sum(d["device_ms"] for d in decode) / 1e3 / sum(p["seconds"] for p in ps),
            "lanes_device_share_of_pass": sum(d["device_ms"] for d in lanes) / 1e3 / sum(p["seconds"] for p in ps),
            **{k: _mean(ps, k) for k in ("t_fetch_s", "t_dispatch_s", "t_prefill_s", "t_sched_s")},
            "first_pass_s": first[drain]["seconds"], "build": built[drain],
        }
    profile = device_profile(lambda: serve_pass(eng, prompts, budgets), category=kernel_category)
    # One decode chunk and one 4-lane call replayed alone, by kernel category
    # (the drain is over: the chunk runs with every slot idle, the lane call
    # on its last arguments; the same kernels either way).
    by_program = {}
    for name, graph in programs.items() if programs["decode_chunk"] is not None else ():
        got = device_profile(graph.replay, category=kernel_category)
        by_program[name] = {"ms": got["device_busy_ms_per_unit"], "kernels": got["kernels_per_unit"],
                            "ms_by_category": got["device_ms_per_unit_by_category"]}
    emit({"phase": "serve_7b_int8", "config": cfg, "engine": eng_cfg, "traffic": SERVE7B_TRAFFIC,
          "cut": "none (int8 weights, 6 GB)", "weight_bytes": weight_bytes, "model_build_s": model_s,
          "useful_tokens": useful, "decode_bytes_per_step": step_bytes, "avg_ctx": avg_ctx,
          "kv_bytes": "int8 codes only, as bench.py:519-521 (the f32 scales add 4 / 128)",
          "lane_row_gather_scatter_MB": 4 * row_bytes / 1e6,
          "lane_row_gather_scatter_bound_ms": 4 * row_bytes / H100_HBM_BYTES_PER_S * 1e3,
          "launches": launches, "launches_per_warm_pass": pass_launches, "launches_per_replay": per_program,
          "warm_pass_captures": warm_captures, "drains": drains,
          "kernel_share": {k: v for k, v in profile.items() if k != "kernels_per_unit_by_category"},
          "program_profiles": by_program})
    del engines, timers
    torch.cuda.empty_cache()
    return launches, {drain: d["useful_tok_s"] for drain, d in drains.items()}


def serve_mixed_96_phase(device, dense) -> dict:
    """Cell 2 (bench.py:627-744): the production Llama in bf16 with dense
    attention serving 96 requests through the open-loop engine (bucketed
    prefill, 32 slots), against static batching (three generate_batch calls
    of 32 rows, pad_to=192, 64 new tokens), in turns; beside them the same
    engine with its bucketed prefill run eagerly (``use_graph`` turned off
    before its first prefill: decode chunks still replay), the route before
    the prefill programs were captured. The engine's useful tok/s,
    interactive_vs_static, the t_* breakdown and the bucketed prefill's
    device share of a drain."""
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine, TorchGenerator
    from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention
    from runia_core_tpu_torch.ops.quant_matmul import quant_matmul

    model = sharing(dense, use_flash=False)
    prompts, budgets = serve_traffic(MIXED_TRAFFIC, LLM_CFG["vocab_size"])
    useful, rows, K = sum(budgets), MIXED_ENGINE["num_slots"], MIXED_ENGINE["chunk_tokens"]
    start = time.perf_counter()
    engine = ContinuousBatchingEngine(model, **MIXED_ENGINE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - start
    quant_matmul.launches = 0
    flash_prefix_attention.launches = flash_prefix_attention.kv8_launches = 0
    first = timed_serve_pass(engine, None, prompts, budgets, "serve_mixed_96")  # the main path
    launches = {"quant_matmul": quant_matmul.launches, "flash_prefix_attention": flash_prefix_attention.launches}
    require(launches == {"quant_matmul": 0, "flash_prefix_attention": 0},
            f"serve_mixed_96: a bf16 dense engine runs no hand kernel: {launches}")
    eager_prefill = ContinuousBatchingEngine(model, **MIXED_ENGINE)
    eager_prefill.use_graph = False  # its bucketed prefill programs are built uncaptured
    timed_serve_pass(eager_prefill, None, prompts, budgets, "serve_mixed_96 eager prefill")
    gen = TorchGenerator(model, max_new_tokens=MIXED_ENGINE["max_new_tokens"])

    def static_pass():
        out = []
        for i in range(0, len(prompts), rows):
            out.append(gen.generate_batch(prompts[i:i + rows], output_scores=False, pad_to=MIXED_STATIC_PAD))
        return out

    static_pass()  # captures its decode program
    fused = ContinuousBatchingEngine(model, **FUSED_MIXED_ENGINE)
    fused_first = timed_fused_pass(fused, prompts, budgets, FUSED_MIXED_LANES, "serve_mixed_96 fused")
    fused_timer = FusedTimer(next(iter(fused._fused_cache.entries.values())))
    engines = {"engine": engine, "engine_eager_prefill": eager_prefill}
    timers = {name: ProgramTimer(e) for name, e in engines.items()}
    passes, static_seconds, fused_passes = {name: [] for name in engines}, [], []
    for turn in range(SERVE_PASSES):
        order = ["engine", "engine_eager_prefill", "fused", "static"]
        for kind in order if turn % 2 == 0 else order[::-1]:
            if kind == "fused":
                fused_passes.append(timed_fused_pass(fused, prompts, budgets, FUSED_MIXED_LANES,
                                                     "serve_mixed_96 fused", fused_timer))
            elif kind == "static":
                torch.cuda.synchronize()
                start = time.perf_counter()
                with no_host_sync():
                    out = static_pass()
                static_seconds.append(time.perf_counter() - start)
                require(all(bool(np.isfinite(o["log_probs"]).all()) for o in out), "serve_mixed_96: static finite")
            else:
                passes[kind].append(timed_serve_pass(engines[kind], timers[kind], prompts, budgets,
                                                     f"serve_mixed_96 {kind}"))
    warm_captures = sum(p["captures"] for ps in [*passes.values(), fused_passes] for p in ps)
    require(warm_captures == 0, f"serve_mixed_96: warm passes capture nothing, got {warm_captures}")
    static_tps = useful / statistics.mean(static_seconds)
    fused_tps = useful / _mean(fused_passes, "seconds")
    record = {}
    for name, ps in passes.items():
        wall_ms = 1e3 * sum(p["seconds"] for p in ps)
        bucketed = [p["programs"]["bucketed"] for p in ps]
        decode = [p["programs"]["decode"] for p in ps]
        chunk_ms = sum(d["device_ms"] for d in decode) / sum(d["calls"] for d in decode)
        d_chunks = _mean(ps, "decode_chunks")
        tps = useful / _mean(ps, "seconds")
        record[name] = {
            "useful_tok_s": tps, "seconds": [p["seconds"] for p in ps], "interactive_vs_static": tps / static_tps,
            **{k: _mean(ps, k) for k in ("t_fetch_s", "t_dispatch_s", "t_prefill_s", "t_sched_s")},
            "bucketed_prefill_calls_per_pass": sum(b["calls"] for b in bucketed) / len(bucketed),
            "bucketed_prefill_ms_per_call": sum(b["device_ms"] for b in bucketed) / sum(b["calls"] for b in bucketed),
            "bucketed_prefill_device_share_of_drain": sum(b["device_ms"] for b in bucketed) / wall_ms,
            "decode_device_share_of_drain": sum(d["device_ms"] for d in decode) / wall_ms,
            "decode_chunk_ms": chunk_ms, "decode_step_ms": chunk_ms / K, "decode_chunks_per_pass": d_chunks,
            "emit_occupancy": useful / (d_chunks * K * rows),
        }
    emit({"phase": "serve_mixed_96", "config": LLM_CFG, "engine": MIXED_ENGINE, "traffic": MIXED_TRAFFIC,
          "cut": "none", "useful_tokens": useful, "engine_build_s": build_s, "first_pass_s": first["seconds"],
          "bucketed_programs": sorted(engine._bucket_progs), "launches": launches,
          **record["engine"], "static_tok_s": static_tps, "static_seconds": static_seconds,
          "static": f"TorchGenerator.generate_batch x {len(prompts) // rows} of {rows} rows, pad_to="
                    f"{MIXED_STATIC_PAD}, {MIXED_ENGINE['max_new_tokens']} new tokens (graph route)",
          "engine_eager_prefill": record["engine_eager_prefill"],
          "fused_tok_s": fused_tps, "fused_vs_static": fused_tps / static_tps,
          "fused_vs_interactive": fused_tps / record["engine"]["useful_tok_s"],
          "fused": {"engine": FUSED_MIXED_ENGINE, "lanes": FUSED_MIXED_LANES, "first_call": fused_first,
                    "seconds": [p["seconds"] for p in fused_passes], "passes": fused_passes},
          "warm_pass_captures": warm_captures})
    del engine, eager_prefill, engines, gen, timers, fused, fused_timer
    _drop_programs()
    torch.cuda.empty_cache()
    return launches


def _same_served(got, want, atol: float, what: str, rel: bool = False) -> float:
    """Tokens identical and the largest log-prob difference (relative to
    max(1, max|log-prob|) with ``rel``) within ``atol``; returns it."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        require(g["tokens"] == w["tokens"], f"{what}: request {i} tokens {g['tokens']} != {w['tokens']}")
        if len(g["tokens"]):
            err = float(np.abs(g["log_probs"] - w["log_probs"]).max())
            worst = max(worst, err / max(1.0, float(np.abs(w["log_probs"]).max())) if rel else err)
    require(worst <= atol, f"{what}: log-prob err {worst} > {atol}")
    return worst


def serve_check_phase(device, dense) -> dict:
    """Correctness of the served path on the card, under sync-debug "error".
    (a) Replays against the eager programs (``use_graph=False``): cell 1's
    engine at 2 layers (both drains) and cell 2's at full depth, 8 requests
    each: tokens identical, log-probs within GRAPH_LOGPROB_ATOL; a second
    pass captures nothing. (b) The card against the CPU: f32, 2 layers at
    cell 1's width, float and int8 + KV8 + fused, chunked prefill of 128 in
    lanes of 4 with the prefix cache on prompts sharing a 256-token prefix:
    tokens identical, log-probs within LLM_XCHECK_REL of max(1, |lp|).
    (c) The engine's greedy tokens are TorchGenerator.generate's."""
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine, TorchGenerator
    from runia_core_tpu_torch.models import LlamaLM, fuse_quantized_llama_params, quantize_llama_params
    from runia_core_tpu_torch.utils import CudaGraph

    record = {"graph_vs_eager": {}, "card_vs_cpu": {}, "engine_vs_generator": {}}
    n = SERVE_CHECK_REQUESTS
    p7, b7 = serve_traffic(SERVE7B_TRAFFIC, SERVE7B_CFG["vocab_size"])
    pm, bm = serve_traffic(MIXED_TRAFFIC, LLM_CFG["vocab_size"])
    small7b = build_serve7b(device, SERVE_CHECK_LAYERS)
    cases = [("serve_7b_int8_2_layers_open_loop", small7b, dict(SERVE7B_ENGINE, defer_fetch=True), p7[:n], b7[:n]),
             ("serve_7b_int8_2_layers_lookahead", small7b, SERVE7B_ENGINE, p7[:n], b7[:n]),
             ("serve_mixed_full_depth", sharing(dense, use_flash=False), MIXED_ENGINE, pm[:n], bm[:n])]
    for name, model, kw, prompts, budgets in cases:
        graph = ContinuousBatchingEngine(model, **kw)
        eager = ContinuousBatchingEngine(model, **kw, use_graph=False)
        with no_host_sync():
            want = serve_pass(eager, prompts, budgets)
            got = serve_pass(graph, prompts, budgets)
            captures = CudaGraph.captures
            again = serve_pass(graph, prompts, budgets)
        require(CudaGraph.captures == captures, f"serve_check {name}: a warm pass captures nothing")
        check_served(got, budgets, f"serve_check {name}")
        err = _same_served(got, want, GRAPH_LOGPROB_ATOL, f"serve_check {name}: replay vs eager")
        _same_served(again, got, 0.0, f"serve_check {name}: second pass")
        record["graph_vs_eager"][name] = {"max_abs_err_log_probs": err, "requests": len(prompts)}
        del graph, eager
    del small7b, cases

    # (b) and (c): f32, 2 layers at cell 1's width
    cfg = dict(SERVE7B_CFG, num_layers=SERVE_CHECK_LAYERS)
    f32 = LlamaLM(**cfg, dtype=torch.float32, use_flash=True).eval()
    f32.init_weights(torch.Generator(device=device).manual_seed(SEED + 21))
    int8 = LlamaLM(**cfg, dtype=torch.float32, use_flash=True, quantized=True, quantized_kv=True,
                   fused_qkv=True).eval()
    int8.load_state_dict(fuse_quantized_llama_params(quantize_llama_params(f32.state_dict())))
    rng = np.random.RandomState(SEED + 22)
    xc = SERVE_XCHECK
    system = list(rng.randint(1, cfg["vocab_size"], xc["system"]))
    prompts = [system + list(rng.randint(1, cfg["vocab_size"], rng.randint(*xc["suffix"])))
               for _ in range(xc["requests"])]
    budgets = [xc["new"]] * len(prompts)
    kw = dict(num_slots=4, max_ctx=SERVE7B_ENGINE["max_ctx"], max_new_tokens=xc["new"], chunk_tokens=4,
              prefill_chunk=128, prefill_lanes=4, prefix_cache=True)
    for name, model in (("f32", f32), ("int8_kv8", int8)):
        cpu = LlamaLM(**cfg, dtype=torch.float32, use_flash=True, quantized=model.quantized,
                      quantized_kv=model.quantized_kv, fused_qkv=model.fused_qkv, device="cpu").eval()
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        card_engine = ContinuousBatchingEngine(model, **kw)
        with no_host_sync():
            got = serve_pass(card_engine, prompts, budgets)
        cpu_engine = ContinuousBatchingEngine(cpu, **kw)
        want = serve_pass(cpu_engine, prompts, budgets)
        hits = card_engine.stats()["prefix_hits"]
        require(hits > 0 and hits == cpu_engine.stats()["prefix_hits"], f"serve_check {name}: prefix hits {hits}")
        err = _same_served(got, want, LLM_XCHECK_REL[name], f"serve_check {name}: card vs CPU", rel=True)
        record["card_vs_cpu"][name] = {"max_rel_err_log_probs": err, "prefix_hits": hits}
        del cpu, cpu_engine, card_engine
    gen = TorchGenerator(f32, max_new_tokens=xc["new"])
    for name, engine_kw in (("chunked_prefix", kw), ("bucketed", dict(num_slots=2, max_ctx=512, chunk_tokens=3))):
        engine = ContinuousBatchingEngine(f32, **{**engine_kw, "max_new_tokens": xc["new"]})
        with no_host_sync():
            got = serve_pass(engine, prompts, budgets)
            want = [gen.generate(p, output_attentions=False, output_hidden_states=False) for p in prompts]
        for i, (g, w) in enumerate(zip(got, want)):
            require(g["tokens"] == w["sequences"][0, len(prompts[i]):].tolist(),
                    f"serve_check {name}: request {i} equals TorchGenerator.generate")
        record["engine_vs_generator"][name] = {"requests": len(prompts), "tokens_identical": True}
    emit({"phase": "serve_check", "layers": SERVE_CHECK_LAYERS, "bound_graph_log_probs": GRAPH_LOGPROB_ATOL,
          "bound_card_vs_cpu": LLM_XCHECK_REL, **record})
    del f32, int8, gen
    _drop_programs()
    torch.cuda.empty_cache()
    return record


# ---- PR: the speculative engine, the fused drain and the serving fronts ----
def spec_traffic(vocab: int):
    """(prompts, budgets) as bench.py:887-893 draws them: the system
    prompt, the budgets, the suffix lengths, then each suffix's tokens."""
    t = SPEC_TRAFFIC
    rng = np.random.RandomState(t["seed"])
    system = list(rng.randint(1, vocab, t["system"]))
    budgets = rng.randint(*t["budgets"], t["requests"])
    prompts = [system + list(rng.randint(1, vocab, int(n))) for n in rng.randint(*t["suffixes"], t["requests"])]
    return prompts, [int(b) for b in budgets]


def distilled_pair(model, draft_layers: int = SPEC_DRAFT_LAYERS):
    """The distilled pair of bench.py:810-871 from ``model``: a target whose
    o / down outputs of blocks ``draft_layers``.. are scaled by SPEC_EPS (an
    int8 model's per-column scales, so every weight byte is still read), and
    a draft of its first ``draft_layers`` blocks, norm_f and lm_head. Both
    hold ``model``'s tensors; only the scaled ones are new."""
    from runia_core_tpu_torch.models import LlamaLM

    keys = ("vocab_size", "num_layers", "num_heads", "num_kv_heads", "d_model", "hidden_dim", "max_len", "dtype",
            "use_flash", "quantized", "quantized_kv", "fused_qkv")
    cfg = {k: getattr(model, k) for k in keys}
    leaf = "scale" if model.quantized else "kernel"
    state = dict(model.state_dict())
    for i in range(draft_layers, model.num_layers):
        for proj in ("o", "down"):
            name = f"block_{i}.{proj}.{leaf}"
            state[name] = state[name] * SPEC_EPS
    target = LlamaLM(**cfg).eval()
    target.load_state_dict(state, assign=True)
    draft = LlamaLM(**dict(cfg, num_layers=draft_layers)).eval()
    draft.load_state_dict({k: v for k, v in state.items() if not k.startswith("block_")
                           or int(k.split(".")[0][6:]) < draft_layers}, assign=True)
    return target, draft


def _counted() -> dict:
    """The launch counts of kernels 3 and 4 (bf16 and KV8)."""
    from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention
    from runia_core_tpu_torch.ops.quant_matmul import quant_matmul

    return {"quant_matmul": quant_matmul.launches, "flash_prefix_attention": flash_prefix_attention.launches,
            "flash_prefix_attention_kv8": flash_prefix_attention.kv8_launches}


def _zero_counts() -> None:
    from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention
    from runia_core_tpu_torch.ops.quant_matmul import quant_matmul

    quant_matmul.launches = 0
    flash_prefix_attention.launches = flash_prefix_attention.kv8_launches = 0


def spec_engine_phase(device, model, engine_kw: dict, phase: str, hand_kernels: bool) -> dict:
    """The speculative engine (bench.py:874-950) on ``model``'s distilled
    pair: the spec engine with its break-even guard armed
    (speculative_breakeven of the draft's byte ratio, gamma 4) against the
    plain engine on the same target and traffic. Both built once (their
    programs captured), a first pass each (the spec one is the main path,
    counted), then SPEC_ENGINE_PASSES timed passes each in turns. Useful
    tok/s and the speedup, acceptance, prefix hits, the guard, the round
    chunk's replay ms by events and its kernels by category, kernel 3 and 4
    launches, and where the greedy tokens of the two engines first differ
    (bf16: a 5-row verify and 1-row steps round differently)."""
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine, speculative_breakeven
    from runia_core_tpu_torch.utils import CudaGraph, device_profile

    target, draft = distilled_pair(model)
    cost = _read_bytes(draft) / _read_bytes(target)
    floor = speculative_breakeven(cost, SPEC_GAMMA)
    prompts, budgets = spec_traffic(model.vocab_size)
    useful = sum(budgets)
    built = {}
    engines = {}
    for kind in ("spec", "plain"):
        captures, start = CudaGraph.captures, time.perf_counter()
        extra = dict(draft_model=draft, gamma=SPEC_GAMMA, spec_min_acceptance=floor) if kind == "spec" else {}
        engines[kind] = ContinuousBatchingEngine(target, **engine_kw, **extra)
        torch.cuda.synchronize()
        built[kind] = {"seconds": time.perf_counter() - start, "captures": CudaGraph.captures - captures}
    spec = engines["spec"]
    per_replay = {"round_chunk": _graph_launches(spec._chunk_prog),
                  **{f"lanes_{w}": _graph_launches(p) for w, p in spec._lane_progs.items()}}
    round_graph = spec._chunk_prog.graph

    _zero_counts()
    first = {"spec": timed_serve_pass(spec, None, prompts, budgets, f"{phase} spec")}
    launches = _counted()
    if hand_kernels:
        require(launches["quant_matmul"] > 0 and launches["flash_prefix_attention_kv8"] > 0,
                f"{phase}: kernels 3 and 4 (KV8) launched on the main path: {launches}")
    else:
        require(launches == {"quant_matmul": 0, "flash_prefix_attention": 0, "flash_prefix_attention_kv8": 0},
                f"{phase}: a bf16 engine with prefill chunks of 64 runs no hand kernel: {launches}")
    with no_host_sync():
        spec_tokens = serve_pass(spec, prompts, budgets)
    first["plain"] = timed_serve_pass(engines["plain"], None, prompts, budgets, f"{phase} plain")
    with no_host_sync():
        plain_tokens = serve_pass(engines["plain"], prompts, budgets)
    divergence = [_first_divergence(a["tokens"], b["tokens"]) for a, b in zip(spec_tokens, plain_tokens)]

    timers = {kind: ProgramTimer(e) for kind, e in engines.items()}
    passes = {kind: [] for kind in engines}
    hits = spec.prefix_hits
    for kind in ["spec", "plain", "plain", "spec"] * SPEC_ENGINE_PASSES:
        if len(passes[kind]) < SPEC_ENGINE_PASSES:
            passes[kind].append(timed_serve_pass(engines[kind], timers[kind], prompts, budgets, f"{phase} {kind}"))
    stats = spec.stats()
    tps = {kind: useful / _mean(ps, "seconds") for kind, ps in passes.items()}
    decode = [p["programs"]["decode"] for p in passes["spec"]]
    chunk_ms = sum(d["device_ms"] for d in decode) / max(1, sum(d["calls"] for d in decode))
    plain_decode = [p["programs"]["decode"] for p in passes["plain"]]
    plain_chunk_ms = sum(d["device_ms"] for d in plain_decode) / max(1, sum(d["calls"] for d in plain_decode))
    rounds = spec._rounds
    profile = None
    if round_graph is not None:
        got = device_profile(round_graph.replay, category=kernel_category)
        profile = {"ms": got["device_busy_ms_per_unit"], "kernels": got["kernels_per_unit"],
                   "ms_by_category": got["device_ms_per_unit_by_category"]}
    record = {
        "phase": phase, "engine": engine_kw, "traffic": SPEC_TRAFFIC, "gamma": SPEC_GAMMA, "eps": SPEC_EPS,
        "draft_layers": SPEC_DRAFT_LAYERS, "draft_cost_ratio": cost, "breakeven_acceptance": floor,
        "useful_tokens": useful, "useful_tok_s": tps["spec"], "plain_useful_tok_s": tps["plain"],
        "speedup_vs_plain_engine": tps["spec"] / tps["plain"],
        "seconds": {k: [p["seconds"] for p in ps] for k, ps in passes.items()},
        "acceptance": stats.get("acceptance"), "accepted": stats["accepted"], "proposed": stats["proposed"],
        "spec_auto_disabled": bool(stats.get("spec_disabled", 0)),
        "prefix_hits_per_pass": (spec.prefix_hits - hits) / SPEC_ENGINE_PASSES,
        "decode_chunks_per_pass": {k: _mean(ps, "decode_chunks") for k, ps in passes.items()},
        "rounds_per_chunk": rounds, "round_chunk_ms": chunk_ms, "round_ms": chunk_ms / rounds,
        "plain_chunk_ms": plain_chunk_ms, "plain_step_ms": plain_chunk_ms / engine_kw["chunk_tokens"],
        "round_chunk_profile": profile, "launches": launches, "launches_per_replay": per_replay,
        "built": built, "first_pass_s": {k: v["seconds"] for k, v in first.items()},
        "warm_pass_captures": sum(p["captures"] for ps in passes.values() for p in ps),
        "greedy_first_divergence": divergence,
        "greedy_identical_requests": sum(d == len(a["tokens"]) for d, a in zip(divergence, spec_tokens)),
        **{f"t_{k}": {kind: _mean(ps, f"t_{k}_s") for kind, ps in passes.items()}
           for k in ("fetch", "dispatch", "prefill", "sched")},
    }
    emit(record)
    del engines, timers, spec, target, draft, round_graph
    torch.cuda.empty_cache()
    return launches


class FusedTimer:
    """CUDA events around a fused drain's iteration programs and the wall
    time of each call: device ms per prefill and decode iteration, and the
    host gap per iteration (the wall time the device spent on no
    iteration: the flag's copy and read, the host's choice, the launch)."""

    def __init__(self, drain):
        self.marks = {"prefill": [], "decode": []}
        self.drain = drain
        drain.programs = tuple(self._timed(kind, p) for kind, p in zip(("prefill", "decode"), drain.programs))

    def _timed(self, kind, fn):
        def call():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            self.marks[kind].append((start, end))

        return call

    def read(self, wall_s: float) -> dict:
        torch.cuda.synchronize()
        out = {kind: {"iters": len(m), "device_ms": sum(a.elapsed_time(b) for a, b in m)}
               for kind, m in self.marks.items()}
        iters = sum(v["iters"] for v in out.values())
        busy = sum(v["device_ms"] for v in out.values())
        out["host_gap_ms_per_iter"] = (wall_s * 1e3 - busy) / max(1, iters)
        out["device_share"] = busy / (wall_s * 1e3)
        for m in self.marks.values():
            m.clear()
        return out


def timed_fused_pass(engine, prompts, budgets, lanes: int, what: str, timer=None) -> dict:
    from runia_core_tpu_torch.utils import CudaGraph

    captures = CudaGraph.captures
    torch.cuda.synchronize()
    start = time.perf_counter()
    with no_host_sync():
        results = engine.generate_all_fused(prompts, budgets, prefill_lanes=lanes)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    check_served(results, budgets, what)
    drain = next(iter(engine._fused_cache.entries.values()))
    return {"seconds": seconds, "captures": CudaGraph.captures - captures, **engine._last_fused_stats,
            "flag_reads": drain.flag_reads, "programs": timer.read(seconds) if timer else None}


def fused_7b_phase(device, model, interactive_tok_s: dict) -> dict:
    """The fused offline drain on cell 1 (the 7B int8 + KV8 model, 24
    requests, SERVE7B_ENGINE) in lanes of 4 x 128 chosen on the device: the
    first call captures the two iteration programs and is the main path
    (counted: kernel 3 at 512 rows, kernel 4's KV8 variant), then timed
    calls; tok/s beside the interactive drains' (serve_7b_int8),
    _last_fused_stats, captures a call, the host gap an iteration."""
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine

    prompts, budgets = serve_traffic(SERVE7B_TRAFFIC, model.vocab_size)
    useful = sum(budgets)
    engine = ContinuousBatchingEngine(model, **SERVE7B_ENGINE)
    _zero_counts()
    first = timed_fused_pass(engine, prompts, budgets, FUSED_7B_LANES, "fused_7b")
    launches = _counted()
    require(launches["quant_matmul"] > 0 and launches["flash_prefix_attention_kv8"] > 0,
            f"fused_7b: kernels 3 and 4 (KV8) launched on the main path: {launches}")
    drain = next(iter(engine._fused_cache.entries.values()))
    per_replay = {name: _graph_launches(p) for name, p in zip(("prefill_iter", "decode_iter"), drain.programs)}
    timer = FusedTimer(drain)
    passes = [timed_fused_pass(engine, prompts, budgets, FUSED_7B_LANES, "fused_7b", timer) for _ in range(2)]
    require(all(p["captures"] == 0 for p in passes), "fused_7b: a warm call captures nothing")
    tps = useful / _mean(passes, "seconds")
    record = {"phase": "fused_7b", "engine": SERVE7B_ENGINE, "lanes": FUSED_7B_LANES, "traffic": SERVE7B_TRAFFIC,
              "useful_tokens": useful, "fused_tok_s": tps, "interactive_tok_s": interactive_tok_s,
              "seconds": [p["seconds"] for p in passes], "first_call": first, "passes": passes,
              "launches": launches, "launches_per_replay": per_replay}
    emit(record)
    del engine, drain, timer
    torch.cuda.empty_cache()
    return launches


def uncertainty_serving_phase(device, dense) -> dict:
    """bench.py:1048-1125: UncertaintyServer with all six methods on the
    production Llama in bf16 (dense attention) in the merged layout, the
    deberta-v2-large judge through wrap_torch_nli; a warm pass (the bucketed
    prefill programs are captured there), then UNC_PASSES timed passes, each
    on a fresh prompt set: responses/s, every score finite."""
    from runia_core_tpu_torch.llm import UncertaintyServer
    from runia_core_tpu_torch.models import DebertaV2Classifier, wrap_torch_nli
    from runia_core_tpu_torch.utils import CudaGraph

    model = sharing(dense, use_flash=False)
    nli = DebertaV2Classifier(**NLI_LARGE, dtype=torch.bfloat16).eval()
    nli.init_weights(torch.Generator(device=device).manual_seed(SEED + 8))
    judge = wrap_torch_nli(nli, PairTok(NLI_LARGE["vocab_size"]), max_len=96, len_buckets=(96,), batch_bucket=16)
    server = UncertaintyServer(model, None, SEMANTIC_REQUESTS, num_samples=UNC_SAMPLES, max_new_tokens=UNC_NEW,
                               temperature=0.9, entailment_model=judge, engine_kwargs=UNC_ENGINE)
    require(server._merged, "uncertainty_serving: one drain serves the deterministic pass and the samples")

    def one_pass(seed):
        rng = np.random.RandomState(seed)
        prompts = [list(rng.randint(1, LLM_CFG["vocab_size"], int(n))) for n in rng.randint(24, 65, UNC_PROMPTS)]
        captures = CudaGraph.captures
        torch.cuda.synchronize()
        start = time.perf_counter()
        with no_host_sync():
            _, scores = server.serve(prompts)
        seconds = time.perf_counter() - start
        require(len(scores) == UNC_PROMPTS, "uncertainty_serving: one score dict a prompt")
        for s_ in scores:
            require(all(np.isfinite(s_[k]) for k in ("perplexity", "generation_entropy", "RAUQ_original_original",
                                                      "normalized_entropy", "eigen_score", "semantic_entropy")),
                    f"uncertainty_serving: every score finite: {s_}")
        return {"seconds": seconds, "captures": CudaGraph.captures - captures,
                "semantic_entropy_mean": float(np.mean([s_["semantic_entropy"] for s_ in scores]))}

    warm = one_pass(11)
    passes = [one_pass(12 + i) for i in range(UNC_PASSES)]
    stats = server.stats()["deterministic"]
    record = {"phase": "uncertainty_serving", "config": LLM_CFG, "engine": UNC_ENGINE,
              "methods": [r["method_name"] for r in SEMANTIC_REQUESTS], "prompts": UNC_PROMPTS,
              "samples": UNC_SAMPLES, "new_tokens": UNC_NEW, "temperature": 0.9,
              "judge": "deberta-v2-large geometry (bench.py _NLI_LARGE), max_len 96, batch_bucket 16",
              "responses_per_s": UNC_PROMPTS / _mean(passes, "seconds"),
              "decoded_tokens_per_s": UNC_PROMPTS * (1 + UNC_SAMPLES) * UNC_NEW / _mean(passes, "seconds"),
              "seconds": [p["seconds"] for p in passes], "warm_pass": warm, "passes": passes,
              "engine_stats": {k: v for k, v in stats.items() if not k.startswith("t_")}}
    emit(record)
    del server, judge, nli, model
    torch.cuda.empty_cache()
    return {}


def generation_service_phase(device, dense) -> dict:
    """GenerationService on the production Llama (bf16): SERVICE_REQUESTS
    prompts of mixed lengths submitted from SERVICE_THREADS threads while
    the worker captures and replays the decode programs. Every
    generate_batch call the worker made is repeated directly with the same
    arguments (bit-identical outputs), and every request's result is its
    row of its call."""
    import threading

    from runia_core_tpu_torch.llm import GenerationService, TorchGenerator
    from runia_core_tpu_torch.utils import CudaGraph

    gen = TorchGenerator(dense, max_new_tokens=SERVICE_NEW)
    calls, real = [], gen.generate_batch

    def recorded(prompts, **kw):
        out = real(prompts, **kw)
        calls.append((prompts, kw, out))
        return out

    gen.generate_batch = recorded
    rng = np.random.RandomState(SEED + 30)
    prompts = [list(rng.randint(1, LLM_CFG["vocab_size"], int(n))) for n in rng.randint(16, 161, SERVICE_REQUESTS)]
    service = GenerationService(gen, max_batch=SERVICE_BATCH, max_wait_s=0.05, length_bucket=64)
    futures = [None] * len(prompts)

    def submit(part):
        for i in range(part, len(prompts), SERVICE_THREADS):
            futures[i] = service.submit(prompts[i])

    captures = CudaGraph.captures
    start = time.perf_counter()
    threads = [threading.Thread(target=submit, args=(k,)) for k in range(SERVICE_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        results = [f.result(timeout=600) for f in futures]
    finally:
        service.close()
    seconds = time.perf_counter() - start
    gen.generate_batch = real
    for filled, kw, out in calls:
        again = gen.generate_batch(filled, **kw)
        require(np.array_equal(again["sequences"], out["sequences"])
                and np.array_equal(again["log_probs"], out["log_probs"]),
                "generation_service: a direct generate_batch call equals the worker's")
    for p, res in zip(prompts, results):
        row = next((filled, i, out) for filled, _, out in calls for i, q in enumerate(filled) if list(q) == list(p))
        filled, i, out = row
        seq = out["sequences"][i]
        require(np.array_equal(res["sequences"][0], seq[seq.shape[0] - len(p) - SERVICE_NEW:])
                and np.array_equal(res["log_probs"], out["log_probs"][i]),
                "generation_service: each result is its row of its call")
        require(res["sequences"][0][:len(p)].tolist() == [int(t) for t in p], "generation_service: the prompt leads")
    record = {"phase": "generation_service", "config": LLM_CFG, "requests": SERVICE_REQUESTS,
              "threads": SERVICE_THREADS, "max_batch": SERVICE_BATCH, "new_tokens": SERVICE_NEW,
              "calls": len(calls), "rows_per_call": [len(c[0]) for c in calls],
              "pad_to": sorted({c[1]["pad_to"] for c in calls}), "seconds": seconds,
              "requests_per_s": SERVICE_REQUESTS / seconds, "captures": CudaGraph.captures - captures,
              "identical_to_direct_calls": True}
    emit(record)
    del gen
    _drop_programs()
    torch.cuda.empty_cache()
    return {}


def guard_prefix_check(device, target) -> dict:
    """The break-even guard fires at a drain boundary and captures the
    draft-free lane programs on null lanes aimed at slot 0; slot 0's rows
    must survive it. A draft of other random weights (acceptance near 0)
    under a floor of 0.99 serves cell 1's traffic (no shared prefix), then
    requests that share only slot 0's first prompt chunk: the graph engine's
    prefix hits must equal the use_graph=False engine's, which never loses
    the slot, and their tokens must agree."""
    import warnings

    from runia_core_tpu_torch.llm import ContinuousBatchingEngine

    draft = build_serve7b(device, 1, seed=SEED + 33)
    n, chunk = SERVE_CHECK_REQUESTS, SPEC7B_ENGINE["prefill_chunk"]
    prompts, budgets = serve_traffic(SERVE7B_TRAFFIC, SERVE7B_CFG["vocab_size"])
    prompts, budgets = prompts[:n], [min(b, SPEC7B_ENGINE["max_new_tokens"]) for b in budgets[:n]]
    rng = np.random.RandomState(SEED + 34)
    suffixes = [list(rng.randint(1, SERVE7B_CFG["vocab_size"], int(k))) for k in rng.randint(8, 65, 4)]
    kw = dict(SPEC7B_ENGINE, draft_model=draft, gamma=SPEC_GAMMA, spec_min_acceptance=0.99)
    runs = {}
    for use_graph in (True, False):
        engine = ContinuousBatchingEngine(target, **kw, use_graph=use_graph)
        with no_host_sync() if use_graph else contextlib.nullcontext():
            serve_pass(engine, prompts, budgets)
            require(engine.stats()["proposed"] >= engine._SPEC_EVIDENCE, "guard check: enough proposals")
            later = [list(engine._slot_prompt[0][:chunk]) + s for s in suffixes]
            hits = engine.stats()["prefix_hits"]
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                served = serve_pass(engine, later, [4] * len(later))
        require(any("speculative decoding disabled" in str(w.message) for w in caught),
                f"guard check (use_graph={use_graph}): the guard fired")
        runs[use_graph] = {"hits": engine.stats()["prefix_hits"] - hits, "served": served, "later": later,
                           "acceptance": engine.stats()["acceptance"]}
        del engine
    require(runs[True]["later"] == runs[False]["later"], "guard check: the same prompt sits in slot 0")
    require(runs[True]["hits"] == runs[False]["hits"] > 0,
            f"guard check: prefix hits after the guard, graph {runs[True]['hits']} vs eager {runs[False]['hits']}")
    err = _same_served(runs[True]["served"], runs[False]["served"], GRAPH_LOGPROB_ATOL, "guard check: replay vs eager")
    return {"prefix_hits_after_guard": runs[True]["hits"], "eager_prefix_hits": runs[False]["hits"],
            "acceptance": runs[True]["acceptance"], "max_abs_err_log_probs": err}


def spec_serve_check_phase(device) -> dict:
    """Correctness of the new programs on the card, under sync-debug
    "error" (the flag reads are the only other waits). (a) Replays against
    use_graph=False at the 7B width, 2 layers, int8 + KV8 with a 1-block
    draft: the spec round chunk and lanes, both fused iterations (plain and
    spec): tokens identical, log-probs within GRAPH_LOGPROB_ATOL.
    (b) f32, 2 layers: the card against the CPU for the spec engine and the
    fused drains (LLM_XCHECK_REL of max(1, |lp|)), int8 + KV8 too. (c) The
    spec engine's greedy tokens are the plain engine's (f32).
    (d) generate_all_fused(prefill_lanes=1) equals generate_all bit for
    bit. (e) ``guard_prefix_check``: after the break-even guard fires, the
    prefix cache hits slot 0 as the use_graph=False engine does."""
    from runia_core_tpu_torch.llm import ContinuousBatchingEngine
    from runia_core_tpu_torch.models import LlamaLM, fuse_quantized_llama_params, quantize_llama_params

    record = {"graph_vs_eager": {}, "card_vs_cpu": {}, "spec_vs_plain": {}, "fused_one_lane_vs_interactive": {}}
    n = SERVE_CHECK_REQUESTS
    sp, sb = spec_traffic(SERVE7B_CFG["vocab_size"])
    sp, sb = sp[:n], sb[:n]
    p7, b7 = serve_traffic(SERVE7B_TRAFFIC, SERVE7B_CFG["vocab_size"])
    p7, b7 = p7[:n], b7[:n]
    small = build_serve7b(device, SPEC_CHECK_LAYERS)
    target, draft = distilled_pair(small, 1)
    spec_kw = dict(SPEC7B_ENGINE, draft_model=draft, gamma=SPEC_GAMMA)
    fused_spec_kw = dict(SERVE7B_ENGINE, chunk_tokens=SPEC7B_ENGINE["chunk_tokens"], draft_model=draft,
                         gamma=SPEC_GAMMA)
    cases = [("spec_engine", spec_kw, sp, sb, None), ("fused_plain", SERVE7B_ENGINE, p7, b7, FUSED_7B_LANES),
             ("fused_spec", fused_spec_kw, p7, b7, FUSED_7B_LANES)]

    def run(engine, prompts, budgets, lanes):
        if lanes is None:
            return serve_pass(engine, prompts, budgets)
        return engine.generate_all_fused(prompts, budgets, prefill_lanes=lanes)

    for name, kw, prompts, budgets, lanes in cases:
        graph = ContinuousBatchingEngine(target, **kw)
        eager = ContinuousBatchingEngine(target, **kw, use_graph=False)
        with no_host_sync():
            want = run(eager, prompts, budgets, lanes)
            got = run(graph, prompts, budgets, lanes)
        check_served(got, budgets, f"spec_serve_check {name}")
        err = _same_served(got, want, GRAPH_LOGPROB_ATOL, f"spec_serve_check {name}: replay vs eager")
        same_stats = graph._last_fused_stats == eager._last_fused_stats if lanes else (
            graph.stats()["accepted"] == eager.stats()["accepted"])
        require(same_stats, f"spec_serve_check {name}: the schedules agree")
        record["graph_vs_eager"][name] = {"max_abs_err_log_probs": err, "requests": len(prompts),
                                          "stats": graph._last_fused_stats if lanes else
                                          {k: graph.stats()[k] for k in ("accepted", "proposed")}}
        if name == "fused_plain":
            with no_host_sync():
                one = graph.generate_all_fused(prompts, budgets, prefill_lanes=1)
                inter = serve_pass(ContinuousBatchingEngine(target, **dict(kw, prefill_lanes=1)), prompts, budgets)
            _same_served(one, inter, 0.0, "spec_serve_check: fused lanes 1 vs generate_all, int8")
            record["fused_one_lane_vs_interactive"]["int8_kv8"] = True
        del graph, eager
    record["guard_keeps_slot_0"] = guard_prefix_check(device, target)
    del small, target, draft

    cfg = dict(SERVE7B_CFG, num_layers=SPEC_CHECK_LAYERS)
    f32 = LlamaLM(**cfg, dtype=torch.float32, use_flash=True).eval()
    f32.init_weights(torch.Generator(device=device).manual_seed(SEED + 31))
    int8 = LlamaLM(**cfg, dtype=torch.float32, use_flash=True, quantized=True, quantized_kv=True,
                   fused_qkv=True).eval()
    int8.load_state_dict(fuse_quantized_llama_params(quantize_llama_params(f32.state_dict())))
    rng = np.random.RandomState(SEED + 32)
    xc = SERVE_XCHECK
    system = list(rng.randint(1, cfg["vocab_size"], xc["system"]))
    prompts = [system + list(rng.randint(1, cfg["vocab_size"], rng.randint(*xc["suffix"])))
               for _ in range(xc["requests"])]
    budgets = [2 * xc["new"]] * len(prompts)
    kw = dict(num_slots=4, max_ctx=SERVE7B_ENGINE["max_ctx"], max_new_tokens=2 * xc["new"], chunk_tokens=10,
              prefill_chunk=128, prefill_lanes=4, prefix_cache=True)
    for name, model in (("f32", f32), ("int8_kv8", int8)):
        target, draft = distilled_pair(model, 1)
        cpu_t, cpu_d = (LlamaLM(**{k: getattr(m, k) for k in ("vocab_size", "num_layers", "num_heads",
                                                              "num_kv_heads", "d_model", "hidden_dim", "max_len",
                                                              "use_flash", "quantized", "quantized_kv",
                                                              "fused_qkv")}, dtype=torch.float32,
                                device="cpu").eval() for m in (target, draft))
        cpu_t.load_state_dict({k: v.cpu() for k, v in target.state_dict().items()})
        cpu_d.load_state_dict({k: v.cpu() for k, v in draft.state_dict().items()})
        out = {}
        for what, lanes in (("spec_engine", None), ("fused_spec", 4), ("fused_plain", 4)):
            spec_extra = {} if what == "fused_plain" else dict(gamma=SPEC_GAMMA)
            card = ContinuousBatchingEngine(target, **kw, **spec_extra,
                                            **({} if what == "fused_plain" else {"draft_model": draft}))
            cpu = ContinuousBatchingEngine(cpu_t, **kw, **spec_extra,
                                           **({} if what == "fused_plain" else {"draft_model": cpu_d}))
            with no_host_sync():
                got = run(card, prompts, budgets, lanes)
            want = run(cpu, prompts, budgets, lanes)
            out[what] = {"max_rel_err_log_probs": _same_served(got, want, LLM_XCHECK_REL[name],
                                                               f"spec_serve_check {name} {what}: card vs CPU",
                                                               rel=True)}
            if what == "spec_engine":
                out[what]["acceptance"] = card.stats().get("acceptance")
                if name == "f32":
                    plain = ContinuousBatchingEngine(target, **kw)
                    with no_host_sync():
                        base = serve_pass(plain, prompts, budgets)
                    record["spec_vs_plain"]["f32_tokens_identical"] = all(
                        a["tokens"] == b["tokens"] for a, b in zip(got, base))
                    require(record["spec_vs_plain"]["f32_tokens_identical"],
                            "spec_serve_check: greedy spec tokens are the plain engine's (f32)")
            del card, cpu
        record["card_vs_cpu"][name] = out
        del cpu_t, cpu_d, target, draft
    emit({"phase": "spec_serve_check", "layers": SPEC_CHECK_LAYERS, "bound_graph_log_probs": GRAPH_LOGPROB_ATOL,
          "bound_card_vs_cpu": LLM_XCHECK_REL, **record})
    del f32, int8
    torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------------------
# Image level C: the int8 PTQ leg, ViT-B/16, training
# ---------------------------------------------------------------------------


@torch.no_grad()
def randomize_resnet(model, generator: torch.Generator):
    """tests/test_torch_resnet.py's randomisation on a port ResNet: kernels
    plus 0.05 N(0, 1), BatchNorm scales and variances uniform in [0.5, 1.5),
    shifts, means and the head bias 0.1 N(0, 1). (A fresh init puts every
    block's last BatchNorm scale at 0, which folds those convs to zero
    codes.)"""
    def noise(t):
        return torch.randn(t.shape, generator=generator, device=t.device)

    def uniform(t):
        return torch.rand(t.shape, generator=generator, device=t.device) + 0.5

    for name, t in model.state_dict().items():
        if name.endswith(".weight") and t.ndim > 1:
            t.add_(0.05 * noise(t))
        elif name.endswith((".running_var", ".weight")):
            t.copy_(uniform(t))
        else:
            t.copy_(0.1 * noise(t))
    return model


def int8_category(name: str) -> str:
    """An int8 call's kernels: the integer GEMM, the patch gathers (copies,
    zero fills, pads), the quantize / rescale / bias / ReLU / residual
    passes, kernels 1-2, the rest."""
    low = name.lower()
    for label, needle in (("marginal_entropy (kernel 1)", "marginal_entropy_kernel"),
                          ("fused_mc_entropy (kernel 2)", "fused_mc_entropy_kernel")):
        if needle in name:
            return label
    if any(k in low for k in ("gemm", "xmma", "cutlass", "imma", "nvjet", "gemv")):
        return "int8 GEMM" if any(k in low for k in ("i8", "s8", "imma", "int8", "i32")) else "f32 GEMM"
    if any(k in low for k in ("copy", "memcpy", "memset", "fill", "pad", "cat", "gather")):
        return "patch copies, pads, zero fills"
    if any(k in low for k in ("elementwise", "vectorized", "unrolled", "round", "clamp")):
        return "quantize, rescale, bias, ReLU, residual passes"
    return kernel_category(name)


def _flatten_qparams(qparams: dict) -> dict:
    return {f"{site}:{field}": value for site, fields in qparams.items() for field, value in fields.items()}


def _unflatten_qparams(state: dict) -> dict:
    out: dict = {}
    for key, value in state.items():
        site, field = key.rsplit(":", 1)
        out.setdefault(site, {})[field] = value
    return out


def _corr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(np.corrcoef(a.double().cpu().numpy().ravel(), b.double().cpu().numpy().ravel())[0, 1])


def int8_rn18_phase(device, gen, smi: str) -> dict:
    """The int8 PTQ LaREx leg (bench.py:1182-1190, larex_resnet18_32px_int8)
    through the port's entry points at full width: ResNet-18 with the CIFAR
    stem, 64 filters, 32 px, batch 512, weights and statistics randomised
    from the seed. (1) quantize_resnet_params on the card from 256 images,
    against the same calibration on the CPU (calib_device="cpu"); (2) the
    int32 sums of a stem, a 3x3 and a 1x1 projection conv, logits and taps,
    card against CPU on the same qparams; (3) counted: the fit (512 images
    through the int8 forward, 16 DropBlock samples, kernel 1, PCA-256, LaREM)
    and both scorer routes under the graph; (4) save_larex_pipeline + the
    qparams by save_state_dict -> load_larex_scorer, equal bit for bit; (5)
    int8 against the f32 forward (scores' correlation, AUROC on
    rand * 2.5 - 0.75); (6) kernels 1-2 against plain on this path's inputs;
    (7) forward ms (int8, bf16, f32) and scorer img/s, in turns."""
    import tempfile

    from runia_core_tpu_torch.checkpoint import load_larex_scorer, load_state_dict, save_larex_pipeline, save_state_dict
    from runia_core_tpu_torch.detectors import MDLatentSpace
    from runia_core_tpu_torch.evaluation import torch_auroc
    from runia_core_tpu_torch.inference import build_larex_scorer
    from runia_core_tpu_torch.models import ResNet18, build_tapped_forward, quantize_resnet, quantize_resnet_params
    from runia_core_tpu_torch.models.quant_vision import _conv_padding, _conv_sites, _site_key, _weight_matrix, int8_conv
    from runia_core_tpu_torch.models.resnet import BatchNorm
    from runia_core_tpu_torch.ops.entropy import marginal_entropy
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda, marginal_entropy_plain
    from runia_core_tpu_torch.ops.mc_entropy_cuda import fused_mc_entropy, fused_mc_entropy_plain, mc_dropblock_weights
    from runia_core_tpu_torch.reduction import apply_pca_ds_split
    from runia_core_tpu_torch.sampling import mc_dropblock_samples
    from runia_core_tpu_torch.utils import cuda_graph_time_ms, cuda_time_ms, device_profile

    def images(n):
        return torch.rand((n, IMG, IMG, 3), generator=gen, device=device)

    cfg = dict(num_classes=NUM_CLASSES, cifar_stem=True, num_filters=NUM_FILTERS)
    model = ResNet18(**cfg)
    require(model.head.weight.device == device, f"int8_rn18: the default device is the card: {model.head.weight.device}")
    randomize_resnet(model, torch.Generator(device=device).manual_seed(SEED + 13))
    model_cpu = ResNet18(**cfg, device="cpu")
    model_cpu.load_state_dict({name: t.cpu() for name, t in model.state_dict().items()})
    record = {"card": smi, "calib_images": INT8_CALIB, "fit_images": INT8_FIT, "act_quantile": INT8_QUANTILE}

    # ---- (1) calibration on the card, and on the CPU ----
    calib = images(INT8_CALIB)
    torch.cuda.synchronize()
    start = time.perf_counter()
    qparams = quantize_resnet_params(model, calib, act_quantile=INT8_QUANTILE)
    calib_s = time.perf_counter() - start
    start = time.perf_counter()
    qparams_cpu = quantize_resnet_params(model, calib, act_quantile=INT8_QUANTILE, calib_device="cpu")
    calib_cpu_s = time.perf_counter() - start
    require(sorted(qparams) == sorted(qparams_cpu) and len(qparams) == 20, f"int8_rn18: 20 conv sites: {sorted(qparams)}")
    scale_ulps, scale_rel = {}, {}
    for site in qparams:
        card, cpu = qparams[site], qparams_cpu[site]
        require(np.array_equal(card["w_q"], cpu["w_q"]), f"int8_rn18 {site}: w_q card = CPU bit for bit")
        require(np.array_equal(card["w_scale"], cpu["w_scale"]) and np.array_equal(card["bias"], cpu["bias"]),
                f"int8_rn18 {site}: w_scale and bias card = CPU bit for bit")
        scale_ulps[site] = abs(int(card["x_scale"].view(np.int32)) - int(cpu["x_scale"].view(np.int32)))
        scale_rel[site] = abs(float(card["x_scale"]) - float(cpu["x_scale"])) / float(cpu["x_scale"])
    require(scale_ulps["conv_init"] == 0, "int8_rn18: the stem's x_scale (the images' own percentile) card = CPU")
    require(max(scale_rel.values()) <= INT8_XSCALE_REL,
            f"int8_rn18: x_scale card vs CPU within {INT8_XSCALE_REL}: {scale_rel}")
    print(f"int8_rn18 calibration: {calib_s:.3f} s on the card, {calib_cpu_s:.3f} s on the CPU; x_scale card vs "
          f"CPU at most {max(scale_ulps.values())} ulps", flush=True)
    # Recorded: BatchNorm's g = scale / sqrt(var + eps) in torch on the card
    # against numpy on the host, the reason the port folds on the host.
    fold = {"channels": 0, "differing": 0}
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, BatchNorm):
                card = (module.weight / torch.sqrt(module.running_var + 1e-5)).cpu().numpy()
                host = module.weight.cpu().numpy() / np.sqrt(module.running_var.cpu().numpy() + np.float32(1e-5))
                fold["channels"] += card.size
                fold["differing"] += int((card != host).sum())
    record["calibration"] = {"card_s": calib_s, "cpu_s": calib_cpu_s, "x_scale_ulps_card_vs_cpu": scale_ulps,
                             "x_scale_max_rel": max(scale_rel.values()), "bound_rel": INT8_XSCALE_REL,
                             "w_q_equal": True, "bn_scale_torch_on_card_vs_numpy": fold}

    # ---- (2) card against CPU on the same qparams: int32 sums, logits, taps ----
    qforward = quantize_resnet(model, None, taps=("pre_pool", "penultimate", "stem"), qparams=qparams)
    qforward_cpu = quantize_resnet(model_cpu, None, taps=("pre_pool", "penultimate", "stem"), qparams=qparams)
    sites = {_site_key(s): s for s in _conv_sites(model)}
    x_small = images(INT8_XCHECK)
    shapes = {"conv_init": (IMG, 3), "stage2_block1/Conv_0": (IMG // 2, 2 * NUM_FILTERS),
              "stage3_block0/conv_proj": (IMG // 2, 2 * NUM_FILTERS)}
    sums = {}
    for key, (side, channels) in shapes.items():
        w_q = torch.from_numpy(qparams[key]["w_q"])
        xq = torch.randint(-127, 128, (INT8_XCHECK, side, side, channels), generator=gen, device=device,
                           dtype=torch.int8)
        pad = _conv_padding(model, sites[key], tuple(w_q.shape[:2]), (side, side))
        args = (tuple(w_q.shape[:2]), int(w_q.shape[-1]), sites[key]["stride"], pad)
        got = int8_conv(xq, _weight_matrix(w_q.to(device)), *args)
        want = int8_conv(xq.cpu(), _weight_matrix(w_q), *args)
        require(got.dtype == torch.int32 and torch.equal(got.cpu(), want),
                f"int8_rn18 {key}: int32 sums card = CPU bit for bit")
        sums[key] = {"shape": list(got.shape), "max_abs_sum": int(want.abs().max()), "equal": True}
    logits, taps = qforward(x_small)
    logits_cpu, taps_cpu = qforward_cpu(x_small.cpu())
    xcheck = {"logits": {"equal": bool(torch.equal(logits.cpu(), logits_cpu)), "rel": _rel(logits, logits_cpu)}}
    for tap in taps_cpu:
        xcheck[tap] = {"equal": bool(torch.equal(taps[tap].cpu(), taps_cpu[tap])), "rel": _rel(taps[tap], taps_cpu[tap])}
    for name, r in xcheck.items():
        require(r["rel"] <= INT8_XCHECK_REL, f"int8_rn18 card vs CPU {name}: rel err {r['rel']} > {INT8_XCHECK_REL}")
    record["xcheck_cpu"] = {"images": INT8_XCHECK, "int32_sums": sums, "outputs": xcheck, "bound_rel": INT8_XCHECK_REL}
    del model_cpu, qforward_cpu

    # ---- (3) the main path, counted: fit on the int8 forward, both scorer routes ----
    marginal_entropy_cuda.launches = fused_mc_entropy.launches = 0
    fit = images(INT8_FIT)
    _, taps = qforward(fit)
    fit_latent = taps["pre_pool"]
    require(fit_latent.dtype == torch.float32 and tuple(fit_latent.shape) == (INT8_FIT, 4, 4, 8 * NUM_FILTERS),
            f"int8_rn18: the f32 pre_pool tap {tuple(fit_latent.shape)}")
    fit_mc = mc_dropblock_samples(fit_latent, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, "Conv", channel_axis=3, generator=gen)
    h_fit = marginal_entropy(fit_mc, K)
    h_pca, pca_state = apply_pca_ds_split(h_fit, nro_components=PCA_DIMS)
    larem = MDLatentSpace()
    larem.setup(h_pca)
    scorers = {fused: build_larex_scorer(qforward, pca_state, larem.state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE,
                                         fused=fused) for fused in (False, True)}
    x = images(BATCH)
    for fused, scorer in scorers.items():
        for _ in range(SCORE_BATCHES):
            with no_host_sync():
                out, scores = scorer(images(BATCH), generator=gen)
            torch.cuda.synchronize()
            require(tuple(scores.shape) == (BATCH,) and bool(torch.isfinite(scores).all())
                    and tuple(out.shape) == (BATCH, NUM_CLASSES), f"int8_rn18 fused={fused}: finite scores")
    launches = {"marginal_entropy": marginal_entropy_cuda.launches, "fused_mc_entropy": fused_mc_entropy.launches}
    require(all(n > 0 for n in launches.values()), f"int8_rn18: kernels 1 and 2 launched on the main path: {launches}")
    print(f"int8_rn18 launches on the main path: {launches}", flush=True)
    record["launches"] = launches

    # ---- (4) persistence: pipeline + qparams saved, a fresh scorer rebuilt ----
    with tempfile.TemporaryDirectory() as tmp:
        save_larex_pipeline(f"{tmp}/larex.npz", pca_state, larem.state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE)
        save_state_dict(f"{tmp}/qparams.npz", _flatten_qparams(qparams))
        loaded = _unflatten_qparams(load_state_dict(f"{tmp}/qparams.npz"))
        reloaded = {fused: load_larex_scorer(f"{tmp}/larex.npz", quantize_resnet(model, None, qparams=loaded),
                                             fused=fused) for fused in (False, True)}
    reload_equal = {}
    for fused in (False, True):
        outs = []
        for scorer in (scorers[fused], reloaded[fused]):
            with no_host_sync():
                outs.append(scorer(x, generator=torch.Generator(device=device).manual_seed(SEED + 14)))
        reload_equal[fused] = bool(torch.equal(outs[0][1], outs[1][1]) and torch.equal(outs[0][0], outs[1][0]))
        require(reload_equal[fused], f"int8_rn18: the reloaded scorer (fused={fused}) equals the original bit for bit")
    record["reload_bit_identical"] = {"two_step": reload_equal[False], "fused": reload_equal[True]}

    # ---- (5) int8 against the f32 forward ----
    model32 = ResNet18(**cfg)
    model32.load_state_dict(model.state_dict())
    model32 = model32.to(memory_format=torch.channels_last).eval()
    fforward = build_tapped_forward(model32, ("pre_pool", "penultimate"))
    weights = mc_dropblock_weights(BATCH, 4, 4, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, gen, device)
    eager = {name: build_larex_scorer(fw, pca_state, larem.state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE, use_graph=False)
             for name, fw in (("int8", qforward), ("f32", fforward))}
    s_int8, s_f32 = eager["int8"](x, weights=weights)[1], eager["f32"](x, weights=weights)[1]
    tap_int8, tap_f32 = qforward(x)[1]["pre_pool"], fforward(x)[1]["pre_pool"]
    fidelity = {"scores_corr": _corr(s_int8, s_f32), "pre_pool_corr": _corr(tap_int8, tap_f32),
                "argmax_agree": float((qforward(x)[0].argmax(-1) == fforward(x)[0].argmax(-1)).float().mean())}
    require(fidelity["pre_pool_corr"] > INT8_CORR, f"int8_rn18: int8 vs f32 pre_pool correlation: {fidelity}")
    ood = torch.rand((BATCH, IMG, IMG, 3), generator=gen, device=device) * 2.5 - 0.75
    aurocs = {}
    for name, fw in (("int8", qforward), ("f32", fforward)):
        _, fit_taps = fw(fit)
        mc = mc_dropblock_samples(fit_taps["pre_pool"].float(), MC_SAMPLES, BLOCK_SIZE, DROP_PROB, "Conv",
                                  channel_axis=3, weights=mc_dropblock_weights(INT8_FIT, 4, 4, MC_SAMPLES, BLOCK_SIZE,
                                                                               DROP_PROB, gen, device))
        h_pca_own, pca_own = apply_pca_ds_split(marginal_entropy_plain(mc, K), nro_components=PCA_DIMS)
        md = MDLatentSpace()
        md.setup(h_pca_own)
        own = build_larex_scorer(fw, pca_own, md.state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE, use_graph=False)
        aurocs[name] = float(torch_auroc(own(x, weights=weights)[1], own(ood, weights=weights)[1]))
    fidelity["auroc"] = aurocs
    require(abs(aurocs["f32"] - aurocs["int8"]) < INT8_AUROC_DELTA, f"int8_rn18: AUROC f32 vs int8: {aurocs}")
    print(f"int8_rn18 int8 vs f32: scores corr {fidelity['scores_corr']:.5f}, AUROC {aurocs}", flush=True)
    record["int8_vs_f32"] = {**fidelity, "bounds": {"corr": INT8_CORR, "auroc_delta": INT8_AUROC_DELTA},
                             "ood": "rand * 2.5 - 0.75"}

    # ---- (6) kernels 1-2 against plain on this path's inputs ----
    tap = taps["pre_pool"].contiguous()
    fit_weights = mc_dropblock_weights(INT8_FIT, 4, 4, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, gen, device)
    k1_err = float((marginal_entropy_cuda(fit_mc, K) - marginal_entropy_plain(fit_mc, K)).abs().max())
    got, want = fused_mc_entropy(fit_weights, tap, K), fused_mc_entropy_plain(fit_weights, tap, K)
    k2_err = float((got - want).abs().max())
    require(k1_err <= ENTROPY_ATOL, f"int8_rn18: kernel 1 vs plain on the fit's samples: {k1_err}")
    require(bool(((got - want).abs() <= FUSED_ATOL + FUSED_RTOL * want.abs()).all()),
            f"int8_rn18: kernel 2 vs plain on the int8 tap: {k2_err}")
    record["kernel_max_abs_err"] = {"marginal_entropy": k1_err, "fused_mc_entropy": k2_err}

    # ---- (7) times: forwards (int8, bf16, f32) replayed in graphs, scorer img/s ----
    model16 = ResNet18(**cfg, dtype=torch.bfloat16)
    model16.load_state_dict(model.state_dict())
    model16 = model16.to(memory_format=torch.channels_last).eval()
    bforward = build_tapped_forward(model16)
    forwards = {"int8": qforward, "bf16": bforward, "f32": fforward}
    fwd_ms = {name: [] for name in forwards}
    for name in ("int8", "bf16", "f32", "f32", "bf16", "int8"):
        fwd_ms[name].append(cuda_graph_time_ms(lambda: forwards[name](x), 10))
    fwd_ms = {name: statistics.mean(v) for name, v in fwd_ms.items()}
    bscorers = {fused: build_larex_scorer(bforward, pca_state, larem.state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE,
                                          fused=fused) for fused in (False, True)}
    variants = {f"{p}_{'fused' if f else 'two_step'}": (s[f]) for p, s in (("int8", scorers), ("bf16", bscorers))
                for f in (False, True)}
    names = list(variants)
    times = {name: [] for name in names}
    for window in range(INT8_WINDOWS):
        for name in names[window % 4:] + names[: window % 4]:
            seeds = itertools.count(window * 1000)
            times[name].append(cuda_time_ms(
                lambda: variants[name](x, generator=torch.Generator(device=device).manual_seed(next(seeds))),
                iters=INT8_CALLS, warmup=2))
    ips = {name: BATCH / (statistics.median(ms) * 1e-3) for name, ms in times.items()}
    prof = {"forward_int8": device_profile(lambda: [qforward(x) for _ in range(5)], 5, category=int8_category),
            "scorer_int8_two_step": device_profile(lambda: [scorers[False](x, generator=gen) for _ in range(5)], 5,
                                                   category=int8_category),
            "scorer_int8_fused": device_profile(lambda: [scorers[True](x, generator=gen) for _ in range(5)], 5,
                                                category=int8_category)}
    print(f"int8_rn18 forward ms (graph replays, batch {BATCH}): " + ", ".join(
        f"{k} {v:.4f}" for k, v in fwd_ms.items()) + f"; scorer img/s: " + ", ".join(
        f"{k} {v:.0f}" for k, v in ips.items()), flush=True)
    record["times"] = {
        "card": smi, "forward_ms_graph": fwd_ms, "int8_over_bf16": fwd_ms["bf16"] / fwd_ms["int8"],
        "int8_over_f32": fwd_ms["f32"] / fwd_ms["int8"], "scorer_img_per_s_median": ips, "scorer_ms": times,
        "device_profile": {k: {"share": r["device_busy_share"], "device_ms_per_call": r["device_busy_ms_per_unit"],
                               "kernels_per_call": r["kernels_per_unit"],
                               "ms_by_category": r["device_ms_per_unit_by_category"],
                               "kernels_by_category": r["kernels_per_unit_by_category"]} for k, r in prof.items()},
    }
    emit({"phase": "int8_rn18", "batch": BATCH, **record})
    del scorers, bscorers, reloaded, eager, model, model16, model32
    torch.cuda.empty_cache()
    return launches


def vit_b16_phase(device, gen, smi: str) -> dict:
    """LaREx on a ViT-B/16 @224 (google/vit-base-patch16-224's geometry: d
    768, 12 layers, 12 heads, patch 16, CLS token and pool, exact GELU, LN
    eps 1e-12; seeded random weights, built directly: no download) at batch
    64: the (64, 14, 14, 768) encoder_tokens tap, PCA-256 and LaREM fitted on
    512 images through the two-step route's pieces, then both scorer routes
    under the graph (counted), kernels 1-2 against plain on this path's
    inputs, scorer img/s in turns."""
    from runia_core_tpu_torch.detectors import MDLatentSpace
    from runia_core_tpu_torch.inference import build_larex_scorer
    from runia_core_tpu_torch.models import ViT, build_tapped_forward
    from runia_core_tpu_torch.ops.entropy import marginal_entropy
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda, marginal_entropy_plain
    from runia_core_tpu_torch.ops.mc_entropy_cuda import fused_mc_entropy, fused_mc_entropy_plain, mc_dropblock_weights
    from runia_core_tpu_torch.reduction import apply_pca_ds_split
    from runia_core_tpu_torch.sampling import mc_dropblock_samples
    from runia_core_tpu_torch.utils import cuda_graph_time_ms, cuda_time_ms, device_profile

    def images(n):
        return torch.rand((n, VIT_IMG, VIT_IMG, 3), generator=gen, device=device)

    side = VIT_IMG // VIT_CFG["patch_size"]
    model = ViT(**VIT_CFG, image_size=VIT_IMG)
    require(model.head.weight.device == device, f"vit_b16: the default device is the card: {model.head.weight.device}")
    model.init_weights(torch.Generator(device=device).manual_seed(SEED + 16))
    forward = build_tapped_forward(model, ("encoder_tokens",))

    marginal_entropy_cuda.launches = fused_mc_entropy.launches = 0
    h_fit = []
    for _ in range(VIT_FIT // VIT_BATCH):
        _, taps = forward(images(VIT_BATCH))
        mc = mc_dropblock_samples(taps["encoder_tokens"], MC_SAMPLES, BLOCK_SIZE, DROP_PROB, "Conv", channel_axis=3,
                                  generator=gen)
        h_fit.append(marginal_entropy(mc, K))
    require(tuple(taps["encoder_tokens"].shape) == (VIT_BATCH, side, side, VIT_CFG["d_model"]),
            f"vit_b16: the encoder_tokens tap {tuple(taps['encoder_tokens'].shape)}")
    h_pca, pca_state = apply_pca_ds_split(torch.cat(h_fit), nro_components=PCA_DIMS)
    larem = MDLatentSpace()
    larem.setup(h_pca)
    scorers = {fused: build_larex_scorer(forward, pca_state, larem.state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE,
                                         tap="encoder_tokens", channel_axis=3, fused=fused) for fused in (False, True)}
    x = images(VIT_BATCH)
    for fused, scorer in scorers.items():
        for _ in range(2):
            with no_host_sync():
                out, scores = scorer(x, generator=gen)
            torch.cuda.synchronize()
            require(tuple(scores.shape) == (VIT_BATCH,) and bool(torch.isfinite(scores).all())
                    and tuple(out.shape) == (VIT_BATCH, VIT_CFG["num_classes"]), f"vit_b16 fused={fused}: finite")
    launches = {"marginal_entropy": marginal_entropy_cuda.launches, "fused_mc_entropy": fused_mc_entropy.launches}
    require(all(n > 0 for n in launches.values()), f"vit_b16: kernels 1 and 2 launched: {launches}")

    _, taps = forward(x)
    tap = taps["encoder_tokens"].contiguous()
    weights = mc_dropblock_weights(VIT_BATCH, side, side, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, gen, device)
    mc = mc_dropblock_samples(tap, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, "Conv", channel_axis=3, weights=weights)
    k1_err = float((marginal_entropy_cuda(mc, K) - marginal_entropy_plain(mc, K)).abs().max())
    got, want = fused_mc_entropy(weights, tap, K), fused_mc_entropy_plain(weights, tap, K)
    require(k1_err <= ENTROPY_ATOL, f"vit_b16: kernel 1 vs plain on the tap's samples: {k1_err}")
    require(bool(((got - want).abs() <= FUSED_ATOL + FUSED_RTOL * want.abs()).all()),
            f"vit_b16: kernel 2 vs plain on the tap: {float((got - want).abs().max())}")
    k_ms = {"marginal_entropy": cuda_graph_time_ms(lambda: marginal_entropy_cuda(mc, K), 20),
            "fused_mc_entropy": cuda_graph_time_ms(lambda: fused_mc_entropy(weights, tap, K), 20),
            "forward": cuda_graph_time_ms(lambda: forward(x), 3)}
    names = ["two_step", "fused"]
    times = {name: [] for name in names}
    for window in range(4):
        for name in names[window % 2:] + names[: window % 2]:
            seeds = itertools.count(window * 1000)
            times[name].append(cuda_time_ms(lambda: scorers[name == "fused"](
                x, generator=torch.Generator(device=device).manual_seed(next(seeds))), iters=5, warmup=1))
    ips = {name: VIT_BATCH / (statistics.median(ms) * 1e-3) for name, ms in times.items()}
    busy = device_profile(lambda: [scorers[False](x, generator=gen) for _ in range(3)], 3, category=flow_category)
    print(f"vit_b16 scorer img/s: {ips}; kernel 1 {k_ms['marginal_entropy']:.4f} ms, kernel 2 "
          f"{k_ms['fused_mc_entropy']:.4f} ms at ({VIT_BATCH}, {side}, {side}, {VIT_CFG['d_model']})", flush=True)
    emit({"phase": "vit_b16", "card": smi, "batch": VIT_BATCH, "cfg": VIT_CFG, "launches": launches,
          "kernel_max_abs_err": {"marginal_entropy": k1_err, "fused_mc_entropy": float((got - want).abs().max())},
          "ms_graph": k_ms, "scorer_img_per_s_median": ips, "scorer_ms": times,
          "device_busy": {"share": busy["device_busy_share"], "device_ms_per_call": busy["device_busy_ms_per_unit"],
                          "ms_by_category": busy["device_ms_per_unit_by_category"]}})
    del scorers, model
    torch.cuda.empty_cache()
    return launches


def train_rn18_phase(device, gen, smi: str) -> dict:
    """training.fit_classifier on the headline ResNet-18 (CIFAR stem, 64
    filters, f32, the seeded init) for 20 steps of Adam on one fixed batch
    of 128 CIFAR-shaped images (labels from a seeded rule), then 20 more
    timed; the loss falls and stays finite, BatchNorm's running statistics
    move; one SGD step card against CPU on 32 images; then train -> tap ->
    LaREx (kernel 1 on the fit, both scorer routes, counted)."""
    import copy

    import torch.nn.functional as F

    from runia_core_tpu_torch.detectors import MDLatentSpace
    from runia_core_tpu_torch.inference import build_larex_scorer
    from runia_core_tpu_torch.models import ResNet18, build_tapped_forward
    from runia_core_tpu_torch.ops.entropy import marginal_entropy
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda
    from runia_core_tpu_torch.ops.mc_entropy_cuda import fused_mc_entropy
    from runia_core_tpu_torch.reduction import apply_pca_ds_split
    from runia_core_tpu_torch.sampling import mc_dropblock_samples
    from runia_core_tpu_torch.training import create_train_state, fit_classifier, make_train_step

    cfg = dict(num_classes=NUM_CLASSES, cifar_stem=True, num_filters=NUM_FILTERS)
    model = ResNet18(**cfg)
    model.init_weights(torch.Generator(device=device).manual_seed(SEED + 18))
    x = torch.rand((TRAIN_BATCH, IMG, IMG, 3), generator=gen, device=device)
    y = (x[:, :16, :16].mean(dim=(1, 2, 3)) * 40).long() % NUM_CLASSES  # a function of the pixels to learn
    start_state = copy.deepcopy(model.state_dict())
    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        loss0 = float(F.cross_entropy(probe(x)[0], y))
    del probe

    torch.cuda.synchronize()
    start = time.perf_counter()
    model, metrics = fit_classifier(model, [(x, y)] * TRAIN_STEPS)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - start
    start = time.perf_counter()
    model, metrics2 = fit_classifier(model, [(x, y)] * TRAIN_STEPS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - start
    moved = {name: float((model.state_dict()[name] - start_state[name]).abs().max())
             for name in start_state if "running" in name}
    require(np.isfinite(metrics["loss"]) and np.isfinite(metrics2["loss"]), f"train_rn18: finite loss {metrics}")
    require(metrics["loss"] < loss0 and metrics2["loss"] < metrics["loss"],
            f"train_rn18: the loss falls: {loss0} -> {metrics['loss']} -> {metrics2['loss']}")
    require(all(v > 0 for v in moved.values()), "train_rn18: every BatchNorm running statistic moved")
    require(not model.training, "train_rn18: fit_classifier leaves the model in eval mode")

    # ---- one SGD step, card against CPU (f32, TF32 off), 32 images ----
    sides = {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        m = ResNet18(**cfg, device=dev)
        m.load_state_dict({k: v.to(dev) for k, v in start_state.items()})
        state, _ = create_train_state(m, tx=lambda p: torch.optim.SGD(p, lr=0.05))
        _, step_metrics = make_train_step(m)(state, x[:TRAIN_XCHECK].to(dev), y[:TRAIN_XCHECK].to(dev))
        sides[where] = {"loss": float(step_metrics["loss"]),
                        "grads": {n: p.grad.detach().cpu() for n, p in m.named_parameters()},
                        "stats": {n: t.cpu() for n, t in m.state_dict().items() if "running" in n}}
    loss_rel = abs(sides["card"]["loss"] - sides["cpu"]["loss"]) / abs(sides["cpu"]["loss"])
    grad_rel = max(_rel(sides["card"]["grads"][n], sides["cpu"]["grads"][n]) for n in sides["cpu"]["grads"]
                   if float(sides["cpu"]["grads"][n].abs().max()) > 0)
    stat_abs = max(float((sides["card"]["stats"][n] - sides["cpu"]["stats"][n]).abs().max())
                   for n in sides["cpu"]["stats"])
    require(loss_rel <= TRAIN_XCHECK_REL["loss"] and grad_rel <= TRAIN_XCHECK_REL["grads"]
            and stat_abs <= TRAIN_XCHECK_REL["stats_abs"],
            f"train_rn18 one step card vs CPU: loss {loss_rel}, grads {grad_rel}, stats {stat_abs}")

    # ---- train -> tap -> LaREx, counted ----
    marginal_entropy_cuda.launches = fused_mc_entropy.launches = 0
    forward = build_tapped_forward(model)
    _, taps = forward(x)
    mc = mc_dropblock_samples(taps["pre_pool"], MC_SAMPLES, BLOCK_SIZE, DROP_PROB, "Conv", channel_axis=3,
                              generator=gen)
    h_pca, pca_state = apply_pca_ds_split(marginal_entropy(mc, K), nro_components=TRAIN_PCA)
    larem = MDLatentSpace()
    larem.setup(h_pca)
    for fused in (False, True):
        scorer = build_larex_scorer(forward, pca_state, larem.state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE, fused=fused)
        with no_host_sync():
            _, scores = scorer(x, generator=gen)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(scores).all()), f"train_rn18: finite LaREx scores (fused={fused})")
    launches = {"marginal_entropy": marginal_entropy_cuda.launches, "fused_mc_entropy": fused_mc_entropy.launches}
    require(all(n > 0 for n in launches.values()), f"train_rn18: kernels 1 and 2 launched: {launches}")
    ms_step = {"first_20_steps": first_s / TRAIN_STEPS * 1e3, "next_20_steps": warm_s / TRAIN_STEPS * 1e3}
    print(f"train_rn18: loss {loss0:.4f} -> {metrics['loss']:.4f} -> {metrics2['loss']:.4f}; ms a step "
          f"{ms_step}; one step card vs CPU: loss {loss_rel:.2e}, grads {grad_rel:.2e}", flush=True)
    emit({"phase": "train_rn18", "card": smi, "batch": TRAIN_BATCH, "steps": 2 * TRAIN_STEPS, "optimizer": "Adam 1e-3",
          "loss": {"start": loss0, "after_20": metrics["loss"], "after_40": metrics2["loss"]},
          "accuracy_after_40": metrics2["accuracy"], "running_stats_max_move": max(moved.values()),
          "ms_per_step_host_clock": ms_step,
          "xcheck_cpu_one_sgd_step": {"images": TRAIN_XCHECK, "loss_rel": loss_rel, "grads_rel_of_max": grad_rel,
                                      "running_stats_abs": stat_abs, "bounds": TRAIN_XCHECK_REL},
          "launches": launches})
    del model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# The object level: the NMS and ROIAlign kernels, the batched object scorer,
# YOLOv8m per-detection scoring
# ---------------------------------------------------------------------------


def random_boxes(gen, n: int, size: float, lo: float, hi: float, device) -> torch.Tensor:
    """n xyxy boxes with corners in [0, size) and sides in [lo, hi)."""
    xy = torch.rand((n, 2), generator=gen, device=device) * size
    wh = torch.rand((n, 2), generator=gen, device=device) * (hi - lo) + lo
    return torch.cat([xy, xy + wh], dim=1)


def yolo_nms_input(gen, device) -> torch.Tensor:
    """NMS_YOLO's score-sorted class-offset boxes."""
    n = NMS_YOLO["anchors"]
    boxes = random_boxes(gen, n, YOLO_IMG - 40.0, 4.0, 160.0, device)
    cls = torch.randint(0, NMS_YOLO["classes"], (n,), generator=gen, device=device)
    scores = torch.rand(n, generator=gen, device=device)
    scores = torch.where(torch.rand(n, generator=gen, device=device) < NMS_YOLO["candidates"], scores, -torch.inf)
    order = torch.sort(scores, descending=True, stable=True).indices
    return (boxes + cls[:, None].float() * NMS_YOLO["max_wh"])[order].contiguous()


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def nms_serial_floor(n: int, kept: int, clock_hz: float) -> dict:
    """The greedy scan's serial floor (NMS_FLOOR_CYCLES): ceil(n / 64)
    column blocks x (hand-off + shared round), and with a shuffle a kept box."""
    blocks = -(-n // 64)
    per_block = NMS_FLOOR_CYCLES["hand_off"] + NMS_FLOOR_CYCLES["shared"]
    return {"column_blocks": blocks, "serial_floor_ms": blocks * per_block / clock_hz * 1e3,
            "serial_floor_with_kept_chain_ms": (blocks * per_block + kept * NMS_FLOOR_CYCLES["shuffle"])
            / clock_hz * 1e3, "sm_clock_hz": clock_hz}


def nms_phase(device, gen) -> dict:
    """The NMS kernel against its plain version (JAX's fixed point) at N =
    1,000, 8,400 (YOLOv8's anchors at 640 px) and 30,000 (ultralytics'
    max_nms), and on NMS_YOLO's class-offset anchors: keep masks identical.
    Timed cold and L2-warm as replays of a CUDA graph, the plain version by
    events. Bound: the IoUs the data needs (each kept box against every
    later box, NMS_IOU_OPERATIONS f32 operations each) against the bytes of
    the boxes and the mask; beside it the bitmask's bytes and all N^2 / 2
    IoUs, and the scan's serial floor."""
    from runia_core_tpu_torch.ops.nms import nms_keep_cuda, nms_keep_plain

    clock_hz = sm_clock_hz()
    flips, timing = {}, {}
    cases = {}
    for n in NMS_SIZES:
        boxes = random_boxes(gen, n, YOLO_IMG, 8.0, 200.0, device)
        scores = torch.rand(n, generator=gen, device=device)
        cases[str(n)] = (boxes[torch.sort(scores, descending=True, stable=True).indices].contiguous(),
                         NMS_THRESHOLDS, NMS_THRESHOLDS[0])
    cases["yolo_class_offsets"] = (yolo_nms_input(gen, device), (NMS_YOLO["iou"],), NMS_YOLO["iou"])
    for name, (sorted_boxes, thresholds, thr) in cases.items():
        n = sorted_boxes.shape[0]
        for t in thresholds:
            got = nms_keep_cuda(sorted_boxes, t)
            again = nms_keep_cuda(sorted_boxes, t)
            want = nms_keep_plain(sorted_boxes, t)
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"nms {name}@{t}: two runs are bit-identical")
            flips[f"{name}@{t}"] = int((got != want).sum())
            require(flips[f"{name}@{t}"] == 0, f"nms {name}@{t}: the kernel's keep mask = plain's: {flips}")
        keep = nms_keep_cuda(sorted_boxes, thr)
        kept_at = torch.nonzero(keep).flatten()
        needed_ious = int((n - 1 - kept_at).sum())
        mask_bytes = n * (-(-n // 64)) * 8
        copies = cold_copies((sorted_boxes,), n * 16 + mask_bytes)
        times = timed_cold(lambda b: nms_keep_cuda(b, thr), lambda b: nms_keep_plain(b, thr), copies)
        bound = roofline(17 * n, NMS_IOU_OPERATIONS * needed_ious, H100_F32_OPS_PER_S)
        all_pairs = roofline(mask_bytes, NMS_IOU_OPERATIONS * n * (n - 1) / 2, H100_F32_OPS_PER_S)
        timing[name] = {"n": n, "iou": thr, "kept": int(keep.sum()), "needed_ious": needed_ious,
                        "copies": len(copies), **times, **with_share(bound, times["ms"]),
                        **nms_serial_floor(n, int(keep.sum()), clock_hz),
                        "bound_all_pairs_and_bitmask": with_share(all_pairs, times["ms"])}
        require(timing[name]["share_of_bound"] <= 1.0, f"nms {name}: faster than its bound: {timing[name]}")
        del copies
    for name, t in timing.items():
        print(f"nms {name}: {t['ms']:.4f} ms cold ({t['kept']} kept of {t['n']}); roofline bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), serial floor {t['serial_floor_ms']:.4f} ms "
              f"({t['column_blocks']} column blocks; {t['serial_floor_with_kept_chain_ms']:.4f} with the kept chain)",
              flush=True)
    top = timing[str(NMS_SIZES[1])]  # YOLOv8's 8,400 anchors, what the adapter's NMS takes
    emit({"phase": "kernel_nms", "keep_flips": flips, "timing": timing, "floor_cycles": NMS_FLOOR_CYCLES,
          "timed_with": "CUDA-graph replays, inputs cold (copies cycled past the L2); ms_l2_warm: one input",
          "library_ms": None, "library": "none: torchvision is not installed, and no PyTorch call is an NMS"})
    return {"max_abs_err": 0.0, "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None}


def roi_work(fmap: torch.Tensor, boxes: torch.Tensor, out: int, scale: float, mean: bool) -> dict:
    """What ROIAlign must move and compute for these boxes: the map cells
    some bin samples (read once), the boxes, the output; two operations a
    channel for each (cell, bin) tap, or for each cell of a ROI's footprint
    in the mean mode."""
    from runia_core_tpu_torch.ops.roi_align import _interpolation

    b, h, w, c = fmap.shape
    k = boxes.shape[0]
    ay, ax = _interpolation(boxes, out, out, h, w, scale, -1, True, 16)
    rows, cols = (ay != 0).any(dim=1), (ax != 0).any(dim=1)  # (K, H), (K, W)
    cells = int((rows[:, :, None] & cols[:, None, :]).reshape(b, k // b, h, w).any(dim=1).sum())
    if mean:
        taps = int((rows.sum(1) * cols.sum(1)).sum())
    else:
        taps = int(((ay != 0).sum(2).sum(1) * (ax != 0).sum(2).sum(1)).sum())
    elem = fmap.element_size()
    out_bytes = k * c * (1 if mean else out * out) * elem
    return roofline(cells * c * elem + 16 * k + out_bytes, 2 * taps * c, H100_F32_OPS_PER_S)


def roi_cases(gen, device) -> dict:
    """(map, boxes, spatial scale) of the object scorer's bf16 pre_pool tap,
    YOLOv8m's backbone_p5 and p3 at 640 px (one whole-image box each) and
    DETR-R50's (1, 25, 38, 2048) backbone map at 800 x 1216 (a whole-image
    box and 99 others)."""
    rng = np.random.RandomState(SEED + 7)
    dets = np.concatenate([make_dets(rng, OBJ_MAX_DET, OBJ_IMG)["boxes"] for _ in range(OBJ_BATCH)])
    yolo_boxes = random_boxes(gen, 300, YOLO_IMG * 0.8, 8.0, 320.0, device)
    yolo_boxes[0] = torch.tensor([0.0, 0.0, YOLO_IMG, YOLO_IMG])
    h, w = DETR_IMG
    detr_boxes = random_boxes(gen, 100, h * 0.8, 16.0, 0.5 * h, device)
    detr_boxes[0] = torch.tensor([0.0, 0.0, w, h])
    return {
        "object_scorer_pre_pool": (torch.rand((OBJ_BATCH, 8, 8, 512), generator=gen, device=device),
                                   torch.from_numpy(dets).to(device), 8 / OBJ_IMG),
        "yolov8m_backbone_p5": (torch.rand((1, 20, 20, 576), generator=gen, device=device), yolo_boxes, 20 / YOLO_IMG),
        "yolov8m_p3": (torch.rand((1, 80, 80, 192), generator=gen, device=device), yolo_boxes, 80 / YOLO_IMG),
        "detr_backbone": (torch.rand((1, h // 32, w // 32, 2048), generator=gen, device=device), detr_boxes, 1 / 32),
    }


def roi_align_phase(device, gen) -> dict:
    """The ROIAlign kernel against its plain version (JAX's separable form)
    at the object scorer's (128, 8, 8, 512) tap with 2,560 boxes, YOLOv8m's
    backbone_p5 and p3 with 300 and DETR's backbone map with 100, both
    modes, f32 and bf16; timed where the main paths call it: the scorer's
    bf16 means, the extractors' f32 means and the MC routes' f32 pooled
    bins."""
    from runia_core_tpu_torch.ops.roi_align import roi_align_nhwc_cuda, roi_align_nhwc_plain

    cases = roi_cases(gen, device)
    errors = {}
    for name, (fmap, boxes, scale) in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = fmap.to(dtype)
            for mean in (False, True):
                got = roi_align_nhwc_cuda(x, boxes, 7, scale, mean=mean)
                again = roi_align_nhwc_cuda(x, boxes, 7, scale, mean=mean)
                want = roi_align_nhwc_plain(x, boxes, 7, scale, mean=mean)
                torch.cuda.synchronize()
                key = f"{name}/{str(dtype)[6:]}/{'mean' if mean else 'pooled'}"
                require(torch.equal(got, again), f"roi_align {key}: two runs are bit-identical")
                rel = float((got.float() - want.float()).abs().max()) / float(x.float().abs().max())
                errors[key] = rel
                bar = ROI_F32_REL if dtype == torch.float32 else ROI_BF16_REL
                require(got.shape == want.shape and rel <= bar, f"roi_align {key}: {rel} of max |feature| > {bar}")
    timing = {}
    for key, (name, dtype, mean) in {"object_scorer_bf16_mean": ("object_scorer_pre_pool", torch.bfloat16, True),
                                     "yolov8m_p5_f32_mean": ("yolov8m_backbone_p5", torch.float32, True),
                                     "yolov8m_p5_f32_pooled": ("yolov8m_backbone_p5", torch.float32, False),
                                     "yolov8m_p3_f32_mean": ("yolov8m_p3", torch.float32, True),
                                     "detr_f32_mean": ("detr_backbone", torch.float32, True),
                                     "detr_f32_pooled": ("detr_backbone", torch.float32, False)}.items():
        fmap, boxes, scale = cases[name]
        fmap = fmap.to(dtype)
        copies = cold_copies((fmap, boxes), fmap.numel() * fmap.element_size())
        times = timed_cold(lambda f, b: roi_align_nhwc_cuda(f, b, 7, scale, mean=mean),
                           lambda f, b: roi_align_nhwc_plain(f, b, 7, scale, mean=mean), copies)
        bound = roi_work(fmap, boxes, 7, scale, mean)
        timing[key] = {"map": list(fmap.shape), "rois": boxes.shape[0], "copies": len(copies), **times,
                       **with_share(bound, times["ms"])}
        require(timing[key]["share_of_bound"] <= 1.0, f"roi_align {key}: faster than its bound: {timing[key]}")
        del copies
    top = timing["object_scorer_bf16_mean"]
    emit({"phase": "kernel_roi_align", "max_rel_err_of_max_feature": errors,
          "bound": {"f32": ROI_F32_REL, "bf16": ROI_BF16_REL}, "timing": timing,
          "timed_with": "CUDA-graph replays, inputs cold (copies cycled past the L2); ms_l2_warm: one input",
          "library_ms": None, "library": "none: torchvision is not installed, and no PyTorch call is a ROIAlign"})
    worst = max(errors[k] * float(cases[k.split("/")[0]][0].abs().max()) for k in errors)
    return {"max_abs_err": worst, "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None}


# The conv-norm epilogue (csrc/conv_epilogue.cu) at ResNet-50 batch-128 and
# ResNet-18 batch-512 maps: (N, C, H, W), residual (None, "add",
# "projected"). Against its twin: f32 to 1e-6, bf16 one step (2^-7) of each
# value, relative to |value| + 1e-6 of the largest (FMAs against
# multiply-adds).
EPILOGUE_CASES = {
    "rn50_b128_stem": ((128, 64, 112, 112), None),
    "rn50_b128_28x28x128_inner": ((128, 128, 28, 28), None),
    "rn50_b128_56x56x256_residual": ((128, 256, 56, 56), "add"),
    "rn50_b128_7x7x2048_projected": ((128, 2048, 7, 7), "projected"),
    "rn18_b512_32x32x64_residual": ((512, 64, 32, 32), "add"),
}
EPILOGUE_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}


def conv_epilogue_phase(device, gen) -> dict:
    """The conv-norm epilogue against its plain twin at EPILOGUE_CASES, f32
    and bf16, in place with the residual untouched; timed in bf16, cold, at
    the ResNet-50 batch-128 block end with its residual, the inner 28 x 28 x
    128 conv and the projected 7 x 7 x 2048 block end, against bytes / 3.35
    TB/s (each map read once, the result written once), beside the module
    passes it replaces (BatchNorm's eval forward, the residual add, ReLU)."""
    from runia_core_tpu_torch.models.resnet import BatchNorm
    from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue, conv_epilogue_plain
    from runia_core_tpu_torch.utils import cuda_time_ms

    def inputs(shape, residual, dtype):
        def fmap():
            return torch.randn(shape, generator=gen, device=device).to(dtype).contiguous(
                memory_format=torch.channels_last)

        def norm():
            bn = BatchNorm(shape[1]).to(device).eval()
            with torch.no_grad():
                bn.weight.uniform_(0.5, 1.5, generator=gen)
                bn.running_var.uniform_(0.5, 1.5, generator=gen)
                bn.bias.normal_(0.0, 0.1, generator=gen)
                bn.running_mean.normal_(0.0, 0.1, generator=gen)
            return bn

        norms = [norm()] + ([norm()] if residual == "projected" else [])
        maps = [fmap()] + ([fmap()] if residual else [])
        return maps, norms

    def args(maps, norms):
        rest = maps[1:] + (list(norms[1].affine()) if len(norms) > 1 else [])
        return (maps[0], *norms[0].affine(), *rest)

    errors = {}
    for name, (shape, residual) in EPILOGUE_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            maps, norms = inputs(shape, residual, dtype)
            kept = [m.clone() for m in maps[1:]]
            want = conv_epilogue_plain(*args(maps, norms))
            got = conv_epilogue(*args(maps, norms))
            torch.cuda.synchronize()
            key = f"{name}/{str(dtype)[6:]}"
            top = float(want.float().abs().max())
            err = float(((got.float() - want.float()).abs() / (want.float().abs() + 1e-6 * top)).max())
            errors[key] = err
            require(got.data_ptr() == maps[0].data_ptr() and all(torch.equal(a, b) for a, b in zip(maps[1:], kept)),
                    f"conv_epilogue {key}: written in place, the residual untouched")
            require(err <= EPILOGUE_TOL[dtype], f"conv_epilogue {key}: {err} > {EPILOGUE_TOL[dtype]}")
            del maps, kept, want, got
    timing = {}
    for name in ("rn50_b128_56x56x256_residual", "rn50_b128_28x28x128_inner", "rn50_b128_7x7x2048_projected"):
        shape, residual = EPILOGUE_CASES[name]
        maps, norms = inputs(shape, residual, torch.bfloat16)
        per_map = maps[0].numel() * maps[0].element_size()
        copies = cold_copies(tuple(maps), per_map * len(maps))

        def modules(*m):
            y = norms[0](m[0])
            if len(m) == 1:
                return torch.relu(y)
            return torch.relu((norms[1](m[1]) if len(norms) > 1 else m[1]) + y)

        times = timed_cold(lambda *m: conv_epilogue(*args(list(m), norms)),
                           lambda *m: conv_epilogue_plain(*args(list(m), norms)), copies)
        turns = itertools.cycle(copies)
        modules_ms = cuda_time_ms(lambda: modules(*next(turns)), 10)
        bound = roofline(per_map * (len(maps) + 1), 0, H100_F32_OPS_PER_S)
        timing[name] = {"map": list(shape), "residual": residual, "copies": len(copies), **times,
                        "modules_ms": modules_ms, **with_share(bound, times["ms"])}
        require(timing[name]["share_of_bound"] <= 1.0, f"conv_epilogue {name}: faster than its bound: {timing[name]}")
        del copies, maps, turns
    top = timing["rn50_b128_56x56x256_residual"]
    emit({"phase": "kernel_conv_epilogue", "max_rel_err": errors, "bound": {"f32": 1e-6, "bf16": 2.0 ** -7},
          "timing": timing, "timed_with": "CUDA-graph replays, inputs cold (copies cycled past the L2); "
          "ms_l2_warm: one input; modules_ms: BatchNorm's eval forward, the residual add and ReLU, eager",
          "library_ms": None, "library": "none: no one PyTorch call is a norm, residual and ReLU"})
    worst = max(errors.values())
    return {"max_rel_err": worst, "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None}


def make_dets(rng, n: int, img: int) -> dict:
    """bench.py:213-220's detections: corners in [0, img - 40), sides 8-38 px."""
    xy = rng.rand(n, 2) * (img - 40)
    wh = rng.rand(n, 2) * 30 + 8
    return {"boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32), "scores": rng.rand(n).astype(np.float32),
            "classes": rng.randint(0, 10, n)}


def object_scorer_phase(device, gen, smi: str) -> dict:
    """The bench leg object_scorer_256px_20det through build_object_scorer at
    full width (see OBJ_*): counted replays of the scorer's graph, graph =
    eager bit for bit, the f32 scorer at batch 4 card against CPU (padded
    rows and the whole-image fallback included), det/s graph and eager in
    turns, the forward and ROI + score stages, the kernel share."""
    from runia_core_tpu_torch.detectors import MDLatentSpace
    from runia_core_tpu_torch.extraction import batched_roi_features, build_object_scorer, pad_detections
    from runia_core_tpu_torch.models import ResNet18, build_tapped_forward
    from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue
    from runia_core_tpu_torch.ops.linalg import mahalanobis_quadform
    from runia_core_tpu_torch.ops.roi_align import roi_align_nhwc_cuda
    from runia_core_tpu_torch.utils import cuda_graph_time_ms, cuda_time_ms, device_profile

    rng = np.random.RandomState(SEED)
    model = ResNet18(num_classes=NUM_CLASSES, dtype=torch.bfloat16)
    require(model.head.weight.device == device, f"object_scorer: the default device is the card")
    model.init_weights(torch.Generator(device=device).manual_seed(SEED + 30))  # then the statistics, and each
    # block's last BatchNorm scale (0 after init), are randomised
    randomize_batchnorm(model, torch.Generator(device=device).manual_seed(SEED + 31))
    model = model.to(memory_format=torch.channels_last)
    forward = build_tapped_forward(model, ("pre_pool",))
    md = MDLatentSpace()
    md.setup(torch.randn((OBJ_FIT, 512), generator=gen, device=device))
    padded = pad_detections([make_dets(rng, OBJ_MAX_DET, OBJ_IMG) for _ in range(OBJ_BATCH)], OBJ_MAX_DET,
                            (OBJ_IMG, OBJ_IMG))
    images = torch.rand((OBJ_BATCH, OBJ_IMG, OBJ_IMG, 3), generator=gen, device=device)
    scorers = {mode: build_object_scorer(forward, md.state, output_sizes=(7,), img_shape=(OBJ_IMG, OBJ_IMG),
                                         use_graph=mode == "graph") for mode in ("graph", "eager")}

    roi_align_nhwc_cuda.launches = conv_epilogue.launches = 0
    outs = []
    for _ in range(3):
        with no_host_sync():  # the first call captures the graph; every call replays it
            outs.append(scorers["graph"](images, padded))
    torch.cuda.synchronize()
    launches = {"roi_align": roi_align_nhwc_cuda.launches, "conv_epilogue": conv_epilogue.launches}
    require(all(n > 0 for n in launches.values()),
            f"object_scorer: the ROIAlign kernel and the conv-norm epilogue launched: {launches}")
    want = scorers["eager"](images, padded)
    require(all(torch.equal(o, want) for o in outs), "object_scorer: graph = eager, bit for bit")
    require(tuple(want.shape) == (OBJ_BATCH, OBJ_MAX_DET) and bool(torch.isfinite(want).all()),
            "object_scorer: finite (128, 20) scores (every row valid)")

    # f32 at batch 4, card against the CPU's plain path, with padded rows and an empty image.
    state = {k: v.float() for k, v in model.state_dict().items()}
    xdets = [make_dets(rng, n, OBJ_IMG) if n else {"boxes": np.zeros((0, 4), np.float32)} for n in (3, 0, 20, 7)]
    xscores = {}
    for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
        m = ResNet18(num_classes=NUM_CLASSES, device=None if side == "card" else dev)
        m.load_state_dict({k: v.to(dev) for k, v in state.items()})
        det_state = {k: v.to(dev) for k, v in md.state.items()}
        xs = build_object_scorer(build_tapped_forward(m, ("pre_pool",)), det_state, output_sizes=(7,),
                                 img_shape=(OBJ_IMG, OBJ_IMG))
        xscores[side] = xs(images[:OBJ_XCHECK].to(dev), pad_detections(xdets, OBJ_MAX_DET, (OBJ_IMG, OBJ_IMG),
                                                                        device=dev)).cpu()
    finite = torch.isfinite(xscores["cpu"])
    require(torch.equal(torch.isfinite(xscores["card"]), finite) and int(finite.sum()) == 3 + 1 + 20 + 7,
            "object_scorer f32: -inf exactly in the padded rows, the empty image's fallback row finite")
    xrel = float((xscores["card"][finite] - xscores["cpu"][finite]).abs().max() / xscores["cpu"][finite].abs().max())
    require(xrel <= OBJ_XCHECK_REL, f"object_scorer f32 card vs CPU: {xrel} of max |score|")
    del m, xs

    # Timing: det/s by CUDA events, graph and eager in turns; the stages by graph replays.
    times = {"graph": [], "eager": []}
    for window in range(OBJ_WINDOWS):
        for mode in (("graph", "eager") if window % 2 == 0 else ("eager", "graph")):
            times[mode].append(cuda_time_ms(lambda: scorers[mode](images, padded), iters=OBJ_CALLS, warmup=1))
    dets_per_call = OBJ_BATCH * OBJ_MAX_DET
    det_per_s = {mode: dets_per_call / (statistics.median(ms) * 1e-3) for mode, ms in times.items()}
    tap = forward(images)[1]["pre_pool"]
    boxes_flat = padded.boxes.reshape(-1, 4)

    def roi_and_score():
        feats = batched_roi_features([tap.permute(0, 3, 1, 2)], padded.boxes, (OBJ_IMG, OBJ_IMG), (7,))
        flat = feats.reshape(-1, feats.shape[-1]).float()
        return -mahalanobis_quadform(flat, md.state["feats_mean"], md.state["precision"])

    stage_ms = {"forward_bf16": cuda_graph_time_ms(lambda: forward(images), 3),
                "roi_and_score": cuda_graph_time_ms(roi_and_score, 20),
                "roi_align_kernel": cuda_graph_time_ms(
                    lambda: roi_align_nhwc_cuda(tap, boxes_flat, 7, 8 / OBJ_IMG, mean=True), 20)}
    busy = device_profile(lambda: [scorers["graph"](images, padded) for _ in range(3)], 3, category=flow_category)
    print(f"object_scorer det/s: {det_per_s}; stages ms {stage_ms}", flush=True)
    emit({"phase": "object_scorer_rn18", "card": smi, "batch": OBJ_BATCH, "img": OBJ_IMG, "max_det": OBJ_MAX_DET,
          "tap": list(tap.shape), "launches": launches, "graph_equals_eager": True,
          "f32_card_vs_cpu_rel": xrel, "bound_f32_card_vs_cpu_rel": OBJ_XCHECK_REL,
          "det_per_s_median": det_per_s, "call_ms": times, "stage_ms": stage_ms,
          "device_busy": {"share": busy["device_busy_share"], "device_ms_per_call": busy["device_busy_ms_per_unit"],
                          "kernels_per_call": busy["kernels_per_unit"],
                          "ms_by_category": busy["device_ms_per_unit_by_category"]}})
    del scorers, model
    torch.cuda.empty_cache()
    return launches


@torch.no_grad()
def randomize_batchnorm(model, generator: torch.Generator):
    """Every BatchNorm's scale and running variance uniform in [0.5, 1.5),
    its shift and running mean 0.1 N(0, 1): non-trivial statistics on a
    seeded detector whose kernels keep their lecun-normal init."""
    from runia_core_tpu_torch.models.resnet import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            for t in (m.weight, m.running_var):
                t.copy_(torch.rand(t.shape, generator=generator, device=t.device) + 0.5)
            for t in (m.bias, m.running_mean):
                t.copy_(0.1 * torch.randn(t.shape, generator=generator, device=t.device))
    return model


def yolov8m_flow_phase(device, gen, smi: str) -> dict:
    """Per-detection OoD scoring on YOLOv8m @640 (see YOLO_*): the port's
    YoloV8JaxAdapter (the NMS kernel) -> BoxFeaturesExtractor on backbone_p5
    (the ROIAlign kernel) over the fit images -> MDLatentSpace ->
    ObjectLevelInference.get_score and BoxInferenceYolo.get_score on
    in-distribution and noise images -> the MC route (kernel 1), counted;
    then the checks and the stages' times."""
    from runia_core_tpu_torch.detectors import MDLatentSpace
    from runia_core_tpu_torch.extraction import BoxFeaturesExtractor, yolo_get_logits
    from runia_core_tpu_torch.inference import BoxInferenceYolo, ObjectLevelInference
    from runia_core_tpu_torch.models import YoloV8, YoloV8JaxAdapter
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda, marginal_entropy_plain
    from runia_core_tpu_torch.ops.nms import nms_indices, nms_keep_cuda
    from runia_core_tpu_torch.ops.roi_align import roi_align_nhwc, roi_align_nhwc_cuda
    from runia_core_tpu_torch.sampling import MCSamplerModule
    from runia_core_tpu_torch.utils import cuda_graph_time_ms, cuda_time_ms, device_profile

    model = YoloV8(num_classes=80, scale="m")
    require(model.layer0.conv.weight.device == device, "yolov8m: the default device is the card")
    model.init_weights(torch.Generator(device=device).manual_seed(SEED + 40))
    randomize_batchnorm(model, torch.Generator(device=device).manual_seed(SEED + 41))
    model = model.to(memory_format=torch.channels_last)
    adapter = YoloV8JaxAdapter(model)  # backbone_p5, iou 0.7, max_det 300

    def images(n, scale=1.0):
        return [torch.rand((YOLO_IMG, YOLO_IMG, 3), generator=gen, device=device) * scale for _ in range(n)]

    fit_images, ind, noise = images(YOLO_FIT), images(YOLO_SCORE), images(YOLO_SCORE, 4.0)
    adapter(fit_images[0], YOLO_CONF)  # cuDNN's autotune for the 640-px shapes, outside the count
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    nms_keep_cuda.launches = roi_align_nhwc_cuda.launches = marginal_entropy_cuda.launches = 0
    seconds = {}
    start = time.perf_counter()
    extractor = BoxFeaturesExtractor(adapter, "yolov8", roi_output_sizes=[7])
    fit = extractor.get_ls_samples([(f"fit{i}.png", x, i) for i, x in enumerate(fit_images)], predict_conf=YOLO_CONF)
    feats = np.concatenate([fit[i]["latent_space_means"] for i in range(YOLO_FIT) if len(fit[i]["boxes"])])
    seconds["extract_fit"] = time.perf_counter() - start
    md = MDLatentSpace()
    md.setup(feats)
    fit_scores = md.postprocess(feats)
    threshold = float(torch.quantile(fit_scores, 0.05))
    inference = ObjectLevelInference(adapter, md, "yolov8", True, ["latent_space_means"], [7])
    box_inference = BoxInferenceYolo(adapter, None, "LaREM", torch.from_numpy(feats).to(device), [7])
    per_image, scores = [], {"ind": [], "noise": []}
    torch.cuda.synchronize()
    start = time.perf_counter()
    for split, batch in (("ind", ind), ("noise", noise)):
        for x in batch:
            det, s = inference.get_score(x, YOLO_CONF)
            rewritten = box_inference.get_score(x, YOLO_CONF, threshold=threshold)
            scores[split].append(torch.as_tensor(s).float().cpu())
            require(np.isfinite(rewritten.extra["ood_scores"]).all(), "yolov8m: BoxInferenceYolo scores finite")
            per_image.append({"candidates": int((det.raw_prediction[0, 4:].max(0) > YOLO_CONF).sum()),
                              "survivors": int(det.boxes.shape[0]),
                              "ood_rewritten": int((rewritten.classes == rewritten.extra["ood_class_id"]).sum())})
    seconds["score_2x16_two_inference_classes"] = time.perf_counter() - start
    mc_extractor = BoxFeaturesExtractor(adapter, "yolov8", roi_output_sizes=[7], extract_noise_entropies=True,
                                        mcd_nro_samples=MC_SAMPLES, dropblock_probs=DROP_PROB,
                                        dropblock_sizes=BLOCK_SIZE, generator=gen)
    start = time.perf_counter()
    for x in ind[:YOLO_MC]:
        res, _ = mc_extractor._get_samples_one_image(x, YOLO_CONF)
        require(np.isfinite(res["latent_space_means"]).all(), "yolov8m: the MC route's entropies are finite")
    seconds["mc_route_8"] = time.perf_counter() - start
    torch.cuda.synchronize()
    launches = {"nms": nms_keep_cuda.launches, "roi_align": roi_align_nhwc_cuda.launches,
                "marginal_entropy": marginal_entropy_cuda.launches}
    require(all(n > 0 for n in launches.values()), f"yolov8m: NMS, ROIAlign and kernel 1 launched: {launches}")
    all_scores = torch.cat(scores["ind"] + scores["noise"])
    require(bool(torch.isfinite(all_scores).all()) and all_scores.numel() > 0, "yolov8m: finite scores")

    # ---- checks ----
    x = ind[0]
    det = adapter(x, YOLO_CONF)
    pred = det.raw_prediction[0].T  # the adapter's own predictions, on the host
    cls = pred[:, 4:]
    sel = cls.max(1) > YOLO_CONF
    cx, cy, w, h = pred[:, 0], pred[:, 1], pred[:, 2], pred[:, 3]
    xyxy = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1).astype(np.float32)
    cand = np.nonzero(sel)[0]
    offset = cls.argmax(1)[cand, None].astype(np.float32) * adapter.max_wh
    kept = nms_indices(torch.from_numpy(xyxy[cand] + offset), torch.from_numpy(cls.max(1)[cand]),
                       adapter.iou_threshold, max_det=adapter.max_det)  # plain, on the CPU
    require(np.array_equal(det.boxes, xyxy[cand][kept]),
            f"yolov8m: the adapter's kept boxes = plain NMS's on its candidates ({len(kept)} of {len(cand)})")
    replay_input = det.raw_prediction.copy()
    replay_input[0, :4] = xyxy.T  # the replay takes its boxes as given; ultralytics makes them xyxy before its NMS
    replayed = yolo_get_logits(replay_input, conf_thres=YOLO_CONF, iou_thres=adapter.iou_threshold,
                               max_det=adapter.max_det)
    require(np.array_equal(replayed, det.logits), "yolov8m: yolo_get_logits on the raw predictions = the logits")
    cpu_model = YoloV8(num_classes=80, scale="m", device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        card_preds = model(x[None])[0].cpu()
        cpu_preds = cpu_model(x[None].cpu())[0]
    xrel = float((card_preds - cpu_preds).abs().max() / cpu_preds.abs().max())
    require(xrel <= YOLO_XCHECK_REL, f"yolov8m f32 forward card vs CPU: {xrel} of max")
    with torch.inference_mode():
        tap = model(x[None])[1]["backbone_p5"]
        rois = roi_align_nhwc(tap, torch.from_numpy(det.boxes).to(device), 7, tap.shape[2] / YOLO_IMG)
        samples = MCSamplerModule(MC_SAMPLES, BLOCK_SIZE, DROP_PROB, generator=gen)(rois)
        samples = samples if samples.ndim == 3 else samples[None]
        k1_err = float((marginal_entropy_cuda(samples, K) - marginal_entropy_plain(samples, K)).abs().max())
    require(k1_err <= ENTROPY_ATOL, f"yolov8m: kernel 1 vs plain on the MC route's samples: {k1_err}")
    # Kernel 1 at this path's (detections, S, 576) clouds, timed as the kernel phases time it.
    n_det = samples.shape[0]
    k1 = timed_cold(lambda c: marginal_entropy_cuda(c, K), lambda c: marginal_entropy_plain(c, K),
                    cold_copies((samples.contiguous(),), samples.numel() * 4))
    k1.update({"shape": list(samples.shape), **with_share(roofline(
        4 * (samples.numel() + n_det * samples.shape[2]), n_det * samples.shape[2] * kl_entropy_operations(
            MC_SAMPLES, K), H100_F32_OPS_PER_S), k1["ms"])})

    eager_adapter = YoloV8JaxAdapter(model, use_graph=False)
    eager = eager_adapter(x, YOLO_CONF)
    require(np.array_equal(eager.boxes, det.boxes) and np.array_equal(eager.logits, det.logits)
            and torch.equal(eager.fmaps[0], det.fmaps[0]), "yolov8m: the adapter's graph = its eager call, bit for bit")

    # ---- timing ----
    adapter_ips = {"graph": [], "eager": []}
    for window in range(4):
        for mode in (("graph", "eager") if window % 2 == 0 else ("eager", "graph")):
            run = adapter if mode == "graph" else eager_adapter
            torch.cuda.synchronize()
            start = time.perf_counter()
            for x_ in ind:
                run(x_, YOLO_CONF)
            adapter_ips[mode].append(len(ind) / (time.perf_counter() - start))
    start = time.perf_counter()
    for x_ in ind:
        inference.get_score(x_, YOLO_CONF)
    scoring_ips = len(ind) / (time.perf_counter() - start)
    with torch.inference_mode():
        preds = model(x[None])[0][0].T
        conf, best = preds[:, 4:].max(dim=1)
        boxes_all = torch.cat([preds[:, :2] - preds[:, 2:4] / 2, preds[:, :2] + preds[:, 2:4] / 2], 1)
        sorted_all = (boxes_all + best[:, None].float() * adapter.max_wh)[
            torch.sort(torch.where(conf > YOLO_CONF, conf, -torch.inf), descending=True, stable=True).indices]
        feats_t = torch.from_numpy(feats[: det.boxes.shape[0]]).to(device)
        kept_boxes = torch.from_numpy(det.boxes).to(device)
        stage_ms = {"forward_f32": cuda_graph_time_ms(lambda: model(x[None]), 3),
                    "forward_f32_eager_events": cuda_time_ms(lambda: model(x[None]), 5),
                    "nms_8400": cuda_graph_time_ms(lambda: nms_keep_cuda(sorted_all, adapter.iou_threshold), 10),
                    "roi_align_mean": cuda_graph_time_ms(
                        lambda: roi_align_nhwc_cuda(tap, kept_boxes, 7, tap.shape[2] / YOLO_IMG, mean=True), 10),
                    "md_score": cuda_time_ms(lambda: md.postprocess(feats_t), 10)}
    busy = device_profile(lambda: [inference.get_score(x_, YOLO_CONF) for x_ in ind[:4]], 4, category=flow_category)
    per = {key: [p[key] for p in per_image] for key in per_image[0]}
    print(f"yolov8m: adapter {adapter_ips} img/s, scoring {scoring_ips:.1f} img/s; stages ms {stage_ms}; "
          f"survivors {statistics.median(per['survivors'])} of {statistics.median(per['candidates'])}", flush=True)
    emit({"phase": "yolov8m_flow", "card": smi, "img": YOLO_IMG, "anchors": int(pred.shape[0]),
          "fit_images": YOLO_FIT, "fit_rows": int(feats.shape[0]), "launches": launches,
          "adapter_img_per_s": adapter_ips, "adapter_img_per_s_median": {
              mode: statistics.median(v) for mode, v in adapter_ips.items()}, "scoring_img_per_s": scoring_ips, "stage_ms": stage_ms,
          "seconds": seconds, "per_image": per, "threshold": threshold,
          "score_median": {k: float(torch.cat(v).median()) for k, v in scores.items()},
          "f32_card_vs_cpu_rel": xrel, "kernel1_max_abs_err": k1_err, "kernel1_timing": k1,
          "device_busy": {"share": busy["device_busy_share"], "device_ms_per_call": busy["device_busy_ms_per_unit"],
                          "kernels_per_call": busy["kernels_per_unit"],
                          "ms_by_category": busy["device_ms_per_unit_by_category"]}})
    del model, cpu_model, adapter, eager_adapter, extractor, mc_extractor
    torch.cuda.empty_cache()
    return launches


def _synthetic_coco(path, preds: dict, rng, known: bool, num_labels: int) -> str:
    """A seeded COCO file around the detections. On the first half of the
    images two objects are detections' boxes jittered by 4 px, so that some
    detections match them; on the other half two small objects lie in the
    top-left corner, away from the detections. A known image's objects carry
    the class its detection scored best (or a random one), a noise image's
    the one unknown category. A random DETR's queries give nearly the same
    box, so both halves are needed for TP and FP, GTU and UU detections."""
    anns = []
    for n, (im_id, pred) in enumerate(preds.items()):
        boxes = np.asarray(pred["boxes"], np.float64)
        classes = np.asarray(pred["logits"]).argmax(1)
        for j in rng.choice(len(boxes), 2, replace=False):
            if n < len(preds) // 2:
                x1, y1, x2, y2 = boxes[j] + rng.normal(0, 4, 4)
                bbox, cls = [x1, y1, max(x2 - x1, 1.0), max(y2 - y1, 1.0)], int(classes[j])
            else:
                bbox, cls = [*rng.uniform(0, 40, 2), *rng.uniform(20, 60, 2)], int(rng.randint(num_labels))
            anns.append((im_id, cls if known else 0, bbox))
    coco = {
        "images": [{"id": im, "file_name": f"{im}.png", "width": DETR_IMG[1], "height": DETR_IMG[0]} for im in preds],
        "annotations": [{"id": k, "image_id": im, "category_id": cat, "bbox": [float(v) for v in bbox],
                         "area": float(bbox[2] * bbox[3])} for k, (im, cat, bbox) in enumerate(anns)],
        "categories": ([{"id": c, "name": f"class{c}"} for c in range(num_labels)] if known
                       else [{"id": 0, "name": "unknown object"}]),
    }
    Path(path).write_text(json.dumps(coco))
    return str(path)


def matcher_against_loops(open_set, evaluator, gt_path: str, is_ood: bool) -> dict:
    """The native matcher against its plain version (the numpy loops) on
    every class's detections of a filled evaluator: TP / FP, recall,
    precision and AP equal, and the unknown-overlap flags."""
    import copy

    ann = open_set.COCOParser(gt_path)
    unknown, _ = open_set._gt_records(ann, None, is_ood)
    dets = tps = 0
    for cls_id, name in enumerate(evaluator._class_names):
        lines = evaluator._predictions.get(cls_id)
        if not lines:
            continue
        recs, npos = open_set._gt_records(ann, name, is_ood)
        ids, _, bb, _ = open_set._parse_prediction_lines(lines)
        got = open_set._greedy_match(ids, bb, copy.deepcopy(recs), 0.5, npos, False)
        want = open_set._greedy_match(ids, bb, copy.deepcopy(recs), 0.5, npos, False, native=False)
        require(all(np.array_equal(np.asarray(g), np.asarray(w)) for g, w in zip(got, want)),
                f"detr open-set: the native matcher = the numpy loops on class {name}")
        flags = [open_set._mark_unknown_overlaps(len(ids), ids, bb, unknown, 0.5, native)[2] for native in (True, False)]
        require(np.array_equal(*flags), f"detr open-set: the native unknown-overlap flags = the loops' on {name}")
        dets, tps = dets + len(ids), tps + int(got[4][-1])
    return {"detections": dets, "true_positives": tps}


def detr_r50_flow_phase(device, gen, smi: str) -> dict:
    """Object-level OoD on DETR-R50 @ 800 x 1216 through open-set evaluation
    (see DETR_*): convert_hf_detr -> DetrAdapter -> BoxFeaturesExtractor on
    the backbone map (the ROIAlign kernel) and its MC route (kernel 1) ->
    MD and LaREM -> get_overall_open_set_results (the native matcher) and
    get_gtu_uu_metrics, counted; then the port against HF, DetrAdapter
    against HFDetrAdapter, the kernels and the matcher against their plain
    versions, and the times."""
    import tempfile

    import transformers

    from runia_core_tpu_torch.detectors import MDLatentSpace
    from runia_core_tpu_torch.evaluation import get_gtu_uu_metrics, get_overall_open_set_results, open_set
    from runia_core_tpu_torch.extraction import BoxFeaturesExtractor, HFDetrAdapter
    from runia_core_tpu_torch.models import DetrAdapter, convert_hf_detr
    from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda, marginal_entropy_plain
    from runia_core_tpu_torch.ops.roi_align import roi_align_nhwc_cuda, roi_align_nhwc_plain
    from runia_core_tpu_torch.sampling import MCSamplerModule
    from runia_core_tpu_torch.utils import cuda_graph_time_ms, cuda_time_ms

    seconds = {}
    start = time.perf_counter()
    cfg = transformers.DetrConfig(
        use_timm_backbone=False, use_pretrained_backbone=False, num_labels=91,
        backbone_config=transformers.ResNetConfig(embedding_size=64, hidden_sizes=[256, 512, 1024, 2048],
                                                  depths=[3, 4, 6, 3], layer_type="bottleneck",
                                                  out_features=["stage4"]))
    torch.manual_seed(SEED + 50)
    hf = transformers.DetrForObjectDetection(cfg).eval()
    rng = np.random.RandomState(SEED + 51)
    with torch.no_grad():
        for name, buf in hf.named_buffers():  # the frozen backbone norms' statistics
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(0.1 * rng.randn(*buf.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.rand(*buf.shape).astype(np.float32) + 0.5))
    params = sum(p.numel() for p in hf.parameters())
    model, _ = convert_hf_detr(hf)
    require(model.input_projection.weight.device == device, "detr: the default device is the card")
    hf_adapter = HFDetrAdapter(hf)  # the HF model on the card
    adapter = DetrAdapter(model)
    seconds["build"] = time.perf_counter() - start
    h, w = DETR_IMG
    images = [torch.rand((h, w, 3), generator=gen, device=device) * (4.0 if i >= DETR_IMAGES - 8 else 1.0)
              for i in range(DETR_IMAGES)]
    splits = {"fit": list(range(DETR_FIT)), "ind": list(range(1000, 1008)), "noise": list(range(2000, 2008))}
    image_of = dict(zip([i for ids in splits.values() for i in ids], images))
    adapter(images[0], DETR_CONF)  # cuDNN's autotune for the 800 x 1216 shapes, outside the count
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    roi_align_nhwc_cuda.launches = marginal_entropy_cuda.launches = conv_epilogue.launches = 0
    start = time.perf_counter()
    extractor = BoxFeaturesExtractor(adapter, "detr-backbone", roi_output_sizes=[7])
    mc_extractor = BoxFeaturesExtractor(adapter, "detr-backbone", roi_output_sizes=[7], extract_noise_entropies=True,
                                        mcd_nro_samples=MC_SAMPLES, dropblock_probs=DROP_PROB,
                                        dropblock_sizes=BLOCK_SIZE, generator=gen)
    out, mc_out = {}, {}
    for split, ids in splits.items():
        loader = [(f"{split}{i}.png", image_of[i], i) for i in ids]
        out[split] = extractor.get_ls_samples(loader, predict_conf=DETR_CONF)
        mc_out[split] = mc_extractor.get_ls_samples(loader, predict_conf=DETR_CONF)
    torch.cuda.synchronize()
    seconds["extract_32x2"] = time.perf_counter() - start
    start = time.perf_counter()
    rows = {split: {kind: np.concatenate([res[split][i]["latent_space_means"] for i in ids])
                    for kind, res in (("md", out), ("LaREM", mc_out))} for split, ids in splits.items()}
    detectors, thresholds, preds = {}, {}, {"ind": {}, "noise": {}}
    for method in ("md", "LaREM"):
        detectors[method] = MDLatentSpace()
        detectors[method].setup(rows["fit"][method])
        thresholds[method] = float(torch.quantile(detectors[method].postprocess(rows["fit"][method]), 0.05))
    for split in ("ind", "noise"):
        scored = {m: detectors[m].postprocess(rows[split][m]).cpu().numpy() for m in detectors}
        for n, i in enumerate(splits[split]):
            require(len(out[split][i]["boxes"]) == 100 and len(mc_out[split][i]["boxes"]) == 100,
                    "detr: predict_conf 0.0 keeps all 100 queries")
            preds[split][i] = {"boxes": out[split][i]["boxes"], "logits": out[split][i]["logits"],
                               **{m: scored[m][100 * n:100 * (n + 1)].tolist() for m in scored}}
    torch.cuda.synchronize()
    seconds["fit_and_score"] = time.perf_counter() - start
    with tempfile.TemporaryDirectory() as tmp:
        grng = np.random.RandomState(SEED + 52)
        ind_path = _synthetic_coco(Path(tmp) / "ind.json", preds["ind"], grng, True, cfg.num_labels)
        ood_path = _synthetic_coco(Path(tmp) / "ood.json", preds["noise"], grng, False, cfg.num_labels)
        osod = dict(ind_dataset_name="ind", ind_gt_annotations_path=ind_path, ind_data_dict={"valid": preds["ind"]},
                    ood_data_dict={"noise": preds["noise"]}, ood_datasets_names=["noise"],
                    ood_annotations_paths={"noise": ood_path}, methods_names=["md", "LaREM"], metric_2007=False)
        for call in ("", "_again"):  # the first builds the native matcher; get_gtu_uu_metrics imports pandas
            start = time.perf_counter()
            results = get_overall_open_set_results(**osod, methods_thresholds=thresholds, evaluate_on_ind=True,
                                                   get_known_classes_metrics=True, is_open_set_model=False)
            seconds[f"open_set_eval_host{call}"] = time.perf_counter() - start
            start = time.perf_counter()
            gtu_uu = get_gtu_uu_metrics(**osod)
            seconds[f"gtu_uu_host{call}"] = time.perf_counter() - start
        launches = {"roi_align": roi_align_nhwc_cuda.launches, "marginal_entropy": marginal_entropy_cuda.launches,
                    "conv_epilogue": conv_epilogue.launches}
        require(all(n > 0 for n in launches.values()),
                f"detr: ROIAlign, kernel 1 and the conv-norm epilogue launched: {launches}")
        flat = [v for ds in results.values() for m in ds.values() for v in m.values()]
        require(all(np.isfinite(v) for v in flat) and {"WI", "AOSE", "AP_U", "E_BK"} <= set(results["noise"]["md"]),
                f"detr: finite open-set metrics {results}")
        gtu_uu_n = [len(g) for g in open_set.get_boxes_gtu_and_uu_ood_dataset(
            "ind", ind_path, preds["noise"], "md", ood_path, False, True)]
        require(min(gtu_uu_n) > 0 and all(np.isfinite(v) for ds in gtu_uu.values() for m in ds.values()
                                          for g in m.values() for v in g.values()),
                f"detr: GTU and UU detections ({gtu_uu_n}) and finite AUROCs {gtu_uu}")

        # ---- the native matcher against its plain version ----
        matcher, eval_host = {}, {}
        for name, path, data, is_ood in (("ind", ind_path, preds["ind"], False),
                                         ("noise", ood_path, preds["noise"], True)):
            evaluators = {}
            for native in (True, False):
                ev = open_set.OpenSetEvaluator("ind", ind_path, metric_2007=False, native=native)
                open_set._fill_evaluator(ev, data, "md", thresholds["md"], False, None, False, None, True)
                start = time.perf_counter()
                evaluators[native] = ev.evaluate(path, is_ood=is_ood, get_known_classes_metrics=True)
                eval_host[f"{name}_{'native' if native else 'numpy_loops'}_s"] = time.perf_counter() - start
            require(evaluators[True] == evaluators[False], f"detr open-set {name}: native = loops, {evaluators}")
            matcher[name] = matcher_against_loops(open_set, ev, path, is_ood)

    # ---- the port against HF, the adapters, the kernels ----
    x = image_of[1000]
    with torch.inference_mode():
        ours, taps = model(x[None])
        theirs = hf(pixel_values=x.permute(2, 0, 1)[None])
    fmap = taps["backbone_fmap"]
    require(tuple(fmap.shape) == (1, h // 32, w // 32, 2048) and taps["encoder_tokens"].shape[1:3] == fmap.shape[1:3],
            f"detr: the (1, 25, 38, 2048) backbone map and 950 encoder tokens: {tuple(fmap.shape)}")
    logits_rel = float((ours["logits"] - theirs.logits).abs().max() / theirs.logits.abs().max())
    boxes_abs = float((ours["pred_boxes"] - theirs.pred_boxes).abs().max())
    require(logits_rel <= DETR_LOGITS_REL and boxes_abs <= DETR_BOXES_ATOL,
            f"detr: the port's forward against HF's, logits {logits_rel} rel, boxes {boxes_abs}")
    flips = 0
    for i in (1000, 1001, 2000, 2001):
        a, b = adapter(image_of[i], DETR_CONF), hf_adapter(image_of[i], DETR_CONF)
        agree = {"boxes": np.allclose(a.boxes, b.boxes, rtol=1e-3, atol=1e-3),
                 "scores": np.allclose(a.scores, b.scores, rtol=1e-4, atol=1e-5),
                 "features": np.allclose(a.features, b.features, rtol=1e-3, atol=1e-4),
                 # 50 random bottleneck blocks leave the map in the thousands: 1e-4 of its largest value
                 "fmaps": _rel(a.fmaps[0], b.fmaps[0]) <= DETR_LOGITS_REL}
        errs = {k: float(np.abs(np.asarray(getattr(a, k)) - np.asarray(getattr(b, k))).max())
                for k in ("boxes", "scores", "features")}
        errs["fmaps"] = _rel(a.fmaps[0], b.fmaps[0])
        require(a.boxes.shape == b.boxes.shape == (100, 4) and all(agree.values()),
                f"detr: DetrAdapter = HFDetrAdapter on image {i}: {agree}, max abs errors (fmaps rel) {errs}")
        rows_ = np.nonzero(a.classes != b.classes)[0]
        gaps = np.abs(a.logits[rows_, a.classes[rows_]] - a.logits[rows_, b.classes[rows_]])
        require(bool((gaps <= 1e-4 * np.abs(a.logits).max()).all()), f"detr: classes differ only at near-ties {gaps}")
        flips += len(rows_)
    det = adapter(x, DETR_CONF)
    boxes = torch.from_numpy(det.boxes).to(device)
    scale = fmap.shape[2] / w
    roi_err = {}
    for mean in (True, False):
        got = roi_align_nhwc_cuda(fmap, boxes, 7, scale, mean=mean)
        want = roi_align_nhwc_plain(fmap, boxes, 7, scale, mean=mean)
        roi_err["mean" if mean else "pooled"] = float((got - want).abs().max()) / float(fmap.abs().max())
    require(max(roi_err.values()) <= ROI_F32_REL, f"detr: ROIAlign kernel vs plain on the backbone map: {roi_err}")
    with torch.inference_mode():
        rois = roi_align_nhwc_plain(fmap, boxes, 7, scale)
        samples = MCSamplerModule(MC_SAMPLES, BLOCK_SIZE, DROP_PROB, generator=gen)(rois)
    k1_err = float((marginal_entropy_cuda(samples, K) - marginal_entropy_plain(samples, K)).abs().max())
    require(k1_err <= ENTROPY_ATOL, f"detr: kernel 1 vs plain on the MC route's (100, 16, 2048) samples: {k1_err}")

    # ---- timing ----
    k1 = timed_cold(lambda c: marginal_entropy_cuda(c, K), lambda c: marginal_entropy_plain(c, K),
                    cold_copies((samples.contiguous(),), samples.numel() * 4))
    n_det, dims = samples.shape[0], samples.shape[2]
    k1.update({"shape": list(samples.shape), **with_share(roofline(
        4 * (samples.numel() + n_det * dims), n_det * dims * kl_entropy_operations(MC_SAMPLES, K),
        H100_F32_OPS_PER_S), k1["ms"])})
    roi = {}
    for mean in (True, False):
        times = timed_cold(lambda f, b: roi_align_nhwc_cuda(f, b, 7, scale, mean=mean),
                           lambda f, b: roi_align_nhwc_plain(f, b, 7, scale, mean=mean),
                           cold_copies((fmap, boxes), fmap.numel() * 4))
        roi["mean" if mean else "pooled"] = {"map": list(fmap.shape), "rois": int(boxes.shape[0]), **times,
                                             **with_share(roi_work(fmap, boxes, 7, scale, mean), times["ms"])}
    adapter_ips = {}
    scored = [image_of[i] for i in splits["ind"] + splits["noise"]]
    for name, run in (("DetrAdapter", adapter), ("HFDetrAdapter", hf_adapter), ("DetrAdapter_again", adapter)):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for x_ in scored:
            run(x_, DETR_CONF)
        adapter_ips[name] = len(scored) / (time.perf_counter() - start)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for x_ in scored:
        res, _ = extractor._get_samples_one_image(x_, DETR_CONF)
        detectors["md"].postprocess(res["latent_space_means"])
    torch.cuda.synchronize()
    det_per_s = 100 * len(scored) / (time.perf_counter() - start)
    with torch.inference_mode():
        stage_ms = {"forward_f32": cuda_graph_time_ms(lambda: model(x[None]), 3),
                    "hf_forward_f32_events": cuda_time_ms(lambda: hf(pixel_values=x.permute(2, 0, 1)[None]), 5)}
    print(f"detr_r50: adapter img/s {adapter_ips}, scoring {det_per_s:.0f} det/s, stages ms {stage_ms}, "
          f"open-set host s {seconds['open_set_eval_host']:.3f} ({seconds['open_set_eval_host_again']:.3f} again)",
          flush=True)
    emit({"phase": "detr_r50_flow", "card": smi, "img": list(DETR_IMG), "params": params,
          "backbone_map": list(fmap.shape), "encoder_tokens": int(fmap.shape[1] * fmap.shape[2]),
          "predict_conf": DETR_CONF, "launches": launches, "seconds": seconds, "thresholds": thresholds,
          "open_set": results, "gtu_uu_detections": gtu_uu_n,
          "gtu_uu_auroc": {m: {g: v["auroc"] for g, v in r.items()} for m, r in gtu_uu["noise"].items()},
          "matcher_vs_loops": matcher, "open_set_eval_host_s": eval_host,
          "xcheck_hf": {"logits_rel": logits_rel, "boxes_abs": boxes_abs, "bounds": [DETR_LOGITS_REL, DETR_BOXES_ATOL],
                        "adapter_class_flips_at_near_ties": flips},
          "roi_align_rel_err": roi_err, "kernel1_max_abs_err": k1_err, "kernel1_timing": k1, "roi_align_timing": roi,
          "adapter_img_per_s": adapter_ips, "scoring_det_per_s": det_per_s, "stage_ms": stage_ms,
          "transformers": transformers.__version__})
    del model, hf, adapter, hf_adapter, extractor, mc_extractor, images, image_of
    torch.cuda.empty_cache()
    return launches, {"roi_align": roi, "marginal_entropy": k1}


@torch.no_grad()
def seeded_convs(model, generator: torch.Generator):
    """Every convolution kernel lecun-normal (std 1 / sqrt(fan_in)) from
    ``generator``, biases 0, as flax initialises them."""
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator, device=m.weight.device)
                           / math.sqrt(m.weight[0].numel()))
            if m.bias is not None:
                m.bias.zero_()
    return model


def deeplabv3p_r50_seg_phase(device, gen, smi: str) -> dict:
    """Segmentation uncertainty on DeepLabV3+-R50 OS16 @ 512 x 512 (see
    SEG_*): (a) build_pixel_uncertainty_scorer under its graph; (b) LaREx over
    the pre_pool tap: FastMCDSamplesExtractor -> get_dl_h_z (kernel 1) -> MD
    -> build_larex_scorer with fused=True (kernel 2) and fused=False (kernel
    1), counted; then replays against eager, the kernels against their plain
    versions at this tap, the card against the CPU, and the times."""
    from runia_core_tpu_torch.detectors import MDLatentSpace
    from runia_core_tpu_torch.evaluation import get_dl_h_z
    from runia_core_tpu_torch.extraction import FastMCDSamplesExtractor
    from runia_core_tpu_torch.inference import build_larex_scorer, build_pixel_uncertainty_scorer
    from runia_core_tpu_torch.models import DeepLabV3Plus, build_tapped_forward
    from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda, marginal_entropy_plain
    from runia_core_tpu_torch.ops.mc_entropy_cuda import fused_mc_entropy, fused_mc_entropy_plain, mc_dropblock_weights
    from runia_core_tpu_torch.utils import cuda_graph_time_ms, cuda_time_ms

    model = DeepLabV3Plus(dropout_rate=0.5)
    require(model.head.weight.device == device, "deeplab: the default device is the card")
    seeded_convs(model, torch.Generator(device=device).manual_seed(SEED + 60))
    randomize_batchnorm(model, torch.Generator(device=device).manual_seed(SEED + 61))
    model = model.to(memory_format=torch.channels_last)

    def images(n, scale=1.0):
        return torch.rand((n, SEG_IMG, SEG_IMG, 3), generator=gen, device=device) * scale

    ind, noise = images(SEG_BATCH), images(SEG_BATCH, 4.0)
    forward = build_tapped_forward(model, ("pre_pool",))
    with torch.inference_mode():
        model(ind)  # cuDNN's autotune for the 512 px shapes, outside the count
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    marginal_entropy_cuda.launches = fused_mc_entropy.launches = conv_epilogue.launches = 0
    seconds = {}
    start = time.perf_counter()
    pixel = build_pixel_uncertainty_scorer(model, mc_samples=SEG_PIXEL_MC)
    maps = []
    for i, batch in enumerate((ind, noise)):
        with no_host_sync():  # the first call captures the scorer's graph; both replay it
            maps.append(pixel(batch, torch.Generator(device=device).manual_seed(SEED + 62 + i)))
    torch.cuda.synchronize()
    seconds["pixel_scorer_2_calls"] = time.perf_counter() - start
    start = time.perf_counter()
    extractor = FastMCDSamplesExtractor(forward, "Conv", "fullmean", mcd_nro_samples=MC_SAMPLES,
                                        dropblock_probs=DROP_PROB, dropblock_sizes=BLOCK_SIZE, generator=gen)
    fit = extractor.get_ls_samples([(images(SEG_BATCH), None) for _ in range(SEG_FIT // SEG_BATCH)])
    samples = fit["latent_space_means"]
    _, h_z = get_dl_h_z(samples, MC_SAMPLES)
    md = MDLatentSpace()
    md.setup(h_z)
    torch.cuda.synchronize()
    seconds["extract_fit"] = time.perf_counter() - start
    scorers = {route: build_larex_scorer(forward, None, md.state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE,
                                         fused=route == "fused") for route in ("two_step", "fused")}
    scores = {}
    start = time.perf_counter()
    for route, scorer in scorers.items():
        scores[route] = []
        for i, batch in enumerate((ind, noise)):
            with no_host_sync():
                scores[route].append(scorer(batch, torch.Generator(device=device).manual_seed(SEED + 64 + i))[1])
    torch.cuda.synchronize()
    seconds["larex_scorers_2x2_calls"] = time.perf_counter() - start
    launches = {"marginal_entropy": marginal_entropy_cuda.launches, "fused_mc_entropy": fused_mc_entropy.launches,
                "conv_epilogue": conv_epilogue.launches}
    require(all(n > 0 for n in launches.values()),
            f"deeplab: kernels 1 and 2 and the conv-norm epilogue launched: {launches}")
    for m in maps:
        require(all(tuple(m[k].shape) == (SEG_BATCH, SEG_IMG, SEG_IMG) for k in m) and m["pred"].dtype == torch.int32
                and all(bool(torch.isfinite(m[k]).all()) for k in ("pred_h", "mi", "msp")),
                "deeplab: finite (4, 512, 512) maps, int32 pred")
        require(float(m["mi"].min()) > -1e-5 and float(m["mi"].max()) > 1e-4,
                "deeplab: MI >= 0 up to f32 noise, and the dropout makes the samples disagree")
    require(all(bool(torch.isfinite(t).all()) for v in scores.values() for t in v), "deeplab: finite LaREx scores")

    # ---- replays against eager, the routes against each other ----
    eager_pixel = build_pixel_uncertainty_scorer(model, mc_samples=SEG_PIXEL_MC, use_graph=False)
    pixel_rel = 0.0
    for i, batch in enumerate((ind, noise)):
        want = eager_pixel(batch, torch.Generator(device=device).manual_seed(SEED + 62 + i))
        require(torch.equal(maps[i]["pred"], want["pred"]), "deeplab: the pixel scorer's replay pred = eager's")
        pixel_rel = max(pixel_rel, *(_rel(maps[i][k], want[k]) for k in ("pred_h", "mi", "msp")))
    require(pixel_rel <= GRAPH_REL, f"deeplab: the pixel scorer's replay against eager: {pixel_rel}")
    larex_rel = {}
    for route in scorers:
        eager = build_larex_scorer(forward, None, md.state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE,
                                   fused=route == "fused", use_graph=False)
        larex_rel[route] = max(_rel(scores[route][i], eager(batch, torch.Generator(device=device).manual_seed(
            SEED + 64 + i))[1]) for i, batch in enumerate((ind, noise)))
    larex_rel["fused_vs_two_step"] = max(_rel(f, t) for f, t in zip(scores["fused"], scores["two_step"]))
    require(max(larex_rel["two_step"], larex_rel["fused"]) <= GRAPH_REL and
            larex_rel["fused_vs_two_step"] <= SEG_ROUTES_REL, f"deeplab: LaREx scorer replays and routes {larex_rel}")

    # ---- the kernels at this path's shapes, the card against the CPU ----
    with torch.inference_mode():
        tap = forward(ind)[1]["pre_pool"].float().contiguous()
    b, th, tw, c = tap.shape
    weights = mc_dropblock_weights(b, th, tw, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, gen, device)
    got, want = fused_mc_entropy(weights, tap, K), fused_mc_entropy_plain(weights, tap, K)
    k2_err = float((got - want).abs().max())
    require(bool(((got - want).abs() <= FUSED_ATOL + FUSED_RTOL * want.abs()).all()),
            f"deeplab: kernel 2 vs plain at the (4, 32, 32, 256) tap: {k2_err}")
    clouds = samples.reshape(-1, MC_SAMPLES, samples.shape[-1]).contiguous()
    scorer_clouds = torch.bmm(weights, tap.reshape(b, th * tw, c)) / (th * tw)  # the two-step scorer's (4, 16, 256)
    k1_err = max(float((marginal_entropy_cuda(x, K) - marginal_entropy_plain(x, K)).abs().max())
                 for x in (clouds, scorer_clouds))
    require(k1_err <= ENTROPY_ATOL, f"deeplab: kernel 1 vs plain on get_dl_h_z's and the scorer's clouds: {k1_err}")
    cpu_model = DeepLabV3Plus(dropout_rate=0.5, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        card_logits = model(ind[:1])[0].cpu()
        cpu_logits = cpu_model(ind[:1].cpu())[0]
    xrel = _rel(card_logits, cpu_logits)
    require(xrel <= SEG_XCHECK_REL, f"deeplab f32 forward card vs CPU: {xrel} of max |logit|")
    del cpu_model

    # ---- timing ----
    read = tap.numel() * 4 + weights.numel() * 4
    k2 = timed_cold(lambda wt, fm: fused_mc_entropy(wt, fm, K), lambda wt, fm: fused_mc_entropy_plain(wt, fm, K),
                    cold_copies((weights, tap), read))
    k2.update({"shape": [b, th, tw, c], "samples": MC_SAMPLES, **with_share(roofline(
        read + 4 * b * c, 2 * b * MC_SAMPLES * th * tw * c + b * c * kl_entropy_operations(MC_SAMPLES, K),
        H100_F32_OPS_PER_S), k2["ms"])})
    k1 = timed_cold(lambda x: marginal_entropy_cuda(x, K), lambda x: marginal_entropy_plain(x, K),
                    cold_copies((clouds,), clouds.numel() * 4))
    n, d = clouds.shape[0], clouds.shape[2]
    k1.update({"shape": list(clouds.shape), **with_share(roofline(
        4 * (clouds.numel() + n * d), n * d * kl_entropy_operations(MC_SAMPLES, K), H100_F32_OPS_PER_S), k1["ms"])})
    ips = {}
    for name, fn in (("pixel_graph", lambda: pixel(ind, torch.Generator(device=device).manual_seed(1))),
                     ("pixel_eager", lambda: eager_pixel(ind, torch.Generator(device=device).manual_seed(1))),
                     ("larex_two_step_graph", lambda: scorers["two_step"](ind)),
                     ("larex_fused_graph", lambda: scorers["fused"](ind))):
        ips[name] = SEG_BATCH / (cuda_time_ms(fn, 3, warmup=1) * 1e-3)
    with torch.inference_mode():
        forward_ms = {"batch4_f32": cuda_graph_time_ms(lambda: model(ind), 2),
                      "batch4_f32_eager_events": cuda_time_ms(lambda: model(ind), 3)}
    print(f"deeplabv3p_r50: img/s {ips}; forward ms {forward_ms}", flush=True)
    emit({"phase": "deeplabv3p_r50_seg", "card": smi, "img": SEG_IMG, "batch": SEG_BATCH, "tap": list(tap.shape),
          "pixel_mc_samples": SEG_PIXEL_MC, "fit_images": SEG_FIT, "launches": launches, "seconds": seconds,
          "pixel_replay_vs_eager_rel": pixel_rel, "larex_rel": larex_rel,
          "bounds": {"graph": GRAPH_REL, "fused_vs_two_step": SEG_ROUTES_REL, "card_vs_cpu": SEG_XCHECK_REL},
          "f32_card_vs_cpu_rel": xrel, "kernel1_max_abs_err": k1_err, "kernel2_max_abs_err": k2_err,
          "kernel1_timing": k1, "kernel2_timing": k2, "img_per_s": ips, "forward_ms": forward_ms,
          "mi_max": [float(m["mi"].max()) for m in maps],
          "score_median": {r: [float(t.median()) for t in v] for r, v in scores.items()}})
    del model, scorers, pixel, eager_pixel
    torch.cuda.empty_cache()
    return launches, {"marginal_entropy": k1, "fused_mc_entropy": k2}


def score_dataset_rn18_phase(device, gen, smi: str):
    """``ScoringService.score_dataset`` over SERVE_IMAGES seeded uint8
    CIFAR-shaped images into the headline LaREx scorer (RN18-CIFAR bf16,
    batch 512, S = 16, PCA-256, LaREM, under its graph), both routes,
    counted; the outputs equal the same scorer called batch by batch on the
    loader's batches with the service's generators, bit for bit, and the
    numpy gather's run; then img/s against the scorer's replay rate and the
    loader alone, and ``device_healthcheck``'s latency. Returns the counts
    and what ``dp_world1`` scores with."""
    from runia_core_tpu_torch.data import PrefetchLoader, gather_normalize
    from runia_core_tpu_torch.detectors import MDLatentSpace
    from runia_core_tpu_torch.inference import ScoringService, build_larex_scorer
    from runia_core_tpu_torch.models import build_tapped_forward
    from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue
    from runia_core_tpu_torch.ops.entropy import marginal_entropy
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda
    from runia_core_tpu_torch.ops.mc_entropy_cuda import fused_mc_entropy
    from runia_core_tpu_torch.reduction import apply_pca_ds_split
    from runia_core_tpu_torch.sampling import mc_dropblock_samples
    from runia_core_tpu_torch.utils import cuda_time_ms, device_healthcheck, device_profile

    model = build_model(torch.bfloat16)
    forward = build_tapped_forward(model, ("pre_pool",))
    fit_images = torch.rand((BATCH, IMG, IMG, 3), generator=gen, device=device)
    with torch.inference_mode():
        latent = forward(fit_images)[1]["pre_pool"].to(torch.float32).contiguous()
    mc = mc_dropblock_samples(latent, MC_SAMPLES, BLOCK_SIZE, DROP_PROB, "Conv", channel_axis=3, generator=gen)
    h_pca, pca_state = apply_pca_ds_split(marginal_entropy(mc, K), nro_components=PCA_DIMS)
    larem = MDLatentSpace()
    larem.setup(h_pca)
    images_u8 = np.random.RandomState(SEED + 70).randint(0, 256, (SERVE_IMAGES, IMG, IMG, 3), dtype=np.uint8)
    routes = {route: build_larex_scorer(forward, pca_state, larem.state, MC_SAMPLES, DROP_PROB, BLOCK_SIZE,
                                        fused=route == "fused") for route in ("two_step", "fused")}
    services = {route: ScoringService(scorer, seed=SEED + 71, max_in_flight=SERVE_WINDOW)
                for route, scorer in routes.items()}
    torch.cuda.synchronize()

    # ---- the main path, counted: a whole dataset through each route ----
    marginal_entropy_cuda.launches = fused_mc_entropy.launches = conv_epilogue.launches = 0
    start = time.perf_counter()
    served = {route: service.score_dataset(images_u8, BATCH) for route, service in services.items()}
    first_s = time.perf_counter() - start
    launches = {"marginal_entropy": marginal_entropy_cuda.launches, "fused_mc_entropy": fused_mc_entropy.launches,
                "conv_epilogue": conv_epilogue.launches}
    require(all(n > 0 for n in launches.values()),
            f"score_dataset: kernels 1 and 2 and the conv-norm epilogue launched: {launches}")
    for route, (logits, scores) in served.items():
        require(tuple(logits.shape) == (SERVE_IMAGES, NUM_CLASSES) and tuple(scores.shape) == (SERVE_IMAGES,)
                and logits.device.type == "cpu" and bool(torch.isfinite(scores).all())
                and bool(torch.isfinite(logits.float()).all()),
                f"score_dataset {route}: finite ({SERVE_IMAGES},) scores and logits on the host")

    # ---- the same scorer batch by batch, and the numpy gather ----
    batches = len(PrefetchLoader(images_u8, batch_size=BATCH))
    for route, scorer in routes.items():
        parts = []
        for i, (x, _) in enumerate(PrefetchLoader(images_u8, batch_size=BATCH)):
            if x.shape[0] < BATCH:
                x = torch.cat([x, x.new_zeros((BATCH - x.shape[0],) + tuple(x.shape[1:]))])
            parts.append(scorer(x, services[route].generator_for(i)))
        direct = [torch.cat([p[j] for p in parts])[:SERVE_IMAGES].cpu() for j in (0, 1)]
        require(all(torch.equal(a, b) for a, b in zip(served[route], direct)),
                f"score_dataset {route}: the service's outputs = direct scorer calls, bit for bit")
    idx = np.random.RandomState(SEED + 72).permutation(SERVE_IMAGES)[:BATCH]
    require(np.array_equal(gather_normalize(images_u8, idx), gather_normalize(images_u8, idx, native=False)),
            "score_dataset: the native gather = the numpy one")
    plain = ScoringService(routes["two_step"], seed=SEED + 71, max_in_flight=SERVE_WINDOW).score_dataset(
        images_u8, BATCH, native=False)
    require(all(torch.equal(a, b) for a, b in zip(plain, served["two_step"])),
            "score_dataset: native=False gives the same outputs")

    # ---- timing: the service per route in turns, the scorer's replay, the loader ----
    runs = {route: [] for route in routes}
    for route in SERVE_TURNS:
        torch.cuda.synchronize()
        start = time.perf_counter()
        services[route].score_dataset(images_u8, BATCH)
        runs[route].append(time.perf_counter() - start)
    x = torch.rand((BATCH, IMG, IMG, 3), generator=gen, device=device)
    replay_ips = {route: BATCH / (cuda_time_ms(lambda: scorer(x, torch.Generator(device=device).manual_seed(1)),
                                               iters=30, warmup=3) * 1e-3) for route, scorer in routes.items()}
    loader_s = {}
    for name, kw in (("host_pinned", {"device": None, "pin_memory": device.type == "cuda"}), ("to_card", {})):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for xb, _ in PrefetchLoader(images_u8, batch_size=BATCH, **kw):
            pass
        torch.cuda.synchronize()
        loader_s[name] = time.perf_counter() - start
    busy = device_profile(lambda: services["two_step"].score_dataset(images_u8, BATCH), 1)
    health_s = device_healthcheck()
    ips = {route: SERVE_IMAGES / statistics.median(t) for route, t in runs.items()}
    record = {"phase": "score_dataset_rn18", "card": smi, "images": SERVE_IMAGES, "batch": BATCH,
              "batches": batches, "tail": SERVE_IMAGES - (batches - 1) * BATCH, "window": SERVE_WINDOW,
              "launches": launches, "first_run_both_routes_s": first_s,
              "service_img_per_s": ips, "service_runs_s": runs, "scorer_replay_img_per_s": replay_ips,
              "service_share_of_replay_rate": {r: ips[r] / replay_ips[r] for r in routes},
              "loader_img_per_s": {k: SERVE_IMAGES / v for k, v in loader_s.items()},
              "device_busy_share_two_step_run": busy["device_busy_share"],
              "device_busy_ms_two_step_run": busy["device_busy_ms_per_unit"],
              "device_time_seen": busy["device_time_seen"], "healthcheck_latency_s": health_s,
              "bit_equal_to_direct_calls": True, "native_equals_numpy": True}
    print(f"score_dataset_rn18 ({smi}): service img/s {ips}, scorer replay img/s {replay_ips}, "
          f"loader img/s {record['loader_img_per_s']}, healthcheck {health_s * 1e3:.3f} ms", flush=True)
    emit(record)
    return launches, {"model": model, "forward": forward, "routes": routes, "larem": larem, "h_pca": h_pca}


def host_ms(fn, iters: int = 10) -> float:
    """ms a call on the host clock, one warm call first, synchronised."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / iters


def dp_world1_phase(device, gen, smi: str, served: dict) -> dict:
    """The data-parallel helpers in a one-process NCCL world (a ``file://``
    rendezvous in a temporary directory, torn down at the end):
    ``data_parallel_scorer`` = the single-device scorer (both routes, the
    same generator state), ``fit_md_sharded`` = ``MDLatentSpace``, the
    sharded KNN and KDE = the dense ones, one ``sharded_train_step`` = one
    plain SGD step; then each one's time against the single-device call.
    One card measures the layer's overhead, not its scaling."""
    import tempfile

    import torch.distributed as dist
    import torch.nn.functional as F

    from runia_core_tpu_torch.detectors import MDLatentSpace
    from runia_core_tpu_torch.detectors.latent import kde_log_density, md_score
    from runia_core_tpu_torch.ops.conv_epilogue import conv_epilogue
    from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda
    from runia_core_tpu_torch.ops.knn import squared_l2_kth_neighbor
    from runia_core_tpu_torch.ops.mc_entropy_cuda import fused_mc_entropy
    from runia_core_tpu_torch.parallel import (
        data_parallel_scorer,
        fit_md_sharded,
        make_mesh,
        shard_batch,
        sharded_kde_log_density,
        sharded_knn_score,
        sharded_train_step,
    )

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=f"file://{tmp}/rendezvous",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(1, device_type=device.type)
            x = torch.rand((BATCH, IMG, IMG, 3), generator=gen, device=device)

            # ---- the main path, counted: the data-parallel scorer, both routes (its split path:
            # keep-weights drawn outside the scorer, its weights= graph, the all-gather) ----
            want = {route: scorer(x, torch.Generator(device=device).manual_seed(SEED + 80))
                    for route, scorer in served["routes"].items()}
            dp = {route: data_parallel_scorer(scorer, mesh) for route, scorer in served["routes"].items()}
            marginal_entropy_cuda.launches = fused_mc_entropy.launches = conv_epilogue.launches = 0
            got = {route: dp[route](shard_batch(x, mesh), torch.Generator(device=device).manual_seed(SEED + 80))
                   for route in dp}
            launches = {"marginal_entropy": marginal_entropy_cuda.launches,
                        "fused_mc_entropy": fused_mc_entropy.launches, "conv_epilogue": conv_epilogue.launches}
            require(all(n > 0 for n in launches.values()),
                    f"dp_world1: kernels 1 and 2 and the conv-norm epilogue launched: {launches}")
            for route in dp:
                require(all(torch.equal(a, b) for a, b in zip(got[route], want[route])),
                        f"dp_world1 {route}: the data-parallel scorer = the single-device scorer")

            # ---- LaREM, KNN, KDE: sharded against dense ----
            h = served["h_pca"]
            state = fit_md_sharded(shard_batch(h, mesh), mesh)
            dense = MDLatentSpace()
            dense.setup(h)
            mean_err = float((state["feats_mean"] - dense.feats_mean.reshape(1, -1)).abs().max())
            want = dense.postprocess(h)
            md_rel = float((md_score(h, state["feats_mean"], state["precision"]) - want).abs().max()
                           / want.abs().max())
            require(mean_err <= 1e-6 and md_rel <= DP_MD_REL,
                    f"dp_world1: fit_md_sharded = MDLatentSpace (mean {mean_err}, scores {md_rel})")
            test, bank = h[: BATCH // 4], h
            knn_equal = torch.equal(-sharded_knn_score(test, bank, DP_KNN_K), squared_l2_kth_neighbor(test, bank,
                                                                                                     DP_KNN_K))
            kde_rel = _rel(sharded_kde_log_density(test, bank, bank.shape[0]), kde_log_density(test, bank))
            require(knn_equal and kde_rel <= 1e-5, f"dp_world1: KNN equal {knn_equal}, KDE {kde_rel}")

            # ---- one sharded SGD step against a plain one ----
            model = build_model(torch.float32)
            images = torch.rand((DP_TRAIN_BATCH, IMG, IMG, 3), generator=gen, device=device)
            labels = torch.randint(0, NUM_CLASSES, (DP_TRAIN_BATCH,), generator=gen, device=device)
            step = sharded_train_step(model, make_mesh(1, 1, device_type=device.type), learning_rate=DP_LR)
            params = step.shard_params(dict(model.named_parameters()))
            new, loss = step(params, shard_batch(images, mesh), shard_batch(labels, mesh))

            def plain_step():
                model.zero_grad()
                with torch.enable_grad():
                    plain_loss = F.cross_entropy(model(images)[0].float(), labels)
                    plain_loss.backward()
                return {n: (p - DP_LR * p.grad).detach() for n, p in model.named_parameters()}, plain_loss.detach()

            plain_new, plain_loss = plain_step()
            loss_rel = abs(float(loss) - float(plain_loss)) / abs(float(plain_loss))
            step_rel = max(float((new[n] - plain_new[n]).abs().max()
                                 / max(float((plain_new[n] - params[n]).abs().max()), 1e-12)) for n in plain_new)
            require(loss_rel <= 1e-6 and step_rel <= DP_STEP_REL,
                    f"dp_world1: sharded step = plain step (loss {loss_rel}, updates {step_rel})")

            # ---- overhead against the single-device calls (host clock, synchronised) ----
            gen_fn = lambda: torch.Generator(device=device).manual_seed(1)  # noqa: E731
            ms = {
                "scorer_two_step": (host_ms(lambda: dp["two_step"](x, gen_fn())),
                                    host_ms(lambda: served["routes"]["two_step"](x, gen_fn()))),
                "fit_md": (host_ms(lambda: fit_md_sharded(h, mesh)), host_ms(lambda: MDLatentSpace().setup(h))),
                "knn": (host_ms(lambda: sharded_knn_score(test, bank, DP_KNN_K)),
                        host_ms(lambda: squared_l2_kth_neighbor(test, bank, DP_KNN_K))),
                "kde": (host_ms(lambda: sharded_kde_log_density(test, bank, bank.shape[0])),
                        host_ms(lambda: kde_log_density(test, bank))),
                "sgd_step": (host_ms(lambda: step(params, images, labels), 5), host_ms(plain_step, 5)),
            }
        finally:
            dist.destroy_process_group()
    overhead = {name: {"sharded_ms": a, "single_ms": b, "ratio": a / b} for name, (a, b) in ms.items()}
    print(f"dp_world1 ({smi}): " + ", ".join(f"{k} {v['ratio']:.3f}x" for k, v in overhead.items()), flush=True)
    emit({"phase": "dp_world1", "card": smi, "backend": "nccl" if device.type == "cuda" else "gloo", "world": 1,
          "launches": launches, "fit_md_mean_err": mean_err, "fit_md_scores_rel": md_rel, "knn_equal": knn_equal,
          "kde_rel": kde_rel, "sgd_loss_rel": loss_rel, "sgd_update_rel": step_rel, "overhead": overhead,
          "bounds": {"md": DP_MD_REL, "update": DP_STEP_REL},
          "note": "one card: the layer's overhead at world size 1, not scaling"})
    return launches


def _adam_update(p, g, lr):
    """The first step of JAX's bias-corrected Adam (fsdp.py), from zero
    moments, as ``parallel.fsdp_train_step`` runs it."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    tf = torch.ones((), dtype=torch.float32, device=g.device)
    m, v = (1 - b1) * g, (1 - b2) * g.square()
    return p - lr * (m / (1 - b1**tf)) / ((v / (1 - b2**tf)).sqrt() + eps)


def mp_world1_phase(device, gen, smi: str) -> dict:
    """The model-parallel layer in a one-process NCCL world (a ``file://``
    rendezvous in a temporary directory, torn down at the end), each leg
    against its unsharded counterpart: ``tp`` + ``engine``, the production
    Llama (bf16 ``use_flash`` and int8 + KV8 + fused qkv) made
    tensor-parallel by ``shard_llama_params`` on a ``model`` axis and served
    by ``ContinuousBatchingEngine`` (the main path, counted: kernel 3 for the
    int8 projections, kernel 4 for the chunked prefills of 128), greedy
    tokens equal to the unsharded engine's; ``sp`` ring attention against
    dense causal attention; ``ep`` the expert-parallel MoE against
    ``moe_ffn``; ``pp`` a one-stage pipeline against the block; ``fsdp`` an
    FSDP Adam step of the headline ResNet-18 and of the Llama cut to 2
    layers against a plain step. Then each leg's time against its
    counterpart's. One card measures the layer's overhead, not its
    scaling."""
    import tempfile

    import torch.distributed as dist
    import torch.nn.functional as F

    from runia_core_tpu_torch.llm import ContinuousBatchingEngine
    from runia_core_tpu_torch.models import LlamaLM
    from runia_core_tpu_torch.parallel import (
        fsdp_train_step,
        init_moe,
        make_mesh,
        moe_ffn,
        pipeline_apply,
        ring_attention,
        shard_batch,
        shard_llama_params,
        sharded_moe_ffn,
    )

    backend = "nccl" if device.type == "cuda" else "gloo"
    prompts, budgets = serve_traffic(MP_TRAFFIC, LLM_CFG["vocab_size"])
    ms, record = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0)
        try:
            dist.all_reduce(torch.zeros(1, device=device))  # the communicator, before any capture
            mesh = make_mesh(1, model_parallel=1, device_type=device.type)

            # ---- tp + engine: the main path, counted ----
            dense, int8 = build_llms(device, LLM_CFG["num_layers"], torch.bfloat16)
            engines = {}
            for name, model in (("bf16", dense), ("int8_kv8", int8)):
                tp_model = shard_llama_params(sharing(model), mesh)
                engines[name] = {"unsharded": ContinuousBatchingEngine(model, **MP_ENGINE),
                                 "tp": ContinuousBatchingEngine(tp_model, **MP_ENGINE)}
            _zero_counts()
            served = {}
            for name in engines:
                with no_host_sync():
                    served[name] = serve_pass(engines[name]["tp"], prompts, budgets)
                check_served(served[name], budgets, f"mp_world1 tp {name}")
            counted = _counted()
            launches = {"quant_matmul": counted["quant_matmul"],
                        "flash_prefix_attention": counted["flash_prefix_attention"]}
            require(counted["quant_matmul"] > 0 and counted["flash_prefix_attention"] > 0
                    and counted["flash_prefix_attention_kv8"] > 0,
                    f"mp_world1: kernels 3 and 4 (bf16 and KV8) launched on the tensor-parallel path: {counted}")
            for name in engines:
                with no_host_sync():
                    want = serve_pass(engines[name]["unsharded"], prompts, budgets)
                same = [a["tokens"] == b["tokens"] for a, b in zip(served[name], want)]
                require(all(same), f"mp_world1 tp {name}: the tensor-parallel engine's tokens = the unsharded "
                                   f"engine's ({sum(same)} of {len(same)} requests)")
                record[f"tp_{name}_requests_equal"] = sum(same)

            def drain_ms(engine):
                torch.cuda.synchronize()
                start = time.perf_counter()
                with no_host_sync():
                    serve_pass(engine, prompts, budgets)
                torch.cuda.synchronize()
                return (time.perf_counter() - start) * 1e3

            for name in engines:  # warm drains, in turns: unsharded, tp, tp, unsharded
                runs = {"tp": [], "unsharded": []}
                for route in ("unsharded", "tp", "tp", "unsharded"):
                    runs[route].append(drain_ms(engines[name][route]))
                ms[f"engine_{name}"] = (min(runs["tp"]), min(runs["unsharded"]))
            del engines, dense, int8, served
            _drop_programs()
            torch.cuda.empty_cache()

            # ---- sp: ring attention against dense causal attention in f32 ----
            q, k, v = (torch.randn(MP_RING, generator=gen, device=device, dtype=torch.bfloat16) for _ in range(3))
            seq_mesh = make_mesh(1, axis_names=("seq", "unused"), device_type=device.type)

            def ring():
                return ring_attention(q, k, v, seq_mesh, seq_axis="seq").full_tensor()

            def dense_attention():
                logits = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(MP_RING[-1])
                causal = torch.ones(logits.shape[-2:], dtype=torch.bool, device=device).tril()
                return torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1) @ v.float()

            want = dense_attention()
            ring_err = float((ring().float() - want).abs().max() / want.abs().max())
            require(ring_err <= MP_RING_REL, f"mp_world1 sp: ring = dense attention ({ring_err} > {MP_RING_REL})")
            ms["ring_attention"] = (host_ms(ring, 5), host_ms(dense_attention, 5))
            del q, k, v, want

            # ---- ep: the expert-parallel MoE against moe_ffn ----
            moe_gen = torch.Generator(device=device).manual_seed(SEED + 90)
            params = init_moe(moe_gen, MP_MOE["d_model"], MP_MOE["d_hidden"], MP_MOE["num_experts"])
            tokens = torch.randn((MP_MOE["tokens"], MP_MOE["d_model"]), generator=moe_gen, device=device)

            def moe_sharded():
                return sharded_moe_ffn(params, tokens, mesh, top_k=MP_MOE["top_k"]).full_tensor()

            def moe_dense():
                return moe_ffn(params, tokens, top_k=MP_MOE["top_k"])

            want = moe_dense()
            moe_err = float((moe_sharded() - want).abs().max() / want.abs().max())
            require(moe_err <= MP_MOE_REL, f"mp_world1 ep: sharded = unsharded MoE ({moe_err} > {MP_MOE_REL})")
            ms["moe"] = (host_ms(moe_sharded, 5), host_ms(moe_dense, 5))
            del params, tokens, want

            # ---- pp: a one-stage pipeline against the block ----
            w = torch.randn((1, MP_PIPE["d"], MP_PIPE["d"]), generator=gen, device=device) / math.sqrt(MP_PIPE["d"])
            x = torch.randn((MP_PIPE["batch"], MP_PIPE["d"]), generator=gen, device=device)

            def block(wi, h):
                return h + torch.tanh(h @ wi)

            def piped():
                return pipeline_apply(block, w, x, mesh, MP_PIPE["micro"])

            want = block(w[0], x)
            pipe_err = float((piped() - want).abs().max() / want.abs().max())
            require(pipe_err <= MP_PIPE_REL, f"mp_world1 pp: pipeline = the block ({pipe_err} > {MP_PIPE_REL})")
            ms["pipeline"] = (host_ms(piped, 5), host_ms(lambda: block(w[0], x), 5))
            del w, x, want

            # ---- fsdp: one Adam step of the ResNet-18 and of the 2-layer Llama against plain steps ----
            fsdp = {}
            resnet = build_model(torch.float32)
            images = torch.rand((MP_FSDP_IMAGES, IMG, IMG, 3), generator=gen, device=device)
            labels = torch.randint(0, NUM_CLASSES, (MP_FSDP_IMAGES,), generator=gen, device=device)
            lm = LlamaLM(**dict(LLM_CFG, num_layers=MP_FSDP_LM_LAYERS)).eval()
            lm.init_weights(torch.Generator(device=device).manual_seed(SEED + 91))
            lm_tokens = torch.randint(1, LLM_CFG["vocab_size"], MP_FSDP_LM_TOKENS, generator=gen, device=device)

            def lm_loss(out, tgt):
                logp = F.log_softmax(out[0][:, :-1].float(), dim=-1)
                return -logp.gather(2, tgt[:, 1:, None]).mean()

            legs = {
                "resnet18": (resnet, "classifier", images, labels,
                             lambda: F.cross_entropy(resnet(images)[0].float(), labels)),
                "llama_2l": (lm, "causal_lm", lm_tokens, lm_tokens,
                             lambda: lm_loss(lm.differentiable_forward(lm_tokens, need_attentions=False,
                                                                       need_hiddens=False), lm_tokens)),
            }
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
                for name, (model, task, inputs, targets, plain_loss) in legs.items():
                    step = fsdp_train_step(model, mesh, learning_rate=MP_LR, task=task)
                    params = step.shard_params(dict(model.named_parameters()))
                    opt = step.init_opt(params)
                    new, _, loss = step(params, opt, shard_batch(inputs, mesh), shard_batch(targets, mesh))
                    frozen = {n: p.requires_grad for n, p in model.named_parameters()}

                    def plain_step():
                        leaves = list(model.parameters())
                        for p in leaves:
                            p.requires_grad_(True)
                        try:
                            with torch.enable_grad():
                                value = plain_loss()
                                grads = torch.autograd.grad(value, leaves)
                        finally:
                            for (n, p) in model.named_parameters():
                                p.requires_grad_(frozen[n])
                        return ({n: _adam_update(p.detach(), g, MP_LR) for (n, p), g in
                                 zip(model.named_parameters(), grads)}, value.detach())

                    plain_new, plain_value = plain_step()
                    loss_rel = abs(float(loss) - float(plain_value)) / abs(float(plain_value))
                    update_err = max(float((new[n].full_tensor() - plain_new[n]).abs().max()) for n in plain_new)
                    sharded = sum(1 for p in new.values() if "Shard" in str(p.placements))
                    require(loss_rel <= 1e-6 and update_err <= MP_ADAM_REL * MP_LR,
                            f"mp_world1 fsdp {name}: FSDP step = plain Adam step (loss {loss_rel}, "
                            f"updates {update_err} > {MP_ADAM_REL * MP_LR})")
                    fsdp[name] = {"loss_rel": loss_rel, "update_max_abs_err": update_err, "sharded_leaves": sharded}
                    ms[f"fsdp_{name}"] = (host_ms(lambda: step(params, opt, inputs, targets), 3),
                                          host_ms(plain_step, 3))
            record["fsdp"] = fsdp
        finally:
            dist.destroy_process_group()
    overhead = {name: {"sharded_ms": a, "single_ms": b, "ratio": a / b} for name, (a, b) in ms.items()}
    print(f"mp_world1 ({smi}): " + ", ".join(f"{k} {v['ratio']:.3f}x" for k, v in overhead.items()), flush=True)
    emit({"phase": "mp_world1", "card": smi, "backend": backend, "world": 1, "launches": counted,
          **record, "ring_rel": ring_err, "moe_rel": moe_err, "pipeline_rel": pipe_err, "overhead": overhead,
          "bounds": {"ring": MP_RING_REL, "moe": MP_MOE_REL, "pipeline": MP_PIPE_REL, "adam": MP_ADAM_REL * MP_LR},
          "note": "one card: the layer's overhead at world size 1, not scaling"})
    return launches


def _drop_programs() -> None:
    """Forget every cached decode program (their buffers and graphs)."""
    from runia_core_tpu_torch.llm.generate import _PROGRAM_CACHE

    _PROGRAM_CACHE.discard(lambda key: True)


def main() -> None:
    sys.path.insert(0, str(REPO))
    import runia_core_tpu_torch  # noqa: F401  (fails outside a checkout)

    seconds = {}

    def timed(name, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - start
        return out

    smi = device_phase()
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(SEED)
    timed("build", build_phase)
    k1 = timed("kernel_marginal_entropy", entropy_phase, device, gen)
    k2 = timed("kernel_fused_mc_entropy", fused_phase, device, gen)
    k3 = timed("kernel_quant_matmul", quant_matmul_phase, device, gen)
    k4 = timed("kernel_flash_prefix_attention", flash_phase, device, gen)
    k4_window = timed("kernel_flash_window", flash_window_phase, device, gen)
    k_moe = timed("kernel_moe_grouped", moe_grouped_phase, device, gen)
    launches = timed("slice", slice_phase, device, gen)
    flow = timed("image_flow_rn50", image_flow_rn50_phase, device, gen, smi)
    evaluation = timed("eval_rn50", eval_rn50_phase, device, gen, smi)
    dense, int8 = build_llms(device, LLM_CFG["num_layers"], torch.bfloat16)
    models = {"bf16": dense, "int8_kv8": int8}
    launches.update(timed("llm_slice", llm_slice_phase, device, models))
    timed("llm_graph", llm_graph_phase, device, models)
    timed("llm_xcheck_f32_cpu", llm_xcheck_phase, device)
    timed("llm_throughput", llm_throughput_phase, device, models)
    semantic = timed("llm_semantic", llm_semantic_phase, device, models["bf16"])
    speculative = timed("spec_slice", spec_slice_phase, device, models["bf16"])
    mixed = timed("serve_mixed_96", serve_mixed_96_phase, device, models["bf16"])
    timed("serve_check", serve_check_phase, device, models["bf16"])
    spec1b = timed("spec_engine_1b", spec_engine_phase, device, models["bf16"], SPEC1B_ENGINE, "spec_engine_1b", False)
    timed("uncertainty_serving", uncertainty_serving_phase, device, models["bf16"])
    timed("generation_service", generation_service_phase, device, models["bf16"])
    del models, dense, int8
    _drop_programs()
    torch.cuda.empty_cache()
    start = time.perf_counter()
    model7b = build_serve7b(device, SERVE7B_CFG["num_layers"])
    torch.cuda.synchronize()
    model7b_s = time.perf_counter() - start
    serve7b, interactive7b = timed("serve_7b_int8", serve_7b_int8_phase, device, model7b, model7b_s)
    spec7b = timed("spec_engine_7b_int8", spec_engine_phase, device, model7b, SPEC7B_ENGINE, "spec_engine_7b_int8",
                   True)
    fused7b = timed("fused_7b", fused_7b_phase, device, model7b, interactive7b)
    del model7b
    torch.cuda.empty_cache()
    timed("spec_serve_check", spec_serve_check_phase, device)
    timed("nli", nli_phase, device)
    moe = timed("moe_slice", moe_slice_phase, device)
    timed("gpt2_slice", family_slice_phase, device, "gpt2")
    timed("neox_slice", family_slice_phase, device, "neox")
    int8_rn18 = timed("int8_rn18", int8_rn18_phase, device, gen, smi)
    vit_b16 = timed("vit_b16", vit_b16_phase, device, gen, smi)
    train_rn18 = timed("train_rn18", train_rn18_phase, device, gen, smi)
    k_nms = timed("kernel_nms", nms_phase, device, gen)
    k_roi = timed("kernel_roi_align", roi_align_phase, device, gen)
    k_epilogue = timed("kernel_conv_epilogue", conv_epilogue_phase, device, gen)
    objects = timed("object_scorer_rn18", object_scorer_phase, device, gen, smi)
    yolo = timed("yolov8m_flow", yolov8m_flow_phase, device, gen, smi)
    detr, _ = timed("detr_r50_flow", detr_r50_flow_phase, device, gen, smi)
    seg, _ = timed("deeplabv3p_r50_seg", deeplabv3p_r50_seg_phase, device, gen, smi)
    dataset, served = timed("score_dataset_rn18", score_dataset_rn18_phase, device, gen, smi)
    dp_world1 = timed("dp_world1", dp_world1_phase, device, gen, smi, served)
    del served
    torch.cuda.empty_cache()
    mp_world1 = timed("mp_world1", mp_world1_phase, device, gen, smi)
    launches.update(nms=0, roi_align=0, conv_epilogue=0, moe_grouped=0)
    for counts in (flow, evaluation, semantic, speculative, mixed, spec1b, serve7b, spec7b, fused7b, moe, int8_rn18,
                   vit_b16, train_rn18, objects, yolo, detr, seg, dataset, dp_world1, mp_world1):
        for name, n in counts.items():
            if name in launches:
                launches[name] += n
    emit({"phase": "seconds", **seconds})
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
         "launches": launches["flash_prefix_attention"], **k4,
         "window": {"launches": k4_window.pop("window_launches"), **k4_window}},
        {"name": "nms", "route": "cuda", "source": "runia_core_tpu_torch/csrc/nms.cu",
         "replaces": "runia_core_tpu/ops/nms.py:47", "launches": launches["nms"], **k_nms},
        {"name": "roi_align", "route": "cuda", "source": "runia_core_tpu_torch/csrc/roi_align.cu",
         "replaces": "runia_core_tpu/ops/roi_align.py:90", "launches": launches["roi_align"], **k_roi},
        {"name": "conv_epilogue", "route": "cuda", "source": "runia_core_tpu_torch/csrc/conv_epilogue.cu",
         "replaces": "none: XLA fuses the JAX ResNet's norm, residual add and ReLU (runia_core_tpu/models/resnet.py)",
         "launches": launches["conv_epilogue"], **k_epilogue},
        {"name": "moe_grouped", "route": "cuda", "source": "runia_core_tpu_torch/csrc/moe_grouped.cu",
         "replaces": "none: the JAX model runs every expert on every token (runia_core_tpu/models/llama.py:413)",
         "launches": launches["moe_grouped"], **k_moe},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
