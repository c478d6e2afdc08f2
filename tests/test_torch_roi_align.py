"""The port's ROIAlign (``runia_core_tpu_torch/ops/roi_align.py``, the plain
version on the CPU) against the JAX package's ``roi_align`` and the numpy
transcription of torchvision in tests/test_roi_align_nms.py.

Tolerances: f32 within 1e-5 of max |feature| (the two contractions sum in
other orders than JAX's and the numpy loop). bf16 within BF16_REL of max
|feature| against JAX's bf16 form: both round the weights and the
intermediate to bf16 and sum in f32, so a result can differ by one bf16
step (2^-8 relative) where the f32 sums round to either side.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from runia_core_tpu.ops.roi_align import roi_align as jax_roi_align
from runia_core_tpu_torch.ops.roi_align import roi_align, roi_align_nhwc, roi_align_nhwc_plain
from test_roi_align_nms import np_roi_align

torch.set_num_threads(1)

F32_REL = 1e-5
BF16_REL = 2**-7


def _check(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


BOXES = np.array([
    [8.0, 8.0, 40.0, 48.0],
    [0.0, 0.0, 96.0, 80.0],  # the whole image
    [30.5, 20.25, 70.75, 60.5],
    [5.0, 5.0, 12.0, 11.0],  # small
    [-20.0, -10.0, 30.0, 20.0],  # partly outside
    [90.0, 70.0, 140.0, 130.0],  # mostly outside
], np.float32)


@pytest.mark.parametrize("out", [7, (3, 5)])
def test_matches_jax_and_torchvision_transcription(out):
    fmap = np.random.RandomState(0).rand(3, 10, 12).astype(np.float32)
    scale = 12 / 96
    got = roi_align(torch.from_numpy(fmap), torch.from_numpy(BOXES), out, scale).numpy()
    _check(got, jax_roi_align(jnp.asarray(fmap), jnp.asarray(BOXES), out, scale), F32_REL)
    if isinstance(out, int):
        _check(got, np_roi_align(fmap, BOXES, out, scale), F32_REL)


def test_bf16_map_matches_jax():
    rng = np.random.RandomState(1)
    fmap = rng.rand(8, 16, 16).astype(np.float32)
    boxes = np.array([[200.3, 100.7, 231.9, 140.2], [13.6, 7.1, 57.8, 44.4]], np.float32)
    got = roi_align(torch.from_numpy(fmap).to(torch.bfloat16), torch.from_numpy(boxes), 7, 16 / 256)
    assert got.dtype == torch.bfloat16
    want = jax_roi_align(jnp.asarray(fmap, jnp.bfloat16), jnp.asarray(boxes), 7, 16 / 256).astype(jnp.float32)
    _check(got.float().numpy(), want, BF16_REL)
    # and within JAX's own bar of the f32 result
    f32 = roi_align(torch.from_numpy(fmap), torch.from_numpy(boxes), 7, 16 / 256).numpy()
    np.testing.assert_allclose(got.float().numpy(), f32, rtol=2e-2, atol=2e-2)


def test_fixed_sampling_ratio():
    fmap = np.random.RandomState(2).rand(2, 8, 8).astype(np.float32)
    boxes = np.array([[1.0, 1.0, 6.0, 7.0]], np.float32)
    got = roi_align(torch.from_numpy(fmap), torch.from_numpy(boxes), 3, 1.0, 2, True).numpy()
    _check(got, np_roi_align(fmap, boxes, 3, 1.0, sampling_ratio=2), F32_REL)
    _check(got, jax_roi_align(jnp.asarray(fmap), jnp.asarray(boxes), 3, 1.0, 2, True), F32_REL)


def test_unaligned():
    fmap = np.random.RandomState(3).rand(2, 8, 8).astype(np.float32)
    boxes = np.array([[1.0, 2.0, 5.0, 6.0], [3.0, 3.0, 3.2, 3.1]], np.float32)
    got = roi_align(torch.from_numpy(fmap), torch.from_numpy(boxes), 4, 1.0, -1, False).numpy()
    _check(got, np_roi_align(fmap, boxes, 4, 1.0, aligned=False), F32_REL)
    _check(got, jax_roi_align(jnp.asarray(fmap), jnp.asarray(boxes), 4, 1.0, -1, False), F32_REL)


def test_batch1_input_and_degenerate_box():
    fmap = np.random.RandomState(4).rand(1, 2, 8, 8).astype(np.float32) + 1.0
    boxes = np.array([[1.0, 1.0, 6.0, 6.0], [3.0, 3.0, 3.0, 3.0], [5.0, 5.0, 2.0, 2.0]], np.float32)
    got = roi_align(torch.from_numpy(fmap), torch.from_numpy(boxes), 2, 1.0)
    assert got.shape == (3, 2, 2, 2)
    assert (got[1:] == 0).all()  # zero-area and inverted boxes pool nothing
    _check(got.numpy(), jax_roi_align(jnp.asarray(fmap), jnp.asarray(boxes), 2, 1.0), F32_REL)


def test_the_max_samples_cap_gives_jaxs_answer_not_torchvisions():
    """A 200-px box on a 256-px map at out 7: ceil(bin) is 29, capped at 16."""
    fmap = np.random.RandomState(5).rand(3, 64, 64).astype(np.float32)
    boxes = np.array([[10.0, 20.0, 210.0, 230.0]], np.float32)
    scale = 64 / 256 * 4  # the map seen at image scale: bins of 28.6 px
    got = roi_align(torch.from_numpy(fmap), torch.from_numpy(boxes), 7, scale).numpy()
    _check(got, jax_roi_align(jnp.asarray(fmap), jnp.asarray(boxes), 7, scale), F32_REL)
    uncapped = np_roi_align(fmap, boxes, 7, scale)
    assert np.abs(got - uncapped).max() > 1e-4  # torchvision samples 29 x 29 a bin
    _check(got, jax_roi_align(jnp.asarray(fmap), jnp.asarray(boxes), 7, scale, max_samples=16), F32_REL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_nhwc_and_mean_mode(dtype):
    """roi_align_nhwc over a batch = roi_align per image; the mean mode =
    the pooled mode's mean over the bins."""
    rng = np.random.RandomState(6)
    fmap = torch.from_numpy(rng.rand(3, 10, 15, 8).astype(np.float32)).to(dtype)  # (B, H, W, C)
    xy = rng.rand(3 * 4, 2) * 60
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.rand(12, 2) * 30 + 2], 1).astype(np.float32))
    pooled = roi_align_nhwc(fmap, boxes, 7, 15 / 96)
    for i in range(3):
        per_image = roi_align(fmap[i].permute(2, 0, 1), boxes[4 * i: 4 * i + 4], 7, 15 / 96)
        torch.testing.assert_close(pooled[4 * i: 4 * i + 4], per_image, rtol=0, atol=0)
    means = roi_align_nhwc(fmap, boxes, 7, 15 / 96, mean=True)
    assert means.shape == (12, 8) and means.dtype == dtype
    torch.testing.assert_close(means, pooled.float().mean(dim=(2, 3)).to(dtype), rtol=0, atol=0)
    want = roi_align_nhwc_plain(fmap.float(), boxes, 7, 15 / 96, mean=True)
    tol = F32_REL if dtype == torch.float32 else 3 * BF16_REL
    _check(means.float().numpy(), want.numpy(), tol)


def _covered(plan, c):
    """How many times each channel is read by the plan's (tile, vector)
    threads, as the kernel's ``j * V < tile_c`` test admits them."""
    counts = np.zeros(c, np.int64)
    for t in range(plan.tiles):
        c0 = t * plan.tile * plan.width
        tile_c = min(c - c0, plan.tile * plan.width)
        for j in range(plan.tile):
            if j * plan.width < tile_c:
                counts[c0 + j * plan.width: c0 + min((j + 1) * plan.width, tile_c)] += 1
    return counts


@pytest.mark.parametrize("c", [3, 100, 192, 512, 2048])
@pytest.mark.parametrize("hw", [(1, 1), (8, 8), (20, 20), (25, 38), (80, 80)])
@pytest.mark.parametrize("mean", [False, True], ids=["pooled", "mean"])
def test_launch_plan_covers_every_channel_once_within_the_block_limits(c, hw, mean):
    """_plan at the object scorer's, YOLOv8m's and DETR's shapes and edges:
    every channel read by exactly one thread, at most 227 KB of shared
    memory and 512 threads a block, the groups within the rows or bins,
    the tiles equal (less than one vector idle a tile)."""
    from runia_core_tpu_torch.ops.roi_align import _MAX_SMEM, _plan

    h, w = hw
    for k in (1, 100, 300, 2560):
        for elem in (4, 2):
            for out in ((7, 7), (3, 5), (14, 14)):
                for vec in (False, True):
                    if vec and c % (16 // elem):
                        continue
                    plan = _plan(k, c, h, w, *out, elem, mean, vec)
                    assert plan.width == (16 // elem if vec else 1)
                    np.testing.assert_array_equal(_covered(plan, c), 1)
                    vectors = -(-c // plan.width)
                    assert plan.tile * plan.tiles - vectors < plan.tiles
                    assert plan.threads % 32 == 0 and plan.tile * plan.groups <= plan.threads <= 512
                    assert 1 <= plan.groups <= (max(1, min(h * w // 64, 32)) if mean else out[0] * out[1])
                    weights = 4 * (out[0] * h + out[1] * w + h + w + 2 * (out[0] + out[1]))
                    scratch = 4 * plan.groups * plan.tile * plan.width if mean else (
                        elem * plan.tile * plan.width * out[0] * out[1])
                    assert plan.smem == weights + scratch <= _MAX_SMEM


def test_launch_plan_fills_the_card_at_the_main_paths_shapes():
    """The grids of the timed shapes: each at least two blocks an SM of the
    H100's 132, the last tile more than half full (C = 192's tiles full:
    YOLOv8m's p3), DETR's 2,048 channels in 16 tiles of 32 vectors when
    pooled."""
    from runia_core_tpu_torch.ops.roi_align import _plan

    shapes = {  # (K, C, H, W, elem, mean)
        "object_scorer_bf16_mean": (2560, 512, 8, 8, 2, True), "yolov8m_p5_mean": (300, 576, 20, 20, 4, True),
        "yolov8m_p5_pooled": (300, 576, 20, 20, 4, False), "yolov8m_p3_mean": (300, 192, 80, 80, 4, True),
        "detr_mean": (100, 2048, 25, 38, 4, True), "detr_pooled": (100, 2048, 25, 38, 4, False),
    }
    for name, (k, c, h, w, elem, mean) in shapes.items():
        plan = _plan(k, c, h, w, 7, 7, elem, mean, True)
        assert k * plan.tiles >= 264, name
        assert 2 * (c // plan.width - (plan.tiles - 1) * plan.tile) > plan.tile, (name, plan)
    assert _plan(300, 192, 80, 80, 7, 7, 4, True, True)[1:4] == (16, 3, 32)
    assert _plan(2560, 512, 8, 8, 7, 7, 2, True, True)[1:5] == (64, 1, 1, 64)
    assert _plan(100, 2048, 25, 38, 7, 7, 4, False, True)[1:4] == (32, 16, 8)
