"""The port's NMS (``runia_core_tpu_torch/ops/nms.py``) against the JAX
package's, on the CPU (the plain version; the kernel is held to it on the
card in test_torch_cuda_kernels.py).

Tolerances: keep masks, orders and kept index lists are compared for
equality. IoUs are held to rtol 1e-6: XLA may rearrange the formula's f32
arithmetic inside a jitted caller and differ from the plain version in the
last bit; a pair that sits exactly on the threshold is then decided by the
port's own f32 arithmetic, which the kernel repeats bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from runia_core_tpu.ops import nms as jax_nms
from runia_core_tpu_torch.ops.nms import (
    batched_class_nms_mask,
    nms_indices,
    nms_keep_plain,
    nms_mask,
    pairwise_iou,
)
from test_roi_align_nms import np_nms

torch.set_num_threads(1)


def _boxes(rng, n, size=640.0, lo=8.0, hi=200.0):
    xy = rng.rand(n, 2) * size
    wh = rng.rand(n, 2) * (hi - lo) + lo
    return np.concatenate([xy, xy + wh], 1).astype(np.float32), rng.rand(n).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_pairwise_iou_matches_jax():
    boxes, _ = _boxes(np.random.RandomState(0), 300)
    want = np.asarray(jax_nms.pairwise_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    got = pairwise_iou(_t(boxes), _t(boxes)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("n", [50, 700])
def test_nms_mask_equals_jax(n, thr):
    boxes, scores = _boxes(np.random.RandomState(n), n)
    want_order, want_keep = jax_nms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thr)
    order, keep = nms_mask(_t(boxes), _t(scores), thr)
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    np.testing.assert_array_equal(nms_indices(_t(boxes), _t(scores), thr),
                                  jax_nms.nms_indices(boxes, scores, thr))


@pytest.mark.parametrize("thr", [0.1, 0.5, 0.9])
def test_nms_indices_equal_numpy_greedy(thr):
    rng = np.random.RandomState(3)
    xy = rng.rand(40, 2) * 50
    boxes = np.concatenate([xy, xy + rng.rand(40, 2) * 30 + 2], 1).astype(np.float32)
    scores = rng.rand(40).astype(np.float32)
    np.testing.assert_array_equal(nms_indices(_t(boxes), _t(scores), thr), np_nms(boxes, scores, thr))


def test_score_ties_keep_jaxs_order():
    scores = np.array([0.5, 0.7, 0.5, 0.7, 0.1], np.float32)
    boxes = np.array([[i * 20.0, 0, i * 20.0 + 10, 10] for i in range(5)], np.float32)
    order, _ = nms_mask(_t(boxes), _t(scores), 0.5)
    assert order.tolist() == [1, 3, 0, 2, 4]
    np.testing.assert_array_equal(order.numpy(), np.asarray(jax_nms.nms_mask(jnp.asarray(boxes),
                                                                             jnp.asarray(scores), 0.5)[0]))


def test_empty_and_single_box():
    out = nms_indices(torch.zeros((0, 4)), torch.zeros(0), 0.5)
    assert out.shape == (0,) and out.dtype == np.int64
    np.testing.assert_array_equal(nms_indices(torch.tensor([[0.0, 0, 5, 5]]), torch.tensor([0.7]), 0.5), [0])


def test_identical_boxes_keep_the_best():
    n = 64
    boxes = np.tile(np.array([[0, 0, 10, 10]], np.float32), (n, 1))
    scores = np.linspace(0.1, 0.9, n).astype(np.float32)
    got = nms_indices(_t(boxes), _t(scores), 0.5)
    np.testing.assert_array_equal(got, [n - 1])
    np.testing.assert_array_equal(got, jax_nms.nms_indices(boxes, scores, 0.5))


def test_alternating_chain():
    n = 32
    boxes = np.stack([np.arange(n) * 6.0, np.zeros(n), np.arange(n) * 6.0 + 10, np.full(n, 10.0)],
                     axis=1).astype(np.float32)  # IoU(i, i + 1) = 0.25
    scores = np.linspace(0.9, 0.1, n).astype(np.float32)
    got = nms_indices(_t(boxes), _t(scores), 0.2)
    np.testing.assert_array_equal(got, np.arange(0, n, 2))
    np.testing.assert_array_equal(got, jax_nms.nms_indices(boxes, scores, 0.2))


def test_max_det():
    boxes, scores = _boxes(np.random.RandomState(4), 40, size=50, lo=2, hi=32)
    got = nms_indices(_t(boxes), _t(scores), 0.99, max_det=3)
    np.testing.assert_array_equal(got, jax_nms.nms_indices(boxes, scores, 0.99, max_det=3))
    assert len(got) == 3


def test_class_offsets_equal_jax():
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 10]], np.float32)
    scores = np.array([0.9, 0.8], np.float32)
    for classes in (np.array([0, 1]), np.array([0, 0])):
        order, keep = batched_class_nms_mask(_t(boxes), _t(scores), _t(classes), 0.5)
        want_order, want_keep = jax_nms.batched_class_nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                                                 jnp.asarray(classes), 0.5)
        np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    assert int(keep.sum()) == 1


def test_zero_area_boxes_suppress_nothing():
    boxes = torch.tensor([[5.0, 5.0, 5.0, 9.0]]).repeat(6, 1)
    assert bool(nms_keep_plain(boxes, 0.0).all())


def test_arrays_go_to_the_requested_device():
    boxes, scores = _boxes(np.random.RandomState(5), 20)
    np.testing.assert_array_equal(nms_indices(boxes, scores, 0.5, device="cpu"),
                                  jax_nms.nms_indices(boxes, scores, 0.5))


def _check_scan_plan(n):
    from runia_core_tpu_torch.ops.nms import _scan_plan

    col_blocks, threads, smem = _scan_plan(n)
    assert col_blocks * 64 >= n > (col_blocks - 1) * 64
    assert threads % 32 == 0 and 32 <= threads <= 1024
    warps = threads // 32
    or_threads = 32 * (warps - -(-warps // 4))  # warps off warp 0's scheduler (warp % 4 != 0)
    assert or_threads > 0 or col_blocks == 1  # a column block beyond the first needs OR warps
    # OR threads: 8 a later word and two warps for each of four groups, or the 768 of a full block
    assert or_threads >= min(768, max(8 * (col_blocks - 1), 256)) or col_blocks == 1
    assert smem == 16 * col_blocks  # the removed and kept words
    static = 3 * 3 * 64 * 8 + 4 * 4 + 4 * 64 + 4 * 4 + 4  # staged blocks, kept lists, counts
    assert smem + static <= 48 * 1024


@pytest.mark.parametrize("n", [1, 63, 64, 65, 8400, 30000, 65536])
def test_scan_plan_at_the_edges(n):
    """The NMS scan's launch (one deciding warp, OR warps, a removed word a
    column block) at ragged 64-box edges, YOLOv8's 8,400 anchors and the
    kernel's largest N."""
    _check_scan_plan(n)


def test_scan_plan_fits_every_n():
    """Every N the kernel takes gets a launch within one block's 1,024
    threads and the 48 KB of shared memory a launch gets without opting
    in."""
    from runia_core_tpu_torch.ops.nms import MAX_NMS_BOXES

    for n in range(1, MAX_NMS_BOXES + 1):
        _check_scan_plan(n)
