"""The port's data path (``data.py``, ``csrc/dataloader.cpp``) against the
JAX package's ``runia_core_tpu/data.py``: gathers and resizes equal to the
JAX package's (the native kernels are one source; the numpy versions one
code), the native kernel equal to ``native=False``, the loader's batches,
shuffle order per epoch, errors and thread lifetime."""

import threading

import numpy as np
import pytest
import torch

from runia_core_tpu import data as jax_data
from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.data import (
    PrefetchLoader,
    _resize_bilinear_numpy,
    gather_normalize,
    gather_resize_normalize,
)

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.RandomState(1)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("case", ["plain", "bgr", "scale_offset"])
def test_gather_equals_jaxs_exactly(rng, native, case):
    channels = 1 if case == "scale_offset" else 3
    imgs = rng.randint(0, 256, (100, 16, 16, channels)).astype(np.uint8)
    idx = rng.choice(100, 32, replace=False)
    kw = {"plain": {}, "bgr": {"bgr_to_rgb": True}, "scale_offset": {"scale": 2.0, "offset": -1.0}}[case]
    ours = gather_normalize(imgs, idx, native=native, **kw)
    np.testing.assert_array_equal(ours, jax_data.gather_normalize(imgs, idx, **kw))
    assert ours.dtype == np.float32 and ours.shape == (32, 16, 16, channels)


def test_native_gather_equals_numpy_and_is_thread_count_free(rng):
    imgs = rng.randint(0, 256, (200, 16, 16, 3)).astype(np.uint8)
    idx = rng.choice(200, 64, replace=False)
    one = gather_normalize(imgs, idx, num_threads=1)
    np.testing.assert_array_equal(one, gather_normalize(imgs, idx, num_threads=4))
    np.testing.assert_array_equal(one, gather_normalize(imgs, idx, native=False))


def test_native_gather_writes_the_given_buffer(rng):
    imgs = rng.randint(0, 256, (10, 4, 4, 3)).astype(np.uint8)
    out = torch.empty((3, 4, 4, 3))
    got = gather_normalize(imgs, np.array([2, 0, 9]), out=out.numpy())
    assert np.shares_memory(got, out.numpy())
    np.testing.assert_array_equal(out.numpy(), imgs[[2, 0, 9]].astype(np.float32) * (1.0 / 255.0))


@pytest.mark.parametrize("native", [True, False])
def test_index_out_of_range_raises(rng, native):
    imgs = rng.randint(0, 256, (10, 4, 4, 1)).astype(np.uint8)
    with pytest.raises(IndexError):
        gather_normalize(imgs, np.array([99], np.int64), native=native)


def test_a_native_loader_that_does_not_build_raises(rng, monkeypatch, tmp_path):
    """No compiler, no native path: the call raises instead of quietly
    taking the numpy version."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    _kernels.dataloader.cache_clear()
    try:
        imgs = rng.randint(0, 256, (4, 4, 4, 3)).astype(np.uint8)
        with pytest.raises(RuntimeError, match="building the native data loader failed"):
            gather_normalize(imgs, np.arange(2))
        with pytest.raises(RuntimeError, match="building the native data loader failed"):
            list(PrefetchLoader(imgs, batch_size=2, device="cpu"))
        assert gather_normalize(imgs, np.arange(2), native=False).shape == (2, 4, 4, 3)
    finally:
        _kernels.dataloader.cache_clear()


def test_resize_equals_jaxs_and_native_equals_numpy(rng):
    images = (rng.rand(6, 17, 23, 3) * 255).astype(np.uint8)
    idx = np.array([4, 0, 2], np.int64)
    native = gather_resize_normalize(images, idx, (8, 12))
    np.testing.assert_array_equal(native, jax_data.gather_resize_normalize(images, idx, (8, 12)))
    plain = gather_resize_normalize(images, idx, (8, 12), native=False)
    np.testing.assert_array_equal(plain, _resize_bilinear_numpy(images[idx].astype(np.float32), 8, 12) * (1.0 / 255.0))
    np.testing.assert_array_equal(
        _resize_bilinear_numpy(images[idx].astype(np.float32), 8, 12),
        jax_data._resize_bilinear_numpy(images[idx].astype(np.float32), 8, 12))
    # numpy finds the source coordinates in float64, the kernel in float32 (the JAX test's bound)
    np.testing.assert_allclose(native, plain, rtol=1e-5, atol=1e-5)


def test_identity_resize_is_normalize(rng):
    images = (rng.rand(4, 9, 9, 3) * 255).astype(np.uint8)
    idx = np.arange(4, dtype=np.int64)
    np.testing.assert_allclose(gather_resize_normalize(images, idx, (9, 9)), gather_normalize(images, idx),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("native", [True, False])
def test_loader_batches_equal_jaxs(rng, native):
    imgs = rng.randint(0, 256, (90, 8, 8, 3)).astype(np.uint8)
    labels = np.arange(90)
    ours = list(PrefetchLoader(imgs, labels, batch_size=32, device="cpu", native=native))
    theirs = list(jax_data.PrefetchLoader(imgs, labels, batch_size=32, device_put=False))
    assert len(ours) == len(theirs) == 3 == len(PrefetchLoader(imgs, batch_size=32, device="cpu"))
    assert ours[2][0].shape == (26, 8, 8, 3)  # remainder kept
    for (x, y), (jx, jy) in zip(ours, theirs):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), jx)
        np.testing.assert_array_equal(y, jy)


def test_drop_remainder(rng):
    imgs = rng.randint(0, 256, (90, 8, 8, 3)).astype(np.uint8)
    loader = PrefetchLoader(imgs, batch_size=32, drop_remainder=True, device="cpu")
    assert len(list(loader)) == 2 == len(loader)


def test_shuffle_order_per_epoch_is_jaxs(rng):
    imgs = rng.randint(0, 256, (64, 4, 4, 1)).astype(np.uint8)
    labels = np.arange(64)
    ours = PrefetchLoader(imgs, labels, batch_size=20, shuffle=True, seed=3, device="cpu")
    theirs = jax_data.PrefetchLoader(imgs, labels, batch_size=20, shuffle=True, seed=3, device_put=False)
    epochs = []
    for _ in range(2):
        got = np.concatenate([y for _, y in ours])
        np.testing.assert_array_equal(got, np.concatenate([y for _, y in theirs]))
        epochs.append(got)
    assert not np.array_equal(epochs[0], np.arange(64))
    assert not np.array_equal(epochs[0], epochs[1])  # the epoch is folded into the seed


def test_producer_exception_propagates(rng):
    imgs = rng.randint(0, 256, (16, 4, 4, 1)).astype(np.uint8)
    loader = PrefetchLoader(imgs, batch_size=8, device="cpu")
    loader._index_batches = lambda: (_ for _ in ()).throw(RuntimeError("boom"))
    with pytest.raises(RuntimeError, match="boom"):
        list(loader)


def test_an_early_break_releases_and_reaps_the_producer(rng):
    imgs = rng.randint(0, 256, (64, 4, 4, 1)).astype(np.uint8)
    before = set(threading.enumerate())
    loader = PrefetchLoader(imgs, batch_size=2, prefetch_depth=1, device="cpu")
    it = iter(loader)
    next(it)
    it.close()  # what a consumer's `break` does to the generator
    assert set(threading.enumerate()) == before
    assert len(list(loader)) == 32  # the next epoch runs in full


def test_resize_in_the_loader_keeps_the_ragged_tail(rng):
    images = (rng.rand(10, 16, 16, 3) * 255).astype(np.uint8)
    batches = [b for b, _ in PrefetchLoader(images, batch_size=4, device="cpu", resize_to=(8, 8))]
    assert batches[0].shape == (4, 8, 8, 3) and batches[-1].shape == (2, 8, 8, 3)
    np.testing.assert_array_equal(batches[0].numpy(), gather_resize_normalize(images, np.arange(4), (8, 8)))


def test_loader_refuses_what_jaxs_refuses(rng):
    with pytest.raises(ValueError, match="mutually exclusive"):
        PrefetchLoader((rng.rand(4, 8, 8, 3) * 255).astype(np.uint8), resize_to=(4, 4), bgr_to_rgb=True)
    with pytest.raises(ValueError, match="uint8"):
        PrefetchLoader(rng.rand(4, 8, 8, 3).astype(np.float32))


def test_the_loader_sends_batches_to_the_gpu_by_default(rng):
    """With no ``device`` the batches go to the GPU through pinned memory:
    on a host without one, the first batch raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")
    loader = PrefetchLoader(rng.randint(0, 256, (4, 4, 4, 3)).astype(np.uint8), batch_size=2)
    assert loader.device == torch.device("cuda") and loader.pin_memory
    with pytest.raises((RuntimeError, AssertionError)):
        list(loader)


def test_the_loader_feeds_the_extractor(rng):
    from runia_core_tpu_torch.extraction import FastMCDSamplesExtractor
    from runia_core_tpu_torch.models import SimpleConvNet, build_tapped_forward

    model = SimpleConvNet(num_classes=2, features=4, device="cpu").init_weights(torch.Generator().manual_seed(0))
    imgs = rng.randint(0, 256, (32, 16, 16, 3)).astype(np.uint8)
    extractor = FastMCDSamplesExtractor(
        model=build_tapped_forward(model), layer_type="Conv", reduction_method="fullmean", mcd_nro_samples=4,
        dropblock_probs=0.3, dropblock_sizes=3, generator=torch.Generator().manual_seed(1), device="cpu",
    )
    out = extractor.get_ls_samples(PrefetchLoader(imgs, np.zeros(32), batch_size=16, device="cpu"))
    assert out["latent_space_means"].shape == (32 * 4, 8)
