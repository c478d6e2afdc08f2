"""Prefetching data loader with a native host-side batch-assembly kernel.

Counterpart of ``runia_core_tpu/data.py``: a background-thread prefetcher
whose hot loop (gathering uint8 images by index into a normalized float32
batch, with an optional BGR->RGB flip, reference runia_core/yolov8.py:41-43,
or a bilinear resize) runs in the multithreaded C++ extension
``csrc/dataloader.cpp``, which releases the GIL, so batch assembly overlaps
GPU compute. The extension is built at first use (``_kernels.dataloader``);
a build that fails raises. The numpy version, equal to it, runs only when a
caller passes ``native=False``.

Batches bound for the GPU are assembled straight into page-locked host
memory and copied with ``non_blocking=True``; PyTorch's caching host
allocator keeps each pinned block out of reuse until its copy has finished.

Usage::

    loader = PrefetchLoader(images_u8, labels, batch_size=512, shuffle=True)
    for images, labels in loader:   # images float32, already on the GPU
        scores = scorer(images, generator)
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from runia_core_tpu_torch import _kernels

__all__ = [
    "PrefetchLoader",
    "gather_normalize",
    "gather_resize_normalize",
]


def gather_normalize(
    images_u8: np.ndarray,
    indices: np.ndarray,
    scale: float = 1.0 / 255.0,
    offset: float = 0.0,
    bgr_to_rgb: bool = False,
    num_threads: int = 4,
    native: bool = True,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(N, H, W, C) uint8 + batch indices -> (B, H, W, C) float32.

    ``native=True`` runs the C++ kernel, which writes into ``out`` (a new
    array if None); ``native=False`` the numpy version (identical results).
    An index out of range raises ``IndexError``.
    """
    images_u8 = np.ascontiguousarray(images_u8)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    batch_shape = (len(indices),) + images_u8.shape[1:]
    if out is None:
        out = np.empty(batch_shape, np.float32)
    if native:
        _kernels.dataloader().gather_normalize(
            images_u8.reshape(images_u8.shape[0], -1),
            indices,
            images_u8.shape[0],
            int(np.prod(images_u8.shape[1:])),
            int(images_u8.shape[-1]),
            float(scale),
            float(offset),
            int(bgr_to_rgb),
            int(num_threads),
            out.reshape(len(indices), -1),
        )
        return out
    batch = images_u8[indices].astype(np.float32) * scale + offset
    if bgr_to_rgb and images_u8.shape[-1] == 3:
        batch = batch[..., ::-1]
    out[...] = batch
    return out


def _resize_bilinear_numpy(images: np.ndarray, h_out: int, w_out: int) -> np.ndarray:
    """Half-pixel bilinear resize of (B, H, W, C) float32: the native
    kernel's semantics (and ``jax.image.resize(method="bilinear")``'s
    without antialiasing)."""
    b, h_in, w_in, c = images.shape
    sy = np.clip((np.arange(h_out) + 0.5) * h_in / h_out - 0.5, 0, h_in - 1)
    sx = np.clip((np.arange(w_out) + 0.5) * w_in / w_out - 0.5, 0, w_in - 1)
    y0 = sy.astype(np.int64)
    x0 = sx.astype(np.int64)
    y1 = np.minimum(y0 + 1, h_in - 1)
    x1 = np.minimum(x0 + 1, w_in - 1)
    fy = (sy - y0).astype(np.float32)[None, :, None, None]
    fx = (sx - x0).astype(np.float32)[None, None, :, None]
    p00 = images[:, y0][:, :, x0]
    p01 = images[:, y0][:, :, x1]
    p10 = images[:, y1][:, :, x0]
    p11 = images[:, y1][:, :, x1]
    top = p00 + fx * (p01 - p00)
    bot = p10 + fx * (p11 - p10)
    return top + fy * (bot - top)


def gather_resize_normalize(
    images_u8: np.ndarray,
    indices: np.ndarray,
    size: Tuple[int, int],
    scale: float = 1.0 / 255.0,
    offset: float = 0.0,
    num_threads: int = 4,
    native: bool = True,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(N, H, W, C) uint8 + indices -> (B, h, w, C) float32, bilinear-resized
    with half-pixel centers and normalized, in one multithreaded
    GIL-releasing C++ pass that writes into ``out`` (a new array if None).
    ``native=False``: the numpy version (the same up to float32 rounding of
    the source coordinates, which numpy computes in float64).
    """
    images_u8 = np.ascontiguousarray(images_u8)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if images_u8.ndim != 4:
        raise ValueError("expect (N, H, W, C) uint8")
    n, h_in, w_in, channels = images_u8.shape
    h_out, w_out = size
    if out is None:
        out = np.empty((len(indices), h_out, w_out, channels), np.float32)
    if native:
        _kernels.dataloader().gather_resize_normalize(
            images_u8.reshape(n, -1),
            indices,
            n,
            h_in,
            w_in,
            channels,
            h_out,
            w_out,
            float(scale),
            float(offset),
            int(num_threads),
            out.reshape(len(indices), -1),
        )
        return out
    batch = images_u8[indices].astype(np.float32)
    out[...] = _resize_bilinear_numpy(batch, h_out, w_out) * scale + offset
    return out


class _DefaultDevice:
    def __repr__(self) -> str:
        return "default_device()"


_DEFAULT_DEVICE = _DefaultDevice()


class PrefetchLoader:
    """Double-buffered batch loader over an in-memory uint8 image bank.

    A background thread assembles the next batch (the native kernel, or
    numpy with ``native=False``) and copies it to ``device`` while the
    current batch is being consumed. ``device`` defaults to the GPU
    (``runia_core_tpu_torch.default_device()``); ``device=None`` keeps the
    batches on the host (page-locked with ``pin_memory=True``, so that a
    later ``.to("cuda", non_blocking=True)`` is asynchronous). The shuffle
    order is ``np.random.RandomState(seed + epoch)``'s, the JAX package's.

    Yields ``(images, labels)``: a float32 (B, H, W, C) tensor and the
    labels' rows (numpy), or None without labels.
    """

    def __init__(
        self,
        images_u8: np.ndarray,
        labels: Optional[np.ndarray] = None,
        batch_size: int = 256,
        shuffle: bool = False,
        seed: int = 0,
        scale: float = 1.0 / 255.0,
        offset: float = 0.0,
        bgr_to_rgb: bool = False,
        num_threads: int = 4,
        device=_DEFAULT_DEVICE,
        drop_remainder: bool = False,
        prefetch_depth: int = 2,
        resize_to: Optional[Tuple[int, int]] = None,
        native: bool = True,
        pin_memory: bool = False,
    ):
        if images_u8.dtype != np.uint8:
            raise ValueError("PrefetchLoader expects uint8 images")
        if resize_to is not None and bgr_to_rgb:
            raise ValueError("resize_to and bgr_to_rgb are mutually exclusive (flip channels in the image bank "
                             "instead)")
        if device is _DEFAULT_DEVICE:
            from runia_core_tpu_torch import default_device

            device = default_device()
        self.images = np.ascontiguousarray(images_u8)
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.scale = scale
        self.offset = offset
        self.bgr_to_rgb = bgr_to_rgb
        self.num_threads = num_threads
        self.device = None if device is None else torch.device(device)
        self.drop_remainder = drop_remainder
        self.prefetch_depth = prefetch_depth
        self.resize_to = resize_to
        self.native = native
        self.pin_memory = pin_memory or (self.device is not None and self.device.type == "cuda")
        self._epoch = 0

    def __len__(self) -> int:
        n = self.images.shape[0]
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        n = self.images.shape[0]
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_remainder else n
        for start in range(0, stop, self.batch_size):
            yield order[start : start + self.batch_size]

    def _assemble(self, idx: np.ndarray) -> torch.Tensor:
        """One batch, gathered straight into a (pinned, where it goes to the
        GPU) host tensor's memory, then sent to ``device``."""
        h, w = self.resize_to if self.resize_to is not None else self.images.shape[1:3]
        host = torch.empty((len(idx), h, w, self.images.shape[3]), dtype=torch.float32,
                           pin_memory=self.pin_memory)
        if self.resize_to is not None:
            gather_resize_normalize(self.images, idx, self.resize_to, self.scale, self.offset, self.num_threads,
                                    self.native, out=host.numpy())
        else:
            gather_normalize(self.images, idx, self.scale, self.offset, self.bgr_to_rgb, self.num_threads,
                             self.native, out=host.numpy())
        if self.device is None:
            return host
        return host.to(self.device, non_blocking=True)

    def __iter__(self) -> Iterator[Tuple]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        sentinel = object()
        error: list = []
        stop = threading.Event()

        def put(item) -> bool:
            # Bounded put that notices consumer abandonment: a consumer that
            # breaks out of the loop sets `stop`, and the producer must not
            # block forever on a full queue (it would pin batches in device
            # memory and leak one thread per early exit).
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idx in self._index_batches():
                    if stop.is_set():
                        return
                    batch = self._assemble(idx)
                    lab = self.labels[idx] if self.labels is not None else None
                    if not put((batch, lab)):
                        return
            except BaseException as exc:  # propagate to the consumer
                error.append(exc)
            finally:
                put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # Runs on normal exhaustion AND on generator close (early break):
            # release the producer, drain queued batches, reap the thread.
            stop.set()
            while not out_q.empty():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
            thread.join()
            if error:
                raise error[0]
            self._epoch += 1
