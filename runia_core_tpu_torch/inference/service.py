"""Pipelined scoring service: the production serving loop.

Counterpart of ``runia_core_tpu/inference/service.py``. The reference scores
one image per ``get_score`` call inside a Python loop (reference
inference/image_level.py:96-120), so its throughput is bounded by Python and
host<->device latency. This service keeps a bounded window of batches in
flight on the GPU: each batch goes up from page-locked memory with
``non_blocking=True``, the scorer is enqueued (a CUDA-graph replay for
``build_larex_scorer``), and its outputs start back into page-locked host
tensors at once, an event recorded behind them. Results are read a few
batches behind submission, each by waiting on its own event, so the host
never waits on the batch it has just enqueued. Host-side batch assembly runs
in the C++ gather kernel of :class:`runia_core_tpu_torch.data.PrefetchLoader`
and overlaps the device's work.

Usage::

    service = ScoringService(scorer, seed=0)
    for logits, scores in service.score_stream(batch_iter):
        ...                                   # host tensors, pipelined

    logits, scores = service.score_dataset(images_u8, batch_size=512)
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from runia_core_tpu_torch.utils.health import NonFiniteError, find_nonfinite
from runia_core_tpu_torch.utils.tree import tree_map

__all__ = ["ScoringService"]


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """A copy of a GPU tensor started into page-locked host memory
    (``copy_to_host_async``'s counterpart); a CPU tensor as it is."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class ScoringService:
    """Stream batches through a scorer with a bounded in-flight window.

    Args:
        scorer: ``(images, generator) -> outputs`` on ``device``: typically
            ``(logits, scores)`` from
            :func:`runia_core_tpu_torch.inference.build_larex_scorer`, but
            any nested tuple / list / dict of tensors streams through.
        seed: base seed; batch ``i`` draws from :meth:`generator_for(i)
            <generator_for>`, the JAX package's ``fold_in(key, i)``.
        max_in_flight: how many batches may be enqueued before the oldest
            result is read. Memory cost is one output structure per slot on
            the device and one in page-locked host memory.
        check_finite: validate every fetched result and raise
            :class:`runia_core_tpu_torch.utils.NonFiniteError` (naming the
            batch) on NaN/inf: a silent NaN score compares false against any
            OoD threshold and would pass as in-distribution.
        device: where the scorer runs and the batches go (None: the GPU,
            ``runia_core_tpu_torch.default_device()``).
    """

    def __init__(
        self,
        scorer: Callable,
        seed: int = 0,
        max_in_flight: int = 8,
        check_finite: bool = False,
        device=None,
    ):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        from runia_core_tpu_torch import default_device

        self.scorer = scorer
        self.seed = seed
        self.max_in_flight = max_in_flight
        self.check_finite = check_finite
        self.device = default_device() if device is None else torch.device(device)
        self._batch_idx = 0

    def generator_for(self, batch_idx: int) -> torch.Generator:
        """Batch ``batch_idx``'s generator on the service's device, seeded
        with the first 64-bit word of ``numpy.random.SeedSequence((seed,
        batch_idx))``: distinct, reproducible streams per batch whatever the
        batch size or window."""
        word = np.random.SeedSequence((self.seed, batch_idx)).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(word))

    def _submit(self, images) -> Tuple[Any, Optional[torch.cuda.Event]]:
        generator = self.generator_for(self._batch_idx)
        self._batch_idx += 1
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        out = self.scorer(images.to(self.device, non_blocking=True), generator)
        # Start the device->host copies now, so that they overlap the
        # compute of the batches behind them in the window.
        host = tree_map(_to_host_async, out)
        if self.device.type != "cuda":
            return host, None
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _fetch(self, submitted, batch_idx: int):
        host, done = submitted
        if done is not None:
            done.synchronize()
        if self.check_finite:
            bad = find_nonfinite(host)
            if bad:
                raise NonFiniteError(f"batch {batch_idx}: non-finite in {bad}")
        return host

    def score_stream(self, batches: Iterable[Any]) -> Iterator[Any]:
        """Yield one output structure of host tensors per input batch, in
        order (for the LaREx scorer: (logits, scores) pairs).

        ``batches`` yields image tensors or arrays (or (images, *rest)
        tuples; the extras are ignored). Results come out
        ``max_in_flight`` batches behind submission; the final drain
        flushes the window.
        """
        window: deque = deque()
        fetched = 0
        for batch in batches:
            images = batch[0] if isinstance(batch, tuple) else batch
            window.append(self._submit(images))
            if len(window) > self.max_in_flight:
                yield self._fetch(window.popleft(), fetched)
                fetched += 1
        while window:
            yield self._fetch(window.popleft(), fetched)
            fetched += 1

    def score_dataset(
        self,
        images_u8: np.ndarray,
        batch_size: int,
        scale: float = 1.0 / 255.0,
        offset: float = 0.0,
        resize_to: Optional[Tuple[int, int]] = None,
        native: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Score a whole uint8 dataset; returns host tensors (logits (N, C),
        scores (N,)).

        Batch assembly runs in the prefetching loader (the C++ kernel, or
        numpy with ``native=False``), into page-locked host memory when the
        service runs on the GPU; ``resize_to=(h, w)`` bilinear-resizes to
        the model's input size in the same host pass. A short final batch is
        padded with zero images up to ``batch_size`` on the host, so the
        scorer's CUDA graph for that shape is reused, and the padding rows
        are dropped from the output.
        """
        from runia_core_tpu_torch.data import PrefetchLoader

        n = images_u8.shape[0]
        pin = self.device.type == "cuda"
        loader = PrefetchLoader(
            images_u8,
            batch_size=batch_size,
            shuffle=False,
            drop_remainder=False,
            scale=scale,
            offset=offset,
            device=None,  # the tail batch is padded on the host first
            resize_to=resize_to,
            native=native,
            pin_memory=pin,
        )

        def padded():
            for images, _ in loader:
                if images.shape[0] < batch_size:
                    full = torch.zeros((batch_size,) + tuple(images.shape[1:]), dtype=images.dtype, pin_memory=pin)
                    full[: images.shape[0]] = images
                    images = full
                yield images

        logits_parts, score_parts = [], []
        for logits, scores in self.score_stream(padded()):
            logits_parts.append(logits)
            score_parts.append(scores)
        return torch.cat(logits_parts)[:n], torch.cat(score_parts)[:n]
