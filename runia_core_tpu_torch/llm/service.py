"""Dynamic request batching for LLM generation: a serving loop.

Counterpart of ``runia_core_tpu/llm/service.py``. Callers submit single
prompts and get futures; one worker thread coalesces the waiting requests
into batches (up to ``max_batch``, waiting at most ``max_wait_s`` for
stragglers) and decodes each batch with one ``TorchGenerator.generate_batch``
call, padded to ``max_batch`` rows and a multiple of ``length_bucket``
prompt tokens, so steady traffic reuses a few decode programs.

The worker does all of the device work: the submitting threads only touch
the queue and their futures. On a GPU the worker captures and replays the
generator's CUDA graphs; ``utils.graphs.CudaGraph`` captures in the
thread-local error mode, so CUDA work on another thread cannot break a
capture in flight.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Sequence

import numpy as np

__all__ = ["GenerationService"]


class GenerationService:
    """Batches concurrent generation requests through one ``TorchGenerator``.

    Usage::

        service = GenerationService(generator, max_batch=32)
        futures = [service.submit(ids) for ids in prompts]
        results = [f.result() for f in futures]   # per-request dicts
        service.close()

    Each result carries ``sequences`` (1, P+T), ``log_probs`` (T,) and
    ``prompt_length``. The decoding parameters (sampling, temperature,
    top-k / top-p, the generator's token budget) are the service's, not a
    request's: one program per (batch, prompt-length bucket) serves all.
    Sampled draws come from the generator's own ``torch.Generator``.
    """

    def __init__(
        self,
        generator,
        max_batch: int = 32,
        max_wait_s: float = 0.01,
        do_sample: bool = False,
        temperature: float = 1.0,
        length_bucket: int = 16,
        top_k: int = 0,
        top_p: float = 1.0,
    ):
        self.generator = generator
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.do_sample = do_sample
        self.temperature = temperature
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        # The longest prompt is padded up to a multiple of this: fewer
        # distinct shapes, fewer programs. The left-pad mask keeps the extra
        # slots inert.
        self.length_bucket = max(1, int(length_bucket))
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, prompt_tokens: Sequence[int]) -> "Future[Dict[str, Any]]":
        """Enqueue one prompt; returns a future resolving to its result."""
        if self._closed:
            raise RuntimeError("GenerationService is closed")
        future: Future = Future()
        self._queue.put((list(prompt_tokens), future))
        return future

    def _collect(self):
        """Block for the first request, then take stragglers for at most
        ``max_wait_s``. [] after an idle 0.1 s, None at shutdown."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        if first is None:
            return None
        batch = [first]
        t_end = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = t_end - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # the shutdown signal again, for the next _collect
                break
            batch.append(item)
        return batch

    def _run(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            if not batch:
                if self._closed:
                    return
                continue
            prompts = [p for p, _ in batch]
            futures = [f for _, f in batch]
            try:
                longest = max(len(p) for p in prompts)
                pad_to = -(-longest // self.length_bucket) * self.length_bucket
                # The batch axis is filled too, with copies of the first
                # prompt whose rows are dropped: (max_batch, bucket) is the
                # only shape whatever the traffic.
                filled = prompts + [prompts[0]] * (self.max_batch - len(prompts))
                out = self.generator.generate_batch(
                    filled, do_sample=self.do_sample, temperature=self.temperature, top_k=self.top_k,
                    top_p=self.top_p, output_scores=False, pad_to=pad_to,
                )
                for i, future in enumerate(futures):
                    p_len = len(prompts[i])
                    seq = np.asarray(out["sequences"][i])
                    # Left padding: keep this request's own tokens.
                    start = seq.shape[0] - (p_len + self.generator.max_new_tokens)
                    future.set_result({
                        "sequences": seq[None, start:],
                        "log_probs": np.asarray(out["log_probs"][i]),
                        "prompt_length": p_len,
                    })
            except BaseException as exc:  # every request of the batch gets the error
                for future in futures:
                    if not future.done():
                        future.set_exception(exc)

    def close(self) -> None:
        """Finish the outstanding requests, then stop the worker."""
        if not self._closed:
            self._closed = True
            self._queue.put(None)
            self._worker.join()
