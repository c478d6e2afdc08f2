"""Failure detection for production serving.

Counterpart of ``runia_core_tpu/utils/health.py``. These utilities make
failure modes explicit:

- :func:`device_healthcheck`: prove a device can still execute and
  round-trip within a deadline (a wedged driver otherwise blocks the first
  caller forever).
- :func:`guard_finite`: wrap a scorer so non-finite outputs raise
  :class:`NonFiniteError` naming the offending output instead of flowing
  into thresholds (NaN compares false against any threshold, which silently
  marks every sample in-distribution).
- :func:`find_nonfinite`: locate NaN/inf leaves in a nested structure of
  tensors (fitted detector states, gradients, scorer outputs) for
  diagnostics, keyed as ``jax.tree_util.keystr`` keys the same structure.
- :func:`with_retries`: exponential-backoff retry for transient device
  errors around a serving call.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Any, Callable, Dict, Optional, Tuple, Type

import numpy as np
import torch

from runia_core_tpu_torch.utils.tree import tree_leaves_with_path

__all__ = [
    "HealthCheckError",
    "NonFiniteError",
    "device_healthcheck",
    "guard_finite",
    "find_nonfinite",
    "with_retries",
]


class HealthCheckError(RuntimeError):
    """A device failed to execute the probe within the deadline."""


class NonFiniteError(ValueError):
    """A guarded function produced NaN/inf outputs."""


def device_healthcheck(device=None, timeout_s: float = 300.0, size: int = 128) -> float:
    """Run a tiny matmul probe, ``(2 I) @ (2 I)``, on ``device`` (None: the
    GPU, ``runia_core_tpu_torch.default_device()``) and validate its sum.

    Returns the *steady-state* round-trip latency in seconds: the probe runs
    twice, and the first run pays the context's start and the library's
    first call. Raises :class:`HealthCheckError` if the probe does not
    complete in ``timeout_s`` (a wedged device) or returns a wrong sum
    (corrupted state).
    """
    from runia_core_tpu_torch import default_device

    device = default_device() if device is None else torch.device(device)

    def probe():
        x = torch.eye(size, dtype=torch.float32, device=device) * 2.0
        float((x @ x).sum())  # first use of the device and the library, first round trip
        start = time.perf_counter()
        y = float((x @ x).sum())
        return y, time.perf_counter() - start

    # No `with` block: leaving it would shutdown(wait=True) and join a
    # worker still blocked inside a wedged driver, so the healthcheck would
    # hang on the very failure it exists to detect. The stuck thread is
    # abandoned instead (wait=False).
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(probe)
    try:
        result, latency = future.result(timeout=timeout_s)
    except concurrent.futures.TimeoutError as exc:
        pool.shutdown(wait=False)
        raise HealthCheckError(f"device {device} did not answer the probe within {timeout_s}s") from exc
    pool.shutdown(wait=False)
    expected = 4.0 * size
    if abs(result - expected) > 1e-3 * expected:
        raise HealthCheckError(f"device {device} probe returned {result}, expected {expected}")
    return latency


def _floating(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


def find_nonfinite(tree: Any) -> Dict[str, int]:
    """Map of leaf path -> count of non-finite elements (only paths with at
    least one). Tensors are counted where they lie; integer and boolean
    leaves are skipped."""
    bad = {}
    for path, leaf in tree_leaves_with_path(tree):
        if not _floating(leaf):
            continue
        if isinstance(leaf, torch.Tensor):
            n = int((~torch.isfinite(leaf)).sum())
        else:
            n = int((~np.isfinite(np.asarray(leaf))).sum())
        if n:
            bad[path] = n
    return bad


def guard_finite(fn: Callable, name: str = "output") -> Callable:
    """Wrap ``fn`` so any non-finite value in its outputs raises
    :class:`NonFiniteError` (with per-output counts) instead of propagating.

    One ``isfinite().all()`` flag per floating tensor leaf is computed where
    the leaf lies; the flags are stacked on the first leaf's device and read
    with one host copy, so the guard costs one sync per call, not one per
    output."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        leaves = [leaf for _, leaf in tree_leaves_with_path(out) if _floating(leaf)]
        tensors = [leaf for leaf in leaves if isinstance(leaf, torch.Tensor)]
        finite = all(np.isfinite(np.asarray(leaf)).all() for leaf in leaves if not isinstance(leaf, torch.Tensor))
        if tensors:
            flags = torch.stack([torch.isfinite(t).all().to(tensors[0].device) for t in tensors])
            finite = finite and bool(flags.all())
        if not finite:
            raise NonFiniteError(f"{name}: non-finite values in {find_nonfinite(out)}")
        return out

    return wrapped


def with_retries(
    fn: Callable,
    retries: int = 2,
    backoff_s: float = 0.5,
    retry_on: Tuple[Type[BaseException], ...] = (torch.AcceleratorError,),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> Callable:
    """Retry ``fn`` on transient device errors with exponential backoff.

    ``retry_on`` defaults to ``torch.AcceleratorError``, the error a failed
    CUDA call raises (the JAX package's ``JaxRuntimeError``).
    ``NonFiniteError`` and other semantic failures are never retried:
    retrying a deterministic program on the same inputs cannot fix them.
    """

    def wrapped(*args, **kwargs):
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except NonFiniteError:
                raise
            except retry_on as exc:
                if attempt >= retries:
                    raise
                if on_retry is not None:
                    on_retry(attempt, exc)
                time.sleep(backoff_s * (2 ** attempt))
                attempt += 1

    return wrapped
