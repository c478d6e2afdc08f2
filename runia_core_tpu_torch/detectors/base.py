"""Postprocessor base classes, registry and thresholds, in PyTorch.

Counterpart of ``runia_core_tpu/detectors/base.py``: every registered class
is constructible as ``cls(cfg=cfg)``, and the fitted state is an explicit
dict of tensors (``state``) that ``load_state`` restores.
"""

from __future__ import annotations

import time
import warnings
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "OodPostprocessor",
    "Postprocessor",
    "get_method_threshold",
    "postprocessor_input_dict",
    "postprocessors_dict",
    "record_time",
    "register_postprocessor",
]

_VALID_INPUT_TYPES = ("latent_space_means", "features", "logits")
postprocessors_dict: Dict[str, type] = {}
postprocessor_input_dict: Dict[str, List[str]] = {}


def register_postprocessor(postprocessor_name, postprocessor_input: List[str]):
    """Class decorator registering a postprocessor under one or more names."""
    names = [postprocessor_name] if isinstance(postprocessor_name, str) else list(postprocessor_name)
    for input_type in postprocessor_input:
        if input_type not in _VALID_INPUT_TYPES:
            raise ValueError(f"Invalid input type {input_type}. Specify one of {_VALID_INPUT_TYPES}.")

    def decorator(cls):
        for name in names:
            postprocessors_dict[name] = cls
            postprocessor_input_dict[name] = list(postprocessor_input)
        return cls

    return decorator


def record_time(function: Callable) -> Callable:
    """Decorator returning ``(result, seconds)``.

    GPU work is asynchronous, so the clock is read after
    ``torch.cuda.synchronize()`` when CUDA has been used in this process.
    """

    def wrapper(*args, **kwargs):
        start = time.monotonic()
        result = function(*args, **kwargs)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return result, time.monotonic() - start

    return wrapper


class Postprocessor(ABC):
    """Base class for post-hoc OoD scoring: ``setup`` fits on InD data,
    ``postprocess`` scores new data."""

    def __init__(self, cfg=None):
        self._setup_flag = False
        self._state: Dict[str, Any] = {}

    @property
    def state(self) -> Dict[str, Any]:
        """Fitted detector state (tensors and scalars)."""
        return self._state

    def load_state(self, state: Dict[str, Any]) -> None:
        """Restore a previously fitted state."""
        self._state = dict(state)
        self._setup_flag = True
        self._rehydrate()

    def _rehydrate(self) -> None:
        """Rebuild attributes from :attr:`state`; by default every entry
        becomes an attribute."""
        for key, value in self._state.items():
            if not key.startswith("__"):
                setattr(self, key, value)

    @abstractmethod
    def setup(self, ind_train_data, **kwargs) -> None:
        raise NotImplementedError

    @abstractmethod
    def postprocess(self, test_data, **kwargs):
        raise NotImplementedError

    def __call__(self, test_data, **kwargs):
        return self.postprocess(test_data, **kwargs)

    def _warn_if_fitted(self, name: str) -> bool:
        """Returns True (and warns) if already fitted; callers skip re-fit."""
        if self._setup_flag:
            warnings.warn(f"{name} already trained")
            return True
        return False


class OodPostprocessor(Postprocessor):
    """Postprocessor with sign flipping and a z-score threshold."""

    def __init__(self, flip_sign: bool = False, cfg=None):
        super().__init__(cfg)
        self.flip_sign = flip_sign
        self.threshold: Optional[float] = None

    def flip_sign_fn(self, scores):
        if self.flip_sign:
            if isinstance(scores, dict):
                for method, values in scores.items():
                    scores[method] = values * -1
            elif isinstance(scores, (np.ndarray, torch.Tensor)):
                scores = scores * -1
            else:
                raise ValueError("scores must be a dict, an ndarray or a tensor")
        return scores

    def set_threshold(self, ind_test_scores, z_score_percentile: float = 1.645) -> None:
        self.threshold = get_method_threshold(ind_test_scores, z_score_percentile)
        self._state["threshold"] = self.threshold
        self._setup_flag = True


def get_method_threshold(scores, z_score_percentile: float) -> float:
    """mean - z * std (higher score = InD)."""
    scores = torch.as_tensor(scores, dtype=torch.float64)
    return float(scores.mean()) - z_score_percentile * float(scores.std(correction=0))
