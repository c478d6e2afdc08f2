"""Logit-based OoD postprocessors: Energy, MSP, GEN, in PyTorch.

Counterpart of ``runia_core_tpu/detectors/logits.py``: each score is one
reduction over the logits' class axis; thresholds follow the reference's
mean - 1.645 std rule through ``set_threshold``, and every class constructs
as ``cls(cfg=cfg)``. An array goes to the GPU (a tensor stays on its
device), and scores come back as tensors there.
"""

from __future__ import annotations

import torch

from runia_core_tpu_torch.detectors.base import OodPostprocessor, register_postprocessor
from runia_core_tpu_torch.detectors.funcs import _require, generalized_entropy
from runia_core_tpu_torch.utils.placement import as_tensor

__all__ = ["Energy", "GEN", "MSP", "energy_score", "msp_score"]


def energy_score(logits) -> torch.Tensor:
    return torch.logsumexp(as_tensor(logits), dim=1)


def msp_score(logits) -> torch.Tensor:
    return torch.softmax(as_tensor(logits), dim=1).amax(dim=1)


class _LogitScorer(OodPostprocessor):
    """Threshold on the flipped scores of the train logits; score test
    logits the same way."""

    def _score(self, logits) -> torch.Tensor:
        raise NotImplementedError

    def setup(self, ind_train_data, **kwargs) -> None:
        self.set_threshold(self.flip_sign_fn(self._score(ind_train_data)))

    def postprocess(self, test_data, **kwargs) -> torch.Tensor:
        _require(self._setup_flag, "setup() must be called before postprocess()")
        return self.flip_sign_fn(self._score(test_data))


@register_postprocessor("energy", postprocessor_input=["logits"])
class Energy(_LogitScorer):
    """Energy score: logsumexp over the logits."""

    def __init__(self, flip_sign: bool = False, cfg=None):
        super().__init__(flip_sign, cfg)

    def _score(self, logits) -> torch.Tensor:
        return energy_score(logits)


@register_postprocessor("msp", postprocessor_input=["logits"])
class MSP(_LogitScorer):
    """Maximum softmax probability."""

    def __init__(self, flip_sign: bool = False, cfg=None):
        super().__init__(flip_sign, cfg)

    def _score(self, logits) -> torch.Tensor:
        return msp_score(logits)


@register_postprocessor("gen", postprocessor_input=["logits"])
class GEN(_LogitScorer):
    """Generalized entropy over the top-M softmax probabilities
    (``cfg.gen_gamma``, M = ``cfg.num_classes`` where the cfg has them)."""

    def __init__(self, flip_sign: bool = False, gamma: float = 0.1, num_classes: int = 10, cfg=None):
        super().__init__(flip_sign, cfg)
        if cfg is not None:
            gamma = getattr(cfg, "gen_gamma", gamma)
            num_classes = getattr(cfg, "num_classes", num_classes)
        self.gamma = gamma
        self.num_classes = num_classes

    def _score(self, logits) -> torch.Tensor:
        return generalized_entropy(torch.softmax(as_tensor(logits), dim=1), self.gamma, self.num_classes)
