"""Feature-based OoD postprocessors: DDU, KNN, Mahalanobis, ViM, ASH, DICE,
ReAct, DICE+ReAct, in PyTorch.

Counterpart of ``runia_core_tpu/detectors/features.py``, with its deliberate
departures from the reference kept: KNN thresholds on the flipped scores
that ``postprocess`` returns, ViM flips its test scores like every other
detector, and ASH sets its threshold on the train features, as the
reference does. ``setup`` fits where its train data lies (an array goes to
the GPU, and the other arrays it is given follow the train data there);
``postprocess`` scores on the fitted state's device and returns a tensor
there. The fitted state is an explicit dict (``state``) that
``load_state`` restores.
"""

from __future__ import annotations

from typing import Optional

import torch

from runia_core_tpu_torch.detectors.base import OodPostprocessor, register_postprocessor
from runia_core_tpu_torch.detectors.funcs import (
    GMMState,
    _require,
    ash_s_linear_layer,
    dice_masked_weight,
    gmm_fit,
    mahalanobis_postprocess,
    mahalanobis_preprocess,
    normalizer,
    percentile,
    react_clip_logits,
    route_dice_logits,
)
from runia_core_tpu_torch.detectors.logits import energy_score
from runia_core_tpu_torch.ops.knn import squared_l2_kth_neighbor
from runia_core_tpu_torch.ops.linalg import empirical_covariance
from runia_core_tpu_torch.utils.placement import as_tensor

__all__ = ["ASH", "DDU", "DICE", "DICEReAct", "KNN", "Mahalanobis", "ReAct", "ViM"]


def _cfg_get(cfg, key, default):
    try:
        return getattr(cfg, key)
    except AttributeError:
        return default


def _fc_params(kwargs, name: str, device):
    """(weight, bias) of the final linear layer, on ``device``."""
    _require("final_linear_layer_params" in kwargs, f"final_linear_layer_params must be provided for {name}")
    fc = kwargs["final_linear_layer_params"]
    return torch.as_tensor(fc["weight"], device=device), torch.as_tensor(fc["bias"], device=device)


def _rows_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


@register_postprocessor("ddu", postprocessor_input=["features"])
class DDU(OodPostprocessor):
    """Deep Deterministic Uncertainty: the logsumexp of per-class MVN
    log-densities (one shared jitter rung)."""

    def __init__(self, flip_sign: bool = False, num_classes: int = 10, cfg=None):
        super().__init__(flip_sign, cfg)
        if cfg is not None:
            num_classes = _cfg_get(cfg, "num_classes", num_classes)
        self.num_classes = num_classes
        self.gmm: Optional[GMMState] = None

    def setup(self, ind_train_data, **kwargs) -> None:
        _require("valid_feats" in kwargs, "valid_feats must be provided for DDU")
        _require("train_labels" in kwargs, "train_labels must be provided for DDU")
        self.gmm, _ = gmm_fit(ind_train_data, kwargs["train_labels"], self.num_classes)
        self._state = {"means": self.gmm.means, "chols": self.gmm.chols}
        self.set_threshold(self.flip_sign_fn(self._score(kwargs["valid_feats"])))

    def _score(self, feats) -> torch.Tensor:
        return torch.logsumexp(self.gmm.log_prob(feats), dim=1)

    def postprocess(self, test_data, **kwargs) -> torch.Tensor:
        _require(self._setup_flag, "setup() must be called before postprocess()")
        return self.flip_sign_fn(self._score(test_data))

    def _rehydrate(self) -> None:
        means = as_tensor(self._state["means"])
        self.gmm = GMMState(means=means, chols=torch.as_tensor(self._state["chols"], device=means.device),
                            jitter=torch.zeros(means.shape[0], device=means.device))
        if "threshold" in self._state:
            self.threshold = float(self._state["threshold"])


@register_postprocessor("knn", postprocessor_input=["features"])
class KNN(OodPostprocessor):
    """Negated squared L2 distance to the k-th neighbour among the
    normalised train features (faiss's squared-distance convention)."""

    def __init__(self, flip_sign: bool = False, k_neighbors: int = 50, cfg=None):
        super().__init__(flip_sign, cfg)
        if cfg is not None:
            k_neighbors = _cfg_get(cfg, "k_neighbors", k_neighbors)
        self.k_neighbors = k_neighbors
        self.index: Optional[torch.Tensor] = None

    def setup(self, ind_train_data, **kwargs) -> None:
        _require("valid_feats" in kwargs, "valid_feats must be provided for KNN setup")
        self.index = normalizer(as_tensor(ind_train_data).to(torch.float32))
        self._state = {"index": self.index, "k_neighbors": self.k_neighbors}
        # Threshold on what postprocess returns (flipped), not on the
        # unflipped scores as the reference does: the JAX package's fix.
        self.set_threshold(self.postprocess(kwargs["valid_feats"], _skip_setup_check=True))

    def postprocess(self, test_data, **kwargs) -> torch.Tensor:
        if not kwargs.get("_skip_setup_check", False):
            _require(self._setup_flag, "setup() must be called before postprocess()")
        test = normalizer(torch.as_tensor(test_data, device=self.index.device).to(torch.float32))
        return self.flip_sign_fn(-squared_l2_kth_neighbor(test, self.index, self.k_neighbors))


@register_postprocessor("mahalanobis", postprocessor_input=["features"])
class Mahalanobis(OodPostprocessor):
    """Class-conditional Mahalanobis score with one shared precision."""

    def __init__(self, flip_sign: bool = False, num_classes: int = 10, cfg=None):
        super().__init__(flip_sign, cfg)
        if cfg is not None:
            num_classes = _cfg_get(cfg, "num_classes", num_classes)
        self.num_classes = num_classes
        self.class_mean: Optional[torch.Tensor] = None
        self.precision: Optional[torch.Tensor] = None

    def setup(self, ind_train_data, **kwargs) -> None:
        _require("train_labels" in kwargs, "train_labels must be provided for Mahalanobis")
        _require("valid_feats" in kwargs, "valid_feats must be provided for Mahalanobis")
        self.class_mean, self.precision = mahalanobis_preprocess(
            {"train features": ind_train_data, "train labels": kwargs["train_labels"]}, self.num_classes)
        self._state = {"class_mean": self.class_mean, "precision": self.precision}
        self.set_threshold(self.flip_sign_fn(self._score(kwargs["valid_feats"])))

    def _score(self, feats) -> torch.Tensor:
        return mahalanobis_postprocess(feats, self.class_mean, self.precision, self.num_classes)

    def postprocess(self, test_data, **kwargs) -> torch.Tensor:
        _require(self._setup_flag, "setup() must be called before postprocess()")
        return self.flip_sign_fn(self._score(test_data))


@register_postprocessor("vim", postprocessor_input=["features", "logits"])
class ViM(OodPostprocessor):
    """Virtual-logit Matching: the residual norm outside the principal
    subspace of the u-centred features, scaled by alpha, against the energy.
    DIM is 1000 at d >= 2048, 512 at d >= 768, else d // 2; the null space
    is the (d - DIM) smallest eigenvectors of ``eigh`` (the covariance is
    symmetric), u = -pinv(W) b with JAX's cutoff."""

    def __init__(self, flip_sign: bool = False, cfg=None):
        super().__init__(flip_sign, cfg)
        self.u: Optional[torch.Tensor] = None
        self.DIM: Optional[int] = None
        self.NS: Optional[torch.Tensor] = None
        self.alpha: Optional[torch.Tensor] = None

    def setup(self, ind_train_data, **kwargs) -> None:
        for key in ("train_logits", "valid_feats", "valid_logits"):
            _require(key in kwargs, f"{key} must be provided for ViM")
        x = as_tensor(ind_train_data)
        w, b = _fc_params(kwargs, "ViM", x.device)
        # JAX's pinv cutoff, 10 max(m, n) eps of the largest singular value.
        self.u = -(torch.linalg.pinv(w, rtol=10.0 * max(w.shape) * torch.finfo(w.dtype).eps) @ b)
        d = x.shape[-1]
        self.DIM = 1000 if d >= 2048 else 512 if d >= 768 else d // 2
        _, eig_vecs = torch.linalg.eigh(empirical_covariance(x - self.u, assume_centered=True))  # ascending
        self.NS = eig_vecs[:, : d - self.DIM].contiguous()
        train_logits = torch.as_tensor(kwargs["train_logits"], device=x.device)
        self.alpha = train_logits.amax(dim=-1).mean() / _rows_norm((x - self.u) @ self.NS).mean()
        self._state = {"u": self.u, "NS": self.NS, "alpha": self.alpha, "DIM": self.DIM}
        self.set_threshold(self.flip_sign_fn(self._score(kwargs["valid_feats"], kwargs["valid_logits"])))

    def _score(self, feats, logits) -> torch.Tensor:
        feats = torch.as_tensor(feats, device=self.NS.device)
        vlogit = _rows_norm((feats - self.u) @ self.NS) * self.alpha
        return -vlogit + energy_score(torch.as_tensor(logits, device=self.NS.device))

    def postprocess(self, test_data, **kwargs) -> torch.Tensor:
        _require(self._setup_flag, "setup() must be called before postprocess()")
        return self.flip_sign_fn(self._score(test_data, kwargs["logits"]))


class _EnergyOfLayer(OodPostprocessor):
    """Energy of logits from a reshaped final layer: ``_logits`` per detector."""

    def _logits(self, feats: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _score(self, feats) -> torch.Tensor:
        return energy_score(self._logits(torch.as_tensor(feats, device=self.b.device)))

    def postprocess(self, test_data, **kwargs) -> torch.Tensor:
        _require(self._setup_flag, "setup() must be called before postprocess()")
        return self.flip_sign_fn(self._score(test_data))


@register_postprocessor("ash", postprocessor_input=["features"])
class ASH(_EnergyOfLayer):
    """Activation Shaping (ASH-S) of the features, then the energy."""

    def __init__(self, flip_sign: bool = False, ash_percentile: int = 85, cfg=None):
        super().__init__(flip_sign, cfg)
        if cfg is not None:
            ash_percentile = _cfg_get(cfg, "ash_percentile", ash_percentile)
        self.ash_percentile = ash_percentile
        self.w: Optional[torch.Tensor] = None
        self.b: Optional[torch.Tensor] = None

    def setup(self, ind_train_data, **kwargs) -> None:
        _require("valid_feats" in kwargs, "valid_feats must be provided for ASH")
        x = as_tensor(ind_train_data)
        self.w, self.b = _fc_params(kwargs, "ASH", x.device)
        self._state = {"w": self.w, "b": self.b, "ash_percentile": self.ash_percentile}
        # The reference sets the threshold on the train features; kept.
        self.set_threshold(self.flip_sign_fn(self._score(x)))

    def _logits(self, feats: torch.Tensor) -> torch.Tensor:
        return ash_s_linear_layer(feats, self.ash_percentile) @ self.w.T + self.b


@register_postprocessor("dice", postprocessor_input=["features"])
class DICE(_EnergyOfLayer):
    """Directed sparsification of the final layer, then the energy."""

    def __init__(self, flip_sign: bool = False, dice_percentile: int = 90, num_classes: int = 10, cfg=None):
        super().__init__(flip_sign, cfg)
        if cfg is not None:
            dice_percentile = _cfg_get(cfg, "dice_percentile", dice_percentile)
            num_classes = _cfg_get(cfg, "num_classes", num_classes)
        self.dice_percentile = dice_percentile
        self.num_classes = num_classes
        self.masked_w: Optional[torch.Tensor] = None
        self.b: Optional[torch.Tensor] = None

    def setup(self, ind_train_data, **kwargs) -> None:
        _require("valid_feats" in kwargs, "valid_feats must be provided for DICE")
        x = as_tensor(ind_train_data)
        w, self.b = _fc_params(kwargs, "DICE", x.device)
        self.masked_w = dice_masked_weight(w, x.mean(dim=0), self.dice_percentile)
        self._state = {"masked_w": self.masked_w, "b": self.b}
        self.set_threshold(self.flip_sign_fn(self._score(kwargs["valid_feats"])))

    def _logits(self, feats: torch.Tensor) -> torch.Tensor:
        return route_dice_logits(feats, self.masked_w, self.b)


@register_postprocessor("react", postprocessor_input=["features"])
class ReAct(_EnergyOfLayer):
    """Activations clipped at the train features' percentile, then the
    energy."""

    def __init__(self, flip_sign: bool = False, react_percentile: int = 90, cfg=None):
        super().__init__(flip_sign, cfg)
        if cfg is not None:
            react_percentile = _cfg_get(cfg, "react_percentile", react_percentile)
        self.react_percentile = react_percentile
        self.activation_threshold: Optional[float] = None
        self.w: Optional[torch.Tensor] = None
        self.b: Optional[torch.Tensor] = None

    def setup(self, ind_train_data, **kwargs) -> None:
        _require("valid_feats" in kwargs, "valid_feats must be provided for ReAct")
        x = as_tensor(ind_train_data)
        self.w, self.b = _fc_params(kwargs, "ReAct", x.device)
        self.activation_threshold = percentile(x, self.react_percentile)
        self._state = {"w": self.w, "b": self.b, "activation_threshold": self.activation_threshold}
        self.set_threshold(self.flip_sign_fn(self._score(kwargs["valid_feats"])))

    def _logits(self, feats: torch.Tensor) -> torch.Tensor:
        return react_clip_logits(feats, self.activation_threshold, self.w, self.b)


@register_postprocessor("dice_react", postprocessor_input=["features"])
class DICEReAct(_EnergyOfLayer):
    """ReAct's clipping, then DICE's routed layer, then the energy."""

    def __init__(self, flip_sign: bool = False, dice_percentile: int = 90, react_percentile: int = 90,
                 num_classes: int = 10, cfg=None):
        super().__init__(flip_sign, cfg)
        if cfg is not None:
            dice_percentile = _cfg_get(cfg, "dice_percentile", dice_percentile)
            react_percentile = _cfg_get(cfg, "react_percentile", react_percentile)
            num_classes = _cfg_get(cfg, "num_classes", num_classes)
        self.dice_percentile = dice_percentile
        self.react_percentile = react_percentile
        self.num_classes = num_classes
        self.masked_w: Optional[torch.Tensor] = None
        self.b: Optional[torch.Tensor] = None
        self.react_activation_threshold: Optional[float] = None

    def setup(self, ind_train_data, **kwargs) -> None:
        _require("valid_feats" in kwargs, "valid_feats must be provided for DICE")
        x = as_tensor(ind_train_data)
        w, self.b = _fc_params(kwargs, "DICE", x.device)
        self.masked_w = dice_masked_weight(w, x.mean(dim=0), self.dice_percentile)
        self.react_activation_threshold = percentile(x, self.react_percentile)
        self._state = {"masked_w": self.masked_w, "b": self.b,
                       "react_activation_threshold": self.react_activation_threshold}
        self.set_threshold(self.flip_sign_fn(self._score(kwargs["valid_feats"])))

    def _logits(self, feats: torch.Tensor) -> torch.Tensor:
        return route_dice_logits(torch.clamp(feats, max=self.react_activation_threshold), self.masked_w, self.b)
