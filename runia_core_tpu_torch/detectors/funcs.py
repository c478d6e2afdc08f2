"""Score math of the post-hoc OoD detectors, in PyTorch.

Counterpart of ``runia_core_tpu/detectors/funcs.py``: the Mahalanobis fit
and score, ``normalizer``, DICE's masked weight and routed layer, ASH-S,
ReAct's clipped layer, the per-class Gaussian mixture (``GMMState``,
``gmm_fit``), GEN's generalized entropy and the MC-dropout predictive
uncertainties, each batched over rows. ``percentile`` is ``np.percentile``
on the tensor's device (DICE and ReAct thresholds): ``torch.quantile``
refuses inputs above 2^24 elements, and ImageNet-sized train features pass
that. The matmuls are true f32 on the GPU while TF32 stays off (PyTorch's
default), the counterpart of JAX's ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from runia_core_tpu_torch.ops.linalg import (
    class_means,
    classwise_mahalanobis_max,
    mvn_fit_cholesky,
    mvn_log_prob,
    shared_class_precision,
)
from runia_core_tpu_torch.utils.placement import as_tensor

__all__ = [
    "GMMState",
    "RouteDICE",
    "ash_s_conv_layer",
    "ash_s_linear_layer",
    "dice_masked_weight",
    "generalized_entropy",
    "get_dice_feat_mean_react_percentile",
    "get_mcd_pred_uncertainty_score",
    "get_predictive_uncertainty_score",
    "gmm_fit",
    "gmm_log_prob",
    "mahalanobis_postprocess",
    "mahalanobis_preprocess",
    "normalizer",
    "percentile",
    "react_clip_logits",
    "route_dice_logits",
]


def _require(ok: bool, message: str) -> None:
    """The JAX package's ``assert`` checks, as an AssertionError that ``-O``
    does not remove."""
    if not ok:
        raise AssertionError(message)


def percentile(x: torch.Tensor, q: float) -> float:
    """``float(np.percentile(x, q))`` over every element of ``x`` (linear
    interpolation), with numpy's own index and weight arithmetic in x's
    dtype (float32 unless x is float64); the two order statistics come from
    ``torch.kthvalue`` on x's device."""
    flat = x.reshape(-1)
    if flat.dtype != torch.float64:
        flat = flat.to(torch.float32)
    dt = np.float64 if flat.dtype == torch.float64 else np.float32
    n = flat.numel()
    quantile = np.asanyarray(np.true_divide(q, dt(100)))
    virtual = np.asanyarray((n - 1) * quantile)
    if virtual >= n - 1:
        lo = hi = n - 1
    elif virtual < 0:
        lo = hi = 0
    else:
        lo = int(np.floor(virtual))
        hi = lo + 1
    gamma = np.asanyarray(virtual - np.floor(virtual), dtype=dt)
    a = dt(torch.kthvalue(flat, lo + 1).values.item())
    b = dt(torch.kthvalue(flat, hi + 1).values.item()) if hi != lo else a
    diff = b - a
    return float(b - diff * (1 - gamma) if gamma >= 0.5 else a + diff * gamma)


def mahalanobis_preprocess(ind_data: Dict[str, object], num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class means and the shared precision of the class-centred data, from
    "train features" / "train labels" (an array goes to the GPU)."""
    x = as_tensor(ind_data["train features"])
    return shared_class_precision(x, ind_data["train labels"], num_classes, warn_label="train class")


def mahalanobis_postprocess(feats, class_mean, precision, num_classes: int) -> torch.Tensor:
    """Per-row max over classes of the negative Mahalanobis quadratic form,
    an empty (NaN) class counting as -inf; on ``class_mean``'s device."""
    del num_classes  # the class count is class_mean's leading axis
    class_mean = as_tensor(class_mean)
    return classwise_mahalanobis_max(torch.as_tensor(feats, device=class_mean.device), class_mean,
                                     torch.as_tensor(precision, device=class_mean.device))


def normalizer(x):
    """Row-wise L2 normalisation with the reference's 1e-10 guard; an array
    stays an array, a tensor a tensor."""
    if isinstance(x, np.ndarray):
        return x / (np.linalg.norm(x, ord=2, axis=-1, keepdims=True) + 1e-10)
    return x / (torch.linalg.vector_norm(x, ord=2, dim=-1, keepdim=True) + 1e-10)


# ---------------------------------------------------------------------------
# DICE
# ---------------------------------------------------------------------------
def dice_masked_weight(weight, info, p: float) -> torch.Tensor:
    """The (C, d) weight with every entry whose contribution (mean
    activation times weight) is at or below the p-th percentile of all
    contributions set to zero."""
    weight = as_tensor(weight)
    contrib = torch.as_tensor(info, device=weight.device)[None, :] * weight
    mask = (contrib > percentile(contrib, p)).to(weight.dtype)
    return weight * mask


def route_dice_logits(x, masked_w, bias) -> torch.Tensor:
    """The linear layer with the DICE-masked weight."""
    masked_w = as_tensor(masked_w)
    out = torch.as_tensor(x, device=masked_w.device) @ masked_w.T
    if bias is not None:
        out = out + torch.as_tensor(bias, device=masked_w.device)
    return out


class RouteDICE:
    """DICE's routed linear layer as a callable: the mask is computed once
    from (weight, info, p) at the first call; weights come through the
    constructor or ``load_params``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, p: float = 90, info=None,
                 weight=None, bias_value=None):
        _require(0 < p < 100, "p must be greater than 0 and less than 100")
        if info is not None:
            _require(isinstance(info, (np.ndarray, torch.Tensor)), "info must be a numpy array or None")
        self.in_features = in_features
        self.out_features = out_features
        self.p = p
        self.info = info
        self.use_bias = bias
        self.weight = as_tensor(weight) if weight is not None else None
        self.bias = as_tensor(bias_value) if bias_value is not None else None
        self.masked_w: Optional[torch.Tensor] = None

    def load_params(self, weight, bias=None) -> "RouteDICE":
        self.weight = as_tensor(weight)
        if bias is not None:
            self.bias = as_tensor(bias)
        self.masked_w = None
        return self

    def calculate_mask_weight(self) -> None:
        _require(self.weight is not None and self.info is not None, "weight and info must be set")
        self.masked_w = dice_masked_weight(self.weight, self.info, self.p)

    def __call__(self, x) -> torch.Tensor:
        if self.masked_w is None:
            self.calculate_mask_weight()
        return route_dice_logits(x, self.masked_w, self.bias if self.use_bias else None)

    forward = __call__


def get_dice_feat_mean_react_percentile(dnn_model, ind_dataloader, react_percentile: int = 90,
                                        channel_axis: int = 1):
    """DICE's mean activation (d,) and ReAct's percentile from the pooled
    features of ``dnn_model`` over a loader: 4-D maps are average-pooled
    over their spatial axes (``channel_axis`` 1: NCHW, else NHWC)."""
    _require(0 < react_percentile < 100, "react_percentile must be greater than 0 and less than 100")
    spatial = (2, 3) if channel_axis == 1 else (1, 2)
    feats = []
    for batch in ind_dataloader:
        inputs = batch[0] if isinstance(batch, (tuple, list)) else batch
        outputs = as_tensor(dnn_model(inputs))
        feats.append(outputs.mean(dim=spatial) if outputs.ndim == 4 else outputs)
    feats = torch.cat(feats)
    return feats.mean(dim=0), percentile(feats, react_percentile)


# ---------------------------------------------------------------------------
# ASH-S
# ---------------------------------------------------------------------------
def _ash_s_rows(flat: torch.Tensor, percentile_: float) -> torch.Tensor:
    """Keep each row's top k = n - round(n p / 100) entries, zero the rest,
    scale by exp(sum before / sum after). Among equal values the lower index
    is kept, as ``jax.lax.top_k`` keeps it (a stable descending sort;
    ``torch.topk`` leaves the order of ties open, and which of two equal
    activations survives changes the logits through the weight's columns)."""
    n = flat.shape[1]
    k = n - int(np.round(n * percentile_ / 100.0))
    s1 = flat.sum(dim=1)
    values, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    kept = torch.zeros_like(flat).scatter(1, idx[:, :k], values[:, :k])
    return kept * torch.exp(s1 / kept.sum(dim=1))[:, None]


def ash_s_linear_layer(x, percentile: int = 85) -> torch.Tensor:
    """ASH-S pruning and exponential rescaling of 2-D activations."""
    x = as_tensor(x)
    _require(x.ndim == 2, "ash_s_linear_layer takes (N, d) activations")
    return _ash_s_rows(x, percentile)


def ash_s_conv_layer(x, percentile: int = 65) -> torch.Tensor:
    """ASH-S over each (C, H, W) map of a 4-D batch."""
    x = as_tensor(x)
    _require(x.ndim == 4, "ash_s_conv_layer takes (B, C, H, W) activations")
    return _ash_s_rows(x.reshape(x.shape[0], -1), percentile).reshape(x.shape)


# ---------------------------------------------------------------------------
# ReAct
# ---------------------------------------------------------------------------
def react_clip_logits(feats, threshold: float, weight, bias) -> torch.Tensor:
    """Activations clipped at ``threshold``, then the final linear layer."""
    weight = as_tensor(weight)
    clipped = torch.clamp(torch.as_tensor(feats, device=weight.device), max=threshold)
    return clipped @ weight.T + torch.as_tensor(bias, device=weight.device)


# ---------------------------------------------------------------------------
# DDU / GMM
# ---------------------------------------------------------------------------
class GMMState:
    """Per-class Gaussian mixture: means (C, d), Cholesky factors (C, d, d)
    and the jitter each factor took. Classes without training samples are
    left out, as the reference drops their NaN rows."""

    def __init__(self, means: torch.Tensor, chols: torch.Tensor, jitter: torch.Tensor):
        self.means = means
        self.chols = chols
        self.jitter = jitter

    def log_prob(self, x) -> torch.Tensor:
        """(N, C) per-class log-densities (``MultivariateNormal.log_prob``)."""
        x = torch.as_tensor(x, device=self.means.device)
        if x.ndim == 3:  # the reference passes (N, 1, d)
            x = x[:, 0, :]
        return mvn_log_prob(x, self.means, self.chols)


def gmm_fit(embeddings, labels, num_classes: int) -> Tuple[GMMState, float]:
    """Per-class MVNs with the reference's shared jitter ladder: (state, the
    jitter used). A class covariance divides by n - 1, by 1 for a class of
    one sample. The rows are gathered in class order once and each class's
    outer-product sum is one (n_c, d) matmul, so the memory is the data's and
    a (d, d) per class."""
    x = as_tensor(embeddings).to(torch.float32)
    labels_np = np.asarray(torch.as_tensor(labels).cpu()).astype(np.int64)
    means = class_means(x, torch.as_tensor(labels_np, device=x.device), num_classes)  # NaN rows: empty classes
    counts = np.bincount(labels_np, minlength=num_classes)
    kept = np.nonzero(counts)[0]
    by_class = x[torch.as_tensor(np.argsort(labels_np, kind="stable"), device=x.device)]
    starts = np.concatenate([[0], np.cumsum(counts)])
    covs = torch.stack([
        (lambda xc: xc.T @ xc)(by_class[starts[c]:starts[c + 1]] - means[c]) / max(counts[c] - 1.0, 1.0)
        for c in kept
    ])
    means = means[torch.as_tensor(kept, device=x.device)]
    chols, jitters = mvn_fit_cholesky(covs)
    return GMMState(means=means, chols=chols, jitter=jitters), float(jitters.max()) if jitters.numel() else 0.0


def gmm_log_prob(state: GMMState, x) -> torch.Tensor:
    return state.log_prob(x)


# ---------------------------------------------------------------------------
# GEN
# ---------------------------------------------------------------------------
def generalized_entropy(probs, gamma: float, M: int) -> torch.Tensor:
    """Negated generalized entropy over each row's M largest probabilities."""
    top = torch.sort(as_tensor(probs), dim=1).values[:, -M:]
    return -(top**gamma * (1.0 - top) ** gamma).sum(dim=1)


# ---------------------------------------------------------------------------
# MC-dropout predictive uncertainty
# ---------------------------------------------------------------------------
def _pred_h_and_mi(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, C) probabilities -> H(mean_s p), H(mean_s p) - mean_s H(p_s)."""
    expected = probs.mean(dim=1)
    pred_h = -(expected * torch.log(expected)).sum(dim=1)
    return pred_h, pred_h - (-(probs * torch.log(probs)).sum(dim=-1)).mean(dim=1)


def get_predictive_uncertainty_score(input_samples, mcd_nro_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predictive entropy and mutual information from stacked MC logits
    (n_images * S, C), images contiguous."""
    logits = as_tensor(input_samples)
    _require(logits.shape[0] % mcd_nro_samples == 0,
             "Input tensor first dimension must be divisible by the mcd_nro_samples")
    probs = torch.softmax(logits, dim=1)
    return _pred_h_and_mi(probs.reshape(-1, mcd_nro_samples, probs.shape[-1]))


def get_mcd_pred_uncertainty_score(
    forward_fn, images, generator: torch.Generator, mcd_nro_samples: int = 2
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``mcd_nro_samples`` stochastic forwards ``forward_fn(generator,
    images) -> logits`` (dropout active, drawing from ``generator``), one
    after another, then (probs (B, S, C), pred-H, MI). JAX maps the S
    forwards with per-sample keys."""
    logits = torch.stack([forward_fn(generator, images) for _ in range(mcd_nro_samples)])  # (S, B, C)
    probs = torch.softmax(logits, dim=-1).transpose(0, 1)
    return (probs, *_pred_h_and_mi(probs))
