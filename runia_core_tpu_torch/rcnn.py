"""RCNN (detectron2-style) adapter helpers, in PyTorch.

Counterpart of ``runia_core_tpu/rcnn.py``. The adapted RCNN is a callable
with a small output protocol, and every random draw comes from an explicit
``torch.Generator`` (the JAX package passes keys):

    model(image, generator=None) -> RCNNOutput(
        scores,          # (N,) post-NMS detection scores
        inter_feat,      # (N, C+1) logits of the NMS survivors (background last)
        box_cls,         # (1000, C+1) raw proposal logits before NMS
        latent,          # the hooked layer's output
        rpn_feats,       # list of (1, C, H, W) RPN intermediate maps
        backbone_feats,  # dict of pyramid level -> (1, C, H, W)
    )

Where the JAX package's DropBlock draws from a key, the port's draws from
the generator, or takes the Bernoulli seed masks it is given (``seeds``:
tests inject the JAX package's). Tensors stay on their device; arrays go to
``device`` (None: the GPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from runia_core_tpu_torch.detectors.base import record_time
from runia_core_tpu_torch.evaluation.entropy import get_dl_h_z
from runia_core_tpu_torch.inference.image_level import LaRDInference, LaRExInference
from runia_core_tpu_torch.ops.dropblock import dropblock2d
from runia_core_tpu_torch.reduction import apply_pca_transform
from runia_core_tpu_torch.utils.placement import as_tensor, to_numpy

__all__ = [
    "LaRDInferenceRCNN",
    "LaRexInferenceRCNN",
    "MCSamplerRCNN",
    "RCNNOutput",
    "get_dice_feat_mean_react_percentile_rcnn",
    "get_energy_score_rcnn",
    "get_ls_mcd_samples_rcnn",
    "get_msp_score_rcnn",
    "remove_background_dimension",
]

# Per MC sample, per map: a (1, H, W) Bernoulli seed mask replacing the draw.
Seeds = Sequence[Sequence[torch.Tensor]]


@dataclass
class RCNNOutput:
    scores: Optional[Any] = None
    inter_feat: Optional[Any] = None
    box_cls: Optional[Any] = None
    latent: Any = None
    rpn_feats: List[Any] = field(default_factory=list)
    backbone_feats: Dict[str, Any] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)


def get_msp_score_rcnn(dnn_model: Callable, input_dataloader: Iterable) -> np.ndarray:
    """Per image, the largest detection score; 0.0 for an image with none."""
    scores = []
    for image in input_dataloader:
        out: RCNNOutput = dnn_model(image)
        pred_scores = to_numpy(out.scores) if out.scores is not None else np.zeros(0)
        scores.append(float(pred_scores.max()) if pred_scores.size else 0.0)
    return np.asarray(scores)


def get_dice_feat_mean_react_percentile_rcnn(
    dnn_model: Callable, ind_dataloader: Iterable, react_percentile: int = 90
) -> Tuple[np.ndarray, float]:
    """DICE's mean-activation vector and ReAct's clipping percentile from the
    proposals' mean features (``model(image).latent``, per proposal)."""
    assert 0 < react_percentile < 100, "react_percentile must be greater than 0 and less than 100"
    feat_log = [to_numpy(dnn_model(inputs).latent).mean(0).reshape(1, -1) for inputs in ind_dataloader]
    feat_log_array = np.array(feat_log).squeeze()
    return feat_log_array.mean(0), float(np.percentile(feat_log_array, react_percentile))


def get_energy_score_rcnn(dnn_model: Callable, input_dataloader: Iterable, device=None):
    """Per image, the mean energy (logsumexp over the classes, background
    column dropped) of the raw proposals and of the NMS survivors."""
    raw_scores, filtered_scores = [], []
    for image in input_dataloader:
        out: RCNNOutput = dnn_model(image)
        box_cls = as_tensor(out.box_cls, device)
        inter = as_tensor(out.inter_feat, box_cls.device)
        raw_scores.append(float(torch.logsumexp(box_cls[:, :-1], dim=1).mean()))
        filtered_scores.append(float(torch.logsumexp(inter[:, :-1], dim=1).mean()))
    return np.asarray(raw_scores), np.asarray(filtered_scores)


def _channel_means(fmap: torch.Tensor) -> torch.Tensor:
    return fmap.mean(dim=(2, 3)).reshape(-1)


class MCSamplerRCNN:
    """MC-DropBlock sampler over the RPN's intermediate maps: each of
    ``mc_samples`` samples DropBlocks every (1, C_l, H_l, W_l) level, reduces
    it to channel means and concatenates the levels -> (S, sum_l C_l). The
    masks come from ``generator`` (PyTorch's default generator of the maps'
    device when None) unless ``seeds`` are given."""

    def __init__(self, mc_samples: int = 8, layer_type: str = "RPN", block_size: int = 8, drop_prob: float = 0.5,
                 generator: Optional[torch.Generator] = None, device=None):
        assert layer_type == "RPN", "layer_type must be 'RPN'"
        self.mc_samples = mc_samples
        self.block_size = block_size
        self.drop_prob = drop_prob
        self.generator = generator
        self.device = device

    def __call__(self, rpn_feats: List[Any], seeds: Optional[Seeds] = None) -> torch.Tensor:
        feats = [as_tensor(f, self.device, torch.float32) for f in rpn_feats]
        samples = []
        for s in range(self.mc_samples):
            parts = [
                _channel_means(dropblock2d(fmap, self.drop_prob, self.block_size, channel_axis=1,
                                           generator=self.generator, seed=None if seeds is None else seeds[s][i]))
                for i, fmap in enumerate(feats)
            ]
            samples.append(torch.cat(parts))
        return torch.stack(samples)

    # PyTorch-module shims: the sampler holds no tensors.
    def to(self, device) -> "MCSamplerRCNN":
        return self

    def train(self, mode: bool = True) -> "MCSamplerRCNN":
        return self


def _reduce_rpn(feats: List[Any], device=None) -> torch.Tensor:
    """Each level's channel means, concatenated."""
    return torch.cat([_channel_means(as_tensor(f, device, torch.float32)) for f in feats])


def get_ls_mcd_samples_rcnn(
    model: Callable,
    data_loader: Iterable,
    mcd_nro_samples: int,
    hook_dropout_layer: str = "latent",
    layer_type: str = "RPN",
    return_raw_predictions: bool = False,
    generator: Optional[torch.Generator] = None,
    dropblock_prob: float = 0.4,
    dropblock_size: int = 1,
    device=None,
    seeds: Optional[Sequence[Seeds]] = None,
):
    """MC-dropout latent samples from an adapted RCNN, called as
    ``model(image, generator)`` so stochastic layers draw from ``generator``.
    ``layer_type`` selects the reduction:
      'Conv': channel means of ``out.latent``;
      'RPN': per-level channel means of ``out.rpn_feats``, concatenated;
      'backbone': each pyramid level DropBlocked (``seeds[image][sample][level]``
        replaces the draw), then channel means;
      'FC': the mean over the feature axis of ``out.latent``; an image whose
        proposal count is not 1000 is skipped, as in the reference.
    Returns (n_images * S, d) samples (and the raw predictions' non-background
    logit means), tensors.
    """
    assert layer_type in ("FC", "Conv", "RPN", "backbone"), (
        "Layer type must be either 'FC','backbone', 'RPN' or 'Conv'"
    )
    dl_samples, raw_predictions = [], []
    for i, image in enumerate(data_loader):
        img_samples = []
        keep_image = True
        for s in range(mcd_nro_samples):
            out: RCNNOutput = model(image, generator)
            if return_raw_predictions:
                raw_predictions.append(as_tensor(out.inter_feat, device)[:, :-1].mean(0))
            if layer_type == "Conv":
                sample = _channel_means(as_tensor(out.latent, device, torch.float32))
            elif layer_type == "RPN":
                sample = _reduce_rpn(out.rpn_feats, device)
            elif layer_type == "backbone":
                parts = []
                for j, v in enumerate(out.backbone_feats.values()):
                    noised = dropblock2d(as_tensor(v, device, torch.float32), dropblock_prob, dropblock_size,
                                         channel_axis=1, generator=generator,
                                         seed=None if seeds is None else seeds[i][s][j])
                    parts.append(_channel_means(noised))
                sample = torch.cat(parts)
            else:  # FC: (n_proposals, d) -> the mean over the feature axis
                latent = as_tensor(out.latent, device, torch.float32)
                if latent.shape[0] != 1000:
                    keep_image = False
                    print(f"Omitted image: {i}")
                    break
                sample = latent.mean(1)
            img_samples.append(sample)
        if keep_image:
            dl_samples.append(torch.stack(img_samples))
    stacked = torch.cat(dl_samples)
    if return_raw_predictions:
        return stacked, torch.stack(raw_predictions)
    return stacked


class LaRexInferenceRCNN(LaRExInference):
    """LaREx inference for adapted RCNNs: the MC sampler runs on the RPN
    intermediate maps the model returns."""

    def __init__(self, model, postprocessor, drop_block_prob, drop_block_size, mcd_samples_nro,
                 mcd_sampler=MCSamplerRCNN, pca_transform=None, layer_type="RPN",
                 generator: Optional[torch.Generator] = None, **kwargs):
        self.model = model
        self.postprocessor = postprocessor
        self.drop_block_prob = drop_block_prob
        self.drop_block_size = drop_block_size
        self.mcd_samples_nro = mcd_samples_nro
        self.layer_type = layer_type
        self.pca_transform = pca_transform
        self.mc_sampler = MCSamplerRCNN(mc_samples=mcd_samples_nro, block_size=drop_block_size,
                                        drop_prob=drop_block_prob, generator=generator)

    def _score(self, mc_samples: torch.Tensor):
        _, sample_h_z = get_dl_h_z(mc_samples, self.mcd_samples_nro)
        if self.pca_transform is not None:
            sample_h_z = apply_pca_transform(sample_h_z, self.pca_transform)
        return self.postprocessor.postprocess(sample_h_z)

    @torch.inference_mode()
    def get_score(self, input_image, layer_hook=None, seeds: Optional[Seeds] = None):
        out: RCNNOutput = self.model(input_image)
        return out, self._score(self.mc_sampler(out.rpn_feats, seeds))

    @record_time
    @torch.inference_mode()
    def get_layer_mc_samples(self, input_image, layer_hook=None):
        out: RCNNOutput = self.model(input_image)
        return self.mc_sampler(out.rpn_feats)

    @record_time
    @torch.inference_mode()
    def get_score_full_inference(self, input_image, layer_hook=None, seeds: Optional[Seeds] = None):
        """The slow twin: ``mcd_samples_nro`` whole forwards, one DropBlock
        each (``seeds[i]``: forward i's one-sample seeds)."""
        mc_samples, out = [], None
        for i in range(self.mcd_samples_nro):
            out = self.model(input_image)
            mc_samples.append(self.mc_sampler(out.rpn_feats, None if seeds is None else seeds[i])[0])
        return out, self._score(torch.stack(mc_samples))


class LaRDInferenceRCNN(LaRDInference):
    """LaRD inference for adapted RCNNs."""

    def __init__(self, model, postprocessor, pca_transform=None, layer_type="Conv"):
        super().__init__(model, postprocessor, pca_transform, layer_type)
        self.layer_type = layer_type

    @torch.inference_mode()
    def get_score(self, input_image, layer_hook=None, device=None):
        out: RCNNOutput = self.model(input_image)
        if self.layer_type == "RPN":
            latent_rep = _reduce_rpn(out.rpn_feats, device).reshape(1, -1)
        else:
            latent_rep = self._reduce(as_tensor(out.latent, device))
        if self.pca_transform is not None:
            latent_rep = apply_pca_transform(latent_rep, self.pca_transform)
        return out, self.postprocessor.postprocess(latent_rep)


def remove_background_dimension(
    fc_params: Dict, ind_data_dict: Dict[str, Any], ood_data_dict: Dict[str, Any], ood_names: List[str]
) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """Strip the RCNN background column from 21- or 11-wide logits and fc
    parameters; arrays and tensors keep their type."""
    w, b = fc_params["weight"], fc_params["bias"]
    if w.shape[0] in (21, 11):
        w = w[:-1, :]
    if b.shape[0] in (21, 11):
        b = b[:-1]
    fc_params["weight"] = w
    fc_params["bias"] = b
    for split in ("train logits", "valid logits"):
        if ind_data_dict[split].shape[-1] in (21, 11):
            ind_data_dict[split] = ind_data_dict[split][:, :-1]
    for ood_dataset in ood_names:
        if ood_data_dict[f"{ood_dataset} logits"].shape[-1] in (21, 11):
            ood_data_dict[f"{ood_dataset} logits"] = ood_data_dict[f"{ood_dataset} logits"][:, :-1]
    return ind_data_dict, ood_data_dict, fc_params
