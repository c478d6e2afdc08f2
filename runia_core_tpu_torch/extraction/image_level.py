"""Image-level MC-dropout latent extractors, batch-first, in PyTorch.

Counterpart of ``runia_core_tpu/extraction/image_level.py``. The model is a
tapped forward, ``images -> (outputs, {tap: activation})``
(``extraction.taps.tap_torch_model`` or ``models.build_tapped_forward``),
and loaders may yield any batch size:

* :class:`FastMCDSamplesExtractor` runs the model once per batch and draws
  the S DropBlock (Conv) or dropout (FC) samples on the cached activation
  (``sampling.mc_dropblock_samples``);
* :class:`MCDSamplesExtractor` runs S stochastic forwards per batch,
  ``model(images, generator)``.

``latent_space_means`` is (n_images * S, d), each image's S samples
contiguous, which is what ``evaluation.get_dl_h_z`` takes. Results stay
tensors on the model's device, so the entropies (kernel 1 on a GPU) follow
without a copy to the host; samples are formed in f32 whatever the
forward's dtype. Each extractor keeps a generator (``generator``, or one
seeded 0 on the device of the first batch), which every batch draws from in
turn: the counterpart of the JAX package's ``fold_in(rng, step)``.
:class:`ImageLvlFeatureExtractor` runs an adapted object detector
(``extraction/adapters.py``) and keeps one whole-image feature row per
image: each captured map's channel means.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union
from warnings import warn

import numpy as np
import torch
import torch.nn.functional as F

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.extraction.adapters import SUPPORTED_OBJECT_DETECTION_ARCHITECTURES, postprocess_architecture_taps
from runia_core_tpu_torch.extraction.object_level import BoxFeaturesExtractor
from runia_core_tpu_torch.ops.dropblock import dropout
from runia_core_tpu_torch.ops.mc_entropy_cuda import mc_dropblock_weights
from runia_core_tpu_torch.sampling import mc_dropblock_samples
from runia_core_tpu_torch.utils.placement import to_numpy

__all__ = [
    "FastMCDSamplesExtractor",
    "ImageLvlFeatureExtractor",
    "MCDSamplesExtractor",
    "deeplabv3p_get_ls_mcd_samples",
    "get_latent_representation_mcd_samples",
]

# Per batch, per tapped layer: a Conv layer's keep-weights (B, S, H*W) or an
# FC layer's keep mask (B, S, d).
Draws = Sequence[Sequence[torch.Tensor]]


class _ExtractorBase:
    """The extractors' common configuration. ``device`` (None: the GPU) is
    where the loader's images are moved before the model sees them."""

    def __init__(
        self,
        model: Callable,
        layer_type: str,
        reduction_method: str,
        tap: Union[str, List[str]] = "pre_pool",
        channel_axis: int = 3,
        return_raw_predictions: bool = False,
        return_stds: bool = False,
        mcd_nro_samples: int = 1,
        dropblock_probs: Union[float, List[float]] = 0.0,
        dropblock_sizes: Union[int, List[int]] = 0,
        return_gt_labels: bool = False,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        if layer_type not in ("FC", "Conv"):
            raise ValueError("Layer type must be either 'FC' or 'Conv'")
        self.model = model
        self.layer_type = layer_type
        self.reduction_method = reduction_method
        self.tap = tap
        self.channel_axis = channel_axis
        self.return_raw_predictions = return_raw_predictions
        self.return_stds = return_stds
        self.mcd_nro_samples = mcd_nro_samples
        self.return_gt_labels = return_gt_labels
        if isinstance(dropblock_probs, (list, tuple)):
            self.dropblock_probs = list(dropblock_probs)
            self.dropblock_sizes = list(dropblock_sizes)
        else:
            self.dropblock_probs = [dropblock_probs]
            self.dropblock_sizes = [dropblock_sizes]
        self.dropout_n_layers = len(self.dropblock_probs)
        self.generator = generator
        self.device = default_device() if device is None else torch.device(device)

    def _generator_on(self, device: torch.device) -> torch.Generator:
        if self.generator is None:
            self.generator = torch.Generator(device=device).manual_seed(0)
        return self.generator

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(images, device=self.device)


def _std_hw(noised: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """(B, S, ...) noised maps -> (B, S, C): the std over W, then the std of
    those over H, ddof=1 each."""
    if channel_axis == 1:  # (B, S, C, H, W)
        return noised.std(dim=4, correction=1).std(dim=3, correction=1)
    return noised.std(dim=3, correction=1).std(dim=2, correction=1)  # (B, S, H, W, C)


class FastMCDSamplesExtractor(_ExtractorBase):
    """One forward per batch, then DropBlock (Conv) or dropout (FC) samples
    of the cached activation.

    Multi-layer taps: ``tap`` a list of tap names with matching
    ``dropblock_probs`` / ``dropblock_sizes`` lists; each sample's features
    are concatenated across layers. A Conv layer's ``return_stds`` uses the
    same keep-weights as its means.
    """

    def __init__(self, model, layer_type, reduction_method, tap="pre_pool", **kwargs):
        super().__init__(model, layer_type, reduction_method, tap=tap, **kwargs)
        if reduction_method not in ("mean", "fullmean"):
            raise ValueError("Only mean and fullmean reduction methods supported")
        if self.return_stds and layer_type == "FC":
            raise ValueError("return_stds is only supported for layer_type='Conv'")
        self.taps = [self.tap] if isinstance(self.tap, str) else list(self.tap)
        if len(self.taps) == 1 and self.dropout_n_layers > 1:
            self.taps = self.taps * self.dropout_n_layers

    def _draw(self, latent: torch.Tensor, i: int) -> torch.Tensor:
        """Layer i's draw for one batch: Conv keep-weights or an FC keep mask."""
        gen, s = self._generator_on(latent.device), self.mcd_nro_samples
        if self.layer_type == "Conv":
            b, h, w = (latent.shape[0], *latent.shape[2:]) if self.channel_axis == 1 else latent.shape[:3]
            return mc_dropblock_weights(b, h, w, s, self.dropblock_sizes[i], self.dropblock_probs[i], gen,
                                        latent.device)
        shape = (latent.shape[0], s, *latent.shape[1:])
        return torch.rand(shape, generator=gen, device=latent.device) < 1.0 - self.dropblock_probs[i]

    def _sample_batch(self, taps: Dict[str, torch.Tensor],
                      draws: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        means, stds = [], []
        for i in range(self.dropout_n_layers):
            latent = taps[self.taps[i]].to(torch.float32)
            draw = self._draw(latent, i) if draws is None else draws[i].to(latent.device)
            if self.layer_type == "Conv":
                means.append(mc_dropblock_samples(
                    latent, self.mcd_nro_samples, self.dropblock_sizes[i], self.dropblock_probs[i], "Conv",
                    reduction=self.reduction_method, channel_axis=self.channel_axis, weights=draw,
                ))
                if self.return_stds:  # the same noised maps, whole: (B, S, C, H, W) or (B, S, H, W, C)
                    noised = mc_dropblock_samples(
                        latent, self.mcd_nro_samples, self.dropblock_sizes[i], self.dropblock_probs[i], "FC",
                        channel_axis=self.channel_axis, weights=draw,
                    ).reshape(latent.shape[0], self.mcd_nro_samples, *latent.shape[1:])
                    stds.append(_std_hw(noised, self.channel_axis))
            else:  # FC: dropout on the (B, d) activation, S times
                expanded = latent[:, None].expand(-1, self.mcd_nro_samples, *latent.shape[1:])
                means.append(dropout(expanded, self.dropblock_probs[i], keep=draw))
        out = {"latent_space_means": torch.cat(means, dim=-1)}
        if self.return_stds:
            out["stds"] = torch.cat(stds, dim=-1)
        return out

    def get_ls_samples(self, data_loader: Iterable, draws: Optional[Draws] = None, **kwargs) -> Dict[str, torch.Tensor]:
        """MC latent samples of a whole dataset.

        Args:
            data_loader: iterable of (images, labels) batches; images are
                (B, H, W, C) for the port's ResNets.
            draws: per batch, per layer, the draw that replaces the
                generator's (Conv keep-weights (B, S, H*W), FC keep masks
                (B, S, d)); tests inject the JAX package's.

        Returns:
            {'latent_space_means': (n_images * S, d)} and, as asked,
            'stds' (n_images * S, C), 'raw_preds' (n_images, ...) and
            'gt_labels' (n_images,), tensors on the model's device.
        """
        results: Dict[str, list] = {"latent_space_means": []}
        for key, wanted in (("raw_preds", self.return_raw_predictions), ("stds", self.return_stds),
                            ("gt_labels", self.return_gt_labels)):
            if wanted:
                results[key] = []
        for step, (images, gt_labels) in enumerate(data_loader):
            outputs, taps = self.model(self._images(images))
            batch = self._sample_batch(taps, None if draws is None else draws[step])
            b, s, d = batch["latent_space_means"].shape
            results["latent_space_means"].append(batch["latent_space_means"].reshape(b * s, d))
            if self.return_stds:
                results["stds"].append(batch["stds"].reshape(b * s, -1))
            if self.return_raw_predictions:
                results["raw_preds"].append(outputs.to(torch.float32))
            if self.return_gt_labels:
                results["gt_labels"].append(
                    torch.as_tensor(gt_labels).reshape(-1).to(batch["latent_space_means"].device))
        out = {key: torch.cat(values, dim=0) for key, values in results.items()}
        print("Latent representation vector size: ", out["latent_space_means"].shape[1])
        return out


class MCDSamplesExtractor(_ExtractorBase):
    """Classic MC dropout: S stochastic forwards per batch. The model takes
    the generator it draws from: ``model(images, generator) -> (outputs,
    taps)``, with its dropout active."""

    def __init__(self, model, layer_type, reduction_method, tap="pre_pool", avg_pooling_parameters=None, **kwargs):
        super().__init__(model, layer_type, reduction_method, tap=tap, **kwargs)
        if reduction_method not in ("mean", "fullmean", "avgpool"):
            raise ValueError("Only mean, fullmean and avg pool reduction methods supported")
        if avg_pooling_parameters is not None and len(avg_pooling_parameters) != 3:
            raise ValueError("Three parameters are needed for average pooling")
        self.avg_pooling_parameters = avg_pooling_parameters

    def _reduce(self, latent: torch.Tensor) -> torch.Tensor:
        latent = latent.to(torch.float32)
        if self.layer_type != "Conv":
            return latent.reshape(latent.shape[0], -1)
        if self.reduction_method == "fullmean":
            return latent.mean(dim=(2, 3) if self.channel_axis == 1 else (1, 2))
        if self.reduction_method == "mean":
            if self.channel_axis == 1:
                return latent.mean(dim=3).reshape(latent.shape[0], -1)
            # NHWC: (B, H, C) -> (B, C, H) before flattening, so the columns
            # are C-major as on the NCHW path and in sampling.py.
            return latent.mean(dim=2).transpose(1, 2).reshape(latent.shape[0], -1)
        # avgpool: zero padding counted, the divisor always k * k
        k, s, p = self.avg_pooling_parameters
        if self.channel_axis == 1:
            return F.avg_pool2d(latent, k, s, p, count_include_pad=True).reshape(latent.shape[0], -1)
        pooled = F.avg_pool2d(latent.permute(0, 3, 1, 2), k, s, p, count_include_pad=True)
        return pooled.permute(0, 2, 3, 1).reshape(latent.shape[0], -1)

    def get_ls_samples(self, data_loader: Iterable, **kwargs):
        """(n_images * S, d) samples, each image's S rows contiguous; with
        ``return_raw_predictions`` also the (n_images * S, ...) outputs."""
        samples, raw = [], []
        for images, _ in data_loader:
            images = self._images(images)
            gen = self._generator_on(images.device)
            reduced, outputs = [], []
            for _ in range(self.mcd_nro_samples):
                out, taps = self.model(images, gen)
                reduced.append(self._reduce(taps[self.tap]))
                outputs.append(out)
            b = images.shape[0]
            samples.append(torch.stack(reduced, dim=1).reshape(b * self.mcd_nro_samples, -1))
            if self.return_raw_predictions:
                raw.append(torch.stack(outputs, dim=1).reshape(b * self.mcd_nro_samples, -1).to(torch.float32))
        stacked = torch.cat(samples, dim=0)
        print("MCD N_samples: ", stacked.shape[1])
        if self.return_raw_predictions:
            return stacked, torch.cat(raw, dim=0)
        return stacked


def deeplabv3p_get_ls_mcd_samples(
    model_module: Callable,
    dataloader: Iterable,
    mcd_nro_samples: int,
    hook_dropout_layer: str = "pre_pool",
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Deprecated reference-named helper: classic MC-dropout extraction from
    a segmentation model's dropout-layer tap."""
    warn("This method is deprecated. Use one of the Extractor classes instead", DeprecationWarning, stacklevel=2)
    extractor = MCDSamplesExtractor(
        model=model_module, layer_type="Conv", reduction_method="fullmean", tap=hook_dropout_layer,
        mcd_nro_samples=mcd_nro_samples, generator=generator, device=device,
    )
    return extractor.get_ls_samples(dataloader)


def get_latent_representation_mcd_samples(
    dnn_model: Callable,
    dataloader: Iterable,
    mcd_nro_samples: int,
    layer_hook: str,
    layer_type: str,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Deprecated reference-named helper: classic MC-dropout extraction with
    a stochastic tapped model."""
    warn("This method is deprecated. Use one of the Extractor classes instead", DeprecationWarning, stacklevel=2)
    if layer_type not in ("FC", "Conv"):
        raise ValueError("Layer type must be either 'FC' or 'Conv'")
    extractor = MCDSamplesExtractor(
        model=dnn_model, layer_type=layer_type, reduction_method="fullmean" if layer_type == "Conv" else "mean",
        tap=layer_hook, mcd_nro_samples=mcd_nro_samples, generator=generator, device=device,
    )
    return extractor.get_ls_samples(dataloader)


class ImageLvlFeatureExtractor:
    """Whole-image latent features of an object detector: run the adapted
    model, reduce each captured (1, C, H, W) map to its channel means and
    concatenate them, one row per image, beside the per-detection logits and
    features the architecture gives; images with no detection go to
    'no_obj'. Results are numpy, as in the JAX package. ``device`` is where
    array maps go (None: the GPU)."""

    def __init__(
        self,
        model: Callable,
        architecture: str,
        rcnn_extraction_type: Optional[str] = None,
        return_raw_predictions: bool = False,
        return_stds: bool = False,
        device=None,
    ):
        assert architecture in SUPPORTED_OBJECT_DETECTION_ARCHITECTURES, (
            f"Only {SUPPORTED_OBJECT_DETECTION_ARCHITECTURES} are supported"
        )
        self.model = model
        self.architecture = architecture
        self.rcnn_extraction_type = rcnn_extraction_type
        self.return_raw_predictions = return_raw_predictions
        self.device = device
        if return_stds:
            raise NotImplementedError  # as the reference

    @torch.inference_mode()
    def _get_samples_one_image(self, image, predict_conf: float, **kwargs):
        det = self.model(image, predict_conf, **kwargs)
        results: Dict[str, object] = {}
        if det.logits is not None:
            results["logits"] = to_numpy(det.logits)
        if det.features is not None:
            results["features"] = to_numpy(det.features)
        found_objs_flag = to_numpy(det.boxes).reshape(-1, 4).shape[0] > 0
        latent_sample = postprocess_architecture_taps(self.architecture, det.fmaps, self.rcnn_extraction_type,
                                                      device=self.device)
        reduced = [to_numpy(t.mean(dim=(2, 3))).reshape(1, -1) for t in latent_sample]
        results["latent_space_means"] = np.concatenate(reduced, axis=1)
        if self.return_raw_predictions:
            results["raw_preds"] = det
        return results, found_objs_flag

    def get_ls_samples(self, data_loader: Iterable, predict_conf: float = 0.25, **kwargs) -> Dict:
        results: Dict[str, list] = {"latent_space_means": [], "features": [], "logits": []}
        no_obj_imgs = []
        for loader_contents in data_loader:
            impath, image, im_id = BoxFeaturesExtractor.unpack_dataloader(loader_contents)
            result_img, found_obj_flag = self._get_samples_one_image(image=image, predict_conf=predict_conf,
                                                                     **kwargs)
            for result_type, result_value in result_img.items():
                if result_type in results:
                    results[result_type].append(result_value)
            if not found_obj_flag:
                no_obj_imgs.append(impath[0])
        out = {k: (np.concatenate(v, axis=0) if len(v) > 0 else v) for k, v in results.items()}
        out["no_obj"] = no_obj_imgs
        print("Latent representation vector size: ", out["latent_space_means"].shape[1])
        print(f"No objects in {len(no_obj_imgs)} images")
        return out
