"""Object-level feature extraction: per-detection features by ROIAlign.

Counterpart of ``runia_core_tpu/extraction/object_level.py``. The adapted
detection model returns a ``DetectionResult`` (``extraction/adapters.py``);
each detection's features are the channel means of its ROIAlign bins
(``ops/roi_align.py``: the CUDA kernel on the card, which writes only the
means unless the standard deviations or the MC route need the bins), and
the MC-DropBlock route samples every detection's pooled ROI at once and
takes the per-dimension KL entropies through ``get_dl_h_z`` (kernel 1).

The extractor draws its DropBlock masks from a ``torch.Generator``
(``generator=``) where the JAX package derives a key per call.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from runia_core_tpu_torch.evaluation.entropy import get_dl_h_z
from runia_core_tpu_torch.extraction.adapters import (
    SUPPORTED_OBJECT_DETECTION_ARCHITECTURES,
    DetectionResult,
    postprocess_architecture_taps,
)
from runia_core_tpu_torch.ops.roi_align import roi_align_nhwc
from runia_core_tpu_torch.sampling import MCSamplerModule
from runia_core_tpu_torch.utils.placement import as_tensor, to_numpy

__all__ = ["BoxFeaturesExtractor", "_dropblock_rois_get_entropy", "_reduce_features_to_rois"]


def _pool(fmap, boxes, output_size: int, img_shape, sampling_ratio: int, mean: bool, device=None) -> torch.Tensor:
    """ROIAlign of ``boxes`` over one (1, C, H, W) map (a tensor stays on its
    device, an array goes to ``device``): (N, C, o, o), or (N, C) means."""
    fmap = as_tensor(fmap, device)
    if fmap.ndim == 3:
        fmap = fmap[None]
    nhwc = fmap.permute(0, 2, 3, 1)  # a channels-last map's NCHW view: no copy
    scale = fmap.shape[3] / img_shape[1]
    return roi_align_nhwc(nhwc, as_tensor(boxes, fmap.device, torch.float32), int(output_size), scale,
                          sampling_ratio, True, mean=mean)


def _reduce_features_to_rois(
    latent_mcd_sample: List[Any],
    output_sizes,
    boxes,
    img_shape: Tuple[int, int],
    sampling_ratio: int,
    n_hooked_reps: int,
    n_detected_objects: int,
    return_stds: bool = False,
    device=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """ROIAlign each hooked (1, C_j, H_j, W_j) map with spatial scale
    fmap_W / img_W, aligned; each object's channel means (and standard
    deviations over the bins, ddof 1), concatenated over the maps.

    Returns:
        (means (N, sum_C), stds (N, sum_C) or None), on the maps' device.
    """
    del n_detected_objects
    means, stds = [], []
    for j in range(n_hooked_reps):
        if not return_stds:
            means.append(_pool(latent_mcd_sample[j], boxes, output_sizes[j], img_shape, sampling_ratio, True, device))
            continue
        rois = _pool(latent_mcd_sample[j], boxes, output_sizes[j], img_shape, sampling_ratio, False, device)
        means.append(rois.mean(dim=(2, 3)))
        stds.append(torch.std(rois.reshape(rois.shape[0], rois.shape[1], -1), dim=2, correction=1))
    return torch.cat(means, dim=1), (torch.cat(stds, dim=1) if return_stds else None)


def _dropblock_rois_get_entropy(
    latent_mcd_sample: List[Any],
    output_sizes,
    boxes,
    img_shape: Tuple[int, int],
    sampling_ratio: int,
    n_hooked_reps: int,
    n_mcd_steps: int,
    mc_sampler: MCSamplerModule,
    weights: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """MC-DropBlock the pooled ROIs of every detection at once and return
    their per-dimension KL entropies (N, C), through ``get_dl_h_z`` (kernel 1
    on the card). ``weights`` (N, S, o*o) replaces the sampler's drawn
    keep-weights (tests inject the JAX package's)."""
    rois = [_pool(latent_mcd_sample[i], boxes, output_sizes[i], img_shape, sampling_ratio, False, device)
            for i in range(n_hooked_reps)]
    rois = torch.cat(rois, dim=1) if len(rois) > 1 else rois[0]  # (N, C, o, o)
    samples = mc_sampler(rois.to(torch.float32), weights=weights)  # (N, S, C)
    if samples.ndim == 2:  # one detection: the sampler squeezes it
        samples = samples[None]
    n, s, d = samples.shape
    _, entropies = get_dl_h_z(samples.reshape(n * s, d), mcd_samples_nro=n_mcd_steps)
    return entropies


class BoxFeaturesExtractor:
    """Per-detection latent features of an object detector.

    ``get_ls_samples`` iterates a loader and returns per-image dicts of
    latent_space_means / features / logits / boxes (numpy) and a 'no_obj'
    list; ``_get_samples_one_image`` is the online path the inference
    classes reuse. The model is an adapted callable returning a
    ``DetectionResult``; its feature maps stay on its device, where the
    ROIAlign runs. ``generator`` feeds the MC-DropBlock masks of
    ``extract_noise_entropies`` (None: PyTorch's default generator of the
    maps' device).
    """

    def __init__(
        self,
        model,
        architecture: str,
        roi_output_sizes,
        hooked_layers=None,
        device=None,
        return_raw_predictions: bool = False,
        return_stds: bool = False,
        mcd_nro_samples: int = 1,
        hook_layer_output: bool = True,
        dropblock_probs: Union[float, List] = 0.0,
        dropblock_sizes: Union[int, List] = 0,
        rcnn_extraction_type: str = None,
        extract_noise_entropies: bool = False,
        roi_sampling_ratio: int = -1,
        generator: Optional[torch.Generator] = None,
    ):
        assert (
            architecture in SUPPORTED_OBJECT_DETECTION_ARCHITECTURES
        ), f"Only {SUPPORTED_OBJECT_DETECTION_ARCHITECTURES} are supported"
        assert rcnn_extraction_type in ("rpn_inter", "rpn_head", "shortcut", "backbone", None)
        self.model = model
        self.architecture = architecture
        self.device = device
        self.rcnn_extraction_type = rcnn_extraction_type
        self.return_raw_predictions = return_raw_predictions
        self.return_stds = return_stds
        self.mcd_nro_samples = mcd_nro_samples
        self.dropblock_probs = dropblock_probs
        self.dropblock_sizes = dropblock_sizes
        self.roi_output_sizes = list(roi_output_sizes)
        self.roi_sampling_ratio = roi_sampling_ratio
        self.n_hooked_reps = len(self.roi_output_sizes)
        # RCNN pyramid modes give five feature levels.
        if self.architecture == "rcnn" and self.rcnn_extraction_type != "shortcut":
            self.roi_output_sizes = self.roi_output_sizes * 5
            self.n_hooked_reps = 5
        self.extract_noise_entropies = extract_noise_entropies
        if self.extract_noise_entropies:
            self.mc_sampler = MCSamplerModule(
                mc_samples=self.mcd_nro_samples,
                block_size=self.dropblock_sizes,
                drop_prob=self.dropblock_probs,
                layer_type="Conv",
                generator=generator,
            )

    @staticmethod
    def unpack_dataloader(loader_contents) -> Tuple[List[str], Any, Any]:
        """A loader item as (impath_list, image, im_id): an (impath, image,
        im_id) tuple, or a dict with 'image' / 'image_id' (and an optional
        'file_name')."""
        if isinstance(loader_contents, dict):
            image = loader_contents["image"]
            im_id = loader_contents.get("image_id", loader_contents.get("file_name"))
            impath = [loader_contents.get("file_name", str(im_id))]
            return impath, image, im_id
        impath, image, im_id = loader_contents
        if isinstance(impath, str):
            impath = [impath]
        return impath, image, im_id

    @torch.inference_mode()
    def _get_samples_one_image(self, image, predict_conf: float, weights: Optional[torch.Tensor] = None,
                               **kwargs) -> Tuple[Dict[str, Any], bool]:
        """Run the adapted model on one image and pool each detection's
        features; an image with no detection is pooled as one whole-image
        box. ``weights`` replaces the MC route's drawn keep-weights."""
        found_objs_flag = True
        det: DetectionResult = self.model(image, predict_conf, **kwargs)
        results: Dict[str, Any] = {}
        if det.logits is not None:
            results["logits"] = np.asarray(det.logits)
        if det.features is not None:
            results["features"] = np.asarray(det.features)

        boxes = np.asarray(det.boxes, dtype=np.float32).reshape(-1, 4)
        img_shape = det.img_shape
        n_detected_objects = boxes.shape[0]
        if n_detected_objects == 0:
            boxes = np.array([[0.0, 0.0, img_shape[1], img_shape[0]]], dtype=np.float32)
            n_detected_objects = 1
            found_objs_flag = False

        latent_sample = postprocess_architecture_taps(
            self.architecture, det.fmaps, self.rcnn_extraction_type, device=self.device
        )
        if len(latent_sample) > 0:
            if not self.extract_noise_entropies:
                means, stds = _reduce_features_to_rois(
                    latent_mcd_sample=latent_sample,
                    output_sizes=self.roi_output_sizes,
                    boxes=boxes,
                    img_shape=img_shape,
                    sampling_ratio=self.roi_sampling_ratio,
                    n_hooked_reps=self.n_hooked_reps,
                    n_detected_objects=n_detected_objects,
                    return_stds=self.return_stds,
                )
                results["latent_space_means"] = to_numpy(means)
                if self.return_stds:
                    results["stds"] = to_numpy(stds)
            else:
                results["latent_space_means"] = to_numpy(_dropblock_rois_get_entropy(
                    latent_mcd_sample=latent_sample,
                    output_sizes=self.roi_output_sizes,
                    boxes=boxes,
                    img_shape=img_shape,
                    sampling_ratio=self.roi_sampling_ratio,
                    n_hooked_reps=self.n_hooked_reps,
                    n_mcd_steps=self.mcd_nro_samples,
                    mc_sampler=self.mc_sampler,
                    weights=weights,
                ))
        else:
            results["latent_space_means"] = []
        results["boxes"] = boxes
        if self.return_raw_predictions:
            results["raw_preds"] = det
        return results, found_objs_flag

    def get_ls_samples(self, data_loader: Iterable, predict_conf: float = 0.25, **kwargs) -> Dict:
        """Per-detection features of a whole dataset: {im_id:
        {latent_space_means, features, logits, boxes}, ..., 'no_obj':
        [paths]}, the layout ``get_aggregated_data_dict`` and
        ``calculate_all_baselines`` read."""
        results: Dict[Any, Dict] = {}
        no_obj_imgs: List[str] = []
        for loader_contents in data_loader:
            impath, image, im_id = self.unpack_dataloader(loader_contents)
            result_img, found_obj_flag = self._get_samples_one_image(image=image, predict_conf=predict_conf,
                                                                     **kwargs)
            results[im_id] = {"latent_space_means": [], "features": [], "logits": [], "boxes": []}
            if found_obj_flag:
                for result_type, result_value in result_img.items():
                    if result_type == "raw_preds":
                        results[im_id][result_type] = result_value
                    else:
                        results[im_id][result_type] = np.asarray(result_value)
            else:
                no_obj_imgs.append(impath[0])
        results["no_obj"] = no_obj_imgs
        print(f"No objects in {len(no_obj_imgs)} images")
        return results
