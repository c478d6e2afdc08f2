"""Online object-level OoD inference, in PyTorch.

Counterpart of ``runia_core_tpu/inference/object_level.py``.
:class:`ObjectLevelInference` scores every detection of an adapted model
through ``BoxFeaturesExtractor``'s per-image path; :class:`BoxInferenceYolo`
also rewrites the detections whose score falls below a threshold to an
"OOD" class, in a new ``DetectionResult`` with the scores attached (the
reference mutates ultralytics ``Boxes``). The features, PCA and scores stay
tensors on the model's device; the result's host fields are numpy.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from runia_core_tpu_torch.detectors import postprocessors_dict
from runia_core_tpu_torch.detectors.base import record_time
from runia_core_tpu_torch.extraction.adapters import DetectionResult
from runia_core_tpu_torch.extraction.object_level import BoxFeaturesExtractor, _reduce_features_to_rois
from runia_core_tpu_torch.reduction import apply_pca_ds_split, apply_pca_transform
from runia_core_tpu_torch.utils.placement import to_numpy

__all__ = ["BoxInferenceYolo", "ObjectLevelInference", "adjust_predictions_faster_rcnn"]


class BoxInferenceYolo:
    """Online YOLO-style per-detection OoD scoring with OOD-class rewriting.

    The adapted model returns a ``DetectionResult`` with ``fmaps``.
    ``ind_samples`` (the in-distribution features the postprocessor and the
    optional PCA are fitted on) go to the postprocessor as given: a tensor
    stays on its device, an array goes to the GPU.
    """

    def __init__(
        self,
        model,
        postprocessor,
        postprocessor_type: str,
        ind_samples,
        roi_output_sizes,
        roi_sampling_ratio: int = -1,
        n_pca_components=None,
        ood_class_id: Optional[int] = None,
    ):
        assert (
            postprocessor_type in postprocessors_dict.keys()
        ), f"postprocessor_type must be one of {postprocessors_dict.keys()}"
        self.model = model
        self.pca_transformation = None
        if n_pca_components:
            self.pca_components = n_pca_components
            ind_samples, self.pca_transformation = apply_pca_ds_split(
                samples=ind_samples, nro_components=n_pca_components
            )
        self.postprocessor = postprocessors_dict[postprocessor_type]()
        self.postprocessor.setup(ind_samples)
        self.roi_output_sizes = list(roi_output_sizes)
        self.roi_sampling_ratio = roi_sampling_ratio
        self.ood_class_id = ood_class_id

    @torch.inference_mode()
    def get_score(
        self,
        input_image,
        confidence_score: float,
        layer_hook=None,
        threshold: float = 0.0,
        use_stds: bool = False,
        **kwargs,
    ) -> DetectionResult:
        """Score every detection (the whole image when there is none) and
        rewrite the sub-threshold ones to the OOD class."""
        det: DetectionResult = self.model(input_image, confidence_score, **kwargs)
        img_shape = det.img_shape
        boxes = np.asarray(det.boxes, np.float32).reshape(-1, 4)
        detected_objects_flag = boxes.shape[0] > 0
        if not detected_objects_flag:
            boxes = np.array([[0.0, 0.0, img_shape[1], img_shape[0]]], np.float32)

        latent_rep = det.fmaps if layer_hook is None else layer_hook
        means, stds = _reduce_features_to_rois(
            latent_mcd_sample=latent_rep,
            output_sizes=self.roi_output_sizes,
            boxes=boxes,
            img_shape=img_shape,
            sampling_ratio=self.roi_sampling_ratio,
            n_hooked_reps=len(self.roi_output_sizes),
            n_detected_objects=boxes.shape[0],
            return_stds=use_stds,
        )
        latent = torch.cat([means, stds], dim=1) if use_stds else means
        if self.pca_transformation is not None:
            latent = apply_pca_transform(latent, self.pca_transformation)
        ood_scores = to_numpy(self.postprocessor.postprocess(latent))

        n_names = len(det.extra.get("names", {})) or (
            int(np.max(det.classes)) + 1 if det.classes is not None and len(det.classes) else 1
        )
        ood_id = self.ood_class_id if self.ood_class_id is not None else n_names
        new_classes = (
            np.asarray(det.classes).copy()
            if det.classes is not None and detected_objects_flag
            else np.zeros(boxes.shape[0], dtype=np.int64)
        )
        new_scores = (
            np.asarray(det.scores).copy()
            if det.scores is not None and detected_objects_flag
            else np.full(boxes.shape[0], confidence_score, np.float32)
        )
        new_classes[ood_scores < threshold] = ood_id
        result = DetectionResult(
            boxes=boxes,
            img_shape=img_shape,
            scores=new_scores,
            classes=new_classes,
            logits=det.logits,
            features=det.features,
            fmaps=det.fmaps,
            extra=dict(det.extra),
        )
        result.extra["ood_scores"] = ood_scores
        result.extra["ood_class_id"] = ood_id
        return result

    @record_time
    def test_time_inference(self, **kwargs):
        return self.get_score(**kwargs)


class ObjectLevelInference:
    """Generic online per-detection OoD scoring: ``BoxFeaturesExtractor``'s
    per-image path, then the postprocessor on the configured input(s).
    ``device`` is where array feature maps go (None: the GPU)."""

    def __init__(
        self,
        model,
        postprocessor,
        architecture: str,
        latent_space_method: bool,
        postprocessor_input: List[str],
        roi_output_sizes,
        hooked_layers=None,
        roi_sampling_ratio: int = -1,
        pca_transform=None,
        rcnn_extraction_type: str = None,
        device=None,
    ):
        self.model = model
        self.postprocessor = postprocessor
        self.architecture = architecture
        self.latent_space_method = latent_space_method
        self.postprocessor_input = postprocessor_input
        self.pca_transform = pca_transform
        self.features_extractor = BoxFeaturesExtractor(
            model=model,
            architecture=architecture,
            rcnn_extraction_type=rcnn_extraction_type,
            roi_output_sizes=roi_output_sizes,
            roi_sampling_ratio=roi_sampling_ratio,
            return_raw_predictions=True,
            device=device,
        )

    def get_score(self, input_image, predict_conf, **kwargs):
        """(raw predictions, per-detection scores); no scores when the model
        found nothing."""
        inference_results, found_objects_flag = self.features_extractor._get_samples_one_image(
            input_image, predict_conf, **kwargs
        )
        if self.pca_transform is not None:
            inference_results["latent_space_means"] = apply_pca_transform(
                inference_results["latent_space_means"], self.pca_transform
            )
        if found_objects_flag:
            if len(self.postprocessor_input) == 1:
                confidence_scores = self.postprocessor.postprocess(inference_results[self.postprocessor_input[0]])
            else:
                confidence_scores = self.postprocessor.postprocess(
                    test_data=inference_results[self.postprocessor_input[0]],
                    logits=inference_results[self.postprocessor_input[1]],
                )
        else:
            confidence_scores = []
        return inference_results["raw_preds"], confidence_scores

    def adjust_predictions_faster_rcnn(self, predictions: Any, scores, ood_class_number: int, **kwargs) -> Any:
        """Relabel sub-threshold detections of an RCNN-style prediction
        object (``det_labels``) to the OoD class."""
        return adjust_predictions_faster_rcnn(predictions, scores, ood_class_number, self.postprocessor.threshold)


def adjust_predictions_faster_rcnn(predictions: Any, scores, ood_class_number: int, threshold: float) -> Any:
    """Set ``det_labels[i] = ood_class_number`` where ``scores[i] < threshold``."""
    for i, score in enumerate(scores):
        if score < threshold:
            predictions.det_labels[i] = ood_class_number
    return predictions
