"""Open-set object-detection (OSOD) evaluation, host numpy code.

Counterpart of ``runia_core_tpu/evaluation/open_set.py``: COCO-JSON parsing,
VOC-style AP/precision/recall, and the open-set metrics: WI (wilderness
impact at recall 0.8), AOSE/nOSE (absolute / normalized open-set error),
known/unknown AP/P/R, E_BK, and GTU/UU score splits. This is offline
evaluation on the host; the per-detection walks (greedy TP/FP matching and
the unknown-overlap flags) run in the native matcher
(``csrc/osod_eval.cpp``, built at first use by
``_kernels.osod_matcher``). A matcher that does not build raises; the numpy
loops, its plain version, run only when a caller passes ``native=False``.
pandas is imported where tables are built and matplotlib where figures are
drawn.

Conventions preserved exactly:
  - predictions are stored as formatted strings per class
    "{image_id} {conf:.3f} {xmin+1:.1f} {ymin+1:.1f} {xmax:.1f} {ymax:.1f}
    {method_score:.3f}" (reference open_set.py:296-303);
  - VOC overlaps use the +1 pixel convention (open_set.py:976-993);
  - IoU threshold 0.5, WI at recall level 0.8 (open_set.py:352,511);
  - logits with 21/11 columns drop the RCNN background column before argmax
    (open_set.py:1311-1313).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.special import softmax

from runia_core_tpu_torch import _kernels

__all__ = [
    "COCOParser",
    "OpenSetEvaluator",
    "voc_eval",
    "voc_ap",
    "get_gtu_uu_per_class",
    "convert_xywh_to_xyxy",
    "evaluate_open_set_detection_one_method",
    "get_overall_open_set_results",
    "convert_osod_results_to_pandas_df",
    "convert_osod_results_to_hierarchical_pandas_df",
    "convert_osod_results_for_mlflow_logging",
    "plot_two_osod_datasets_metrics",
    "plot_two_osod_datasets_per_metric",
    "get_boxes_gtu_and_uu_ood_dataset",
    "get_labels_and_scores_from_logits",
    "get_n_unk_ood_dataset",
]


class COCOParser:
    """Minimal COCO-JSON parser (reference open_set.py:26-216)."""

    def __init__(self, anns_file: str, using_subset: Optional[List] = False):
        with open(anns_file, "r") as f:
            coco = json.load(f)
        # Empty/False subset means "keep everything".
        subset = set(using_subset) if using_subset else None
        keep = (lambda image_id: subset is None or image_id in subset)

        self.categories_original = {"categories": coco["categories"]}
        self.licenses_dict = {"licenses": coco["licenses"]} if "licenses" in coco else {}
        self.info_dict = {"info": coco["info"]} if "info" in coco else {}

        # Category records gain a per-subset instance "count" in place (the
        # entries are shared with categories_original, as in the reference).
        self.cat_dict = {}
        for cat in coco["categories"]:
            cat["count"] = 0
            self.cat_dict[cat["id"]] = cat

        self.im_dict = {img["id"]: img for img in coco["images"] if keep(img["id"])}
        self.annIm_dict = defaultdict(list)
        self.annId_dict = {}
        for ann in coco["annotations"]:
            if not keep(ann["image_id"]):
                continue
            self.annIm_dict[ann["image_id"]].append(ann)
            self.annId_dict[ann["id"]] = ann
            self.cat_dict[ann["category_id"]]["count"] += 1

    def get_imgIds(self):
        return list(self.im_dict.keys())

    def get_annIds(self, im_ids) -> List[int]:
        if not isinstance(im_ids, list):
            im_ids = [im_ids]
        ids: List[int] = []
        for im_id in im_ids:
            ids.extend(ann["id"] for ann in self.annIm_dict[im_id])
        return ids

    def load_anns(self, ann_ids) -> List[Dict]:
        ann_ids = ann_ids if isinstance(ann_ids, list) else [ann_ids]
        return [self.annId_dict[ann_id] for ann_id in ann_ids]

    def load_cats(self, class_ids) -> List[Dict]:
        class_ids = class_ids if isinstance(class_ids, list) else [class_ids]
        return [self.cat_dict[class_id] for class_id in class_ids]

    def get_img_info(self, im_ids) -> List[Dict]:
        im_ids = im_ids if isinstance(im_ids, list) else [im_ids]
        return [self.im_dict[im_id] for im_id in im_ids]

    def get_img_ids_per_cat_name(self, cat_name: str) -> List:
        cat_id = [c["id"] for c in self.cat_dict.values() if c["name"] == cat_name][0]
        return list(
            {ann["image_id"] for ann in self.annId_dict.values()
             if ann["category_id"] == cat_id}
        )


def convert_xywh_to_xyxy(bbox: List[float]) -> List[float]:
    """COCO [x, y, w, h] -> [x1, y1, x2, y2]."""
    x1, y1, w, h = bbox
    return [x1, y1, x1 + w, y1 + h]


def _voc_overlaps(gt_boxes: np.ndarray, bb: np.ndarray) -> np.ndarray:
    """IoU of one box vs many, with the VOC +1 pixel convention
    (reference open_set.py:957-993)."""
    ixmin = np.maximum(gt_boxes[:, 0], bb[0])
    iymin = np.maximum(gt_boxes[:, 1], bb[1])
    ixmax = np.minimum(gt_boxes[:, 2], bb[2])
    iymax = np.minimum(gt_boxes[:, 3], bb[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inters = iw * ih
    uni = (
        (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
        + (gt_boxes[:, 2] - gt_boxes[:, 0] + 1.0) * (gt_boxes[:, 3] - gt_boxes[:, 1] + 1.0)
        - inters
    )
    return inters / uni


def _gt_records(
    annotations: COCOParser, classname: Optional[str], is_ood: bool
) -> Tuple[Dict[str, Dict], int]:
    """Ground-truth records per image for one class (classname=None means the
    'unknown' aggregation: every object when is_ood)."""
    recs: Dict[str, Dict] = {}
    count = 0
    for imagename in annotations.annIm_dict.keys():
        if is_ood:
            if classname in (None, "unknown"):
                objs = list(annotations.annIm_dict[imagename])
            else:
                objs = []
        else:
            target = "unknown" if classname is None else classname
            objs = [
                obj
                for obj in annotations.annIm_dict[imagename]
                if annotations.cat_dict[obj["category_id"]]["name"] == target
            ]
        bbox = np.array([convert_xywh_to_xyxy(o["bbox"]) for o in objs])
        difficult = np.zeros(len(objs), dtype=bool)
        count += int((~difficult).sum())
        recs[str(imagename) if isinstance(imagename, int) else imagename] = {
            "bbox": bbox,
            "difficult": difficult,
            "det": [False] * len(objs),
        }
    return recs, count


def _parse_prediction_lines(lines: List[str]):
    """Split the formatted prediction strings and sort by confidence desc."""
    split = [x.strip().split(" ") for x in lines]
    image_ids = [x[0] for x in split]
    if len(image_ids) == 0 or len(image_ids[0]) == 0:
        return [], [], [], []
    confidence = np.array([float(x[1]) for x in split])
    bb = np.array([[float(z) for z in x[2:6]] for x in split]).reshape(-1, 4)
    method_scores = np.array([float(x[6]) for x in split])
    order = np.argsort(-confidence)
    return (
        [image_ids[i] for i in order],
        confidence[order],
        bb[order],
        method_scores[order],
    )


def _flatten_recs(image_ids: List[str], recs: Dict[str, Dict]):
    """Flatten per-image GT record dicts into contiguous tables for the
    native matcher: per-detection image index (-1 if the image has no GT
    record), per-image (offset, count) into a packed (ngt, 4) box array,
    and packed difficult flags."""
    keys = list(recs.keys())
    key_to_idx = {k: i for i, k in enumerate(keys)}
    counts = np.empty(len(keys), dtype=np.int64)
    boxes_list = []
    difficult_list = []
    for i, k in enumerate(keys):
        rec = recs[k]
        box = rec["bbox"]
        n = box.shape[0] if box.size else 0
        counts[i] = n
        if n:
            boxes_list.append(np.ascontiguousarray(box, dtype=np.float64))
            difficult_list.append(
                np.ascontiguousarray(rec["difficult"], dtype=np.uint8)
            )
    offsets = np.zeros(len(keys), dtype=np.int64)
    if len(keys) > 1:
        offsets[1:] = np.cumsum(counts)[:-1]
    gt_boxes = (
        np.concatenate(boxes_list, axis=0)
        if boxes_list
        else np.empty((0, 4), dtype=np.float64)
    )
    gt_difficult = (
        np.concatenate(difficult_list)
        if difficult_list
        else np.empty((0,), dtype=np.uint8)
    )
    det_img_idx = np.fromiter(
        (key_to_idx.get(im, -1) for im in image_ids), dtype=np.int64,
        count=len(image_ids),
    )
    return det_img_idx, offsets, counts, gt_boxes, gt_difficult


def _greedy_match(
    image_ids: List[str],
    bb: np.ndarray,
    class_recs: Dict[str, Dict],
    ovthresh: float,
    npos: int,
    use_07_metric: bool,
    native: bool = True,
):
    """Greedy TP/FP assignment + PR curve + AP (reference open_set.py:793-863).

    The native matcher (csrc/osod_eval.cpp) does the walk; ``native=False``
    runs the numpy loop below, its plain version (tests hold the two equal).
    """
    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    if native and nd:
        det_img_idx, offsets, counts, gt_boxes, gt_difficult = _flatten_recs(
            image_ids, class_recs
        )
        _kernels.osod_matcher().greedy_match(
            det_img_idx, np.ascontiguousarray(bb, dtype=np.float64),
            offsets, counts, gt_boxes, gt_difficult, float(ovthresh), tp, fp,
        )
        return _finish_match(nd, tp, fp, npos, use_07_metric)
    for d in range(nd):
        rec = class_recs.get(image_ids[d])
        if rec is None:
            continue
        box = bb[d].astype(float)
        gt = rec["bbox"].astype(float) if rec["bbox"].size else rec["bbox"]
        ovmax, jmax = -np.inf, -1
        if gt.size > 0:
            overlaps = _voc_overlaps(gt, box)
            jmax = int(np.argmax(overlaps))
            ovmax = overlaps[jmax]
        if ovmax > ovthresh:
            if not rec["difficult"][jmax]:
                if not rec["det"][jmax]:
                    tp[d] = 1.0
                    rec["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0
    return _finish_match(nd, tp, fp, npos, use_07_metric)


def _finish_match(nd, tp, fp, npos, use_07_metric):
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    recall = tp / float(npos) if npos > 0 else tp
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(recall, precision, use_07_metric)
    return nd, recall, precision, ap, tp, fp


def _mark_unknown_overlaps(
    nd: int,
    image_ids: List[str],
    bb: np.ndarray,
    unknown_recs: Dict[str, Dict],
    ovthresh: float,
    native: bool = True,
):
    """Flag detections overlapping an unknown GT object
    (reference open_set.py:909-954); ``native=False``: the numpy loop."""
    is_unk = np.zeros(nd)
    if native and nd:
        det_img_idx, offsets, counts, gt_boxes, _ = _flatten_recs(
            image_ids, unknown_recs
        )
        _kernels.osod_matcher().max_overlap_flags(
            det_img_idx, np.ascontiguousarray(bb, dtype=np.float64),
            offsets, counts, gt_boxes, float(ovthresh),
            min(os.cpu_count() or 1, 16), is_unk,
        )
        return float(np.sum(is_unk)), np.cumsum(is_unk), is_unk
    for d in range(nd):
        rec = unknown_recs.get(image_ids[d])
        if rec is None:
            continue
        gt = rec["bbox"].astype(float) if rec["bbox"].size else rec["bbox"]
        if gt.size > 0 and np.max(_voc_overlaps(gt, bb[d].astype(float))) > ovthresh:
            is_unk[d] = 1.0
    return float(np.sum(is_unk)), np.cumsum(is_unk), is_unk


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """VOC AP: 11-point (2007) or precision-envelope integration
    (reference open_set.py:996-1041)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else float(np.max(prec[rec >= t]))
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    # precision envelope (monotone non-increasing from the right)
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval(
    predictions_per_class: List[str],
    test_annotations: COCOParser,
    classname: str,
    ovthresh: float = 0.5,
    use_07_metric: bool = True,
    is_ood: bool = True,
    native: bool = True,
):
    """Per-class VOC eval + open-set bookkeeping (reference open_set.py:563-628).

    Returns (rec, prec, ap, unk_det_as_known_count, n_unk,
    tp_plus_fp_closed_set, fp_open_set); the last two are None for the
    'unknown' class row.
    """
    class_recs, npos = _gt_records(test_annotations, classname, is_ood)
    image_ids, _confidence, bb, _method_scores = _parse_prediction_lines(
        predictions_per_class
    )
    nd, rec, prec, ap, tp, fp = _greedy_match(
        image_ids, bb, class_recs, ovthresh, npos, use_07_metric, native
    )
    unknown_recs, n_unk = _gt_records(test_annotations, None, is_ood)
    if classname == "unknown":
        return rec, prec, ap, 0, n_unk, None, None
    is_unk_sum, fp_open_set, _ = _mark_unknown_overlaps(
        nd, image_ids, bb, unknown_recs, ovthresh, native
    )
    return rec, prec, ap, is_unk_sum, n_unk, tp + fp, fp_open_set


def get_gtu_uu_per_class(
    predictions_per_class: List[str],
    test_annotations: COCOParser,
    classname: str,
    ovthresh: float = 0.5,
    use_07_metric: bool = True,
    is_ood: bool = True,
    native: bool = True,
):
    """Split one class's detections into GTU (overlap an unknown GT) and UU
    (no overlap) groups (reference open_set.py:631-705)."""
    class_recs, npos = _gt_records(test_annotations, classname, is_ood)
    image_ids, confidence, bb, method_scores = _parse_prediction_lines(
        predictions_per_class
    )
    nd, *_ = _greedy_match(image_ids, bb, class_recs, ovthresh, npos, use_07_metric, native)
    unknown_recs, _ = _gt_records(test_annotations, None, is_ood)
    _, _, is_unk = _mark_unknown_overlaps(nd, image_ids, bb, unknown_recs, ovthresh, native)
    gtu_mask = is_unk == 1
    uu_mask = is_unk == 0
    def pick(mask):
        return {
            "image_ids": [image_ids[i] for i in np.where(mask)[0]],
            "confidence": [confidence[i] for i in np.where(mask)[0]],
            "bboxes": [bb[i] for i in np.where(mask)[0]],
            "method_scores": [method_scores[i] for i in np.where(mask)[0]],
        }
    return pick(gtu_mask), pick(uu_mask)


class OpenSetEvaluator:
    """Open-set detection evaluator (reference open_set.py:219-560).

    Known classes come from the InD ground-truth categories; an extra
    "unknown" class is appended. Detections are accumulated with ``process``
    and scored with ``evaluate``. ``native=False`` matches with the numpy
    loops instead of the native matcher.
    """

    def __init__(self, id_dataset_name: str, ground_truth_annotations_path: str, metric_2007: bool,
                 native: bool = True):
        ground_truth_annotations = COCOParser(ground_truth_annotations_path)
        self._dataset_name = id_dataset_name
        self._class_names = [
            cat["name"] for cat in ground_truth_annotations.cat_dict.values()
        ] + ["unknown"]
        self.total_num_class = len(ground_truth_annotations.cat_dict) + 1
        self.unknown_class_index = self.total_num_class - 1
        self.num_known_classes = len(ground_truth_annotations.cat_dict)
        self.known_classes = self._class_names[: self.num_known_classes]
        self._is_2007 = metric_2007
        self._native = native
        self._predictions = defaultdict(list)

    def reset(self):
        self._predictions = defaultdict(list)

    def process(self, image_id, boxes, softmax_scores, method_scores, classes) -> None:
        """Append formatted detections (+1 x/y offset inverts the VOC loading
        convention, reference open_set.py:296-303)."""
        for box, s_score, cls, m_score in zip(boxes, softmax_scores, classes, method_scores):
            xmin, ymin, xmax, ymax = box
            xmin += 1
            ymin += 1
            self._predictions[cls].append(
                f"{image_id} {s_score:.3f} {xmin:.1f} {ymin:.1f} {xmax:.1f} {ymax:.1f} {m_score:.3f}"
            )

    def _per_class_sweep(self, test_annotations: COCOParser, is_ood: bool):
        """Run voc_eval for every class at IoU 50."""
        predictions = defaultdict(list)
        for clsid, lines in self._predictions.items():
            predictions[clsid].extend(lines)

        state = {
            k: defaultdict(list)
            for k in (
                "aps", "recs", "precs", "all_recs", "all_precs",
                "unk_det_as_knowns", "num_unks", "tp_plus_fp_cs", "fp_os",
            )
        }
        num_unk = 0
        for cls_id, cls_name in enumerate(self._class_names):
            lines = predictions.get(cls_id, [""])
            for thresh in [50]:
                rec, prec, ap, unk_det_as_known, num_unk, tp_plus_fp_cs, fp_os = voc_eval(
                    lines,
                    test_annotations,
                    cls_name,
                    ovthresh=thresh / 100.0,
                    use_07_metric=self._is_2007,
                    is_ood=is_ood,
                    native=self._native,
                )
                state["aps"][thresh].append(ap * 100)
                state["unk_det_as_knowns"][thresh].append(unk_det_as_known)
                state["num_unks"][thresh].append(num_unk)
                state["all_precs"][thresh].append(prec)
                state["all_recs"][thresh].append(rec)
                state["tp_plus_fp_cs"][thresh].append(tp_plus_fp_cs)
                state["fp_os"][thresh].append(fp_os)
                if len(rec) > 0:
                    state["recs"][thresh].append(rec[-1] * 100)
                    state["precs"][thresh].append(prec[-1] * 100)
                else:
                    state["recs"][thresh].append(0)
                    state["precs"][thresh].append(0)
        return state, num_unk

    def evaluate(
        self,
        test_annotations_path: str,
        is_ood: bool,
        get_known_classes_metrics: bool,
        using_subset: Optional[List] = False,
    ) -> Dict[str, float]:
        """mAP + WI@0.8 + AOSE/nOSE + known/unknown AP/P/R (+ E_BK for OoD)
        (reference open_set.py:305-433)."""
        test_annotations = COCOParser(test_annotations_path, using_subset)
        state, num_unk = self._per_class_sweep(test_annotations, is_ood)

        results_2d: Dict[str, float] = {}
        mAP = {iou: np.mean(x) for iou, x in state["aps"].items()}
        if get_known_classes_metrics:
            results_2d["mAP"] = mAP[50]

        wi = self.compute_WI_at_many_recall_level(
            state["all_recs"], state["tp_plus_fp_cs"], state["fp_os"]
        )
        results_2d["WI"] = wi[0.8][50] * 100

        total_unk_as_known = {iou: np.sum(x) for iou, x in state["unk_det_as_knowns"].items()}
        results_2d["AOSE"] = total_unk_as_known[50]
        if num_unk > 0:
            results_2d["nOSE"] = round(total_unk_as_known[50] * 100 / num_unk, 3)
            if is_ood:
                total_fp_ood = 0
                for cls in state["tp_plus_fp_cs"][50]:
                    if cls is not None and len(cls) > 0:
                        total_fp_ood += cls.max()
                # Error of detecting an unlabeled region as a known class
                results_2d["E_BK"] = total_fp_ood - total_unk_as_known[50]
        else:
            results_2d["nOSE"] = 0.0

        if get_known_classes_metrics:
            results_2d.update(
                {
                    "AP_K": np.mean(state["aps"][50][: self.num_known_classes]),
                    "P_K": np.mean(state["precs"][50][: self.num_known_classes]),
                    "R_K": np.mean(state["recs"][50][: self.num_known_classes]),
                }
            )
        results_2d.update(
            {
                "AP_U": np.mean(state["aps"][50][-1]),
                "P_U": np.mean(state["precs"][50][-1]),
                "R_U": np.mean(state["recs"][50][-1]),
            }
        )
        return {metric: round(float(x), 3) for metric, x in results_2d.items()}

    def get_boxes_gtu_uu(
        self,
        test_annotations_path: str,
        is_ood: bool,
        using_subset: Optional[List] = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Method scores split into GTU / UU groups (reference :435-481)."""
        test_annotations = COCOParser(test_annotations_path, using_subset)
        predictions = defaultdict(list)
        for clsid, lines in self._predictions.items():
            predictions[clsid].extend(lines)
        gtus, uus = [], []
        for cls_id, cls_name in enumerate(self._class_names):
            lines = predictions.get(cls_id, [""])
            gtu, uu = get_gtu_uu_per_class(
                lines, test_annotations, cls_name,
                ovthresh=0.5, use_07_metric=self._is_2007, is_ood=is_ood,
                native=self._native,
            )
            gtus.extend(gtu["method_scores"])
            uus.extend(uu["method_scores"])
        return np.array(gtus), np.array(uus)

    def compute_WI_at_many_recall_level(self, recalls, tp_plus_fp_cs, fp_os):
        """WI at recall 0.8 (reference :483-515)."""
        wi_at_recall = {}
        for r in [8]:
            r = r / 10
            wi_at_recall[r] = self.compute_WI_at_a_recall_level(
                recalls, tp_plus_fp_cs, fp_os, recall_level=r
            )
        return wi_at_recall

    def compute_WI_at_a_recall_level(
        self, recalls, tp_plus_fp_cs, fp_os, recall_level: float = 0.5
    ):
        """WI = mean(open-set FP) / mean(TP+FP) over known classes at the
        operating point closest to the recall level (reference :517-560)."""
        wi_at_iou = {}
        for iou, recall in recalls.items():
            tp_plus_fps, fps = [], []
            for cls_id, rec in enumerate(recall):
                if cls_id in range(self.num_known_classes) and len(rec) > 0:
                    index = min(range(len(rec)), key=lambda i: abs(rec[i] - recall_level))
                    tp_plus_fps.append(tp_plus_fp_cs[iou][cls_id][index])
                    fps.append(fp_os[iou][cls_id][index])
            wi_at_iou[iou] = np.mean(fps) / np.mean(tp_plus_fps) if tp_plus_fps else 0
        return wi_at_iou


def get_labels_and_scores_from_logits(logits) -> Tuple[np.ndarray, np.ndarray]:
    """argmax labels + max softmax scores, stripping the RCNN background
    column for 21/11-dim logits (reference open_set.py:1278-1314)."""
    logits = np.asarray(logits)
    scores = softmax(logits, axis=-1)
    if logits.shape[1] == 21 or logits.shape[1] == 11:
        scores = scores[:, :-1]
    pred_classes = np.argmax(scores, axis=-1)
    return pred_classes, scores.max(axis=-1)


def get_boxes_from_precalculated(boxes) -> np.ndarray:
    return np.asarray(boxes)


def _filter_predictions_by_conf_score(
    labels, softmax_scores, boxes, method_scores, min_conf_score
):
    valid = np.where(softmax_scores >= min_conf_score)
    return labels[valid], softmax_scores[valid], boxes[valid], method_scores[valid]


def _fill_evaluator(
    evaluator: OpenSetEvaluator,
    predictions_dict: Dict,
    method_name: str,
    threshold: Optional[float],
    is_open_set_model: bool,
    unk_class_number,
    using_subset,
    min_conf_score,
    tag_unknowns: bool,
) -> None:
    """Feed per-image predictions into the evaluator, optionally relabeling
    sub-threshold detections as unknown."""
    subset = set(using_subset) if using_subset else None
    for im_id, im_pred in predictions_dict.items():
        if subset is None or im_id in subset:
            if len(im_pred["boxes"]) > 0:
                labels, softmax_scores = get_labels_and_scores_from_logits(
                    im_pred["logits"]
                )
                boxes = get_boxes_from_precalculated(im_pred["boxes"])
                method_scores = np.array(predictions_dict[im_id][method_name])
                if tag_unknowns:
                    if not is_open_set_model:
                        unk_boxes = np.where(method_scores < threshold)
                    else:
                        unk_boxes = np.where(labels == unk_class_number)
                    labels[unk_boxes] = evaluator.unknown_class_index
                if min_conf_score is not None:
                    labels, softmax_scores, boxes, method_scores = (
                        _filter_predictions_by_conf_score(
                            labels, softmax_scores, boxes, method_scores, min_conf_score
                        )
                    )
                if len(labels) > 0:
                    evaluator.process(
                        image_id=im_id,
                        boxes=boxes,
                        softmax_scores=softmax_scores,
                        method_scores=method_scores,
                        classes=labels,
                    )


def evaluate_open_set_detection_one_method(
    id_dataset_name: str,
    id_gt_annotations_path: str,
    predictions_dict: Dict,
    method_name: str,
    threshold: float,
    test_gt_annotations_path: str,
    metric_2007: bool,
    evaluating_ood: bool,
    get_known_classes_metrics: bool,
    is_open_set_model: bool,
    unk_class_number=None,
    using_subset: Optional[List] = False,
    min_conf_score: Optional[float] = None,
) -> Dict[str, float]:
    """Evaluate one OoD method's thresholded predictions on one dataset
    (reference open_set.py:1044-1135)."""
    evaluator = OpenSetEvaluator(id_dataset_name, id_gt_annotations_path, metric_2007)
    evaluator.reset()
    _fill_evaluator(
        evaluator, predictions_dict, method_name, threshold, is_open_set_model,
        unk_class_number, using_subset, min_conf_score, tag_unknowns=True,
    )
    return evaluator.evaluate(
        test_gt_annotations_path,
        is_ood=evaluating_ood,
        get_known_classes_metrics=get_known_classes_metrics,
        using_subset=using_subset,
    )


def get_boxes_gtu_and_uu_ood_dataset(
    id_dataset_name: str,
    id_gt_annotations_path: str,
    predictions_dict: Dict,
    method_name: str,
    test_gt_annotations_path: str,
    metric_2007: bool,
    evaluating_ood: bool,
    using_subset: Optional[List] = False,
    min_conf_score: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """GTU/UU method-score split for an OoD dataset (reference :1138-1209)."""
    evaluator = OpenSetEvaluator(id_dataset_name, id_gt_annotations_path, metric_2007)
    evaluator.reset()
    _fill_evaluator(
        evaluator, predictions_dict, method_name, None, False, None,
        using_subset, min_conf_score, tag_unknowns=False,
    )
    return evaluator.get_boxes_gtu_uu(
        test_gt_annotations_path, is_ood=evaluating_ood, using_subset=using_subset
    )


def get_overall_open_set_results(
    ind_dataset_name: str,
    ind_gt_annotations_path: str,
    ind_data_dict: Dict,
    ood_data_dict: Dict,
    ood_datasets_names: List[str],
    ood_annotations_paths: Dict[str, str],
    methods_names: List[str],
    methods_thresholds: Dict[str, float],
    metric_2007: bool,
    evaluate_on_ind: bool,
    get_known_classes_metrics: bool,
    is_open_set_model: bool,
    unk_class_number=None,
    using_id_val_subset: Optional[List] = False,
    min_conf_score: Optional[float] = None,
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Sweep all methods over InD + every OoD dataset (reference :1347-1439)."""
    open_set_results: Dict[str, Dict] = {}
    if evaluate_on_ind:
        open_set_results[ind_dataset_name] = {}
        for baseline_name in methods_names:
            open_set_results[ind_dataset_name][baseline_name] = (
                evaluate_open_set_detection_one_method(
                    id_dataset_name=ind_dataset_name,
                    id_gt_annotations_path=ind_gt_annotations_path,
                    predictions_dict=ind_data_dict["valid"],
                    method_name=baseline_name,
                    threshold=methods_thresholds[baseline_name],
                    test_gt_annotations_path=ind_gt_annotations_path,
                    metric_2007=metric_2007,
                    evaluating_ood=False,
                    get_known_classes_metrics=True,
                    using_subset=using_id_val_subset,
                    is_open_set_model=is_open_set_model,
                    unk_class_number=unk_class_number,
                    min_conf_score=min_conf_score,
                )
            )
    for ood_dataset_name in ood_datasets_names:
        open_set_results[ood_dataset_name] = {}
        for baseline_name in methods_names:
            open_set_results[ood_dataset_name][baseline_name] = (
                evaluate_open_set_detection_one_method(
                    id_dataset_name=ind_dataset_name,
                    id_gt_annotations_path=ind_gt_annotations_path,
                    predictions_dict=ood_data_dict[ood_dataset_name],
                    method_name=baseline_name,
                    threshold=methods_thresholds[baseline_name],
                    test_gt_annotations_path=ood_annotations_paths[ood_dataset_name],
                    metric_2007=metric_2007,
                    evaluating_ood=True,
                    get_known_classes_metrics=get_known_classes_metrics,
                    is_open_set_model=is_open_set_model,
                    unk_class_number=unk_class_number,
                    min_conf_score=min_conf_score,
                )
            )
    return open_set_results


def convert_osod_results_to_pandas_df(
    open_set_results: Dict[str, Dict[str, float]],
    methods_names: List[str],
    save_method_as_data: bool,
):
    """Results dict -> flat pandas DataFrame (reference :1442-1476)."""
    import pandas as pd

    first = open_set_results[list(open_set_results.keys())[0]]
    col_names = (["Method"] if save_method_as_data else []) + list(first.keys())
    new_dict = {}
    for method_name in methods_names:
        row = list(open_set_results[method_name].values())
        new_dict[method_name] = ([method_name] + row) if save_method_as_data else row
    return pd.DataFrame.from_dict(new_dict, orient="index", columns=col_names)


def convert_osod_results_to_hierarchical_pandas_df(
    osod_results_a,
    osod_results_b,
    methods_names: List[str],
    save_method_as_data: bool,
    datasets_names: List[str],
):
    """Two results dicts -> multi-index DataFrame (reference :1479-1527)."""
    import pandas as pd

    first = osod_results_a[list(osod_results_a.keys())[0]]
    col_names = (["Method"] if save_method_as_data else []) + list(first.keys())
    columns = pd.MultiIndex.from_product(
        [datasets_names, col_names], names=["Dataset", "Metric"]
    )
    new_dict = {}
    for method_name in methods_names:
        row = list(osod_results_a[method_name].values()) + list(
            osod_results_b[method_name].values()
        )
        new_dict[method_name] = ([method_name] + row) if save_method_as_data else row
    return pd.DataFrame.from_dict(new_dict, orient="index", columns=columns)


def convert_osod_results_for_mlflow_logging(
    open_set_results, ood_datasets_names: List[str], methods_names: List[str]
) -> Dict[str, float]:
    """Flatten nested results for mlflow (reference :1671-1700)."""
    results_for_mlflow = {}
    for ood_dataset_name in ood_datasets_names:
        for baseline_name in methods_names:
            for metric_name, value in open_set_results[ood_dataset_name][baseline_name].items():
                results_for_mlflow[f"{ood_dataset_name} {baseline_name} {metric_name}"] = value
    return results_for_mlflow


def _osod_bar_figure(group_labels, series, title, figsize, legend_cols=1):
    """Shared grouped-bar scaffold for the two OSOD comparison figures.

    ``series`` is an ordered ``{legend_label: values}`` mapping with one
    value per group. Groups sit at integer x positions; the bars of a group
    are packed side by side starting at the group position, the tick label
    centered under the pack. Percent values are printed above each bar.
    """
    import matplotlib.pyplot as plt

    n_series = len(series)
    bar_w = 1.0 / (n_series + 1)  # leave one bar-width gap between groups
    base = np.arange(len(group_labels), dtype=float)
    fig, ax = plt.subplots(layout="constrained", figsize=figsize)
    ax.grid(axis="y", linestyle="--")
    for pos, (label, values) in enumerate(series.items()):
        bars = ax.bar(base + pos * bar_w, np.asarray(values, float),
                      bar_w, label=label)
        for rect, v in zip(bars, np.asarray(values, float)):
            ax.annotate(f"{v:.2f}", fontsize=8, ha="center",
                        xytext=(0, 3), textcoords="offset points",
                        xy=(rect.get_x() + rect.get_width() / 2, v))
    ax.set_xticks(base + bar_w * (n_series - 1) / 2, group_labels)
    ax.set(ylabel="Percentage", ylim=(0, 100), title=title)
    ax.legend(ncols=legend_cols)
    return fig


def plot_two_osod_datasets_metrics(
    osod_results_a,
    osod_results_b,
    methods_names: List[str],
    datasets_names: List[str],
    metrics_to_plot: List[str],
    show_plot: bool,
):
    """Grouped bar chart across metrics (reference :1530-1600): one bar per
    (method, dataset) pair in every metric group."""
    import matplotlib.pyplot as plt

    series = {
        f"{method} {ds_name}": np.asarray(
            table.loc[method][metrics_to_plot], float
        )
        for method in methods_names
        for table, ds_name in zip((osod_results_a, osod_results_b),
                                  datasets_names)
    }
    fig = _osod_bar_figure(
        metrics_to_plot, series,
        title=f"OSOD metrics for {datasets_names[0]} and {datasets_names[1]}",
        figsize=(4 * len(methods_names), 6),
        legend_cols=max(1, len(methods_names) // 3),
    )
    if show_plot:  # pragma: no cover
        plt.show()
    return fig


def plot_two_osod_datasets_per_metric(
    osod_results_a,
    osod_results_b,
    methods_names: List[str],
    datasets_names: List[str],
    metric_to_plot: str,
    show_plot: bool,
):
    """Bar chart for one metric across methods (reference :1603-1668): one
    bar per dataset in every method group."""
    import matplotlib.pyplot as plt

    series = {
        ds_name: np.asarray(table[metric_to_plot], float)
        for table, ds_name in zip((osod_results_a, osod_results_b),
                                  datasets_names)
    }
    fig = _osod_bar_figure(
        methods_names, series,
        title=(f"OSOD {metric_to_plot} for {datasets_names[0]} "
               f"and {datasets_names[1]}"),
        figsize=(1.5 * len(methods_names), 5),
    )
    if show_plot:  # pragma: no cover
        plt.show()
    return fig


def get_n_unk_ood_dataset(annotations_path: str) -> int:
    """Total annotation count of an (all-unknown) OoD dataset
    (reference :1703-1722)."""
    annotations = COCOParser(annotations_path)
    return len(annotations.get_annIds(annotations.get_imgIds()))
