"""PASCAL VOC AP@0.5 on the host.

Counterpart of ``dnn_inference_engine_tpu/eval/voc.py``, a numpy copy
(pinned by ``tests/test_torch_eval.py``): per-class ranked detections
matched greedily to ground truth at IoU >= 0.5, one detection per ground
truth box, difficult boxes ignored; AP as the area under the
precision-recall curve, or the VOC07 11-point metric.

  detections: per image {"boxes": (D,4) xyxy, "scores": (D,),
                         "classes": (D,) int}
  ground_truth: per image {"boxes": (G,4) xyxy, "classes": (G,) int,
                           "difficult": (G,) bool (optional)}
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(D,4) x (G,4) xyxy -> (D,G) IoU."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def _average_precision(rec: np.ndarray, prec: np.ndarray,
                       use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval(detections: Sequence[Dict], ground_truth: Sequence[Dict],
             cls: int, iou_thresh: float = 0.5,
             use_07_metric: bool = False) -> float:
    """AP@iou for one class over the dataset."""
    # gather GT for this class
    gt_per_img = []
    npos = 0
    for gt in ground_truth:
        mask = np.asarray(gt["classes"]) == cls
        boxes = np.asarray(gt["boxes"], np.float32).reshape(-1, 4)[mask]
        difficult = np.asarray(
            gt.get("difficult", np.zeros(len(mask), bool)))[mask]
        npos += int(np.sum(~difficult))
        gt_per_img.append({"boxes": boxes, "difficult": difficult,
                           "matched": np.zeros(len(boxes), bool)})

    # gather detections for this class across images, rank globally
    recs = []
    for img_id, det in enumerate(detections):
        mask = np.asarray(det["classes"]) == cls
        boxes = np.asarray(det["boxes"], np.float32).reshape(-1, 4)[mask]
        scores = np.asarray(det["scores"], np.float32)[mask]
        for b, s in zip(boxes, scores):
            recs.append((float(s), img_id, b))
    if not recs or npos == 0:
        return 0.0
    recs.sort(key=lambda r: -r[0])

    tp = np.zeros(len(recs))
    fp = np.zeros(len(recs))
    for i, (_s, img_id, box) in enumerate(recs):
        gt = gt_per_img[img_id]
        if gt["boxes"].size == 0:
            fp[i] = 1.0
            continue
        ious = _iou_matrix(box[None], gt["boxes"])[0]
        j = int(np.argmax(ious))
        if ious[j] >= iou_thresh:
            if gt["difficult"][j]:
                continue  # difficult GT: detection ignored entirely
            if not gt["matched"][j]:
                tp[i] = 1.0
                gt["matched"][j] = True
            else:
                fp[i] = 1.0
        else:
            fp[i] = 1.0

    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    rec = tp_cum / npos
    prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    return _average_precision(rec, prec, use_07_metric)


def voc_map(detections: Sequence[Dict], ground_truth: Sequence[Dict],
            num_classes: int = 20, iou_thresh: float = 0.5,
            use_07_metric: bool = False):
    """mAP@iou over all classes. Returns (mAP, per-class AP list)."""
    aps: List[float] = [
        voc_eval(detections, ground_truth, c, iou_thresh, use_07_metric)
        for c in range(num_classes)
    ]

    def n_evaluable(c):
        """non-difficult GT count — classes with only difficult GT have an
        undefined AP and are excluded (standard VOC behavior)."""
        n = 0
        for gt in ground_truth:
            cls = np.asarray(gt["classes"])
            diff = np.asarray(gt.get("difficult", np.zeros(len(cls), bool)))
            n += int(np.sum((cls == c) & ~diff))
        return n

    present = [c for c in range(num_classes) if n_evaluable(c) > 0]
    if not present:
        return 0.0, aps
    return float(np.mean([aps[c] for c in present])), aps
