"""PASCAL VOC loading and the engine's mAP over a split.

Counterpart of ``dnn_inference_engine_tpu/eval/voc_dataset.py``. Expects
the VOCdevkit layout:

  <voc_dir>/VOC2007/JPEGImages/*.jpg
  <voc_dir>/VOC2007/Annotations/*.xml
  <voc_dir>/VOC2007/ImageSets/Main/test.txt
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from dnn_inference_engine_tpu_torch.config import (
    SCORE_THRESH_EVAL, VOC_CLASSES)


def parse_voc_xml(path: str) -> Dict:
    """One annotation file -> {"boxes" (G,4) xyxy, "classes",
    "difficult"}; objects of other classes are skipped."""
    root = ET.parse(path).getroot()
    boxes, classes, difficult = [], [], []
    for obj in root.findall("object"):
        name = obj.findtext("name")
        if name not in VOC_CLASSES:
            continue
        bb = obj.find("bndbox")
        boxes.append([float(bb.findtext(k))
                      for k in ("xmin", "ymin", "xmax", "ymax")])
        classes.append(VOC_CLASSES.index(name))
        difficult.append(obj.findtext("difficult", "0") == "1")
    return {
        "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
        "classes": np.asarray(classes, np.int32),
        "difficult": np.asarray(difficult, bool),
    }


def voc_image_list(voc_dir: str, split: str = "2007_test"):
    """[(id, jpg path, xml path)] of a split such as ``2007_test``."""
    year, part = split.split("_")
    base = os.path.join(voc_dir, f"VOC{year}")
    with open(os.path.join(base, "ImageSets", "Main", f"{part}.txt")) as f:
        ids = [line.strip() for line in f if line.strip()]
    return [(i,
             os.path.join(base, "JPEGImages", f"{i}.jpg"),
             os.path.join(base, "Annotations", f"{i}.xml")) for i in ids]


def evaluate_voc(engine, voc_dir: str, split: str = "2007_test",
                 limit: Optional[int] = None, batch: Optional[int] = None,
                 use_07_metric: bool = True) -> Dict:
    """The engine's mAP@0.5 over a VOC split. Detection runs at the eval
    score threshold (``SCORE_THRESH_EVAL``, where the NMS pool is
    uncapped) whatever the engine's own; its threshold is restored
    after."""
    from dnn_inference_engine_tpu_torch.eval.voc import voc_map
    from dnn_inference_engine_tpu_torch.preprocess import (
        boxes_to_original, load_image, preprocess_image)

    items = voc_image_list(voc_dir, split)
    if limit:
        items = items[:limit]
    batch = batch or max(engine.config.batch, 1)
    size = engine.config.input_size

    detections: List[Dict] = []
    ground_truth: List[Dict] = []
    old_thresh = engine.config.score_thresh
    engine.config.score_thresh = SCORE_THRESH_EVAL
    try:
        for i in range(0, len(items), batch):
            chunk = items[i:i + batch]
            xs, metas = [], []
            for _id, jpg, xml in chunk:
                x, meta = preprocess_image(load_image(jpg), size)
                xs.append(x)
                metas.append(meta)
                ground_truth.append(parse_voc_xml(xml))
            xb = np.zeros((batch, size, size, 3), np.float32)
            xb[:len(xs)] = np.stack(xs)
            boxes, scores, classes = engine.detect(xb)
            for j, meta in enumerate(metas):
                keep = scores[j] > 0
                detections.append({
                    "boxes": boxes_to_original(boxes[j][keep], meta),
                    "scores": scores[j][keep],
                    "classes": classes[j][keep],
                })
    finally:
        engine.config.score_thresh = old_thresh

    m, aps = voc_map(detections, ground_truth, len(VOC_CLASSES),
                     use_07_metric=use_07_metric)
    return {
        "mAP@0.5": m,
        "per_class": {VOC_CLASSES[c]: aps[c] for c in range(len(VOC_CLASSES))},
        "images": len(items),
        "mode": engine.config.mode,
    }
