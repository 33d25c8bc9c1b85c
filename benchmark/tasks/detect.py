"""Detection cells: ``Engine.forward_fn()`` then ``Engine.postprocess`` on
a pool batch (``detect_fn``'s two halves), the boxes, scores and classes
copied to the host; the float32 head is what the forward hands on.

``det_unmatched`` counts, over the sampled batches, the detections (score
above 0) on either side with no counterpart on the other: the same image
and class, IoU at least ``MATCH_IOU`` and scores within
``MATCH_SCORE``. Near a threshold (the score, the IoU of the
suppression, the candidate or detection cap) a detection may flip on
rounding, and counts once or twice. The match only pairs detections; how
far each pair lies apart is judged by two more numbers, so that the
decode is held to the reference's arithmetic and not only to the NMS's
choices: ``box_gap``, the widest gap of a box coordinate between a
detection and its counterpart (the one of highest IoU), in pixels, and
``score_gap``, the widest gap of their scores. A decode in half
precision, or boxes all moved by the same few pixels (which leaves the
NMS's choices as they were), fails them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference import detect_post
from benchmark.trace import FORWARD, POSTPROCESS, TO_HOST

MATCH_IOU = 0.5
MATCH_SCORE = 0.05
COMBINE = {"det_unmatched": "sum", "box_gap": "max", "score_gap": "max"}


def engine_config(cfg: Dict, traffic: Dict) -> Dict:
    return {"score_thresh": traffic["score_thresh"],
            "nms_iou_thresh": traffic["nms_iou_thresh"],
            "nms_topk": traffic["nms_topk"],
            "max_detections": traffic["max_detections"]}


def window_call(engine, span):
    forward, post = engine.forward_fn(), engine.postprocess

    def call(x):
        with span(FORWARD):
            head = forward(x)
        with span(POSTPROCESS):
            b, s, c = post(head)
        with span(TO_HOST):
            out = (b.cpu().numpy(), s.cpu().numpy(), c.cpu().numpy())
        return out, head
    return call


def reference_outputs(head: torch.Tensor, cfg: Dict, traffic: Dict,
                      size: int, decode_dtype=torch.float32):
    boxes, scores = detect_post.decode(
        head, cfg["anchors"], cfg["num_classes"], size,
        anchors_in_cells=cfg["anchors_in"] == "cells", dtype=decode_dtype)
    return detect_post.nms(boxes, scores, traffic["nms_iou_thresh"],
                           traffic["score_thresh"], traffic["nms_topk"],
                           traffic["max_detections"])


def _matches(b1, s1, c1, b2, s2, c2):
    """Side 1's detections against side 2's: (valid and matched by none,
    the box gap and the score gap of each matched one to its counterpart
    of highest IoU)."""
    iou = _iou(b1, b2)                                   # (N, D1, D2)
    ok = ((c1[:, :, None] == c2[:, None, :]) & (s2[:, None, :] > 0)
          & (iou >= MATCH_IOU)
          & ((s1[:, :, None] - s2[:, None, :]).abs() <= MATCH_SCORE))
    valid, hit = s1 > 0, ok.any(-1)
    best = torch.where(ok, iou, torch.full_like(iou, -1.0)).argmax(-1)
    pb = torch.gather(b2, 1, best[..., None].expand_as(b1))
    ps = torch.gather(s2, 1, best)
    m = valid & hit
    return (valid & ~hit, (b1 - pb).abs().amax(-1)[m],
            (s1 - ps).abs()[m])


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax1, ay1, ax2, ay2 = (t[:, :, None] for t in a.unbind(-1))
    bx1, by1, bx2, by2 = (t[:, None, :] for t in b.unbind(-1))
    iw = torch.clamp_min(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                         0)
    ih = torch.clamp_min(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                         0)
    inter = iw * ih
    area_a = torch.clamp_min(ax2 - ax1, 0) * torch.clamp_min(ay2 - ay1, 0)
    area_b = torch.clamp_min(bx2 - bx1, 0) * torch.clamp_min(by2 - by1, 0)
    return inter / torch.clamp_min(area_a + area_b - inter, 1e-9)


def compare(out, ref) -> Dict[str, float]:
    """One sampled batch: the program's host outputs against the
    reference's."""
    dev = ref[0].device
    b, s, c = (torch.as_tensor(np.asarray(v), device=dev) for v in out)
    rb, rs, rc = ref
    inf = {name: float("inf") for name in COMBINE}
    if b.shape != rb.shape or s.shape != rs.shape or c.shape != rc.shape:
        return inf
    if not (torch.isfinite(b).all() and torch.isfinite(s).all()):
        return inf
    c, rc = c.to(torch.int64), rc.to(torch.int64)
    lost, box, score = zip(_matches(b, s, c, rb, rs, rc),
                           _matches(rb, rs, rc, b, s, c))
    box, score = torch.cat(box), torch.cat(score)
    return {"det_unmatched": float(sum(int(x.sum()) for x in lost)),
            "box_gap": float(box.max()) if box.numel() else 0.0,
            "score_gap": float(score.max()) if score.numel() else 0.0}


def head_of(out) -> None:
    """The host outputs hold no head: the window keeps the forward's."""
    return None
