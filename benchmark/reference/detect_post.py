"""Plain reference of YOLO's decode and of greedy per-class NMS, in plain
PyTorch (float32), from darknet's region-layer equations and the engine's
documented candidate order and tie-breaks.

Decode of a (N, S, S, A * (5 + C)) head: for anchor a of cell (row, col),
``bx = (col + sigmoid(tx)) * S_px / S``, ``by`` alike, ``bw = anchor_w *
exp(tw)`` (times the cell's pixels where the anchors are in cells),
``bh`` alike, the score of class c ``sigmoid(to) * softmax(t_cls)_c``.
Candidates are ordered anchor-major, ``m = a * S * S + row * S + col``.

NMS: the candidates are the top ``topk`` by their best class score (all M
where ``topk`` is None or not smaller), the lower index first among
equal scores. For each class, a candidate is valid where its score is
over ``score_thresh``; in order of score, the lower candidate index first
among equal scores, a valid candidate is kept unless its IoU with a
candidate kept before it is over ``iou_thresh``. The kept (class,
candidate) pairs are merged by score, class-major index order among
equal scores, into the first ``max_det`` rows: boxes xyxy (``cx - w *
0.5``, ...), scores and classes, zero where fewer are kept.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def decode(head: torch.Tensor, anchors: Sequence[Sequence[float]],
           num_classes: int, input_size: int, anchors_in_cells: bool = True,
           dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> boxes (N, M, 4) cxcywh in pixels, scores (N, M, C), float32.
    Computed on the columnar (N, A, 5 + C, S * S) view of the head, the
    softmax over its class axis, as the engine documents its decode, so
    that each score rounds as the engine's does. ``dtype`` is the
    arithmetic's (float32; the control's lower precision computes it in
    float16)."""
    head = head.to(dtype)
    n, s = head.shape[0], head.shape[1]
    a, e = len(anchors), 5 + num_classes
    cell_px = input_size / s
    t = head.reshape(n, s * s, a * e).transpose(1, 2).reshape(n, a, e, s * s)
    cell = torch.arange(s * s, device=head.device)
    col = (cell % s).to(dtype)
    row = (cell // s).to(dtype)
    anc = torch.tensor(anchors, dtype=dtype, device=head.device)
    unit = cell_px if anchors_in_cells else 1.0
    bx = (col + torch.sigmoid(t[:, :, 0])) * cell_px             # (N,A,S2)
    by = (row + torch.sigmoid(t[:, :, 1])) * cell_px
    bw = anc[:, 0][None, :, None] * torch.exp(t[:, :, 2]) * unit
    bh = anc[:, 1][None, :, None] * torch.exp(t[:, :, 3]) * unit
    obj = torch.sigmoid(t[:, :, 4])
    scores = obj[:, :, None] * torch.softmax(t[:, :, 5:], dim=2)  # (N,A,C,S2)
    boxes = torch.stack([bx, by, bw, bh], -1).reshape(n, a * s * s, 4)
    scores = scores.permute(0, 1, 3, 2).reshape(n, a * s * s, num_classes)
    return boxes.float(), scores.float()


def iou_matrix(xyxy: torch.Tensor) -> torch.Tensor:
    """(N, K, 4) xyxy -> (N, K, K) IoU in float32."""
    x1, y1, x2, y2 = xyxy.unbind(-1)
    area = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)
    iw = torch.clamp_min(torch.minimum(x2[:, :, None], x2[:, None])
                         - torch.maximum(x1[:, :, None], x1[:, None]), 0)
    ih = torch.clamp_min(torch.minimum(y2[:, :, None], y2[:, None])
                         - torch.maximum(y1[:, :, None], y1[:, None]), 0)
    inter = iw * ih
    union = area[:, :, None] + area[:, None] - inter
    return inter / torch.clamp_min(union, 1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
        score_thresh: float, topk: Optional[int], max_det: int):
    """boxes (N, M, 4) cxcywh, scores (N, M, C) -> (boxes (N, D, 4) xyxy,
    scores (N, D), classes (N, D) int32), D = max_det."""
    n, m, c = scores.shape
    k = m if topk is None else min(topk, m)
    best = scores.amax(-1)
    oidx = torch.sort(best, dim=-1, descending=True, stable=True)[1][:, :k]
    oidx = torch.sort(oidx, dim=-1)[0] if k == m else oidx
    bk = torch.gather(boxes, 1, oidx[..., None].expand(n, k, 4))
    sk = torch.gather(scores, 1, oidx[..., None].expand(n, k, c))
    cx, cy, w, h = bk.unbind(-1)
    xyxy = torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5,
                        cy + h * 0.5], -1)
    hit = iou_matrix(xyxy) > iou_thresh                      # (N, K, K)
    sc = sk.permute(0, 2, 1)                                 # (N, C, K)
    valid = sc > score_thresh
    # rank order: score descending, candidate index ascending
    key_idx = oidx[:, None, :].expand(n, c, k)
    order = torch.sort(key_idx, dim=-1, stable=True)[1]
    order = torch.gather(order, -1, torch.sort(
        torch.gather(sc, -1, order), dim=-1, descending=True,
        stable=True)[1])
    keep = torch.zeros_like(valid)
    rows = torch.arange(n, device=sc.device)[:, None]
    for r in range(k):
        i = order[:, :, r]                                   # (N, C)
        hit_i = hit[rows, i]                                 # (N, C, K)
        blocked = (hit_i & keep).any(-1)
        v = torch.gather(valid, -1, i[..., None])[..., 0]
        keep.scatter_(-1, i[..., None], (v & ~blocked)[..., None])
    flat = torch.where(keep, sc, torch.zeros_like(sc)).reshape(n, c * k)
    d = min(max_det, c * k)
    s_top, i_top = torch.sort(flat, dim=-1, descending=True, stable=True)
    s_top, i_top = s_top[:, :d], i_top[:, :d]
    cls = (i_top // k).to(torch.int32)
    b_top = torch.gather(xyxy, 1, (i_top % k)[..., None].expand(n, d, 4))
    if d < max_det:
        pad = max_det - d
        b_top = torch.cat([b_top, b_top.new_zeros(n, pad, 4)], 1)
        s_top = torch.cat([s_top, s_top.new_zeros(n, pad)], 1)
        cls = torch.cat([cls, cls.new_zeros(n, pad)], 1)
    return b_top, s_top, cls
