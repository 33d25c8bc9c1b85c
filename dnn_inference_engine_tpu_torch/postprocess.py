"""Head decode + NMS on the device, in the columnar layout.

Counterpart of the columnar path of
``dnn_inference_engine_tpu/postprocess.py``: ``decode_yolov2_cols`` and
``decode_yolov3_cols`` (boxes (N,4,M) cxcywh and scores (N,C,M),
anchor-major order m = anchor*S*S + cell) and ``device_nms_cols`` (one class-agnostic candidate
top-K, one shared IoU matrix, per-class greedy suppression as a Jacobi
fixpoint). Plain PyTorch: no Pallas kernel computes these.

Tie-breaks follow the JAX package: ``jax.lax.top_k`` puts the lower index
first among equal values, so every top-K here is a stable descending sort.
"""

from __future__ import annotations

import torch

from dnn_inference_engine_tpu_torch.config import (
    INPUT_SIZE, MAX_DETECTIONS, NMS_IOU_THRESH, NUM_CLASSES,
    SCORE_THRESH_VIS, YOLOV2_TINY_ANCHORS,
)


def _decode_cols(head, anchors, num_classes: int, input_size: int,
                 anchors_in_cells: bool, softmax_cls: bool):
    n, s = head.shape[0], head.shape[1]
    a = len(anchors)
    e = 5 + num_classes
    s2 = s * s
    cell_px = input_size / s
    # (N,S,S,A*E) -> (N,S2,A*E) -> (N,A*E,S2) -> (N,A,E,S2)
    x = head.reshape(n, s2, a * e).transpose(1, 2).reshape(n, a, e, s2)
    cell = torch.arange(s2, device=head.device)
    col = (cell % s).to(torch.float32)
    row = (cell // s).to(torch.float32)
    anc = torch.tensor(anchors, dtype=torch.float32, device=head.device)
    bx = (col + torch.sigmoid(x[:, :, 0, :])) * cell_px        # (N,A,S2)
    by = (row + torch.sigmoid(x[:, :, 1, :])) * cell_px
    scale_wh = cell_px if anchors_in_cells else 1.0
    bw = anc[:, 0][None, :, None] * torch.exp(x[:, :, 2, :]) * scale_wh
    bh = anc[:, 1][None, :, None] * torch.exp(x[:, :, 3, :]) * scale_wh
    obj = torch.sigmoid(x[:, :, 4, :])
    logits = x[:, :, 5:, :]                                    # (N,A,C,S2)
    cls = (torch.softmax(logits, dim=2) if softmax_cls
           else torch.sigmoid(logits))
    scores = obj[:, :, None, :] * cls                          # (N,A,C,S2)
    boxes = torch.stack([bx, by, bw, bh], dim=1)               # (N,4,A,S2)
    scores = scores.permute(0, 2, 1, 3)                        # (N,C,A,S2)
    return (boxes.reshape(n, 4, a * s2),
            scores.reshape(n, num_classes, a * s2))


def decode_yolov2_cols(head, anchors=YOLOV2_TINY_ANCHORS,
                       num_classes: int = NUM_CLASSES,
                       input_size: int = INPUT_SIZE):
    """Columnar decode: (N,4,M) cxcywh + (N,C,M), anchor-major order."""
    return _decode_cols(head, anchors, num_classes, input_size,
                        anchors_in_cells=True, softmax_cls=True)


def decode_yolov3_cols(head, anchors_px, num_classes: int = NUM_CLASSES,
                       input_size: int = INPUT_SIZE):
    """Columnar decode of one YOLOv3 head: anchors in pixels, sigmoid
    class scores."""
    return _decode_cols(head, anchors_px, num_classes, input_size,
                        anchors_in_cells=False, softmax_cls=False)


def _pack_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., K) bool -> (..., ceil(K/64)) int64 bitset over the last axis:
    bit b of word w is element w*64+b (K zero-padded to a multiple of 64).
    Bits are summed into bytes, and 8 bytes read as one little-endian
    word."""
    k = x.shape[-1]
    kp = -(-k // 64) * 64
    if kp != k:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (kp - k,))], dim=-1)
    weights = (1 << torch.arange(8, device=x.device)).to(torch.uint8)
    xb = x.reshape(x.shape[:-1] + (kp // 8, 8)).to(torch.uint8)
    return (xb * weights).sum(dim=-1, dtype=torch.uint8).view(torch.int64)


def _greedy_fixpoint(s: torch.Tensor, oidx: torch.Tensor,
                     iou_hit: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Exact greedy NMS keep masks as a Jacobi fixpoint over a bit-packed
    dominance matrix, batched over images.

    s (B,C,K) per-class candidate scores; oidx (B,K) original candidate
    indices (tie-break order); iou_hit (B,K,K); valid (B,C,K).
    dom[b,c,i,j] = j precedes i in class-c greedy order (score desc,
    index tie-break) and iou_hit[b,i,j]. Greedy's keep is the unique
    solution of keep[i] = valid[i] and not any_j(dom[i,j] and keep[j]);
    Jacobi iteration from keep = valid reaches it in (longest suppression
    chain + 2) sweeps, at most K. Each sweep syncs with the host once.
    """
    k = valid.shape[-1]
    si, sj = s[..., :, None], s[..., None, :]
    prec = (sj > si) | ((sj == si)
                        & (oidx[:, None, None, :] < oidx[:, None, :, None]))
    dom_p = _pack_bits(prec & iou_hit[:, None])                # (B,C,K,W)

    def step(keep):
        hits = dom_p & _pack_bits(keep)[..., None, :]
        return valid & ~(hits != 0).any(dim=-1)

    prev, keep, it = valid, step(valid), 1
    while it < k and bool((prev != keep).any()):
        prev, keep, it = keep, step(keep), it + 1
    return keep


def _desc_topk(v: torch.Tensor, k: int):
    """Top-k along the last axis, lower index first among ties (as
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def device_nms_cols(boxes: torch.Tensor, scores: torch.Tensor,
                    iou_thresh: float = NMS_IOU_THRESH,
                    score_thresh: float = SCORE_THRESH_VIS,
                    topk: int = MAX_DETECTIONS,
                    max_det: int = MAX_DETECTIONS):
    """boxes (B,4,M) cxcywh, scores (B,C,M) -> (boxes (B,D,4) xyxy,
    scores (B,D), classes (B,D) int32), zero-padded, score-descending,
    D = max_det. Candidate order follows the input's M order."""
    b, c, m = scores.shape
    topk = min(topk, m)
    if topk < m:
        _, oidx = _desc_topk(scores.amax(dim=1), topk)         # (B,K)
        bk = torch.gather(boxes, 2, oidx[:, None, :].expand(b, 4, topk))
        sk = torch.gather(scores, 2, oidx[:, None, :].expand(b, c, topk))
    else:
        oidx = torch.arange(m, device=boxes.device).expand(b, m)
        bk, sk = boxes, scores
    x1 = bk[:, 0] - bk[:, 2] * 0.5                             # (B,K)
    y1 = bk[:, 1] - bk[:, 3] * 0.5
    x2 = bk[:, 0] + bk[:, 2] * 0.5
    y2 = bk[:, 1] + bk[:, 3] * 0.5
    area = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)
    ix1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    iy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    ix2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    iy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = torch.clamp_min(ix2 - ix1, 0) * torch.clamp_min(iy2 - iy1, 0)
    union = area[:, :, None] + area[:, None, :] - inter
    iou = inter / torch.clamp_min(union, 1e-9)
    valid = sk > score_thresh
    keep = _greedy_fixpoint(sk, oidx, iou > iou_thresh, valid)

    sk_out = torch.where(keep, sk, torch.zeros_like(sk)).reshape(b, c * topk)
    d = min(max_det, c * topk)
    s_top, i_top = _desc_topk(sk_out, d)
    cls = (i_top // topk).to(torch.int32)
    k_idx = i_top % topk
    bxyxy = torch.stack([x1, y1, x2, y2], dim=1)               # (B,4,K)
    bk_out = torch.gather(bxyxy, 2, k_idx[:, None, :].expand(b, 4, d))
    bk_out = bk_out.transpose(1, 2)                            # (B,D,4)
    if d < max_det:           # keep the advertised static shape
        pad = max_det - d
        bk_out = torch.cat([bk_out, bk_out.new_zeros(b, pad, 4)], dim=1)
        s_top = torch.cat([s_top, s_top.new_zeros(b, pad)], dim=1)
        cls = torch.cat([cls, cls.new_zeros(b, pad)], dim=1)
    return bk_out, s_top, cls
