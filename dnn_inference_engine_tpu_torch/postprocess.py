"""Head decode + NMS.

Counterpart of ``dnn_inference_engine_tpu/postprocess.py``:

- the columnar path the engine runs, on the device: ``decode_yolov2_cols``
  and ``decode_yolov3_cols`` (boxes (N,4,M) cxcywh and scores (N,C,M),
  anchor-major order m = anchor*S*S + cell) and ``device_nms_cols`` (one
  class-agnostic candidate top-K, one shared IoU matrix, per-class greedy
  suppression as a Jacobi fixpoint);
- the row-major public API on the tensors' device: ``decode_yolov2``,
  ``decode_yolov3`` (boxes (N,M,4), scores (N,M,C), m = cell*A +
  anchor), ``cxcywh_to_xyxy``, ``device_nms`` (the same fixpoint) and
  ``device_nms_seq`` (per-class top-K and a K-step greedy loop, a second
  oracle);
- ``nms_fixpoint`` (``csrc/nms_fixpoint.cu``), the fixpoint's loop as one
  kernel on the card, for JAX's on-device ``lax.while_loop``, and its
  plain version ``nms_fixpoint_plain``;
- ``host_nms``: per-class greedy NMS of one image in numpy, through the
  native library's ``nms_greedy`` where it builds.

The profiler scopes of the JAX package (``post_decode``,
``nms_candidates``, ``nms_suppress``, ``nms_merge``; opened only while a
profiler runs) let ``runtime/profiling.trace_attribution`` split a
detect's device time.

Plain PyTorch but for the fixpoint's loop: no Pallas kernel computes
these, and the dominance words and the IoU stay PyTorch ops, as they are
XLA ops in the JAX package. Tie-breaks follow the
JAX package: ``jax.lax.top_k`` puts the lower index first among equal
values, so every top-K here is a stable descending sort, and candidates
keep the input's M order.
"""

from __future__ import annotations

from typing import Optional

import ctypes

import numpy as np
import torch

from dnn_inference_engine_tpu_torch.config import (
    INPUT_SIZE, MAX_DETECTIONS, NMS_IOU_THRESH, NUM_CLASSES,
    SCORE_THRESH_VIS, YOLOV2_TINY_ANCHORS,
)
from dnn_inference_engine_tpu_torch.runtime.profiling import scope

# Jacobi sweeps of the NMS fixpoint's plain version (``nms_fixpoint_plain``,
# the CPU's path) between two host reads of its convergence test; the
# kernel (``nms_fixpoint``) runs the whole loop on the card and reads
# nothing. Measured on an H100 (700 W) by chip_smoke.py phase 10 when the
# plain loop ran on the card: seeded weights need 12 sweeps at b32, 7 at
# b1 (K = 256) and 20 at the eval grade's b2 (K = 845); the NMS then took
# 3.36-3.73 ms of host time at b32 in groups of 4 (3.60-5.05 with one read
# a sweep), 1.90-2.30 at b1, and 4 was the best group or within 16% of it
# in every case.
SWEEPS_PER_SYNC = 4


def _decode_rows(head, anchors, num_classes: int, input_size: int,
                 anchors_in_cells: bool, softmax_cls: bool):
    n, s = head.shape[0], head.shape[1]
    a = len(anchors)
    e = 5 + num_classes
    cell_px = input_size / s
    x = head.reshape(n, s * s * a, e)                    # m = cell*A + anchor
    mi = torch.arange(s * s * a, device=head.device)
    col = ((mi // a) % s).to(torch.float32)
    row = (mi // (a * s)).to(torch.float32)
    anc = torch.tensor(anchors, dtype=torch.float32, device=head.device)
    anc_w, anc_h = anc[:, 0].repeat(s * s), anc[:, 1].repeat(s * s)
    with scope("post_decode"):
        bx = (col + torch.sigmoid(x[..., 0])) * cell_px
        by = (row + torch.sigmoid(x[..., 1])) * cell_px
        bw = anc_w * torch.exp(x[..., 2])
        bh = anc_h * torch.exp(x[..., 3])
        if anchors_in_cells:
            bw, bh = bw * cell_px, bh * cell_px
        obj = torch.sigmoid(x[..., 4])
        logits = x[..., 5:]
        cls = (torch.softmax(logits, dim=-1) if softmax_cls
               else torch.sigmoid(logits))
        return torch.stack([bx, by, bw, bh], dim=-1), obj[..., None] * cls


def decode_yolov2(head, anchors=YOLOV2_TINY_ANCHORS,
                  num_classes: int = NUM_CLASSES,
                  input_size: int = INPUT_SIZE):
    """(N,S,S,A*(5+C)) head -> boxes (N,S*S*A,4) cxcywh in pixels and
    scores (N,S*S*A,C): darknet's decode, anchors in cell units, softmax
    class scores times the objectness."""
    return _decode_rows(head, anchors, num_classes, input_size,
                        anchors_in_cells=True, softmax_cls=True)


def decode_yolov3(head, anchors_px, num_classes: int = NUM_CLASSES,
                  input_size: int = INPUT_SIZE):
    """YOLOv3 head decode: anchors in pixels, sigmoid class scores."""
    return _decode_rows(head, anchors_px, num_classes, input_size,
                        anchors_in_cells=False, softmax_cls=False)


def cxcywh_to_xyxy(boxes):
    """(..., 4) cxcywh -> xyxy, numpy or torch."""
    cx, cy, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    stack = np.stack if isinstance(boxes, np.ndarray) else torch.stack
    return stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


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
    with scope("post_decode"):
        bx = (col + torch.sigmoid(x[:, :, 0, :])) * cell_px    # (N,A,S2)
        by = (row + torch.sigmoid(x[:, :, 1, :])) * cell_px
        scale_wh = cell_px if anchors_in_cells else 1.0
        bw = anc[:, 0][None, :, None] * torch.exp(x[:, :, 2, :]) * scale_wh
        bh = anc[:, 1][None, :, None] * torch.exp(x[:, :, 3, :]) * scale_wh
        obj = torch.sigmoid(x[:, :, 4, :])
        logits = x[:, :, 5:, :]                                # (N,A,C,S2)
        cls = (torch.softmax(logits, dim=2) if softmax_cls
               else torch.sigmoid(logits))
        scores = obj[:, :, None, :] * cls                      # (N,A,C,S2)
        boxes = torch.stack([bx, by, bw, bh], dim=1)           # (N,4,A,S2)
        scores = scores.permute(0, 2, 1, 3)                    # (N,C,A,S2)
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


def _dominance(s: torch.Tensor, oidx: torch.Tensor,
               iou_hit: torch.Tensor) -> torch.Tensor:
    """dom[b,c,i,j] = j precedes i in class-c greedy order (score desc,
    index tie-break) and iou_hit[b,i,j], bit-packed over j: (B,C,K,W)."""
    si, sj = s[..., :, None], s[..., None, :]
    prec = (sj > si) | ((sj == si)
                        & (oidx[:, None, None, :] < oidx[:, None, :, None]))
    return _pack_bits(prec & iou_hit[:, None])


def _sweep(dom_p: torch.Tensor, valid: torch.Tensor,
           keep: torch.Tensor) -> torch.Tensor:
    """One Jacobi sweep: valid and not dominated by a kept candidate."""
    hits = dom_p & _pack_bits(keep)[..., None, :]
    return valid & ~(hits != 0).any(dim=-1)


def _check_fixpoint_args(dom_p: torch.Tensor, valid: torch.Tensor) -> None:
    k = valid.shape[-1] if valid.ndim else 0
    if (valid.ndim != 3 or valid.dtype != torch.bool
            or dom_p.dtype != torch.int64
            or tuple(dom_p.shape) != (*valid.shape, -(-k // 64))
            or dom_p.device != valid.device):
        raise ValueError(
            "nms_fixpoint: need dom_p (B,C,K,ceil(K/64)) int64 and valid "
            f"(B,C,K) bool on one device, got {dom_p.dtype} "
            f"{tuple(dom_p.shape)} on {dom_p.device} and {valid.dtype} "
            f"{tuple(valid.shape)} on {valid.device}")


def nms_fixpoint_plain(dom_p: torch.Tensor, valid: torch.Tensor,
                       group: Optional[int] = None,
                       return_sweeps: bool = False):
    """Plain PyTorch version of ``nms_fixpoint``: the Jacobi loop, batched
    over (image, class), in groups of ``group`` sweeps (default
    ``SWEEPS_PER_SYNC``) between host reads of its convergence test
    (``_greedy_fixpoint.host_syncs`` counts the reads). A sweep after the
    fixpoint changes nothing, so the masks equal those of a read after
    every sweep, and the K bound holds. With ``return_sweeps``, also the
    sweeps each (image, class) takes when JAX's loop runs it alone, as
    the kernel does: (B, C) int32."""
    group = group or SWEEPS_PER_SYNC
    k = valid.shape[-1]
    keep = _sweep(dom_p, valid, valid)
    # the last sweep that changed each (image, class)'s mask
    last = (keep != valid).any(dim=-1).to(torch.int32) if return_sweeps \
        else None
    it = 1
    while it < k:
        for _ in range(min(group, k - it)):
            prev, keep = keep, _sweep(dom_p, valid, keep)
            it += 1
            if return_sweeps:
                last = torch.where((prev != keep).any(dim=-1),
                                   torch.full_like(last, it), last)
        _greedy_fixpoint.host_syncs += 1
        if not bool((prev != keep).any()):
            break
    if return_sweeps:
        return keep, torch.clamp(last + 1, max=max(k, 1))
    return keep


def nms_fixpoint(dom_p: torch.Tensor, valid: torch.Tensor,
                 return_sweeps: bool = False):
    """Greedy NMS keep masks (B,C,K) bool as the Jacobi fixpoint of
    ``keep[i] = valid[i] and not any_j(dom[i,j] and keep[j])`` from
    ``keep = valid``, stopping where a sweep changes nothing or after K
    sweeps, as JAX's ``lax.while_loop`` does. ``dom_p`` (B,C,K,W) int64:
    bit j of word w is candidate 64w + j (``_dominance``); ``valid``
    (B,C,K) bool. With ``return_sweeps``, also each (image, class)'s
    sweeps, (B, C) int32.

    On a CUDA tensor one launch of ``csrc/nms_fixpoint.cu`` runs the whole
    loop, a block each (image, class), and the host reads nothing; on a
    CPU tensor the plain version runs."""
    _check_fixpoint_args(dom_p, valid)
    if valid.device.type == "cpu":
        return nms_fixpoint_plain(dom_p, valid, return_sweeps=return_sweeps)
    if valid.device.type != "cuda":
        raise ValueError(f"nms_fixpoint: unsupported device {valid.device}")
    from dnn_inference_engine_tpu_torch.ops import _build
    b, c, k = valid.shape
    w = dom_p.shape[-1]
    if 3 * w * 8 > 48 * 1024:
        raise ValueError(f"nms_fixpoint: K = {k} needs {3 * w * 8} bytes "
                         "of shared memory a block, over 48 KB")
    dom_p, valid = dom_p.contiguous(), valid.contiguous()
    keep = torch.empty_like(valid)
    sweeps = (torch.empty((b, c), dtype=torch.int32, device=valid.device)
              if return_sweeps else None)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("nms_fixpoint", "nms_fixpoint",
                         [p, p, p, p, i, i, i, p])
    err = fn(dom_p.data_ptr(), valid.data_ptr(), keep.data_ptr(),
             sweeps.data_ptr() if return_sweeps else None, b * c, k, w,
             _build.stream_ptr(valid.device))
    nms_fixpoint.launches += 1
    _build.check(err, "nms_fixpoint")
    return (keep, sweeps) if return_sweeps else keep


nms_fixpoint.launches = 0


def _greedy_fixpoint(s: torch.Tensor, oidx: torch.Tensor,
                     iou_hit: torch.Tensor, valid: torch.Tensor,
                     group: Optional[int] = None) -> torch.Tensor:
    """Exact greedy NMS keep masks as a Jacobi fixpoint over a bit-packed
    dominance matrix (``_dominance``), batched over images.

    s (B,C,K) per-class candidate scores; oidx (B,K) original candidate
    indices (tie-break order); iou_hit (B,K,K); valid (B,C,K). Greedy's
    keep is the unique solution of keep[i] = valid[i] and not
    any_j(dom[i,j] and keep[j]); Jacobi iteration from keep = valid
    reaches it in (longest suppression chain + 2) sweeps, at most K
    (``nms_fixpoint``). ``group``: run the plain version with that many
    sweeps between host reads instead.
    """
    dom_p = _dominance(s, oidx, iou_hit)
    if group is not None:
        return nms_fixpoint_plain(dom_p, valid, group)
    return nms_fixpoint(dom_p, valid)


_greedy_fixpoint.host_syncs = 0


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
    D = max_det. Candidate order follows the input's M order. On the card
    the fixpoint is one ``nms_fixpoint`` launch and the host reads
    nothing; on the CPU its plain version reads the convergence test once
    a group of ``SWEEPS_PER_SYNC`` sweeps (``_greedy_fixpoint.host_syncs``)."""
    b, c, m = scores.shape
    topk = min(topk, m)
    with scope("nms_candidates"):
        if topk < m:
            _, oidx = _desc_topk(scores.amax(dim=1), topk)     # (B,K)
            bk = torch.gather(boxes, 2,
                              oidx[:, None, :].expand(b, 4, topk))
            sk = torch.gather(scores, 2,
                              oidx[:, None, :].expand(b, c, topk))
        else:
            oidx = torch.arange(m, device=boxes.device).expand(b, m)
            bk, sk = boxes, scores
    with scope("nms_suppress"):
        x1 = bk[:, 0] - bk[:, 2] * 0.5                         # (B,K)
        y1 = bk[:, 1] - bk[:, 3] * 0.5
        x2 = bk[:, 0] + bk[:, 2] * 0.5
        y2 = bk[:, 1] + bk[:, 3] * 0.5
        area = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)
        ix1 = torch.maximum(x1[:, :, None], x1[:, None, :])
        iy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
        ix2 = torch.minimum(x2[:, :, None], x2[:, None, :])
        iy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
        inter = (torch.clamp_min(ix2 - ix1, 0)
                 * torch.clamp_min(iy2 - iy1, 0))
        union = area[:, :, None] + area[:, None, :] - inter
        iou = inter / torch.clamp_min(union, 1e-9)
        valid = sk > score_thresh
        keep = _greedy_fixpoint(sk, oidx, iou > iou_thresh, valid)
    with scope("nms_merge"):
        sk_out = torch.where(keep, sk,
                             torch.zeros_like(sk)).reshape(b, c * topk)
        d = min(max_det, c * topk)
        s_top, i_top = _desc_topk(sk_out, d)
        cls = (i_top // topk).to(torch.int32)
        k_idx = i_top % topk
        bxyxy = torch.stack([x1, y1, x2, y2], dim=1)           # (B,4,K)
        bk_out = torch.gather(bxyxy, 2, k_idx[:, None, :].expand(b, 4, d))
        bk_out = bk_out.transpose(1, 2)                        # (B,D,4)
        if d < max_det:           # keep the advertised static shape
            pad = max_det - d
            bk_out = torch.cat([bk_out, bk_out.new_zeros(b, pad, 4)],
                               dim=1)
            s_top = torch.cat([s_top, s_top.new_zeros(b, pad)], dim=1)
            cls = torch.cat([cls, cls.new_zeros(b, pad)], dim=1)
    return bk_out, s_top, cls


def device_nms(boxes: torch.Tensor, scores: torch.Tensor,
               iou_thresh: float = NMS_IOU_THRESH,
               score_thresh: float = SCORE_THRESH_VIS,
               topk: int = MAX_DETECTIONS,
               max_det: int = MAX_DETECTIONS):
    """Row-major ``device_nms_cols``: boxes (B,M,4) cxcywh, scores (B,M,C)
    -> (boxes (B,D,4) xyxy, scores (B,D), classes (B,D) int32). The same
    candidates in the same M order, so the same outputs as the JAX
    function (cx - w/2 and cx - w*0.5 round alike)."""
    return device_nms_cols(boxes.transpose(1, 2), scores.transpose(1, 2),
                           iou_thresh=iou_thresh, score_thresh=score_thresh,
                           topk=topk, max_det=max_det)


def _pairwise_iou_xyxy(b: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) xyxy -> (..., K, K) IoU."""
    area = (torch.clamp_min(b[..., 2] - b[..., 0], 0)
            * torch.clamp_min(b[..., 3] - b[..., 1], 0))
    x1 = torch.maximum(b[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(b[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(b[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(b[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-9)


@torch.no_grad()
def device_nms_seq(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_thresh: float = NMS_IOU_THRESH,
                   score_thresh: float = SCORE_THRESH_VIS,
                   topk: int = MAX_DETECTIONS,
                   max_det: int = MAX_DETECTIONS):
    """The sequential formulation: per-class top-K, then K greedy steps
    (each kept candidate suppresses the later ones it overlaps above
    ``iou_thresh``). boxes (B,M,4) cxcywh, scores (B,M,C); outputs as
    ``device_nms``. A second oracle for the fixpoint; no detect path
    runs it."""
    b, m, c = scores.shape
    topk = min(topk, m)
    sc_k, idx = _desc_topk(scores.transpose(1, 2), topk)        # (B,C,K)
    bxy = cxcywh_to_xyxy(boxes)
    bk = torch.gather(bxy[:, None].expand(b, c, m, 4), 2,
                      idx[..., None].expand(b, c, topk, 4))   # (B,C,K,4)
    iou = _pairwise_iou_xyxy(bk)                               # (B,C,K,K)
    valid = sc_k > score_thresh
    later = (torch.arange(topk, device=boxes.device)[None, :]
             > torch.arange(topk, device=boxes.device)[:, None])  # (K,K)
    suppressed = torch.zeros_like(valid)
    keep = torch.zeros_like(valid)
    for i in range(topk):
        live = ~suppressed[..., i] & valid[..., i]
        keep[..., i] = live
        suppressed |= live[..., None] & (iou[..., i, :] > iou_thresh) \
            & later[i]
    sk = torch.where(keep, sc_k, torch.zeros_like(sc_k)).reshape(b, -1)
    d = min(max_det, c * topk)
    s_top, i_top = _desc_topk(sk, d)
    cls = (i_top // topk).to(torch.int32)
    bk_out = torch.gather(bk.reshape(b, c * topk, 4), 1,
                          i_top[..., None].expand(b, d, 4))
    if d < max_det:
        pad = max_det - d
        bk_out = torch.cat([bk_out, bk_out.new_zeros(b, pad, 4)], dim=1)
        s_top = torch.cat([s_top, s_top.new_zeros(b, pad)], dim=1)
        cls = torch.cat([cls, cls.new_zeros(b, pad)], dim=1)
    return bk_out, s_top, cls


def host_nms(boxes: np.ndarray, scores: np.ndarray,
             iou_thresh: float = NMS_IOU_THRESH,
             score_thresh: float = SCORE_THRESH_VIS,
             max_det: int = MAX_DETECTIONS):
    """Per-class greedy NMS of one image on the host. boxes (M,4) cxcywh,
    scores (M,C) -> (boxes xyxy (D,4), scores (D,), classes (D,)) for the
    D <= max_det survivors, score-descending; the native ``nms_greedy``
    where the library builds, a numpy loop otherwise."""
    from dnn_inference_engine_tpu_torch.runtime.native_bridge import (
        native_nms)
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    bx = np.asarray(cxcywh_to_xyxy(boxes))
    out_b, out_s, out_c = [], [], []
    for c in range(scores.shape[1]):
        sc = scores[:, c]
        cand = np.where(sc > score_thresh)[0]
        cand = cand[np.argsort(-sc[cand], kind="stable")]
        # no cap per class: max_det applies to the merged list below, so
        # the native and numpy paths give the same output
        kept_local = native_nms(bx[cand], sc[cand], iou_thresh,
                                score_thresh, len(cand))
        if kept_local is not None:
            kept = cand[kept_local]
        else:
            kept = []
            for i in cand:
                if all(_iou_single(bx[i], bx[j]) <= iou_thresh
                       for j in kept):
                    kept.append(i)
        for i in kept:
            out_b.append(bx[i])
            out_s.append(sc[i])
            out_c.append(c)
    if not out_b:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                np.zeros((0,), np.int32))
    order = np.argsort(-np.asarray(out_s), kind="stable")[:max_det]
    return (np.asarray(out_b, np.float32)[order],
            np.asarray(out_s, np.float32)[order],
            np.asarray(out_c, np.int32)[order])


def _iou_single(a, b) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
    ua = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
    ub = max(b[2] - b[0], 0) * max(b[3] - b[1], 0)
    return float(inter / max(ua + ub - inter, 1e-9))
