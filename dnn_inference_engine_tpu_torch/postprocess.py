"""Head decode + NMS.

Counterpart of ``dnn_inference_engine_tpu/postprocess.py``:

- the columnar path the engine runs, on the device: ``decode_yolov2_cols``
  and ``decode_yolov3_cols`` (boxes (N,4,M) cxcywh and scores (N,C,M),
  anchor-major order m = anchor*S*S + cell) and ``device_nms_cols`` (one
  class-agnostic candidate top-K, one shared IoU matrix, per-class greedy
  suppression: greedy NMS, on the card one ``nms_suppress`` launch, on
  the CPU a Jacobi fixpoint);
- the row-major public API on the tensors' device: ``decode_yolov2``,
  ``decode_yolov3`` (boxes (N,M,4), scores (N,M,C), m = cell*A +
  anchor), ``cxcywh_to_xyxy``, ``device_nms`` (the same fixpoint) and
  ``device_nms_seq`` (per-class top-K and a K-step greedy loop, a second
  oracle);
- ``nms_suppress`` (``csrc/nms_suppress.cu``), the suppress stage (IoU,
  dominance and JAX's on-device ``lax.while_loop``) as one kernel on the
  card, and its plain version ``nms_suppress_plain``: the IoU in PyTorch,
  ``_dominance``'s words and the fixpoint's loop ``nms_fixpoint_plain``;
- ``host_nms``: per-class greedy NMS of one image in numpy, through the
  native library's ``nms_greedy`` where it builds.

The profiler scopes of the JAX package (``post_decode``,
``nms_candidates``, ``nms_suppress``, ``nms_merge``; opened only while a
profiler runs) let ``runtime/profiling.trace_attribution`` split a
detect's device time.

Plain PyTorch but for the suppress stage on the card: no Pallas kernel
computes these. Tie-breaks follow the
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
from dnn_inference_engine_tpu_torch.ops.gemm import H100_SMS
from dnn_inference_engine_tpu_torch.quant.quantize import f32_tensor
from dnn_inference_engine_tpu_torch.runtime.profiling import (
    launch_span, scope)

# Jacobi sweeps of the NMS fixpoint's plain version (``nms_fixpoint_plain``,
# the CPU's path) between two host reads of its convergence test; the
# kernel (``nms_suppress``) runs the whole stage on the card and reads
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
    anc = f32_tensor(anchors, head.device)                  # (A, 2)
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
    anc = f32_tensor(anchors, head.device)                  # (A, 2)
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
    """Columnar decode: (N,4,M) cxcywh + (N,C,M), anchor-major order.
    ``anchors``: (w, h) pairs, or their (A, 2) float32 tensor on the
    head's device, which the decode reads with no copy (an engine makes
    it once)."""
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


def nms_fixpoint_plain(dom_p: torch.Tensor, valid: torch.Tensor,
                       group: Optional[int] = None,
                       return_sweeps: bool = False):
    """Greedy NMS keep masks (B,C,K) bool as the Jacobi fixpoint of
    ``keep[i] = valid[i] and not any_j(dom[i,j] and keep[j])`` from
    ``keep = valid``, stopping where a sweep changes nothing or after K
    sweeps, as JAX's ``lax.while_loop`` does. ``dom_p`` (B,C,K,W) int64:
    bit j of word w is candidate 64w + j (``_dominance``); ``valid``
    (B,C,K) bool. The loop is batched over (image, class), in groups of
    ``group`` sweeps (default ``SWEEPS_PER_SYNC``) between host reads of
    its convergence test (``_greedy_fixpoint.host_syncs`` counts the
    reads). A sweep after the fixpoint changes nothing, so the masks equal
    those of a read after every sweep, and the K bound holds. With
    ``return_sweeps``, also the sweeps each (image, class) takes when
    JAX's loop runs it alone: (B, C) int32."""
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
    (``nms_fixpoint_plain``, ``group`` sweeps between host reads).
    """
    return nms_fixpoint_plain(_dominance(s, oidx, iou_hit), valid, group)


_greedy_fixpoint.host_syncs = 0


def _iou_hit(xyxy: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """(B,K,K) bool: the pairwise IoU of xyxy (B,4,K) over ``iou_thresh``."""
    x1, y1, x2, y2 = xyxy.unbind(1)                        # (B,K)
    area = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)
    ix1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    iy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    ix2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    iy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = (torch.clamp_min(ix2 - ix1, 0)
             * torch.clamp_min(iy2 - iy1, 0))
    union = area[:, :, None] + area[:, None, :] - inter
    iou = inter / torch.clamp_min(union, 1e-9)
    return iou > iou_thresh


def nms_suppress_plain(xyxy: torch.Tensor, sk: torch.Tensor,
                       oidx: torch.Tensor, iou_thresh: float,
                       score_thresh: float) -> torch.Tensor:
    """Plain PyTorch version of ``nms_suppress`` (same arguments): the
    pairwise IoU (B,K,K) of the candidates' boxes (``_iou_hit``), ``valid
    = sk > score_thresh``, and ``_greedy_fixpoint`` over them (the
    dominance words, then the Jacobi loop with its host reads)."""
    return _greedy_fixpoint(sk, oidx, _iou_hit(xyxy, iou_thresh),
                            sk > score_thresh)


# the largest K the kernel takes: its count of word tasks, 32 W (W + 1)
# with W = ceil(K/64), stays an int
NMS_MAX_K = 1 << 18
# the dynamic shared memory a block may take: the 227 KB of an H100 SM,
# less the kernel's static words and a margin
NMS_SMEM_MAX = 226 * 1024
# the K up to which a class takes one block (its IoUs are few)
NMS_CLUSTER_MIN_K = 513


def nms_suppress_lists(k: int, rows_in_smem: bool = False) -> int:
    """Bytes of one ``nms_suppress`` block's candidate lists at K (the
    layout ``csrc/nms_suppress.cu`` states): boxes 16 K, the bitmatrix
    rows 8 K ceil(K/64) when they stay in shared memory, oidx 8 K, scores,
    areas, positions and rank positions 16 K, the sort's indices 4 P (P
    the power of two >= K), the equal-key flags K."""
    w = -(-k // 64)
    p = 1 << max(k - 1, 0).bit_length()
    return (16 * k + (8 * k * w if rows_in_smem else 0) + 8 * k + 16 * k
            + 4 * p + k)


def nms_suppress_smem(k: int, rows_in_smem: bool,
                      lists_in_smem: bool = True) -> int:
    """Dynamic shared memory of one ``nms_suppress`` block at K: the
    removed and kept words, 16 ceil(K/64), then the lists
    (``nms_suppress_lists``) when they stay in shared memory."""
    return 16 * -(-k // 64) + (nms_suppress_lists(k, rows_in_smem)
                               if lists_in_smem else 0)


def nms_suppress_form(b: int, c: int, k: int, sms: int = H100_SMS) -> dict:
    """How ``nms_suppress`` launches at (B, C, K) on ``sms`` SMs:
    ``threads`` a block (256 up to K 512, so the b32 pin's 640 blocks run
    in one wave; else 1024), ``cluster`` G blocks
    an (image, class) (1 up to K 512; above, the largest of 8, 4, 2 with
    B C G blocks on at most ``sms`` SMs, so the grid runs in one wave: a
    block of K > 512 holds an SM), ``rows_in_smem`` (the bitmatrix
    in shared memory where it fits, else a global scratch of
    ``scratch_words``), ``lists_in_smem`` (the candidates' lists in
    shared memory where they fit, up to K ~4800, else a global region of
    ``list_bytes`` a block), ``smem`` bytes a block."""
    if not 0 < k <= NMS_MAX_K:
        raise ValueError(f"nms_suppress: K = {k}, need 1 <= K <= "
                         f"{NMS_MAX_K}")
    lists_in_smem = nms_suppress_smem(k, False) <= NMS_SMEM_MAX
    rows_in_smem = (lists_in_smem
                    and nms_suppress_smem(k, True) <= NMS_SMEM_MAX)
    cluster = 1
    if k >= NMS_CLUSTER_MIN_K:
        cluster = next((g for g in (8, 4, 2) if b * c * g <= sms), 1)
    return dict(threads=256 if k < NMS_CLUSTER_MIN_K else 1024,
                cluster=cluster, rows_in_smem=rows_in_smem,
                lists_in_smem=lists_in_smem,
                smem=nms_suppress_smem(k, rows_in_smem, lists_in_smem),
                scratch_words=0 if rows_in_smem
                else b * c * k * -(-k // 64),
                list_bytes=0 if lists_in_smem
                else -(-nms_suppress_lists(k) // 16) * 16)


def _check_suppress_args(xyxy, sk, oidx) -> None:
    ok = (xyxy.ndim == 3 and sk.ndim == 3 and oidx.ndim == 2
          and xyxy.dtype == torch.float32 and sk.dtype == torch.float32
          and oidx.dtype == torch.int64 and xyxy.shape[1] == 4
          and xyxy.shape[0] == sk.shape[0] == oidx.shape[0]
          and xyxy.shape[2] == sk.shape[2] == oidx.shape[1]
          and xyxy.device == sk.device == oidx.device)
    if not ok:
        raise ValueError(
            "nms_suppress: need xyxy (B,4,K) float32, sk (B,C,K) float32 "
            "and oidx (B,K) int64 on one device, got "
            f"{xyxy.dtype} {tuple(xyxy.shape)} on {xyxy.device}, "
            f"{sk.dtype} {tuple(sk.shape)} on {sk.device}, "
            f"{oidx.dtype} {tuple(oidx.shape)} on {oidx.device}")


@launch_span("nms_suppress")
def nms_suppress(xyxy: torch.Tensor, sk: torch.Tensor, oidx: torch.Tensor,
                 iou_thresh: float = NMS_IOU_THRESH,
                 score_thresh: float = SCORE_THRESH_VIS) -> torch.Tensor:
    """Greedy NMS keep masks (B,C,K) bool of ``device_nms_cols``'s
    candidates: xyxy (B,4,K) float32 (x1, y1, x2, y2), sk (B,C,K) float32,
    oidx (B,K) int64 (the tie-break among equal scores); a candidate is
    kept when its score is over ``score_thresh`` and no kept candidate
    that precedes it (higher score, or equal score and lower oidx)
    overlaps it with an IoU over ``iou_thresh`` (both thresholds compared
    in float32).

    On a CUDA tensor one launch of ``csrc/nms_suppress.cu`` (the IoU, the
    rank order and the scan on the card; the host reads nothing); on a CPU
    tensor the plain version, ``nms_suppress_plain``."""
    _check_suppress_args(xyxy, sk, oidx)
    if sk.device.type == "cpu":
        return nms_suppress_plain(xyxy, sk, oidx, iou_thresh, score_thresh)
    if sk.device.type != "cuda":
        raise ValueError(f"nms_suppress: unsupported device {sk.device}")
    from dnn_inference_engine_tpu_torch.ops import _build
    b, c, k = sk.shape
    form = nms_suppress_form(b, c, k, _build.sm_count(sk.device))
    xyxy, sk, oidx = xyxy.contiguous(), sk.contiguous(), oidx.contiguous()
    keep = torch.empty(sk.shape, dtype=torch.bool, device=sk.device)
    scratch = (torch.empty(form["scratch_words"], dtype=torch.int64,
                           device=sk.device)
               if form["scratch_words"] else None)
    lists = (torch.empty(b * c * form["cluster"] * form["list_bytes"],
                         dtype=torch.uint8, device=sk.device)
             if form["list_bytes"] else None)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.function("nms_suppress", "nms_suppress",
                         [p, p, p, p, p, p, ctypes.c_longlong, i, i, i, f, f,
                          i, i, i, p])
    err = fn(xyxy.data_ptr(), sk.data_ptr(), oidx.data_ptr(),
             keep.data_ptr(),
             scratch.data_ptr() if scratch is not None else None,
             lists.data_ptr() if lists is not None else None,
             form["list_bytes"], b * c, c, k, float(np.float32(iou_thresh)),
             float(np.float32(score_thresh)), form["cluster"],
             form["threads"], form["smem"], _build.stream_ptr(sk.device))
    nms_suppress.launches += 1
    _build.check(err, "nms_suppress")
    return keep


nms_suppress.launches = 0


def _desc_topk(v: torch.Tensor, k: int):
    """Top-k along the last axis, lower index first among ties (as
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _nms_candidates(boxes: torch.Tensor, scores: torch.Tensor, topk: int):
    """The class-agnostic candidate pool of ``device_nms_cols``: oidx
    (B,K) (the top ``topk`` by best class score, or every M in order),
    their boxes (B,4,K) and scores (B,C,K)."""
    b, c, m = scores.shape
    if topk < m:
        _, oidx = _desc_topk(scores.amax(dim=1), topk)         # (B,K)
        return (oidx, torch.gather(boxes, 2,
                                   oidx[:, None, :].expand(b, 4, topk)),
                torch.gather(scores, 2, oidx[:, None, :].expand(b, c, topk)))
    return torch.arange(m, device=boxes.device).expand(b, m), boxes, scores


def _xyxy_cols(bk: torch.Tensor) -> torch.Tensor:
    """(B,4,K) cxcywh -> (B,4,K) xyxy, as ``nms_suppress`` takes it."""
    x1 = bk[:, 0] - bk[:, 2] * 0.5                             # (B,K)
    y1 = bk[:, 1] - bk[:, 3] * 0.5
    x2 = bk[:, 0] + bk[:, 2] * 0.5
    y2 = bk[:, 1] + bk[:, 3] * 0.5
    return torch.stack([x1, y1, x2, y2], dim=1)


@torch.no_grad()
def device_nms_cols(boxes: torch.Tensor, scores: torch.Tensor,
                    iou_thresh: float = NMS_IOU_THRESH,
                    score_thresh: float = SCORE_THRESH_VIS,
                    topk: int = MAX_DETECTIONS,
                    max_det: int = MAX_DETECTIONS):
    """boxes (B,4,M) cxcywh, scores (B,C,M) -> (boxes (B,D,4) xyxy,
    scores (B,D), classes (B,D) int32), zero-padded, score-descending,
    D = max_det. Candidate order follows the input's M order. On the card
    the suppress stage is one ``nms_suppress`` launch and the host reads
    nothing; on the CPU its plain version reads the fixpoint's convergence
    test once a group of ``SWEEPS_PER_SYNC`` sweeps
    (``_greedy_fixpoint.host_syncs``)."""
    b, c, m = scores.shape
    topk = min(topk, m)
    with scope("nms_candidates"):
        oidx, bk, sk = _nms_candidates(boxes, scores, topk)
    with scope("nms_suppress"):
        bxyxy = _xyxy_cols(bk)
        keep = nms_suppress(bxyxy, sk, oidx, iou_thresh, score_thresh)
    with scope("nms_merge"):
        sk_out = torch.where(keep, sk,
                             torch.zeros_like(sk)).reshape(b, c * topk)
        d = min(max_det, c * topk)
        s_top, i_top = _desc_topk(sk_out, d)
        cls = (i_top // topk).to(torch.int32)
        k_idx = i_top % topk
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
