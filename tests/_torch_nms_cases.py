"""Seeded inputs of the NMS's suppress stage, in numpy, for the CPU tests
(against the JAX package) and the card tests (the kernel against its
plain version). No JAX here: the card tests import it.

A fixpoint case (``CASES``, for ``postprocess.nms_fixpoint_plain`` and
JAX's ``_greedy_fixpoint``) is ``(s, oidx, hit, valid)``: per-class
candidate scores s (B, C, K) float32, the candidates' original indices
oidx (B, K) int64 (the tie-break order), the IoU-above-threshold relation
hit (B, K, K) bool and valid (B, C, K) bool, as ``device_nms_cols`` builds
them. A box case (``BOX_CASES``, for ``postprocess.nms_suppress``) is
``(xyxy, s, oidx)``: the candidates' boxes (B, 4, K) float32 as x1, y1,
x2, y2 planes, s and oidx; ``IOU_THRESH`` and ``SCORE_THRESH`` apply.
"""

import numpy as np

IOU_THRESH = 0.45
SCORE_THRESH = 0.2


def _hits(rng, b, k, clusters):
    """Boxes jittered around a few cluster centres (so suppression chains
    form), their pairwise IoU above ``IOU_THRESH``."""
    centre = rng.uniform(16, 240, (b, clusters, 2))
    which = rng.integers(0, clusters, (b, k))
    xy = np.take_along_axis(centre, which[..., None], 1) + rng.normal(
        0, 6, (b, k, 2))
    wh = rng.uniform(12, 40, (b, k, 2))
    lo, hi = xy - wh / 2, xy + wh / 2
    ix = np.clip(np.minimum(hi[:, :, None, 0], hi[:, None, :, 0])
                 - np.maximum(lo[:, :, None, 0], lo[:, None, :, 0]), 0, None)
    iy = np.clip(np.minimum(hi[:, :, None, 1], hi[:, None, :, 1])
                 - np.maximum(lo[:, :, None, 1], lo[:, None, :, 1]), 0, None)
    inter = ix * iy
    area = wh[..., 0] * wh[..., 1]
    iou = inter / (area[:, :, None] + area[:, None, :] - inter)
    return iou > IOU_THRESH


def random_case(b, c, k, seed, ties=False, clusters=None):
    """Clustered boxes; scores cubed uniforms (most under the threshold),
    or with ``ties`` a few levels, so that exact ties are common and the
    index breaks them; a random candidate order."""
    rng = np.random.default_rng(seed)
    hit = _hits(rng, b, k, clusters or max(2, k // 24))
    if ties:
        s = (rng.integers(0, 5, (b, c, k)) / 4).astype(np.float32)
    else:
        s = (rng.uniform(0, 1, (b, c, k)) ** 3).astype(np.float32)
    oidx = np.stack([rng.permutation(4 * k)[:k] for _ in range(b)])
    return s, oidx.astype(np.int64), hit, s > SCORE_THRESH


def empty_case(b, c, k, seed):
    """No valid candidate: every score under the threshold."""
    s, oidx, hit, _ = random_case(b, c, k, seed)
    s = s * SCORE_THRESH
    return s, oidx, hit, s > SCORE_THRESH


def chain_case(k):
    """One image, one class: K candidates in a chain, each overlapping only
    its neighbours, scores falling along it. Greedy keeps every other one
    after K - 1 dependent steps: the deepest chain K candidates hold, so
    the K cap stops the loop just where the masks are right."""
    s = np.linspace(0.9, 0.4, k, dtype=np.float32)[None, None]
    idx = np.arange(k)
    hit = (np.abs(idx[:, None] - idx[None, :]) <= 1)[None]
    return s, idx[None].astype(np.int64), hit, s > SCORE_THRESH


# name -> the case at the CPU tests' size
CASES = {
    "k256": lambda: random_case(2, 3, 256, seed=1),
    "k100": lambda: random_case(2, 3, 100, seed=2),
    "k100_ties": lambda: random_case(2, 3, 100, seed=3, ties=True),
    "k256_ties": lambda: random_case(2, 3, 256, seed=4, ties=True),
    "k256_empty": lambda: empty_case(2, 3, 256, seed=5),
    "k100_chain": lambda: chain_case(100),
    "k65_chain": lambda: chain_case(65),
}


def _boxes(rng, b, k, clusters):
    """(B, 4, K) float32 xyxy: boxes jittered around a few cluster centres
    (so suppression chains form)."""
    centre = rng.uniform(16, 400, (b, clusters, 2))
    which = rng.integers(0, clusters, (b, k))
    xy = np.take_along_axis(centre, which[..., None], 1) + rng.normal(
        0, 6, (b, k, 2))
    wh = rng.uniform(12, 40, (b, k, 2))
    lo, hi = xy - wh / 2, xy + wh / 2
    return np.stack([lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]],
                    1).astype(np.float32)


def box_case(b, c, k, seed, ties=False, valid_share=None):
    """Clustered boxes; scores cubed uniforms (most under the threshold),
    with ``ties`` a few levels (exact ties common, the oidx breaks them),
    or with ``valid_share`` that share over the threshold (1: every
    candidate valid, as at the eval grade); a random candidate order."""
    rng = np.random.default_rng(seed)
    xyxy = _boxes(rng, b, k, max(2, k // 24))
    if ties:
        s = rng.integers(0, 5, (b, c, k)) / 4
    elif valid_share is not None:
        s = SCORE_THRESH + (1 - SCORE_THRESH) * rng.uniform(0, 1, (b, c, k))
        s[rng.uniform(0, 1, (b, c, k)) >= valid_share] = 0
    else:
        s = rng.uniform(0, 1, (b, c, k)) ** 3
    oidx = np.stack([rng.permutation(4 * k)[:k] for _ in range(b)])
    return xyxy, s.astype(np.float32), oidx.astype(np.int64)


def box_empty_case(b, c, k, seed):
    """No valid candidate: every score under the threshold."""
    xyxy, s, oidx = box_case(b, c, k, seed)
    return xyxy, (s * SCORE_THRESH).astype(np.float32), oidx


def box_chain_case(k):
    """One image, one class: K boxes 10 px wide along x, 3 px apart, so
    each overlaps its neighbours (IoU 7/13) and no other (IoU 4/16 at two
    steps); scores falling along the chain. Greedy keeps every other one
    after K - 1 dependent steps."""
    x = 3 * np.arange(k, dtype=np.float32)
    xyxy = np.stack([x, np.zeros(k, np.float32), x + 10,
                     np.full(k, 10, np.float32)])[None]
    s = np.linspace(0.9, 0.4, k, dtype=np.float32)[None, None]
    return xyxy, s, np.arange(k, dtype=np.int64)[None]


def iou_f32(a, b):
    """The plain version's IoU of xyxy boxes a and b ((..., 4) float32),
    step by step in float32: b the earlier candidate."""
    f = np.float32
    area = [np.maximum(x[..., 2] - x[..., 0], f(0))
            * np.maximum(x[..., 3] - x[..., 1], f(0)) for x in (a, b)]
    inter = (np.maximum(np.minimum(a[..., 2], b[..., 2])
                        - np.maximum(a[..., 0], b[..., 0]), f(0))
             * np.maximum(np.minimum(a[..., 3], b[..., 3])
                          - np.maximum(a[..., 1], b[..., 1]), f(0)))
    return inter / np.maximum((area[0] + area[1]) - inter, f(1e-9))


def ulp_pairs(widths=(100.0, 211.0, 1000.0, 53.0, 37.0, 401.0)):
    """Pairs of boxes (wide a, narrow b, one row band each) whose float32
    IoU is f32(IOU_THRESH) or one ulp either side of it: [(a, b, iou)]."""
    t = np.float32(IOU_THRESH)
    want = {np.nextafter(t, np.float32(0)), t, np.nextafter(t, np.float32(1))}
    out = []
    for a in widths:
        a = np.float32(a)
        bw = np.float32(IOU_THRESH) * a
        for direction in (np.float32(0), np.float32(np.inf)):
            x = bw
            for _ in range(64):
                q = iou_f32(np.array([0, 0, x, 1], np.float32),
                            np.array([0, 0, a, 1], np.float32))
                if q in want and (a, x) not in [(p[0], p[1]) for p in out]:
                    out.append((a, x, q))
                x = np.nextafter(x, direction)
    return out


def box_ulp_case():
    """One image, two classes: each pair of ``ulp_pairs`` in a row band of
    its own (y 2p .. 2p + 1), the wide box first in rank; pairs whose IoU
    is over f32(0.45) lose their narrow box, the others keep both. The
    second class ranks the narrow box first."""
    pairs = ulp_pairs()
    k = 2 * len(pairs)
    xyxy = np.zeros((1, 4, k), np.float32)
    for p, (a, b, _) in enumerate(pairs):
        xyxy[0, :, 2 * p] = [0, 2 * p, a, 2 * p + 1]
        xyxy[0, :, 2 * p + 1] = [0, 2 * p, b, 2 * p + 1]
    s = np.empty((1, 2, k), np.float32)
    s[0, 0] = np.where(np.arange(k) % 2 == 0, 0.9, 0.6)
    s[0, 1] = np.where(np.arange(k) % 2 == 0, 0.6, 0.9)
    return xyxy, s, np.arange(k, dtype=np.int64)[None]


def box_oidx_reversed_case(k=100, seed=9):
    """Equal scores in each class, oidx running against the position: the
    oidx alone orders the scan, opposite to the candidates' order."""
    xyxy, _, _ = box_case(1, 2, k, seed)
    s = np.full((1, 2, k), 0.5, np.float32)
    s[0, 1, ::3] = 0.7
    return xyxy, s, (k - 1 - np.arange(k, dtype=np.int64))[None]


def box_dup_case(k=100, seed=10):
    """Equal scores and equal oidx in runs (neither of such a pair
    precedes the other, so neither suppresses the other)."""
    xyxy, _, _ = box_case(1, 2, k, seed)
    rng = np.random.default_rng(seed)
    s = (rng.integers(0, 3, (1, 2, k)) / 2).astype(np.float32)
    oidx = (np.arange(k, dtype=np.int64) // 3)[None]
    return xyxy, s, oidx


def box_nonfinite_case(k=100, seed=11):
    """NaN and infinite coordinates and a NaN score: a NaN anywhere in an
    IoU makes it NaN, which is no hit; a NaN score is not valid."""
    xyxy, s, oidx = box_case(1, 2, k, seed, valid_share=0.8)
    xyxy[0, 0, 3] = np.nan
    xyxy[0, 2, 7] = np.inf
    xyxy[0, 1, 11] = -np.inf
    xyxy[0, 3, 11] = np.inf
    xyxy[0, :, 20] = np.nan
    s[0, 0, 5] = np.nan
    return xyxy, s, oidx


def box_degenerate_case(k=64, seed=12):
    """Zero-area and inverted boxes (union floored at 1e-9) and exact
    duplicates of a box."""
    xyxy, s, oidx = box_case(1, 2, k, seed, valid_share=0.9)
    xyxy[0, 2, :8] = xyxy[0, 0, :8]                  # zero width
    xyxy[0, 2, 8:12] = xyxy[0, 0, 8:12] - 5          # inverted
    xyxy[0, :, 12:20] = xyxy[0, :, 20:21]            # copies of box 20
    return xyxy, s, oidx


# name -> the box case at the CPU tests' size; the fixpoint cases' names
# first, as boxes
BOX_CASES = {
    "k256": lambda: box_case(2, 3, 256, seed=1),
    "k100": lambda: box_case(2, 3, 100, seed=2),
    "k100_ties": lambda: box_case(2, 3, 100, seed=3, ties=True),
    "k256_ties": lambda: box_case(2, 3, 256, seed=4, ties=True),
    "k256_empty": lambda: box_empty_case(2, 3, 256, seed=5),
    "k100_chain": lambda: box_chain_case(100),
    "k65_chain": lambda: box_chain_case(65),
    "ulp": box_ulp_case,
    "oidx_reversed": box_oidx_reversed_case,
    "dup_keys": box_dup_case,
    "nonfinite": box_nonfinite_case,
    "degenerate": box_degenerate_case,
    "k845_all_valid": lambda: box_case(1, 2, 845, seed=13, valid_share=1),
    "k2535_all_valid": lambda: box_case(1, 2, 2535, seed=14, valid_share=1),
}
