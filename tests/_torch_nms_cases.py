"""Seeded inputs of the NMS fixpoint (``postprocess.nms_fixpoint``), in
numpy, for the CPU tests (against the JAX package) and the card tests
(the kernel against its plain version). No JAX here: the card tests
import it.

A case is ``(s, oidx, hit, valid)``: per-class candidate scores s
(B, C, K) float32, the candidates' original indices oidx (B, K) int64
(the tie-break order), the IoU-above-threshold relation hit (B, K, K)
bool and valid (B, C, K) bool, as ``device_nms_cols`` builds them.
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
