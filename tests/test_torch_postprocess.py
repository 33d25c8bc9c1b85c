"""The port's columnar decode and fixpoint NMS against the JAX package.

Decode: rtol 1e-5, because sigmoid, exp and softmax differ by a few ulps
between XLA and PyTorch. NMS is fed JAX's decoded boxes and scores and
must give identical keep masks and identical outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu import postprocess as jpost

from dnn_inference_engine_tpu_torch import postprocess as tpost


def _jax_keep(boxes, scores, iou_thresh, score_thresh, topk):
    """JAX's keep masks (B,C,K) and candidate indices, built as
    device_nms_cols builds them."""
    m = boxes.shape[-1]
    keeps, oidxs = [], []
    for bx, sc in zip(boxes, scores):
        bx, sc = jnp.asarray(bx), jnp.asarray(sc)
        if topk < m:
            import jax
            _, oidx = jax.lax.top_k(jnp.max(sc, axis=0), topk)
            bk, sk = jnp.take(bx, oidx, axis=1), jnp.take(sc, oidx, axis=1)
        else:
            oidx = jnp.arange(m, dtype=jnp.int32)
            bk, sk = bx, sc
        x1, y1 = bk[0] - bk[2] * 0.5, bk[1] - bk[3] * 0.5
        x2, y2 = bk[0] + bk[2] * 0.5, bk[1] + bk[3] * 0.5
        area = jnp.maximum(x2 - x1, 0) * jnp.maximum(y2 - y1, 0)
        inter = (jnp.maximum(jnp.minimum(x2[:, None], x2[None]) -
                             jnp.maximum(x1[:, None], x1[None]), 0) *
                 jnp.maximum(jnp.minimum(y2[:, None], y2[None]) -
                             jnp.maximum(y1[:, None], y1[None]), 0))
        iou = inter / jnp.maximum(area[:, None] + area[None] - inter, 1e-9)
        keeps.append(np.asarray(jpost._greedy_fixpoint(
            sk, oidx, iou > iou_thresh, sk > score_thresh)))
        oidxs.append(np.asarray(oidx))
    return np.stack(keeps), np.stack(oidxs)


def _compare_nms(boxes, scores, iou_thresh, score_thresh, topk, max_det):
    ref = jpost.device_nms_cols(jnp.asarray(boxes), jnp.asarray(scores),
                                iou_thresh=iou_thresh,
                                score_thresh=score_thresh, topk=topk,
                                max_det=max_det)
    got = tpost.device_nms_cols(torch.from_numpy(boxes),
                                torch.from_numpy(scores),
                                iou_thresh=iou_thresh,
                                score_thresh=score_thresh, topk=topk,
                                max_det=max_det)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # the keep masks themselves
    k = min(topk, boxes.shape[-1])
    jkeep, oidx = _jax_keep(boxes, scores, iou_thresh, score_thresh, k)
    bt, st = torch.from_numpy(boxes), torch.from_numpy(scores)
    oi = torch.from_numpy(oidx).long()
    bk = torch.gather(bt, 2, oi[:, None, :].expand(-1, 4, -1))
    sk = torch.gather(st, 2, oi[:, None, :].expand(-1, st.shape[1], -1))
    x1, y1 = bk[:, 0] - bk[:, 2] * 0.5, bk[:, 1] - bk[:, 3] * 0.5
    x2, y2 = bk[:, 0] + bk[:, 2] * 0.5, bk[:, 1] + bk[:, 3] * 0.5
    area = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    inter = ((torch.minimum(x2[:, :, None], x2[:, None]) -
              torch.maximum(x1[:, :, None], x1[:, None])).clamp_min(0) *
             (torch.minimum(y2[:, :, None], y2[:, None]) -
              torch.maximum(y1[:, :, None], y1[:, None])).clamp_min(0))
    iou = inter / (area[:, :, None] + area[:, None] - inter).clamp_min(1e-9)
    tkeep = tpost._greedy_fixpoint(sk, oi, iou > iou_thresh,
                                   sk > score_thresh)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    return got


def test_decode_cols_matches_jax():
    head = (np.random.default_rng(3).standard_normal((2, 13, 13, 125))
            * 2).astype(np.float32)
    jb, js = jpost.decode_yolov2_cols(jnp.asarray(head))
    tb, ts = tpost.decode_yolov2_cols(torch.from_numpy(head))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-12)


@pytest.mark.parametrize("s,anchors", [(13, slice(3, None)),
                                       (26, slice(None, 3))])
def test_decode_yolov3_cols_matches_jax(s, anchors):
    """Each YOLOv3 head with its half of the pixel anchors (sigmoid class
    scores, no softmax)."""
    from dnn_inference_engine_tpu.config import YOLOV3_TINY_ANCHORS
    head = (np.random.default_rng(s).standard_normal((2, s, s, 75))
            * 2).astype(np.float32)
    anc = YOLOV3_TINY_ANCHORS[anchors]
    jb, js = jpost.decode_yolov3_cols(jnp.asarray(head), anc)
    tb, ts = tpost.decode_yolov3_cols(torch.from_numpy(head), anc)
    assert tuple(tb.shape) == (2, 4, 3 * s * s)
    assert tuple(ts.shape) == (2, 20, 3 * s * s)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-12)


@pytest.mark.parametrize("topk", [845, 64])
def test_nms_on_jax_decode_matches_jax(topk):
    """Fed JAX's decoded boxes: uncapped and top-K-capped pools."""
    head = (np.random.default_rng(4).standard_normal((2, 13, 13, 125))
            * 2).astype(np.float32)
    jb, js = jpost.decode_yolov2_cols(jnp.asarray(head))
    got = _compare_nms(np.array(jb), np.array(js), 0.45, 0.05, topk, 64)
    assert int((got[1] > 0).sum()) > 10


def test_nms_deep_suppression_chain_matches_jax():
    """Each box suppresses only its neighbour (spacing 10, width 40):
    greedy keeps every other box; the fixpoint needs ~n sweeps."""
    n = 24
    cx = 100 + 10 * np.arange(n, dtype=np.float32)
    boxes = np.stack([cx, np.full(n, 100, np.float32),
                      np.full(n, 40, np.float32),
                      np.full(n, 40, np.float32)])[None]        # (1,4,n)
    scores = np.linspace(0.9, 0.4, n, dtype=np.float32)[None, None]
    got = _compare_nms(boxes, scores, 0.45, 0.1, n, n)
    assert int((got[1] > 0).sum()) == n // 2


def test_nms_ties_follow_candidate_order():
    """Equal scores: lower candidate index first, as jax.lax.top_k."""
    boxes = np.tile(np.array([[100], [100], [40], [40]], np.float32),
                    (1, 1, 6))
    boxes[0, 0] += np.arange(6, dtype=np.float32) * 50
    scores = np.full((1, 3, 6), 0.5, np.float32)
    _compare_nms(boxes, scores, 0.45, 0.1, 4, 8)


def test_pack_bits():
    """Bit b of word w is element w*64+b, zero-padded to a word."""
    rng = np.random.default_rng(5)
    for shape in ((7,), (3, 65), (2, 4, 128), (5, 150)):
        x = rng.uniform(0, 1, shape) > 0.5
        p = tpost._pack_bits(torch.from_numpy(x)).numpy()
        k = shape[-1]
        assert p.shape == shape[:-1] + (-(-k // 64),)
        bits = (p[..., :, None].view(np.uint64)
                >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
        bits = bits.reshape(shape[:-1] + (-1,))[..., :k].astype(bool)
        np.testing.assert_array_equal(bits, x)
