"""The port's decode and NMS against the JAX package.

Decode, columnar and row-major: rtol 1e-5, because sigmoid, exp and
softmax differ by a few ulps between XLA and PyTorch; fed the port's own
decode, the NMS gives the JAX one's classes and survivor counts exactly
and its boxes within 1e-3 px. Fed JAX's decoded boxes and scores, every
NMS (columnar and row-major fixpoint, sequential, host) must give
identical keep masks and outputs. The fixpoint's sweeps run in groups
between host reads: its masks must equal those of a read after every
sweep and a plain greedy loop.
"""

import time

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


# ---------------------------------------------------------------------------
# The row-major API, the sequential and host NMS
# ---------------------------------------------------------------------------

def _head(seed, s=13, e=125):
    return (np.random.default_rng(seed).standard_normal((2, s, s, e))
            * 2).astype(np.float32)


@pytest.mark.parametrize("model", ["v2", "v3-13", "v3-26"])
def test_decode_rows_matches_jax(model):
    from dnn_inference_engine_tpu.config import YOLOV3_TINY_ANCHORS
    if model == "v2":
        head = _head(6)
        jb, js = jpost.decode_yolov2(jnp.asarray(head))
        tb, ts = tpost.decode_yolov2(torch.from_numpy(head))
    else:
        s, anc = ((13, YOLOV3_TINY_ANCHORS[3:]) if model == "v3-13"
                  else (26, YOLOV3_TINY_ANCHORS[:3]))
        head = _head(7, s, 75)
        jb, js = jpost.decode_yolov3(jnp.asarray(head), anc)
        tb, ts = tpost.decode_yolov3(torch.from_numpy(head), anc)
    assert tb.shape == jb.shape and ts.shape == js.shape
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-12)


def test_cxcywh_to_xyxy_matches_jax():
    b = np.random.default_rng(8).uniform(0, 400, (3, 7, 4)).astype(
        np.float32)
    want = np.asarray(jpost.cxcywh_to_xyxy(jnp.asarray(b)))
    np.testing.assert_array_equal(tpost.cxcywh_to_xyxy(b), want)
    np.testing.assert_array_equal(
        tpost.cxcywh_to_xyxy(torch.from_numpy(b)).numpy(), want)


def _rows_inputs(seed):
    jb, js = jpost.decode_yolov2(jnp.asarray(_head(seed)))
    return np.array(jb), np.array(js)


@pytest.mark.parametrize("fn", ["device_nms", "device_nms_seq"])
@pytest.mark.parametrize("topk,thresh", [(845, 0.05), (64, 0.05),
                                         (256, 0.3)])
def test_row_major_nms_matches_jax(fn, topk, thresh):
    boxes, scores = _rows_inputs(9)
    kw = dict(iou_thresh=0.45, score_thresh=thresh, topk=topk, max_det=64)
    want = getattr(jpost, fn)(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    got = getattr(tpost, fn)(torch.from_numpy(boxes),
                             torch.from_numpy(scores), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.asarray(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[1] > 0).sum()) > 0


@pytest.mark.parametrize("topk", [845, 64])
def test_nms_on_own_decode_matches_jax(topk):
    """Each package from the same head through its own decode: classes
    and survivor counts exact, boxes within 1e-3 px."""
    head = _head(10)
    jb, js = jpost.decode_yolov2(jnp.asarray(head))
    want = jpost.device_nms(jb, js, score_thresh=0.05, topk=topk,
                            max_det=128)
    tb, ts = tpost.decode_yolov2(torch.from_numpy(head))
    got = tpost.device_nms(tb, ts, score_thresh=0.05, topk=topk,
                           max_det=128)
    np.testing.assert_array_equal((got[1] > 0).sum(1).numpy(),
                                  (np.asarray(want[1]) > 0).sum(1))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("native", [True, False])
def test_host_nms_matches_jax_and_device_nms(monkeypatch, native):
    """host_nms against JAX's (native library, or both on the numpy loop)
    and against device_nms's survivors with the pool uncapped."""
    from dnn_inference_engine_tpu.runtime import native_bridge as jnb
    from dnn_inference_engine_tpu_torch.runtime import native_bridge as tnb
    if native:
        # JAX's bridge gives up for the process on a library another test
        # process is still writing (make -C native): load it again
        for _ in range(10):
            if jnb.native_available():
                break
            time.sleep(1.0)
            jnb._load_attempted, jnb._lib = False, None
        assert jnb.native_available() and tnb.native_available()
    else:
        for mod in (jnb, tnb):
            monkeypatch.setattr(mod, "native_nms", lambda *a: None)
    boxes, scores = _rows_inputs(11)
    for i in range(2):
        got = tpost.host_nms(boxes[i], scores[i], 0.45, 0.05, 128)
        want = jpost.host_nms(boxes[i], scores[i], 0.45, 0.05, 128)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        db, ds, dc = (t[i].numpy() for t in tpost.device_nms(
            torch.from_numpy(boxes), torch.from_numpy(scores),
            score_thresh=0.05, topk=845, max_det=128))
        n = int((ds > 0).sum())
        assert n == len(got[1]) > 0
        dev = sorted(zip(dc[:n].tolist(), ds[:n].tolist()))
        hst = sorted(zip(got[2].tolist(), got[1].tolist()))
        assert dev == hst
    empty = tpost.host_nms(boxes[0], scores[0] * 0, 0.45, 0.05, 128)
    assert [e.shape for e in empty] == [(0, 4), (0,), (0,)]


# ---------------------------------------------------------------------------
# The fixpoint's sweeps in groups between host reads (ROADMAP C3)
# ---------------------------------------------------------------------------

def _greedy_ref(s, oidx, iou_hit, valid):
    """Plain greedy per image and class: in (score desc, index) order,
    keep a valid candidate no kept one overlaps."""
    b, c, k = s.shape
    keep = np.zeros((b, c, k), bool)
    for bi in range(b):
        for ci in range(c):
            order = sorted(range(k), key=lambda j: (-s[bi, ci, j],
                                                    oidx[bi, j]))
            kept = []
            for j in order:
                if valid[bi, ci, j] and not any(iou_hit[bi, j, q]
                                                for q in kept):
                    kept.append(j)
            keep[bi, ci, kept] = True
    return keep


def _fixpoint_both(s, oidx, iou_hit, valid, group):
    args = [torch.from_numpy(a) for a in (s, oidx, iou_hit, valid)]
    tpost._greedy_fixpoint.host_syncs = 0
    one = tpost._greedy_fixpoint(*args, group=1).numpy()
    syncs_one = tpost._greedy_fixpoint.host_syncs
    tpost._greedy_fixpoint.host_syncs = 0
    grouped = tpost._greedy_fixpoint(*args, group=group).numpy()
    syncs = tpost._greedy_fixpoint.host_syncs
    np.testing.assert_array_equal(grouped, one)
    np.testing.assert_array_equal(grouped, _greedy_ref(s, oidx, iou_hit,
                                                       valid))
    return syncs_one, syncs


@pytest.mark.parametrize("group", [2, 4, 7])
@pytest.mark.parametrize("seed", range(6))
def test_fixpoint_groups_match_per_sweep_and_greedy(seed, group):
    """Fuzzed scores (ties among them), overlaps and validity."""
    rng = np.random.default_rng(seed)
    b, c, k = 2, 3, int(rng.integers(5, 40))
    s = rng.integers(0, 6, (b, c, k)).astype(np.float32) / 5
    oidx = np.stack([rng.permutation(k) for _ in range(b)]).astype(np.int64)
    hit = rng.uniform(0, 1, (b, k, k)) < rng.uniform(0.05, 0.5)
    hit = hit | hit.transpose(0, 2, 1)
    valid = s > 0.1
    syncs_one, syncs = _fixpoint_both(s, oidx, hit, valid, group)
    assert syncs <= syncs_one
    assert syncs == -(-syncs_one // group) or syncs <= syncs_one


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("n", [3, 24, 65])
def test_fixpoint_long_chain_and_k_bound(n, group):
    """A chain: each candidate overlaps only its neighbours, scores
    falling along it, so greedy keeps every other one after n - 1
    dependent steps. Jacobi needs n + 1 sweeps to see the fixpoint; the
    K bound stops it at n, where it already holds."""
    s = np.linspace(0.9, 0.4, n, dtype=np.float32)[None, None]
    oidx = np.arange(n, dtype=np.int64)[None]
    idx = np.arange(n)
    hit = (np.abs(idx[:, None] - idx[None, :]) == 1)[None]
    valid = np.ones((1, 1, n), bool)
    syncs_one, syncs = _fixpoint_both(s, oidx, hit, valid, group)
    assert syncs_one == n - 1
    assert syncs == -(-(n - 1) // group)


def test_fixpoint_syncs_per_detect():
    """device_nms_cols reads the host once a group of sweeps: a seeded
    13x13 head at score 0.05 (K = 845) converges within the first
    group, one read per detect."""
    jb, js = jpost.decode_yolov2_cols(jnp.asarray(_head(12)))
    tpost._greedy_fixpoint.host_syncs = 0
    tpost.device_nms_cols(torch.from_numpy(np.array(jb)),
                          torch.from_numpy(np.array(js)),
                          score_thresh=0.05, topk=845, max_det=64)
    assert tpost._greedy_fixpoint.host_syncs == 1
    assert tpost.SWEEPS_PER_SYNC == 4
