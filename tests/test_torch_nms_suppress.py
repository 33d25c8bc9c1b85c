"""The NMS's suppress stage on the CPU (``postprocess.nms_suppress``,
``csrc/nms_suppress.cu``).

- The plain version (``nms_suppress_plain``: the PyTorch IoU, the
  dominance words and the fixpoint's loop) equals JAX's
  ``_greedy_fixpoint`` fed JAX's own IoU of the same boxes, image by image,
  bit for bit, and the port's ``device_nms_cols`` equals JAX's end to end.
- A numpy replay of the kernel's schedule (``replay_kernel``: compaction
  by warp ballots, the bitonic rank sort, the rank-order gather, the
  float32 IoU step by step, the bitmatrix word tasks split over a
  cluster's blocks, the fix-up of equal keys, the warp's chunked scan and
  the scatter) equals the plain version bit for bit: the fixpoint cases
  as boxes (ties, nothing valid, chains K - 1 deep), IoUs one ulp either
  side of f32(0.45), equal scores with the oidx against the position,
  equal scores and oidx, NaN and infinite boxes, degenerate boxes, and
  every candidate valid at K 845 (the bitmatrix in shared memory) and K
  2535 (the global scratch).
- The launch form (``nms_suppress_form``: the candidates' lists in global
  memory above K ~4800, so every pool up to ``NMS_MAX_K`` launches) and
  the wrapper's refusals.

The kernel itself runs on the card only (``tests/test_torch_gpu.py``).
Many small torch ops: the module pins one thread (ROADMAP C5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from dnn_inference_engine_tpu import postprocess as jpost

from dnn_inference_engine_tpu_torch import postprocess as tpost

from _torch_nms_cases import (BOX_CASES, IOU_THRESH, SCORE_THRESH,
                              box_case, iou_f32, ulp_pairs)

SMS = 132                            # an H100 SXM
COUNT_MAX = 256                      # the kernel ranks so many by counting
F = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(torch_threads)


def _plain(case, iou_thresh=IOU_THRESH, score_thresh=SCORE_THRESH):
    xyxy, s, oidx = (torch.from_numpy(a) for a in case)
    return tpost.nms_suppress_plain(xyxy, s, oidx, iou_thresh,
                                    score_thresh).numpy()


# ---------------------------------------------------------------------------
# the kernel's schedule in numpy
# ---------------------------------------------------------------------------

def _before(a, b, n, s, o):
    """The kernel's rank order of compacted indices (vectorized): score
    descending, then oidx, then position; indices >= n after all."""
    pad = (a >= n) | (b >= n)
    a_, b_ = np.minimum(a, max(n - 1, 0)), np.minimum(b, max(n - 1, 0))
    sa, sb = s[a_], s[b_]
    oa, ob = o[a_], o[b_]
    real = np.where(sa != sb, sa > sb,
                    np.where(oa != ob, oa < ob, a < b))
    return np.where(pad, a < b, real)


def _count_ranks(n, s, o):
    """The kernel's rank for n <= COUNT_MAX: thread i counts the j that
    come before i; idx[rank] = i."""
    i = np.arange(n)
    before = _before(i[None, :], i[:, None], n, s, o)     # [i, j]: j first
    idx = np.full(n, -1)
    idx[before.sum(1)] = i
    return idx


def _bitonic(n, s, o):
    """The kernel's sort network over Pn = pow2 >= n indices, pair p of a
    stage at i = 2p - (p & (j - 1)), l = i + j."""
    pn = 1
    while pn < n:
        pn *= 2
    idx = np.arange(pn)
    k2 = 2
    while k2 <= pn:
        j = k2 // 2
        while j > 0:
            p = np.arange(pn // 2)
            i = 2 * p - (p & (j - 1))
            l = i + j
            x, y = idx[i], idx[l]
            up = (i & k2) == 0
            swap = np.where(up, _before(y, x, n, s, o), _before(x, y, n, s, o))
            idx[i], idx[l] = np.where(swap, y, x), np.where(swap, x, y)
            j //= 2
        k2 *= 2
    return idx


def _compact(s_all, thr, threads):
    """Chunks of ``threads`` candidates: a warp's ballot, the warps'
    counts summed before it, a lane's rank among its warp's valid lanes."""
    k = s_all.shape[0]
    slots = np.full(k, -1)
    n = 0
    for k0 in range(0, k, threads):
        flags = np.zeros(threads, bool)
        chunk = s_all[k0:k0 + threads]
        with np.errstate(invalid="ignore"):
            flags[:chunk.shape[0]] = chunk > thr
        per_warp = flags.reshape(-1, 32)
        counts = per_warp.sum(1)
        warp_off = np.concatenate([[0], np.cumsum(counts)[:-1]])
        lane_rank = np.cumsum(per_warp, 1) - per_warp
        j = n + warp_off[:, None] + lane_rank
        slots[k0:k0 + chunk.shape[0]] = np.where(
            per_warp, j, -1).reshape(-1)[:chunk.shape[0]]
        n += int(counts.sum())
    pos = np.full(n, -1)
    pos[slots[slots >= 0]] = np.flatnonzero(slots >= 0)
    return pos


def _tasks(n, g, cluster):
    """Block ``g``'s tasks q (its groups of S lanes take q0 + group + i *
    groups) and each one's (row, word): rows grouped by 64, group gg's
    rows holding words gg .. Wn - 1, a group's tasks word-major."""
    wn = -(-n // 64)
    q_all = 32 * wn * (wn + 1)
    q = np.arange(q_all * g // cluster, q_all * (g + 1) // cluster)
    starts = np.concatenate([[0], np.cumsum(64 * (wn - np.arange(wn)))])
    gg = np.searchsorted(starts, q, side="right") - 1
    local = q - starts[gg]
    return q, 64 * gg + local % 64, gg + local // 64


def lanes_a_task(n, cluster, threads):
    """The kernel's S: the most lanes a task (a power of two up to 32)
    with every live task (row < n) of a block given S lanes at once."""
    wn = -(-n // 64)
    live = (32 * wn * (wn + 1) - (64 * wn - n)) // cluster
    s = 1
    while s < 32 and live * s * 2 <= threads:
        s *= 2
    return s


def task_rows_words(n, g, cluster):
    """The (row, word) of every task block ``g`` of a cluster writes, rows
    >= n (the last group's padding) dropped."""
    _, r, w = _tasks(n, g, cluster)
    return r[r < n], w[r < n]


def replay_kernel(xyxy, sk, oidx, iou_thresh=IOU_THRESH,
                  score_thresh=SCORE_THRESH, sms=SMS):
    """keep (B, C, K) as the kernel computes it, a cluster of G blocks an
    (image, class) (``nms_suppress_form``)."""
    b, c, k = sk.shape
    form = tpost.nms_suppress_form(b, c, k, sms)
    cl, threads = form["cluster"], form["threads"]
    thr_s, thr_iou = F(score_thresh), F(iou_thresh)
    keep = np.zeros((b, c, k), bool)
    for bi in range(b):
        for ci in range(c):
            s_all = sk[bi, ci]
            # 1. compact, in position order
            pos = _compact(s_all, thr_s, threads)
            n = pos.shape[0]
            s, o = s_all[pos], oidx[bi][pos]
            # 2. rank
            idx = _bitonic(n, s, o)[:n]
            if n <= COUNT_MAX:
                assert np.array_equal(_count_ranks(n, s, o), idx)
            # 3. gather in rank order; equal keys
            rpos = pos[idx]
            box = xyxy[bi][:, rpos].T                        # (n, 4)
            dup = np.zeros(n, bool)
            dup[1:] = (s[idx][1:] == s[idx][:-1]) & (o[idx][1:] == o[idx][:-1])
            # 4. build: word w of row r holds hit(64w + j, r) for 64w + j > r
            wn = -(-n // 64)
            with np.errstate(invalid="ignore", divide="ignore"):
                hit = iou_f32(box[:, None, :], box[None, :, :]) > thr_iou
            later = np.arange(n)[:, None] > np.arange(n)[None, :]
            hit &= later                                     # [r2, r]
            # finite boxes: a pair whose bounds do not overlap tests 0 > thr
            with np.errstate(invalid="ignore", over="ignore"):
                area = ((box[:, 2] - box[:, 0]).clip(0)
                        * (box[:, 3] - box[:, 1]).clip(0))
            if np.isfinite(box).all() and np.isfinite(area).all():
                a, b_ = box[:, None, :], box[None, :, :]
                ov = ((np.minimum(a[..., 2], b_[..., 2])
                       > np.maximum(a[..., 0], b_[..., 0]))
                      & (np.minimum(a[..., 3], b_[..., 3])
                         > np.maximum(a[..., 1], b_[..., 1])))
                assert np.array_equal(hit & ~ov,
                                      later & ~ov & (F(0) > thr_iou))
            padded = np.zeros((64 * wn, n), bool)
            padded[:n] = hit
            lanes = np.uint64(1) << np.arange(64, dtype=np.uint64)
            dense = (padded.reshape(wn, 64, n).astype(np.uint64)
                     * lanes[None, :, None]).sum(1).T        # (n, wn)
            rows = np.full((n, wn), 0xDEAD, np.uint64)      # unwritten
            written = np.zeros((n, wn), int)
            for g in range(cl):
                r, w = task_rows_words(n, g, cl)
                rows[r, w] = dense[r, w]
                np.add.at(written, (r, w), 1)
            upper = np.arange(wn)[None, :] >= (np.arange(n) // 64)[:, None]
            assert np.array_equal(written, upper.astype(int))
            # 5. clear the bits between equal keys
            for r2 in np.flatnonzero(dup):
                gs = r2
                while gs > 0 and dup[gs]:
                    gs -= 1
                rows[gs:r2, r2 // 64] &= ~np.uint64(1 << (r2 % 64))
            # 6. the scan, 64 ranks a chunk: warp 0 walks the ranks whose
            # diagonal word is nonzero; the block ORs the kept rows' words
            removed = np.zeros(wn, np.uint64)
            kept_bits = np.zeros(wn, np.uint64)
            for ch in range(wn):
                r0, m = 64 * ch, min(64, n - 64 * ch)
                diag = [int(x) for x in rows[r0:r0 + m, ch]]
                live = (1 << m) - 1
                nz = sum(1 << j for j in range(m) if diag[j])
                rm = int(removed[ch])
                todo = nz & ~rm & live
                while todo:
                    j = (todo & -todo).bit_length() - 1
                    rm |= diag[j]
                    todo &= ~rm & (~1 << j)
                kept = ~rm & live
                kept_bits[ch] = kept
                kept_idx = [j for j in range(m) if (kept >> j) & 1]
                words = wn - ch - 1
                for p in range(len(kept_idx) * words):
                    jn, w = p // words, ch + 1 + p % words
                    removed[w] |= rows[r0 + kept_idx[jn], w]
            # 7. scatter
            for r in range(n):
                if (int(kept_bits[r // 64]) >> (r % 64)) & 1:
                    keep[bi, ci, rpos[r]] = True
    return keep


# ---------------------------------------------------------------------------
# the plain version against JAX
# ---------------------------------------------------------------------------

def _jax_keep(xyxy, s, oidx, iou_thresh=IOU_THRESH,
              score_thresh=SCORE_THRESH):
    """JAX's keep masks, an image at a time: its IoU lines of
    ``device_nms_cols`` op by op, then ``_greedy_fixpoint``."""
    keeps = []
    for bi in range(s.shape[0]):
        x1, y1, x2, y2 = (jnp.asarray(xyxy[bi, i]) for i in range(4))
        area = jnp.maximum(x2 - x1, 0) * jnp.maximum(y2 - y1, 0)
        ix1 = jnp.maximum(x1[:, None], x1[None, :])
        iy1 = jnp.maximum(y1[:, None], y1[None, :])
        ix2 = jnp.minimum(x2[:, None], x2[None, :])
        iy2 = jnp.minimum(y2[:, None], y2[None, :])
        inter = jnp.maximum(ix2 - ix1, 0) * jnp.maximum(iy2 - iy1, 0)
        union = area[:, None] + area[None, :] - inter
        iou = inter / jnp.maximum(union, 1e-9)
        sk = jnp.asarray(s[bi])
        keeps.append(np.asarray(jpost._greedy_fixpoint(
            sk, jnp.asarray(oidx[bi].astype(np.int32)), iou > iou_thresh,
            sk > score_thresh)))
    return np.stack(keeps)


@pytest.mark.parametrize("name", [n for n in sorted(BOX_CASES)
                                  if n != "k2535_all_valid"])
def test_plain_matches_jax_per_image(name):
    """The plain version bit for bit against JAX's fixpoint fed JAX's own
    IoU of the same boxes (JAX's oidx is int32; the cases' fit)."""
    case = BOX_CASES[name]()
    np.testing.assert_array_equal(_plain(case), _jax_keep(*case))


@pytest.mark.parametrize("score_thresh,topk", [(0.25, 256), (0.005, 845)])
def test_device_nms_cols_matches_jax_end_to_end(score_thresh, topk):
    """A seeded 13x13 head decoded by JAX: the port's ``device_nms_cols``
    (its suppress stage the plain version on the CPU) equals JAX's, boxes,
    scores and classes, at the serving threshold and pool and at the eval
    grade's (K 845, nearly every candidate valid)."""
    head = np.random.default_rng(21).normal(0, 2, (2, 13, 13, 125))
    jb, js = jpost.decode_yolov2_cols(jnp.asarray(head.astype(np.float32)))
    ref = jpost.device_nms_cols(jb, js, score_thresh=score_thresh,
                                topk=topk)
    got = tpost.device_nms_cols(torch.from_numpy(np.array(jb)),
                                torch.from_numpy(np.array(js)),
                                score_thresh=score_thresh, topk=topk)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int((got[1] > 0).sum()) > 0


# ---------------------------------------------------------------------------
# the replay against the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(BOX_CASES))
def test_kernel_schedule_replay_matches_plain(name):
    """The kernel's schedule gives the plain version's masks bit for bit."""
    case = BOX_CASES[name]()
    want = _plain(case)
    np.testing.assert_array_equal(replay_kernel(*case), want)
    if name.endswith("empty"):
        assert not want.any()
    if name.endswith("chain"):
        k = case[1].shape[-1]
        assert want[0, 0].tolist() == [i % 2 == 0 for i in range(k)]


@pytest.mark.parametrize("sms", [132, 40, 8])
def test_replay_on_a_cluster_matches_plain(sms):
    """K 845 with every candidate valid on fewer SMs: the cluster of the
    form (2 blocks at 132 SMs and B C = 40; 1 at 40 and 8) splits the
    word tasks, and the masks stay the plain version's."""
    case = box_case(2, 20, 845, seed=15, valid_share=0.6)
    form = tpost.nms_suppress_form(2, 20, 845, sms)
    assert form["cluster"] == (2 if sms == 132 else 1)
    np.testing.assert_array_equal(replay_kernel(*case, sms=sms),
                                  _plain(case))


@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("n", [1, 13, 64, 65, 845, 2535])
def test_word_tasks_cover_the_upper_triangle_once(n, cluster):
    """Every word (r, w >= r // 64) of the bitmatrix is one task of one
    block, and a warp's groups in one step (at most 32 consecutive q)
    take at most two words, so their reads of a word's boxes are
    broadcasts."""
    wn = -(-n // 64)
    seen = np.zeros((n, wn), int)
    for g in range(cluster):
        r, w = task_rows_words(n, g, cluster)
        np.add.at(seen, (r, w), 1)
        q, _, w_all = _tasks(n, g, cluster)
        step = (q - q[0]) // 32 if q.size else q
        for st in np.unique(step):
            assert len(np.unique(w_all[step == st])) <= 2
    upper = np.arange(wn)[None, :] >= (np.arange(n) // 64)[:, None]
    assert np.array_equal(seen, upper.astype(int))


@pytest.mark.parametrize("n,threads,cluster,lanes", [
    (13, 256, 1, 16), (138, 256, 1, 1), (64, 256, 1, 4), (64, 1024, 1, 16),
    (845, 1024, 2, 1), (2535, 1024, 2, 1), (0, 256, 1, 32)])
def test_lanes_a_task(n, threads, cluster, lanes):
    """The pins' classes (a dozen candidates, some over a hundred) spread a
    word's 64 tests over several lanes; the eval grade's give each thread
    a word; the live tasks (rows < n) are what the rule counts."""
    assert lanes_a_task(n, cluster, threads) == lanes
    wn = -(-n // 64)
    live = sum(int((r < n).sum()) for r, _ in
               (task_rows_words(n, g, cluster) for g in range(cluster)))
    assert live == 32 * wn * (wn + 1) - (64 * wn - n)


def test_ulp_pairs_straddle_the_threshold():
    """The ulp case holds IoUs of f32(0.45) and one ulp either side: only
    the one above suppresses, in the plain version as in the replay."""
    pairs = ulp_pairs()
    t = F(IOU_THRESH)
    qs = {q for _, _, q in pairs}
    assert qs == {np.nextafter(t, F(0)), t, np.nextafter(t, F(1))}
    keep = _plain(BOX_CASES["ulp"]())
    for p, (_, _, q) in enumerate(pairs):
        # class 0 ranks the wide box first, class 1 the narrow one
        assert keep[0, 0, 2 * p] and keep[0, 1, 2 * p + 1]
        assert keep[0, 0, 2 * p + 1] == (not q > t)
        assert keep[0, 1, 2 * p] == (not q > t)


def test_thresholds_compare_in_float32():
    """The thresholds are compared as float32 (PyTorch and JAX cast a
    Python float to the tensor's dtype): a score equal to f32(0.3), which
    lies above 0.3, is not over the threshold 0.3."""
    xyxy, s, oidx = BOX_CASES["k100"]()
    s = s.copy()
    s[:, :, ::2] = F(0.3)
    assert float(F(0.3)) > 0.3
    keep = _plain((xyxy, s, oidx), score_thresh=0.3)
    assert not keep[:, :, ::2].any()
    np.testing.assert_array_equal(
        replay_kernel(xyxy, s, oidx, score_thresh=0.3), keep)


# ---------------------------------------------------------------------------
# the launch form and the wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,c,k,threads,cluster,in_smem,lists_in_smem", [
    (32, 20, 256, 256, 1, True, True),       # the b32 pin
    (1, 20, 256, 256, 1, True, True),        # the b1 pin
    (16, 20, 256, 256, 1, True, True),       # the YOLOv3 b16 pin
    (2, 20, 845, 1024, 2, True, True),       # the eval grade, YOLOv2
    (2, 20, 2535, 1024, 2, False, True),     # the eval grade, YOLOv3
    (1, 20, 845, 1024, 4, True, True),
    (32, 20, 2535, 1024, 1, False, True),
    (1, 1, 4096, 1024, 8, False, True),
    (2, 20, 4335, 1024, 2, False, True),     # YOLOv3 at 544 px
    (2, 20, 5415, 1024, 2, False, False),    # YOLOv3 at 608 px
    (1, 20, 15360, 1024, 4, False, False),   # YOLOv3 at 1024 px
])
def test_form_at_main_path_sizes(b, c, k, threads, cluster, in_smem,
                                 lists_in_smem):
    form = tpost.nms_suppress_form(b, c, k, SMS)
    assert (form["threads"], form["cluster"], form["rows_in_smem"],
            form["lists_in_smem"]) == (threads, cluster, in_smem,
                                       lists_in_smem)
    assert form["smem"] <= tpost.NMS_SMEM_MAX
    w = -(-k // 64)
    assert form["scratch_words"] == (0 if in_smem else b * c * k * w)
    # the layout's regions, 16-byte aligned where a float4 or u64 starts:
    # the removed and kept words, then the lists here or in global memory
    assert form["smem"] == tpost.nms_suppress_smem(k, in_smem, lists_in_smem)
    assert form["smem"] == 16 * w + (
        tpost.nms_suppress_lists(k, in_smem) if lists_in_smem else 0)
    assert (16 * w) % 16 == 0 and (16 * k + 8 * k * w) % 8 == 0
    if lists_in_smem:
        assert form["list_bytes"] == 0
    else:
        assert form["list_bytes"] % 16 == 0
        assert 0 <= form["list_bytes"] - tpost.nms_suppress_lists(k) < 16


def test_lists_leave_shared_memory_only_where_they_must():
    """The lists stay in shared memory up to the largest K whose lists fit
    (YOLOv3-tiny up to 544 px, K 4335), and go to global memory above."""
    k_max = max(k for k in range(4096, 8193)
                if tpost.nms_suppress_smem(k, False) <= tpost.NMS_SMEM_MAX)
    assert 4335 <= k_max < 5415
    assert tpost.nms_suppress_form(2, 20, k_max)["lists_in_smem"]
    assert not tpost.nms_suppress_form(2, 20, k_max + 1)["lists_in_smem"]


def test_form_refuses_k_out_of_range():
    for k in (0, tpost.NMS_MAX_K + 1):
        with pytest.raises(ValueError, match="nms_suppress"):
            tpost.nms_suppress_form(1, 20, k)
    form = tpost.nms_suppress_form(1, 20, tpost.NMS_MAX_K)
    assert form["smem"] <= tpost.NMS_SMEM_MAX
    # the kernel's count of word tasks stays an int
    w = -(-tpost.NMS_MAX_K // 64)
    assert 32 * w * (w + 1) < 2 ** 31


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper is its plain version and launches nothing;
    ``device_nms_cols`` goes through the wrapper."""
    case = BOX_CASES["k256"]()
    before = tpost.nms_suppress.launches
    xyxy, s, oidx = (torch.from_numpy(a) for a in case)
    keep = tpost.nms_suppress(xyxy, s, oidx, IOU_THRESH, SCORE_THRESH)
    assert keep.dtype == torch.bool and keep.shape == s.shape
    np.testing.assert_array_equal(keep.numpy(), _plain(case))
    assert tpost.nms_suppress.launches == before
    seen = []
    real = tpost.nms_suppress

    def spy(*a):
        seen.append(a)
        return real(*a)
    tpost.nms_suppress = spy
    try:
        boxes = torch.rand(2, 4, 300) * 100
        tpost.device_nms_cols(boxes, torch.rand(2, 3, 300), topk=128)
    finally:
        tpost.nms_suppress = real
    assert len(seen) == 1 and tuple(seen[0][0].shape) == (2, 4, 128)


@pytest.mark.parametrize("bad", ["dtype", "words", "valid_dtype", "ndim",
                                 "oidx_dtype", "k_mismatch"])
def test_wrapper_refuses_other_layouts(bad):
    xyxy, s, oidx = (torch.from_numpy(a) for a in BOX_CASES["k100"]())
    if bad == "dtype":
        xyxy = xyxy.double()
    elif bad == "words":
        xyxy = xyxy[:, :3]
    elif bad == "valid_dtype":
        s = s > SCORE_THRESH
    elif bad == "ndim":
        xyxy, s, oidx = xyxy[0], s[0], oidx[0]
    elif bad == "oidx_dtype":
        oidx = oidx.int()
    else:
        oidx = oidx[:, :50]
    with pytest.raises(ValueError, match="nms_suppress"):
        tpost.nms_suppress(xyxy, s, oidx)
