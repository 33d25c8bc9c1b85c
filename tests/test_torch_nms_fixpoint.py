"""The NMS fixpoint's kernel contract on the CPU (``postprocess.nms_fixpoint``,
``csrc/nms_fixpoint.cu``).

- The plain version (``nms_fixpoint_plain``, the CPU's path and the
  card's reference) equals JAX ``postprocess._greedy_fixpoint`` image by
  image, bit for bit, on seeded cases: K = 256 and K = 100 (not a
  multiple of 64), exact score ties (the index breaks them), no valid
  candidate, and a chain K - 1 deep, where the K cap stops the loop.
- A numpy replay of the kernel's schedule (a block a (image, class)
  stopping at its own fixpoint; the keep bits as 32-bit words, each a
  warp's ballot of 32 rows, two of them a 64-bit word of ``dom``) equals
  the batched plain loop bit for bit, and its sweeps equal the plain
  version's count per (image, class).

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

from _torch_nms_cases import CASES, chain_case

THREADS = 256                        # csrc/nms_fixpoint.cu's block


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(torch_threads)


def _dom_valid(case):
    s, oidx, hit, valid = case
    dom_p = tpost._dominance(torch.from_numpy(s), torch.from_numpy(oidx),
                             torch.from_numpy(hit))
    return dom_p, torch.from_numpy(valid)


def _replay_kernel(dom_p: np.ndarray, valid: np.ndarray):
    """The kernel's schedule in numpy: per (image, class) block, three
    bitsets of W 64-bit words (the sweep's input, its output, valid), read
    as 32-bit words; each warp of 32 threads takes 32 consecutive rows
    (rows i = tid, tid + 256, ...), a row read only while its candidate is
    valid, and its lane 0 stores their ballot as one 32-bit word and
    notes a change; the block stops where no warp changed a word, or after
    K sweeps. Returns (keep (B,C,K), sweeps (B,C))."""
    b, c, k, w = dom_p.shape
    dom = dom_p.view(np.uint64)
    rows = -(-k // 32) * 32
    keep = np.zeros((b, c, k), bool)
    sweeps = np.zeros((b, c), np.int32)
    lanes = np.arange(32, dtype=np.uint64)
    for bi in range(b):
        for ci in range(c):
            bits = np.zeros(3 * w, np.uint64)
            words = bits.view(np.uint32)                 # little-endian
            cur, nxt, vb = 0, w, 2 * w                   # offsets, 64-bit
            v = np.zeros(rows, bool)
            v[:k] = valid[bi, ci]
            for j in range(rows // 32):
                word = np.uint32((v[32 * j:32 * j + 32].astype(np.uint64)
                                  << lanes).sum())
                words[2 * vb + j] = words[2 * cur + j] = word
            it = 0
            while True:
                changed = False
                # warp-sized row groups, in the order the threads take them
                for r0 in range(0, rows, THREADS):
                    for j in range(r0 // 32, min(r0 + THREADS, rows) // 32):
                        kept = np.zeros(32, bool)
                        for lane in range(32):
                            i = 32 * j + lane
                            if not (words[2 * vb + j] >> np.uint32(lane)) & 1:
                                continue
                            kw = bits[cur:cur + w]
                            kept[lane] = not np.any(
                                (kw != 0) & ((dom[bi, ci, i] & kw) != 0))
                        word = np.uint32((kept.astype(np.uint64)
                                          << lanes).sum())
                        words[2 * nxt + j] = word
                        changed |= word != words[2 * cur + j]
                it += 1
                if not changed or it >= k:
                    break
                cur, nxt = nxt, cur
            out = words[2 * nxt:2 * nxt + 2 * w]
            keep[bi, ci] = ((out[np.arange(k) // 32]
                             >> (np.arange(k) % 32).astype(np.uint32))
                            & 1).astype(bool)
            sweeps[bi, ci] = it
    return keep, sweeps


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_per_image(name):
    """Bit for bit against JAX's ``lax.while_loop`` fixpoint, an image at a
    time (JAX's function takes one image; the port's the batch)."""
    case = CASES[name]()
    s, oidx, hit, valid = case
    dom_p, vt = _dom_valid(case)
    got = tpost.nms_fixpoint_plain(dom_p, vt).numpy()
    for bi in range(s.shape[0]):
        ref = np.asarray(jpost._greedy_fixpoint(
            jnp.asarray(s[bi]), jnp.asarray(oidx[bi].astype(np.int32)),
            jnp.asarray(hit[bi]), jnp.asarray(valid[bi])))
        np.testing.assert_array_equal(got[bi], ref, err_msg=f"image {bi}")
    if name.endswith("empty"):
        assert not got.any()
    if name.endswith("chain"):
        k = s.shape[-1]
        assert got[0, 0].tolist() == [i % 2 == 0 for i in range(k)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_schedule_replay_matches_plain(name):
    """The kernel's per-(image, class) exit and 32-row words give the
    batched plain loop's masks bit for bit, and the sweeps the plain
    version counts for each (image, class) under JAX's loop."""
    dom_p, vt = _dom_valid(CASES[name]())
    keep, sweeps = tpost.nms_fixpoint_plain(dom_p, vt, return_sweeps=True)
    rkeep, rsweeps = _replay_kernel(dom_p.numpy(), vt.numpy())
    np.testing.assert_array_equal(rkeep, keep.numpy())
    np.testing.assert_array_equal(rsweeps, sweeps.numpy())
    assert sweeps.dtype == torch.int32 and sweeps.shape == vt.shape[:2]


@pytest.mark.parametrize("k", [65, 100])
def test_chain_k_minus_1_deep_stops_at_the_k_cap(k):
    """A chain K - 1 deep: the masks are right after K sweeps, and the K
    cap stops the loop there, in the replay and in the plain version."""
    dom_p, vt = _dom_valid(chain_case(k))
    keep, sweeps = tpost.nms_fixpoint_plain(dom_p, vt, group=1,
                                            return_sweeps=True)
    assert sweeps.tolist() == [[k]]
    _, rsweeps = _replay_kernel(dom_p.numpy(), vt.numpy())
    assert rsweeps.tolist() == [[k]]
    assert keep[0, 0].tolist() == [i % 2 == 0 for i in range(k)]


@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("name", ["k100", "k256_ties"])
def test_plain_groups_keep_masks_and_sweeps(name, group):
    """The plain version's group size (host reads) changes neither its
    masks nor its sweep counts."""
    dom_p, vt = _dom_valid(CASES[name]())
    ref, ref_sweeps = tpost.nms_fixpoint_plain(dom_p, vt, group=1,
                                               return_sweeps=True)
    keep, sweeps = tpost.nms_fixpoint_plain(dom_p, vt, group=group,
                                            return_sweeps=True)
    assert torch.equal(keep, ref) and torch.equal(sweeps, ref_sweeps)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper is its plain version and launches nothing;
    ``_greedy_fixpoint`` goes through the wrapper."""
    case = CASES["k256"]()
    dom_p, vt = _dom_valid(case)
    before = tpost.nms_fixpoint.launches
    keep, sweeps = tpost.nms_fixpoint(dom_p, vt, return_sweeps=True)
    ref, ref_sweeps = tpost.nms_fixpoint_plain(dom_p, vt,
                                               return_sweeps=True)
    assert torch.equal(keep, ref) and torch.equal(sweeps, ref_sweeps)
    s, oidx, hit, _ = (torch.from_numpy(a) for a in case)
    assert torch.equal(tpost._greedy_fixpoint(s, oidx, hit, vt), ref)
    assert tpost.nms_fixpoint.launches == before


@pytest.mark.parametrize("bad", ["dtype", "words", "valid_dtype", "ndim"])
def test_wrapper_refuses_other_layouts(bad):
    dom_p, vt = _dom_valid(CASES["k100"]())
    if bad == "dtype":
        dom_p = dom_p.to(torch.int32)
    elif bad == "words":
        dom_p = dom_p[..., :1]
    elif bad == "valid_dtype":
        vt = vt.to(torch.uint8)
    else:
        dom_p, vt = dom_p[0], vt[0]
    with pytest.raises(ValueError, match="nms_fixpoint"):
        tpost.nms_fixpoint(dom_p, vt)
