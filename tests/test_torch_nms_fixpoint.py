"""The NMS fixpoint's plain loop on the CPU
(``postprocess.nms_fixpoint_plain``: the CPU's suppress stage and the
reference of the card's ``csrc/nms_suppress.cu``).

- The plain version equals JAX ``postprocess._greedy_fixpoint`` image by
  image, bit for bit, on seeded cases: K = 256 and K = 100 (not a
  multiple of 64), exact score ties (the index breaks them), no valid
  candidate, and a chain K - 1 deep, where the K cap stops the loop.
- Its group size (sweeps between host reads) changes neither its masks
  nor its sweep counts, and the chain takes exactly K sweeps.

The kernel and its schedule: ``tests/test_torch_nms_suppress.py``.
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


@pytest.mark.parametrize("k", [65, 100])
def test_chain_k_minus_1_deep_stops_at_the_k_cap(k):
    """A chain K - 1 deep: the masks are right after K sweeps, and the K
    cap stops the loop there, at every group size."""
    dom_p, vt = _dom_valid(chain_case(k))
    for group in (1, 4, k):
        keep, sweeps = tpost.nms_fixpoint_plain(dom_p, vt, group=group,
                                                return_sweeps=True)
        assert sweeps.tolist() == [[k]]
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
