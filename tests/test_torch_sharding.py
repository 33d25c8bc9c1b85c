"""The port's mesh of ranks and its sharding rules against the JAX
package's, on the CPU.

- ``channel_shard_pair``: YOLOv2-tiny (12, 13), YOLOv3-tiny (10, 12),
  ResNet-18 (2, 3), as JAX's;
- ``param_specs`` name the axis that JAX's PartitionSpecs put on
  ``model``, and ``shard_params`` gives each rank the slice that
  ``jax.device_put(v, NamedSharding(mesh, spec)).addressable_shards``
  gives the device at the rank's place in a (dp, mp) mesh of the
  conftest's 8 CPU devices;
- ``input_sharding``: each rank's rows are those of the device at its
  place (JAX ``input_sharding``'s ``devices_indices_map``);
- the rank layout (data index r // mp, model index r % mp, JAX's
  row-major device grid), a (1, 1) mesh without a process group,
  ``init_distributed`` for one process, and the backend rule.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from dnn_inference_engine_tpu.models import build_model as jbuild
from dnn_inference_engine_tpu.parallel import sharding as jsharding

from dnn_inference_engine_tpu_torch.models import build_model
from dnn_inference_engine_tpu_torch.parallel import mesh as tmesh
from dnn_inference_engine_tpu_torch.parallel.mesh import Mesh
from dnn_inference_engine_tpu_torch.parallel.sharding import (
    _out_of_sequence_refs, channel_shard_pair, input_sharding, param_specs,
    shard_params)

MODELS = {"yolov2-tiny": (12, 13), "yolov3-tiny": (10, 12),
          "resnet18": (2, 3)}
MESHES = [(1, 2), (2, 2), (1, 4), (4, 2)]


def _models(name):
    kw = {"num_classes": 10} if name == "resnet18" else {}
    return build_model(name, **kw), jbuild(name, **kw)


@pytest.mark.parametrize("name", list(MODELS))
def test_channel_shard_pair_matches_jax(name):
    tm, jm = _models(name)
    assert channel_shard_pair(tm) == jsharding.channel_shard_pair(jm) \
        == MODELS[name]
    assert _out_of_sequence_refs(tm) == jsharding._out_of_sequence_refs(jm)


def _axis(spec: P):
    """The axis a PartitionSpec puts on 'model' (None: replicated)."""
    return next((i for i, a in enumerate(spec) if a == "model"), None)


@pytest.mark.parametrize("policy", ["channel", "replicated"])
@pytest.mark.parametrize("name", list(MODELS))
def test_param_specs_match_jax(name, policy):
    tm, jm = _models(name)
    for li, (t, j) in enumerate(zip(param_specs(tm, policy),
                                    jsharding.param_specs(jm, policy))):
        for k in ("w", "wq", "s_w", "b"):
            assert t.get(k) == (_axis(j[k]) if k in j else None), (li, k)


def _qparams(name, seed=0):
    """Seeded quantized-looking params of every layer (shapes only
    matter here), as numpy."""
    tm, _ = _models(name)
    g = np.random.default_rng(seed)
    out = []
    for p in tm.init_params(torch.Generator().manual_seed(seed), "cpu"):
        q = {k: v.numpy() for k, v in p.items()}
        if "w" in q:
            q["wq"] = g.integers(-127, 128, q["w"].shape).astype(np.int8)
            q["s_w"] = g.uniform(1e-3, 1e-2, q["w"].shape[-1]).astype(
                np.float32)
        out.append(q)
    return out


def _jmesh(shape):
    return JMesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(
        shape), ("data", "model"))


@pytest.mark.parametrize("shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", list(MODELS))
def test_shard_params_equal_jax_addressable_shards(name, shape):
    """Each rank's params are the shard JAX places on the device at the
    rank's place in the mesh (channel policy; the pair's leaves split,
    every other leaf whole)."""
    tm, jm = _models(name)
    qp = _qparams(name)
    jmesh = _jmesh(shape)
    jspecs = jsharding.param_specs(jm, "channel")
    devices = np.asarray(jmesh.devices).ravel()
    for rank in range(shape[0] * shape[1]):
        mine = shard_params([{k: torch.from_numpy(v) for k, v in p.items()}
                             for p in qp], Mesh(shape, rank), tm, "channel")
        for li in MODELS[name]:
            for k, v in qp[li].items():
                arr = jax.device_put(v, NamedSharding(
                    jmesh, jspecs[li].get(k, P())))
                shard = next(s for s in arr.addressable_shards
                             if s.device == devices[rank])
                np.testing.assert_array_equal(
                    mine[li][k].numpy(), np.asarray(shard.data),
                    err_msg=f"rank {rank} layer {li} {k}")
        # the rest is the whole, untouched
        assert all(mine[li][k].shape == qp[li][k].shape
                   for li in range(len(qp)) if li not in MODELS[name]
                   for k in qp[li])


def test_shards_are_copies_of_their_own():
    """A shard owns its storage, so a layout cached on it (the K-major
    matrix, the kernels' tiles) is the shard's, not cut from the whole's."""
    tm, _ = _models("yolov2-tiny")
    qp = [{k: torch.from_numpy(v) for k, v in p.items()}
          for p in _qparams("yolov2-tiny")]
    for rank in range(2):
        mine = shard_params(qp, Mesh((1, 2), rank), tm, "channel")
        for li in (12, 13):
            assert mine[li]["wq"].is_contiguous()
            assert (mine[li]["wq"].untyped_storage().data_ptr()
                    != qp[li]["wq"].untyped_storage().data_ptr())
        assert mine[0]["wq"] is qp[0]["wq"]


@pytest.mark.parametrize("shape", MESHES + [(2, 1), (8, 1)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_input_rows_match_jax(shape):
    batch = 8
    jmesh = _jmesh(shape)
    imap = jsharding.input_sharding(jmesh).devices_indices_map(
        (batch, 1, 1, 3))
    devices = np.asarray(jmesh.devices).ravel()
    for rank in range(shape[0] * shape[1]):
        sl = imap[devices[rank]][0]
        want = (sl.start or 0, batch if sl.stop is None else sl.stop)
        got = input_sharding(Mesh(shape, rank), batch)
        assert (got.start, got.stop) == want, rank


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 3)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_rank_layout_is_the_row_major_device_grid(shape):
    jgrid = np.arange(shape[0] * shape[1]).reshape(shape)
    for rank in range(shape[0] * shape[1]):
        m = Mesh(shape, rank)
        assert jgrid[m.data_index, m.model_index] == rank


def test_one_rank_mesh_needs_no_process_group():
    m = tmesh.make_mesh((1, 1))
    assert m.shape == (1, 1) and m.model_group is None \
        and m.data_group is None
    x = torch.arange(6)
    assert tmesh.gather_rows(x, m) is x and tmesh.gather_rows(x, None) is x
    assert tmesh.all_reduce_sum(x, None) is x
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.make_mesh((0, 2))


def test_init_distributed_for_one_process_does_nothing(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.init_distributed() is False
    assert tmesh.init_distributed(num_processes=1) is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="process_id"):
        monkeypatch.delenv("RANK", raising=False)
        tmesh.init_distributed("127.0.0.1:1", num_processes=2)


@pytest.mark.parametrize("cuda,cards,ranks,want", [
    (False, 0, 4, "gloo"), (True, 1, 1, "nccl"), (True, 4, 4, "nccl"),
    (True, 1, 2, None), (True, 2, 4, None)])
def test_backend_rule(monkeypatch, cuda, cards, ranks, want):
    """NCCL when every rank here has a card of its own, gloo without a
    card; more ranks than cards must ask for gloo by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want is None:
        with pytest.raises(ValueError, match="backend='gloo'"):
            tmesh.default_backend(ranks)
    else:
        assert tmesh.default_backend(ranks) == want


def test_make_sharded_forward_is_the_data_parallel_generic_forward():
    """One rank (no data group): the generic forward on the xla tier."""
    from dnn_inference_engine_tpu_torch.parallel.sharding import (
        make_sharded_forward)
    tm, _ = _models("yolov2-tiny")
    params = tm.init_params(torch.Generator().manual_seed(0), "cpu")
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    fwd = make_sharded_forward(tm, Mesh((1, 1)), mode="fp32")
    assert torch.equal(fwd(params, x), tm.forward(params, x, kernel="xla"))
