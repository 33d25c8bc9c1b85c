"""The port's Engine on a mesh of gloo ranks on the CPU (64 px), against
its own single-device Engine and the JAX package's sharded Engine.

Ranks of ``_torch_dist_worker.py`` (``engine`` mode) build the W8A8
engine of each case from one checkpoint, with ``mesh_shape`` (1, 2),
(2, 1) or (2, 2) and ``sharding="channel"``, and save the detect and
classify of one global batch. Every rank must hold the whole batch, and
it must equal the single-device engine's bit for bit: YOLOv2-tiny under
its pin and on the generic xla and pallas tiers, YOLOv3-tiny and
ResNet-18 under their pins. The channel pair's row-parallel conv sums
exact int32 accumulators across ranks, then rounds in the order of the
conv it stands for.

Against the JAX package's sharded Engine (the conftest's 8 CPU devices,
the same checkpoint): detections within tests/test_torch_engine.py's
limits (classes and survivor counts exact, boxes within 1e-3 px), heads
within 1e-5. Its jit contracts the f32 head's epilogue into an FMA,
which is why there is a tolerance at all; the gemm tier is left out, as
there, because that contraction flips int8 codes mid-network there
(ROADMAP section C), and so does ResNet-18's jitted forward in its
shortcuts: that case runs the JAX engine op by op, on one mesh, with
the logits within 1e-5 of the largest (the pool sums in another order).
"""

import types

import jax
import numpy as np
import pytest

import _torch_dist as td

from dnn_inference_engine_tpu.config import EngineConfig as JConfig
from dnn_inference_engine_tpu.runtime.engine import Engine as JEngine

from dnn_inference_engine_tpu_torch.config import EngineConfig
from dnn_inference_engine_tpu_torch.parallel.mesh import Mesh
from dnn_inference_engine_tpu_torch.parallel.sharded_engine import (
    _validated_pair, plan_param_specs)
from dnn_inference_engine_tpu_torch.parallel.sharding import (
    input_sharding)
from dnn_inference_engine_tpu_torch.runtime.engine import Engine

pytestmark = pytest.mark.subproc

MESHES = [(1, 2), (2, 1), (2, 2)]
CASES = {c[0]: c[1:] for c in [
    ("v2_pin", "yolov2-tiny", "auto"), ("v2_xla", "yolov2-tiny", "xla"),
    ("v2_pallas", "yolov2-tiny", "pallas"),
    ("v3_pin", "yolov3-tiny", "auto"), ("r18_pin", "resnet18", "auto")]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_engine")
    td.write_inputs(str(d))
    for mesh in MESHES:
        outs = td.spawn("engine", mesh[0] * mesh[1], str(d), mesh,
                        timeout=240)
        td.check_ranks(outs, "engine")
    return str(d)


def _single(d, model, kernel):
    return Engine(EngineConfig(
        model=model, mode="w8a8", kernel=kernel, batch=td.BATCH,
        input_size=td.SIZE, score_thresh=0.02,
        num_classes=10 if model == "resnet18" else 20),
        device="cpu").load_weights(f"{d}/{model}.npz").prepare()


def _want(eng, imgs, detector):
    heads = eng.classify(imgs)
    heads = heads if isinstance(heads, tuple) else (heads,)
    out = {f"head{i}": np.asarray(h) for i, h in enumerate(heads)}
    if detector:
        out.update(zip(("boxes", "scores", "classes"),
                       (np.asarray(t) for t in eng.detect(imgs))))
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_engine_equals_single_device(runs, mesh, case):
    model, kernel = CASES[case]
    imgs = np.load(f"{runs}/images.npy")
    want = _want(_single(runs, model, kernel), imgs, model != "resnet18")
    for r in range(mesh[0] * mesh[1]):
        got = td.load(td.rank_file(runs, "engine", mesh, case, r))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("mesh,case", [
    (m, c) for c in ("v2_pin", "v2_xla", "v3_pin") for m in MESHES]
    + [((1, 2), "r18_pin")], ids=lambda v: v if isinstance(v, str)
    else f"{v[0]}x{v[1]}")
def test_sharded_engine_matches_jax(runs, mesh, case, monkeypatch):
    model, kernel = CASES[case]
    if model == "resnet18":
        # op by op (jax.jit of a function at call time returns it), one
        # mesh (about 20 s on the CPU): the jitted forward contracts the
        # shortcuts' f32 epilogues into FMAs, which move codes
        # mid-network (tests/test_torch_resnet18.py)
        monkeypatch.setattr(jax, "jit", lambda f=None, **kw: f)
    imgs = np.load(f"{runs}/images.npy")
    jeng = JEngine(JConfig(
        model=model, mode="w8a8", kernel=kernel, batch=td.BATCH,
        input_size=td.SIZE, score_thresh=0.02, mesh_shape=mesh,
        sharding="channel", num_classes=10 if model == "resnet18" else 20,
        weights=f"{runs}/{model}.npz")).load_weights().prepare()
    assert jeng.mesh is not None
    got = td.load(td.rank_file(runs, "engine", mesh, case, 0))
    want = jeng.forward_fn()(jeng.exec_params, jeng._device_batch(imgs))
    want = want if isinstance(want, tuple) else (want,)
    for i, w in enumerate(want):
        w = np.asarray(w)
        # ResNet-18: the logits within 1e-5 of the largest (the pool sums
        # in another order)
        atol = 1e-5 * (np.abs(w).max() if model == "resnet18" else 1.0)
        np.testing.assert_allclose(got[f"head{i}"], w, rtol=0, atol=atol)
    if model == "resnet18":
        return
    jb, js, jc = (np.asarray(t) for t in jeng.detect(imgs))
    np.testing.assert_array_equal((got["scores"] > 0).sum(1),
                                  (js > 0).sum(1))
    np.testing.assert_array_equal(got["classes"], jc)
    np.testing.assert_allclose(got["boxes"], jb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"], js, rtol=1e-5, atol=1e-7)


def _stub(model, mode="w8a8", sharding="channel"):
    from dnn_inference_engine_tpu_torch.models import build_model
    return types.SimpleNamespace(
        config=EngineConfig(model=model, mode=mode, sharding=sharding),
        model=build_model(model))


@pytest.mark.parametrize("mode", ["fp32", "w8"])
def test_channel_sharding_outside_w8a8_raises(mode):
    with pytest.raises(ValueError, match="requires mode='w8a8'"):
        _validated_pair(_stub("yolov2-tiny", mode))


def test_a_model_with_no_pair_raises(monkeypatch):
    from dnn_inference_engine_tpu_torch.parallel import sharded_engine as se
    monkeypatch.setattr(se, "channel_shard_pair", lambda model: None)
    with pytest.raises(ValueError, match="no shardable conv pair"):
        _validated_pair(_stub("yolov2-tiny"))


def test_unknown_policy_raises_and_replicated_has_no_pair():
    with pytest.raises(ValueError, match="unknown sharding policy"):
        _validated_pair(_stub("yolov2-tiny", sharding="rows"))
    assert _validated_pair(_stub("yolov2-tiny", "fp32", "replicated")) \
        is None


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_a_mesh_without_a_process_group_raises(shape):
    with pytest.raises(RuntimeError, match="init_distributed.*torchrun"):
        Engine(EngineConfig(mode="w8a8", mesh_shape=shape,
                            sharding="channel"), device="cpu")


@pytest.mark.parametrize("batch,dp", [(3, 2), (6, 4), (1, 2)])
def test_a_batch_the_data_axis_does_not_divide_raises(batch, dp):
    with pytest.raises(ValueError, match="not divisible by the data-axis "
                                         f"size {dp}"):
        input_sharding(Mesh((dp, 1), 0), batch)


def test_one_rank_mesh_is_the_single_device_engine():
    """mesh (1, 1) with the channel policy is one device, as in JAX (no
    mesh, nothing split): equal to the replicated engine."""
    kw = dict(mode="w8a8", batch=2, input_size=64)
    x = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3)).astype(
        np.uint8)
    outs = []
    for sharding in ("channel", "replicated"):
        with pytest.warns(UserWarning, match="uniform noise"):
            eng = Engine(EngineConfig(sharding=sharding, **kw),
                         device="cpu").load_weights(seed=1).prepare()
        assert eng.mesh is None
        outs.append(eng.detect(x))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model,pair", [("yolov2-tiny", (12, 13)),
                                        ("yolov3-tiny", (10, 12))])
def test_plan_param_specs_split_the_pair_stages(model, pair):
    """The pin's stages of the pair carry the split axes (Cout: 3, Cin: 2);
    the folded stem and every other stage are replicated, as JAX's."""
    from dnn_inference_engine_tpu_torch.models import build_model
    from dnn_inference_engine_tpu_torch.runtime.plan import build_plan
    m = build_model(model)
    stages = build_plan(m, batch=32)
    specs = plan_param_specs(m, stages, "channel")
    by_li = {st.conv_li: sp for st, sp in zip(stages, specs)}
    assert by_li[pair[0]]["wq"] == 3 and by_li[pair[0]]["b"] == 0
    assert by_li[pair[1]] == {"w": 2, "wq": 2}
    assert by_li[0] == {}
    assert all(sp == {} for li, sp in by_li.items() if li not in pair)
    assert all(sp == {} for sp in plan_param_specs(m, stages))
