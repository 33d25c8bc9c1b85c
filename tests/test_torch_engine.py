"""The port's Engine against the JAX Engine, end to end on the CPU.

YOLOv2-tiny and YOLOv3-tiny w8a8 at 64 px with the JAX engine's random
weights and calibration scales carried across
(models/weights.params_from_numpy).
Detections: classes and survivor counts exact, boxes within 1e-3 px.
A strategy file (``EngineConfig.strategy``) replaces the pinned table in
both engines: the one here runs the folded k2 entry, fold_xla_s2 and the
rs kinds. It leaves out the gemm tier, whose folded-order epilogue the
JAX engine's jit contracts into an FMA that flips int8 codes mid-network
(ROADMAP section C); tests/test_torch_plan.py holds that tier against
the op-by-op JAX plan.
The heads agree up to the single FMA rounding that XLA's jit applies to
the f32 head on the CPU (see tests/test_torch_plan.py), which is why the
boxes and scores get a tolerance at all.
"""

import json

import jax
import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu.config import EngineConfig as JConfig
from dnn_inference_engine_tpu.runtime.engine import Engine as JEngine
from dnn_inference_engine_tpu.runtime.plan_sweep import (
    _strategy_jsonable)

from dnn_inference_engine_tpu_torch.config import EngineConfig
from dnn_inference_engine_tpu_torch.runtime.engine import Engine


# the sweep's new kinds, no gemm tier (see the module docstring)
STRATEGY = {0: ("fold_xla_k2", 4, {"cin_pad": 64}), 2: ("fold_xla_s2", 2),
            4: ("fold_xla_k2", 2), 6: ("rs2", 2), 8: ("rs", 2)}


def _engines(batch, score_thresh, model="yolov2-tiny", strategy=None):
    kw = dict(model=model, mode="w8a8", batch=batch, input_size=64,
              score_thresh=score_thresh, strategy=strategy)
    calib = np.random.default_rng(11).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32)
    jeng = JEngine(JConfig(kernel="auto", **kw)).load_weights(
        key=jax.random.PRNGKey(0)).prepare(calib)
    teng = Engine(EngineConfig(**kw), device="cpu").load_weights(
        params=jax.tree.map(np.asarray, jeng.params),
        act_scales=jeng.act_scales).prepare()
    assert [s.kind for s in teng._plan] == [s.kind for s in jeng._plan]
    return jeng, teng


@pytest.mark.parametrize("model,batch,thresh,strategy", [
    pytest.param("yolov2-tiny", 2, 0.02, False, id="2-0.02"),
    pytest.param("yolov2-tiny", 1, 0.3, False, id="1-0.3"),
    pytest.param("yolov3-tiny", 2, 0.02, False, id="yolov3-2-0.02"),
    pytest.param("yolov3-tiny", 1, 0.3, False, id="yolov3-1-0.3"),
    pytest.param("yolov2-tiny", 2, 0.02, True, id="strategy-2-0.02")])
def test_detect_matches_jax_engine(model, batch, thresh, strategy, tmp_path):
    path = None
    if strategy:
        path = tmp_path / "strategy.json"
        path.write_text(json.dumps({"strategy": _strategy_jsonable(STRATEGY)}))
        path = str(path)
    jeng, teng = _engines(batch, thresh, model, path)
    if strategy:
        assert [s.kind for s in teng._plan][:5] == [
            "fold_xla_k2", "fold_xla_s2", "fold_xla_k2", "rs", "rs"]
    imgs = np.random.default_rng(12).integers(
        0, 256, (batch, 64, 64, 3)).astype(np.uint8)
    jb, js, jc = jeng.detect(imgs)
    tb, ts, tc = teng.detect(imgs)
    assert tb.shape == jb.shape and ts.shape == js.shape
    np.testing.assert_array_equal((ts > 0).sum(axis=1), (js > 0).sum(axis=1))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-7)
    if thresh < 0.25:
        assert (js > 0).sum() > 0          # the case exercises survivors
    got = teng.classify(imgs)
    if model == "yolov3-tiny":
        # the JAX engine's classify cannot stack two heads of different
        # shapes; its forward returns them as a tuple
        want = jeng.forward_fn()(jeng.exec_params, jeng._device_batch(imgs))
        assert isinstance(got, tuple) and len(got) == len(want) == 2
    else:
        got, want = (got,), (jeng.classify(imgs),)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)


def test_s0_strategy_engine_prepares_stage0_kernel_plan(tmp_path):
    """S3, the b32 pin with s0 at layer 0, on the 416 px model: prepare
    builds a plan whose stage 0 is s0 (reading f32: the engine divides a
    uint8 batch by 255 first) with v2's operand and its dense-K matrix.
    Weights and scales are carried in, so nothing is calibrated at 416 px
    on the CPU."""
    from dnn_inference_engine_tpu.runtime.plan import _YOLOV2_STRATEGY
    from dnn_inference_engine_tpu_torch.models import build_model
    from dnn_inference_engine_tpu_torch.runtime.plan import (
        plan_input_uint8_ok)
    path = tmp_path / "s3.json"
    path.write_text(json.dumps({"strategy": _strategy_jsonable(
        {**_YOLOV2_STRATEGY, 0: ("s0", 4)})}))
    model = build_model("yolov2-tiny")
    fp32 = [{k: v.numpy() for k, v in p.items()}
            for p in model.init_params(torch.Generator().manual_seed(0),
                                       "cpu")]
    eng = Engine(EngineConfig(mode="w8a8", batch=32, strategy=str(path)),
                 device="cpu").load_weights(
        params=fp32, act_scales=[0.01] * (len(model.layers) + 1)).prepare()
    assert [s.kind for s in eng._plan][:3] == ["s0", "fold_xla",
                                               "fold_xla_k2"]
    assert not plan_input_uint8_ok(eng._plan)
    assert eng._plan_params[0]["wv"].shape == (3, 128, 256)


def test_engine_needs_a_device_or_a_card(monkeypatch):
    """Without a card the engine raises unless the caller asks for the
    CPU; the default engine (fp32, kernel auto) then runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(EngineConfig())
    eng = Engine(EngineConfig(batch=1, input_size=64),
                 device="cpu").load_weights(seed=0).prepare()
    assert eng.config.mode == "fp32" and eng._plan is None
    heads = eng.classify(np.zeros((1, 64, 64, 3), np.uint8))
    assert heads.shape == (1, 2, 2, 125) and np.isfinite(heads).all()


def test_engine_seeded_init_and_calibration_on_cpu():
    """The port's own path: seeded weights, noise calibration, detect."""
    eng = Engine(EngineConfig(mode="w8a8", batch=1, input_size=64),
                 device="cpu")
    with pytest.warns(UserWarning, match="uniform noise"):
        eng.load_weights(seed=3).prepare()
    again = Engine(EngineConfig(mode="w8a8", batch=1, input_size=64),
                   device="cpu").load_weights(seed=3)
    for a, b in zip(eng.fp32_params, again.fp32_params):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert len(eng.act_scales) == len(eng.model.layers) + 1
    x = np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    b, s, c = eng.detect(x)
    assert b.shape == (1, 128, 4) and s.shape == (1, 128)
    assert np.isfinite(eng.classify(x)).all()
