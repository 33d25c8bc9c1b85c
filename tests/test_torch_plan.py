"""The port's fused W8A8 plan against the JAX plan, stage by stage.

YOLOv2-tiny at 64 px, batch 2, random weights and calibration scales made
by the JAX package and carried across. Each stage of the port is fed the
exact entry state that the JAX plan recorded (``record_states``) and must
produce the JAX plan's next state bit for bit, under the batch-32 table
and the batch-1 and batch-8 pins. The whole head must match too, for
uint8 wire input and for f32 input.

Calibration is held against the JAX package too, from the same fp32
weights: XLA and PyTorch sum the fp32 convs in different orders, so each
layer's activations and each scale agree to a few float32 ulps, not bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu.models import yolov2_tiny as jyolo
from dnn_inference_engine_tpu.ops.conv import conv2d_fp32 as jconv2d_fp32
from dnn_inference_engine_tpu.quant.quantize import (
    calibrate as jcalibrate, quantize_model_params as jquantize)
from dnn_inference_engine_tpu.runtime import plan as jplan

from dnn_inference_engine_tpu_torch.models import yolov2_tiny as tyolo
from dnn_inference_engine_tpu_torch.models.weights import params_from_numpy
from dnn_inference_engine_tpu_torch.ops.conv import conv2d_fp32
from dnn_inference_engine_tpu_torch.quant.quantize import (
    calibrate as tcalibrate, quantize_model_params as tquantize)
from dnn_inference_engine_tpu_torch.runtime import plan as tplan

PINS = {"b32": jplan._YOLOV2_STRATEGY,
        "b1": jplan._BATCH_STRATEGIES[("yolov2-tiny", 1)],
        "b8": jplan._BATCH_STRATEGIES[("yolov2-tiny", 8)]}


def _np(t):
    return np.asarray(t)


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(7)
    jm = jyolo()
    params = jm.init_params(jax.random.PRNGKey(0))
    imgs = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    scales = jcalibrate(jm, params, imgs, batch=2)
    jq = jquantize(params, jm.layers)
    tq, tscales = params_from_numpy(jax.tree.map(np.asarray, jq), scales,
                                    device="cpu")
    u8 = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    tp, _ = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return dict(jm=jm, jq=jq, scales=scales, tm=tyolo(), tq=tq,
                tscales=tscales, u8=u8, params=params, tp=tp, imgs=imgs)


# A float32 ulp is at most 2**-23 of a value; the fp32 paths may differ by
# reordered sums, which the tests below allow up to 32 ulps.
ULPS = 32
F32_EPS = float(np.finfo(np.float32).eps)


def test_calibrate_matches_jax(nets):
    """Same fp32 weights, same images: the port's scales (conv2d_fp32 and
    Model.forward_fp32 underneath) agree with jcalibrate's."""
    got = tcalibrate(nets["tm"], nets["tp"], nets["imgs"], batch=2,
                     device="cpu")
    assert len(got) == len(nets["scales"]) == len(nets["tm"].layers) + 1
    np.testing.assert_allclose(got, nets["scales"], rtol=ULPS * F32_EPS,
                               atol=0)


def test_forward_fp32_matches_jax_per_layer(nets):
    x = nets["imgs"]
    _, want = nets["jm"].forward_fp32(nets["params"], jnp.asarray(x),
                                      capture_inputs=True)
    _, got = nets["tm"].forward_fp32(nets["tp"], torch.from_numpy(x),
                                     capture_inputs=True)
    assert len(got) == len(want)
    for li, (g, w) in enumerate(zip(got, want)):
        w = _np(w)
        assert g.shape == w.shape, li
        tol = ULPS * np.spacing(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                   err_msg=f"layer {li}")


def test_quantize_model_params_matches_jax(nets):
    want = jquantize(nets["params"], nets["jm"].layers)
    got = tquantize(nets["tp"], nets["tm"].layers)
    for li, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), li
        for key in w:
            np.testing.assert_array_equal(g[key].numpy(), _np(w[key]))


@pytest.mark.parametrize("act,stride,padding", [
    ("leaky", 1, "SAME"), ("linear", 1, "VALID"), ("leaky", 2, "SAME")])
def test_conv2d_fp32_matches_jax(act, stride, padding):
    """The reference conv at HIGHEST precision (no TF32 on the card)."""
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 13, 13, 64)).astype(np.float32)
    w = (r.standard_normal((3, 3, 64, 128)) * 0.05).astype(np.float32)
    b = r.standard_normal(128).astype(np.float32)
    want = _np(jconv2d_fp32(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            act=act, stride=stride, padding=padding))
    got = conv2d_fp32(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), act=act, stride=stride,
                      padding=padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ULPS * np.spacing(np.abs(want).max()))


def _plans(nets, pin):
    jst = jplan.build_plan(nets["jm"], PINS[pin])
    tst = tplan.build_plan(nets["tm"], PINS[pin])
    assert [(s.kind, s.conv_li, s.fold, s.k) for s in tst] == \
        [(s.kind, s.conv_li, s.fold, s.k) for s in jst]
    jpp = jplan.prepare_plan_params(nets["jm"], nets["jq"], jst)
    tpp = tplan.prepare_plan_params(nets["tm"], nets["tq"], tst)
    for a, b in zip(jpp, tpp):
        for key in a:
            np.testing.assert_array_equal(b[key].numpy(), _np(a[key]))
    return jst, jpp, tst, tpp


def test_strategy_tables_match_jax():
    assert tplan._YOLOV2_STRATEGY == jplan._YOLOV2_STRATEGY
    assert tplan._YOLOV3_STRATEGY == jplan._YOLOV3_STRATEGY
    for key in (("yolov2-tiny", 1), ("yolov2-tiny", 8)):
        assert tplan._BATCH_STRATEGIES[key] == jplan._BATCH_STRATEGIES[key]
    for batch in (None, 1, 2, 8, 32):
        assert (tplan.default_strategy("yolov2-tiny", batch)
                == jplan.default_strategy("yolov2-tiny", batch))
    for batch in (1, 2, 16):
        assert (tplan.default_strategy("yolov3-tiny", batch)
                == jplan.default_strategy("yolov3-tiny", batch)
                == jplan._YOLOV3_STRATEGY)


@pytest.mark.parametrize("pin", ["b32", "b1", "b8"])
def test_every_stage_matches_jax(nets, pin):
    jst, jpp, tst, tpp = _plans(nets, pin)
    states = []
    head = jplan.plan_forward_w8a8(nets["jm"], jst, jpp, nets["scales"],
                                   jnp.asarray(nets["u8"]),
                                   record_states=states)
    outs = [s[:3] for s in states[1:]] + [(head, None, 1)]
    kinds = set()
    for si, st in enumerate(tst):
        x, cs, cf, _ = states[si]
        cs = None if cs is None else float(cs)
        got, gs, gf = tplan._run_stage(
            nets["tm"].layers, st, tpp[si], torch.from_numpy(np.array(x)),
            cs, cf, nets["tscales"])
        want, ws, wf = outs[si]
        assert got.dtype == torch.int8 or ws is None
        np.testing.assert_array_equal(got.numpy(), _np(want),
                                      err_msg=f"stage {si} {st.kind}")
        assert gf == wf and (gs is None) == (ws is None), (si, gs, ws)
        if gs is not None:
            assert np.float32(gs) == np.float32(ws)
        kinds.add(st.kind)
    assert {"stem_rs", "fold_xla", "xla", "pool"} <= kinds
    assert ("fold_xla_k2" in kinds) == (pin != "b1")


@pytest.mark.parametrize("wire", ["uint8", "f32"])
def test_forward_head_matches_jax(nets, wire):
    """Exact against the JAX plan run op by op. Under ``jax.jit`` XLA on
    the CPU contracts the f32 head's acc*scale + bias into one fused
    multiply-add, so the jitted head may differ from both by that single
    rounding: at most a few ulps of the head's magnitude."""
    jst, jpp, tst, tpp = _plans(nets, "b32")
    x = nets["u8"] if wire == "uint8" else (
        nets["u8"].astype(np.float32) / np.float32(255.0))

    def run(xx):
        return jplan.plan_forward_w8a8(nets["jm"], jst, jpp, nets["scales"],
                                       xx)
    eager = _np(run(jnp.asarray(x)))
    jitted = _np(jax.jit(run)(jnp.asarray(x)))
    states = []
    got = tplan.plan_forward_w8a8(nets["tm"], tst, tpp, nets["tscales"],
                                  torch.from_numpy(x), record_states=states)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2, 2, 125)
    assert [s[2] for s in states[:3]] == [1, 2, 1]    # fold state per stage
    np.testing.assert_array_equal(got.numpy(), eager)
    ulp = np.spacing(np.abs(eager).max())
    np.testing.assert_allclose(got.numpy(), jitted, rtol=0, atol=4 * ulp)


def test_generic_forward_w8a8_matches_jax(nets):
    """Model.forward_w8a8, the layer-by-layer reference path."""
    x = nets["u8"].astype(np.float32) / np.float32(255.0)
    ref = nets["jm"].forward_w8a8(nets["jq"], nets["scales"], jnp.asarray(x))
    got = nets["tm"].forward_w8a8(nets["tq"], nets["tscales"],
                                  torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), _np(ref))


@pytest.mark.parametrize("entry,item", [
    (("auto", 1), "A3"), (("rs2", 2), "B4"), (("fold_xla_s2", 2), "B7"),
    (("s0", 4), "B8"), (("gemm", 1), "A3")])
def test_unported_kinds_raise_with_roadmap_item(entry, item):
    with pytest.raises(NotImplementedError, match=item):
        tplan.build_plan(tyolo(), {0: entry})


def test_unported_model_raises_with_roadmap_item():
    """ResNet-18 (shortcut, global average pool, dense) is still to
    come; an unknown name lists the ported models."""
    from dnn_inference_engine_tpu_torch.models import build_model
    with pytest.raises(NotImplementedError, match="A10"):
        build_model("resnet18")
    with pytest.raises(ValueError, match="yolov3-tiny"):
        build_model("yolov4")


def test_folded_entry_stage_raises():
    """A folded first conv (other than the fused stem) quantizes the
    input with quant_space_to_depth4, which is not ported yet."""
    model = tyolo()
    plan = tplan.build_plan(model, {0: ("fold_xla_k2", 4, {"cin_pad": 64})})
    x = torch.zeros((1, 64, 64, 3))
    with pytest.raises(NotImplementedError, match="B5"):
        tplan._run_stage(model.layers, plan[0], {}, x, None, 1,
                         [0.1] * 16)
