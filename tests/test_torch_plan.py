"""The port's fused W8A8 plan against the JAX plan, stage by stage.

YOLOv2-tiny at 64 px, batch 2, random weights and calibration scales made
by the JAX package and carried across. Each stage of the port is fed the
exact entry state that the JAX plan recorded (``record_states``) and must
produce the JAX plan's next state bit for bit, under the batch-32 table,
the batch-1 and batch-8 pins and three strategies (S1-S3) that run every
kind the sweep proposes: the folded entry stages (quant_space_to_depth4),
fold_xla_s2 (gmax_shift_s2d2) and its negative fold sentinel, rs and rs2
(conv3x3_rs, s2d_out too), and the gemm and auto conv tiers. The whole
head must match too, for uint8 wire input and for f32 input.

An f32 head that the gemm tier computes (S2's and S3's L14) is held
within 2 ulps of its magnitude: the JAX Pallas GEMM, jitted even when the
plan runs op by op, rounds acc*scale + bias once (an FMA); the port
rounds twice (tests/test_torch_ops.py pins both roundings exactly).

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
        "b8": jplan._BATCH_STRATEGIES[("yolov2-tiny", 8)],
        # the two strategies chip_smoke.py runs on the card
        "s1": {0: ("fold_xla_k2", 4, {"cin_pad": 64}), 2: ("fold_xla_s2", 2),
               4: ("fold_xla_k2", 2), 6: ("rs2", 2), 8: ("rs", 2),
               10: ("gemm", 1), 12: ("auto", 1), 13: ("auto", 1),
               14: ("xla", 1)},
        "s2": {0: ("fold_xla", 4, {"cin_pad": 64}), 2: ("rs", 2),
               4: ("rs2", 2), 6: ("auto", 1), 8: ("auto", 1),
               10: ("xla", 1), 12: ("gemm", 1), 13: ("xla", 1),
               14: ("gemm", 1)},
        # the unpadded k2 entry, rs emitting s2d(2) into a fold_xla stage
        "s3": {0: ("fold_xla_k2", 4), 2: ("rs", 2, {"s2d_out": True}),
               4: ("fold_xla", 2), 6: ("gemm", 1), 8: ("auto", 1),
               10: ("auto", 1), 12: ("xla", 1), 13: ("gemm", 1),
               14: ("auto", 1)}}

# the conv stage kinds each pin must run
PIN_KINDS = {"b32": {"stem_rs", "fold_xla", "fold_xla_k2", "xla"},
             "b1": {"stem_rs", "fold_xla", "xla"},
             "b8": {"stem_rs", "fold_xla", "fold_xla_k2", "xla"},
             "s1": {"fold_xla_k2", "fold_xla_s2", "rs", "gemm", "auto",
                    "xla"},
             "s2": {"fold_xla", "rs", "auto", "xla", "gemm"},
             "s3": {"fold_xla_k2", "rs", "fold_xla", "gemm", "auto", "xla"}}
# pins whose f32 head comes from the gemm tier (one FMA rounding in JAX)
GEMM_HEAD = {"s2", "s3"}


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


def _stage_keys(stages):
    return None if stages is None else [
        (s.kind, s.conv_li, s.pool_li, s.fold, s.k, s.s2d_out, s.cin_pad)
        for s in stages]


def _plans(nets, pin):
    jst = jplan.build_plan(nets["jm"], PINS[pin])
    tst = tplan.build_plan(nets["tm"], PINS[pin])
    assert _stage_keys(tst) == _stage_keys(jst)
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


def _assert_head(got, want, pin):
    if pin in GEMM_HEAD:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 * np.spacing(np.abs(want).max()))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pin", list(PINS))
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
        if si + 1 == len(tst):
            _assert_head(got.numpy(), _np(want), pin)
        else:
            np.testing.assert_array_equal(got.numpy(), _np(want),
                                          err_msg=f"stage {si} {st.kind}")
        assert gf == wf and (gs is None) == (ws is None), (si, gs, ws)
        if gs is not None:
            assert np.float32(gs) == np.float32(ws)
        kinds.add(st.kind)
    assert kinds - {"pool"} == PIN_KINDS[pin]


@pytest.mark.parametrize("pin", ["b32", "s1", "s2", "s3"])
@pytest.mark.parametrize("wire", ["uint8", "f32"])
def test_forward_head_matches_jax(nets, wire, pin):
    """Exact against the JAX plan run op by op (within 2 ulps where the
    gemm tier makes the head). Under ``jax.jit`` XLA on the CPU contracts
    the f32 head's acc*scale + bias into one fused multiply-add, so the
    jitted head may differ from both by that single rounding: at most a
    few ulps of the head's magnitude. The fold state of every stage
    matches the JAX plan's, the negative sentinel of fold_xla_s2 too."""
    jst, jpp, tst, tpp = _plans(nets, pin)
    x = nets["u8"] if wire == "uint8" else (
        nets["u8"].astype(np.float32) / np.float32(255.0))

    def run(xx):
        return jplan.plan_forward_w8a8(nets["jm"], jst, jpp, nets["scales"],
                                       xx)
    jstates = []
    eager = _np(jplan.plan_forward_w8a8(nets["jm"], jst, jpp, nets["scales"],
                                        jnp.asarray(x), record_states=jstates))
    jitted = _np(jax.jit(run)(jnp.asarray(x)))
    states = []
    got = tplan.plan_forward_w8a8(nets["tm"], tst, tpp, nets["tscales"],
                                  torch.from_numpy(x), record_states=states)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2, 2, 125)
    assert [s[2] for s in states] == [s[2] for s in jstates]   # fold states
    if pin == "s1":
        assert [s[2] for s in states[:4]] == [1, 2, -8, 1]
    _assert_head(got.numpy(), eager, pin)
    ulp = np.spacing(np.abs(eager).max())
    np.testing.assert_allclose(got.numpy(), jitted, rtol=0, atol=4 * ulp)


def test_generic_forward_w8a8_matches_jax(nets):
    """Model.forward_w8a8, the layer-by-layer reference path."""
    x = nets["u8"].astype(np.float32) / np.float32(255.0)
    ref = nets["jm"].forward_w8a8(nets["jq"], nets["scales"], jnp.asarray(x))
    got = nets["tm"].forward_w8a8(nets["tq"], nets["tscales"],
                                  torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), _np(ref))


@pytest.mark.parametrize("entry,item", [(("s0", 4), "B8")])
def test_unported_kinds_raise_with_roadmap_item(entry, item):
    """s0 at the one shape it was written for (layer 0 of the 416 px
    model) is still to come."""
    with pytest.raises(NotImplementedError, match=item):
        tplan.build_plan(tyolo(), {0: entry})


def test_s0_degrades_to_fold_xla_off_its_shape(nets):
    """Away from layer 0 of the 416 px model, s0 is a fold_xla stage, as
    in the JAX plan."""
    strat = {0: ("stem_rs", 4, {"cin_pad": 64}), 2: ("s0", 2)}
    tst = tplan.build_plan(tyolo(), strat)
    assert tst[1].kind == "fold_xla" and tst[1].fold == 2
    assert _stage_keys(tst) == _stage_keys(
        jplan.build_plan(nets["jm"], strat))


@pytest.mark.parametrize("entry", [("auto", 1), ("rs2", 2),
                                   ("fold_xla_s2", 2), ("gemm", 1)])
def test_once_unported_kinds_build_as_jax(nets, entry):
    """The kinds that raised before this slice build the JAX plan's
    stages (the b32 table's L4 is the fold_xla_k2 f=2 consumer that
    fold_xla_s2 needs)."""
    strat = dict(PINS["b32"])
    strat[2] = entry
    want = jplan.build_plan(nets["jm"], strat)
    assert _stage_keys(tplan.build_plan(nets["tm"], strat)) == \
        _stage_keys(want)
    assert want is not None


def _l2_l4_candidates():
    from dnn_inference_engine_tpu.runtime.plan_sweep import candidate_entries
    return candidate_entries(jyolo(), 2, "w8a8"), \
        candidate_entries(jyolo(), 4, "w8a8")


@pytest.mark.parametrize("c2", _l2_l4_candidates()[0], ids=str)
def test_build_plan_legality_grid_matches_jax(nets, c2):
    """Every pair of sweep candidates at L2 and L4 under the batch-32
    table: None exactly where the JAX plan gives None, else the same
    stages; a None comes with the illegal layer."""
    for c4 in _l2_l4_candidates()[1]:
        strat = dict(PINS["b32"])
        strat[2], strat[4] = c2, c4
        want = jplan.build_plan(nets["jm"], strat)
        got, why = tplan.plan_or_reason(nets["tm"], strat)
        assert _stage_keys(got) == _stage_keys(want), (c2, c4)
        assert (why == "") == (got is not None)
        if got is None:
            assert why.startswith(("layer 2:", "layer 4:")), why


def test_unported_model_raises_with_roadmap_item():
    """ResNet-18 (shortcut, global average pool, dense) is still to
    come; an unknown name lists the ported models."""
    from dnn_inference_engine_tpu_torch.models import build_model
    with pytest.raises(NotImplementedError, match="A10"):
        build_model("resnet18")
    with pytest.raises(ValueError, match="yolov3-tiny"):
        build_model("yolov4")


@pytest.mark.parametrize("wire", ["uint8", "f32"])
@pytest.mark.parametrize("entry", [
    ("fold_xla_k2", 4, {"cin_pad": 64}), ("fold_xla_k2", 4),
    ("fold_xla", 4, {"cin_pad": 64}), ("fold_xla", 4), ("rs", 4),
    ("rs2", 4), ("fold_xla_k2", 2), ("fold_xla", 2)], ids=str)
def test_folded_entry_stage_matches_jax(nets, entry, wire):
    """A folded first conv quantizes the network input: through
    quant_space_to_depth4 where the JAX plan fuses it (f=4, k2 or k3
    entry; uint8 normalized in the kernel), else quantize_act with the
    /255 first. Output, scale and fold equal the JAX stage's."""
    x = nets["u8"] if wire == "uint8" else (
        nets["u8"].astype(np.float32) / np.float32(255.0))
    strat = {0: entry}
    jst = jplan.build_plan(nets["jm"], strat)
    tst = tplan.build_plan(nets["tm"], strat)
    jpp = jplan.prepare_plan_params(nets["jm"], nets["jq"], jst[:1])
    tpp = tplan.prepare_plan_params(nets["tm"], nets["tq"], tst[:1])
    want, ws, wf = jplan._run_stage(nets["jm"].layers, jst[0], jpp[0],
                                    jnp.asarray(x), None, 1, nets["scales"],
                                    {})
    got, gs, gf = tplan._run_stage(nets["tm"].layers, tst[0], tpp[0],
                                   torch.from_numpy(x), None, 1,
                                   nets["tscales"])
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert gf == wf and np.float32(gs) == np.float32(ws)


def test_folded_entry_stage_raises(nets):
    """The fused stems quantize the network input themselves: given an
    int8 tensor mid-network (a scale already set) they raise, where
    every other folded entry kind now runs (the test above)."""
    for entry in (("stem_rs", 4, {"cin_pad": 64}), ("stem_dg", 4)):
        st = tplan.build_plan(nets["tm"], {0: entry})[0]
        pp = tplan.prepare_plan_params(nets["tm"], nets["tq"], [st])[0]
        x = torch.zeros((1, 64, 64, 3), dtype=torch.int8)
        with pytest.raises(ValueError, match="entry stage"):
            tplan._run_stage(nets["tm"].layers, st, pp, x, 0.05, 1,
                             nets["tscales"])
