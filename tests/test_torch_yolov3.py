"""The port's YOLOv3-tiny against the JAX package, on the CPU.

YOLOv3-tiny at 64 px, batch 2: random weights and calibration scales made
by the JAX package and carried across (``params_from_numpy``). It is the
port's first model with graph layers: two routes, an upsample and two
detection heads (layers 15 and 21). Held against JAX:

- the fp32 forward per layer and the calibration scales, within 32
  float32 ulps (XLA and PyTorch sum the fp32 convs in different orders);
- the layer-by-layer W8A8 forward, exactly;
- the fused plan under the JAX pin ``_YOLOV3_STRATEGY`` (whose stage 0 is
  ``stem_dg``), stage by stage from the entry states the JAX plan
  recorded, route sources included, exactly; both heads exactly against
  the JAX plan run op by op and within 4 ulps of the jitted JAX heads
  (XLA contracts the f32 heads' acc*scale + bias into one FMA under jit,
  see tests/test_torch_plan.py);
- the same for a strategy with the new kinds: the folded k2 entry
  (quant_space_to_depth4), ``rs`` at L2, ``fold_xla_s2`` at L4 feeding
  ``fold_xla_k2`` at L6 (gmax_shift_s2d2 and the negative fold sentinel),
  and the gemm and auto tiers; L8 is a route source, so it cannot fold.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu.models.yolov3_tiny import yolov3_tiny as jyolo3
from dnn_inference_engine_tpu.quant.quantize import (
    calibrate as jcalibrate, quantize_model_params as jquantize)
from dnn_inference_engine_tpu.runtime import plan as jplan

from dnn_inference_engine_tpu_torch.models import build_model
from dnn_inference_engine_tpu_torch.models import yolov3_tiny as tyolo3
from dnn_inference_engine_tpu_torch.models.weights import params_from_numpy
from dnn_inference_engine_tpu_torch.quant.quantize import (
    calibrate as tcalibrate)
from dnn_inference_engine_tpu_torch.runtime import plan as tplan

ULPS = 32
F32_EPS = float(np.finfo(np.float32).eps)

STRATEGIES = {
    "pin": jplan._YOLOV3_STRATEGY,
    "sweep-kinds": {0: ("fold_xla_k2", 4, {"cin_pad": 64}), 2: ("rs", 2),
                    4: ("fold_xla_s2", 2), 6: ("fold_xla_k2", 2),
                    8: ("auto", 1), 10: ("gemm", 1), 12: ("auto", 1),
                    13: ("gemm", 1), 14: ("auto", 1), 15: ("xla", 1),
                    17: ("gemm", 1), 20: ("auto", 1), 21: ("xla", 1)},
}


def _np(t):
    return np.asarray(t)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(9)
    jm = jyolo3()
    params = jm.init_params(jax.random.PRNGKey(1))
    imgs = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    scales = jcalibrate(jm, params, imgs, batch=2)
    jq = jquantize(params, jm.layers)
    tq, tscales = params_from_numpy(jax.tree.map(np.asarray, jq), scales,
                                    device="cpu")
    tp, _ = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    u8 = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    return dict(jm=jm, params=params, jq=jq, scales=scales, tm=tyolo3(),
                tp=tp, tq=tq, tscales=tscales, imgs=imgs, u8=u8)


def test_model_matches_jax(nets):
    """Same layers, head width and out_layers; the registry builds it."""
    jm, tm = nets["jm"], nets["tm"]
    assert [(type(a).__name__, dataclasses.asdict(a)) for a in tm.layers] \
        == [(type(a).__name__, dataclasses.asdict(a)) for a in jm.layers]
    assert tm.out_layers == jm.out_layers == (15, 21)
    assert tm.out_channels() == jm.out_channels()
    assert build_model("yolov3-tiny").out_layers == (15, 21)
    assert build_model("yolov3-tiny", num_classes=80).layers[15].out_ch == 255


def test_params_from_numpy_carries_yolov3(nets):
    """The route/upsample layers' {} entries pass; fp32 and quantized
    params arrive unchanged, on the CPU."""
    for src, got in ((nets["params"], nets["tp"]), (nets["jq"], nets["tq"])):
        assert len(got) == len(nets["jm"].layers)
        for li, (a, b) in enumerate(zip(src, got)):
            assert set(a) == set(b), li
            for key in a:
                np.testing.assert_array_equal(b[key].numpy(), _np(a[key]))
    assert [li for li, p in enumerate(nets["tq"]) if not p] == \
        [1, 3, 5, 7, 9, 11, 16, 18, 19]


def test_init_params_seeded(nets):
    """The port's own He init: {} for pools, routes and the upsample."""
    p = nets["tm"].init_params(torch.Generator().manual_seed(0), "cpu")
    assert [li for li, d in enumerate(p) if not d] == \
        [1, 3, 5, 7, 9, 11, 16, 18, 19]
    assert tuple(p[20]["w"].shape) == (3, 3, 384, 256)


def test_forward_fp32_matches_jax_per_layer(nets):
    x = nets["imgs"]
    jres, want = nets["jm"].forward_fp32(nets["params"], jnp.asarray(x),
                                         capture_inputs=True)
    tres, got = nets["tm"].forward_fp32(nets["tp"], torch.from_numpy(x),
                                        capture_inputs=True)
    assert len(got) == len(want) == len(nets["tm"].layers) + 1
    for li, (g, w) in enumerate(zip(got, want)):
        w = _np(w)
        assert g.shape == w.shape, li
        tol = ULPS * np.spacing(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                   err_msg=f"layer {li}")
    assert isinstance(tres, tuple) and len(tres) == 2
    for g, w in zip(tres, jres):
        w = _np(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=ULPS * np.spacing(np.abs(w).max()))


def test_calibrate_matches_jax(nets):
    got = tcalibrate(nets["tm"], nets["tp"], nets["imgs"], batch=2,
                     device="cpu")
    assert len(got) == len(nets["scales"]) == len(nets["tm"].layers) + 1
    np.testing.assert_allclose(got, nets["scales"], rtol=ULPS * F32_EPS,
                               atol=0)


def test_generic_forward_w8a8_matches_jax(nets):
    """Model.forward_w8a8 with its routes and upsample: both heads
    exact."""
    x = nets["u8"].astype(np.float32) / np.float32(255.0)
    ref = nets["jm"].forward_w8a8(nets["jq"], nets["scales"], jnp.asarray(x))
    got = nets["tm"].forward_w8a8(nets["tq"], nets["tscales"],
                                  torch.from_numpy(x))
    assert isinstance(got, tuple) and len(got) == 2
    assert tuple(got[0].shape) == (2, 2, 2, 75)
    assert tuple(got[1].shape) == (2, 4, 4, 75)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def _plans(nets, name="pin"):
    jst = jplan.build_plan(nets["jm"], STRATEGIES[name])
    tst = tplan.build_plan(nets["tm"], STRATEGIES[name])
    assert [(s.kind, s.conv_li, s.pool_li, s.fold, s.k) for s in tst] == \
        [(s.kind, s.conv_li, s.pool_li, s.fold, s.k) for s in jst]
    jpp = jplan.prepare_plan_params(nets["jm"], nets["jq"], jst)
    tpp = tplan.prepare_plan_params(nets["tm"], nets["tq"], tst)
    for a, b in zip(jpp, tpp):
        for key in a:
            np.testing.assert_array_equal(b[key].numpy(), _np(a[key]))
    return jst, jpp, tst, tpp


def test_plan_stages_match_jax(nets):
    jst, _, tst, _ = _plans(nets)
    kinds = [s.kind for s in tst]
    assert kinds[0] == "stem_dg" and kinds.count("route") == 2
    assert kinds.count("upsample") == 1
    assert tplan.plan_input_uint8_ok(tst) == jplan.plan_input_uint8_ok(jst)
    assert tplan._referenced_layers(nets["tm"]) == \
        jplan._referenced_layers(nets["jm"]) == {8, 13, 15, 18, 21}


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_every_stage_matches_jax(nets, name):
    """Each stage of the port, fed the JAX plan's recorded entry state
    (the saved route sources too), gives the JAX plan's next state bit
    for bit."""
    jst, jpp, tst, tpp = _plans(nets, name)
    if name != "pin":
        assert {"fold_xla_k2", "rs", "fold_xla_s2", "gemm", "auto"} <= {
            st.kind for st in tst}
    states = []
    heads = jplan.plan_forward_w8a8(nets["jm"], jst, jpp, nets["scales"],
                                    jnp.asarray(nets["u8"]),
                                    record_states=states)
    assert len(states) == len(tst)
    outs = [s[:3] for s in states[1:]]
    for si, st in enumerate(tst):
        x, cs, cf, jsaved = states[si]
        cs = None if cs is None else float(cs)
        saved = {k: (_t(t), None if s is None else float(s))
                 for k, (t, s) in jsaved.items()}
        got, gs, gf = tplan._run_stage(
            nets["tm"].layers, st, tpp[si], _t(x), cs, cf,
            nets["tscales"], saved)
        if si + 1 == len(tst):
            np.testing.assert_array_equal(got.numpy(), _np(heads[1]))
            continue
        want, ws, wf = outs[si]
        np.testing.assert_array_equal(got.numpy(), _np(want),
                                      err_msg=f"stage {si} {st.kind}")
        assert gf == wf and (gs is None) == (ws is None), (si, gs, ws)
        if gs is not None:
            assert np.float32(gs) == np.float32(ws)


@pytest.mark.parametrize("name", list(STRATEGIES))
@pytest.mark.parametrize("wire", ["uint8", "f32"])
def test_forward_heads_match_jax(nets, wire, name):
    """Both heads exact against the JAX plan run op by op. Against the
    jitted JAX plan only under the pin: with gemm-tier stages, jax.jit
    contracts their folded-order epilogue into an FMA and flips int8
    codes mid-network, so the jitted JAX plan departs from its own op-by-op
    run (ROADMAP section C)."""
    jst, jpp, tst, tpp = _plans(nets, name)
    x = nets["u8"] if wire == "uint8" else (
        nets["u8"].astype(np.float32) / np.float32(255.0))

    def run(xx):
        return jplan.plan_forward_w8a8(nets["jm"], jst, jpp, nets["scales"],
                                       xx)
    eager = [_np(h) for h in run(jnp.asarray(x))]
    jitted = [_np(h) for h in jax.jit(run)(jnp.asarray(x))]
    states = []
    got = tplan.plan_forward_w8a8(nets["tm"], tst, tpp, nets["tscales"],
                                  torch.from_numpy(x), record_states=states)
    assert isinstance(got, tuple) and len(got) == 2
    assert [tuple(h.shape) for h in got] == [(2, 2, 2, 75), (2, 4, 4, 75)]
    assert sorted(states[-1][3]) == [8, 13, 15, 18]   # saved before L21
    for g, e, j in zip(got, eager, jitted):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), e)
        if name == "pin":
            ulp = np.spacing(np.abs(e).max())
            np.testing.assert_allclose(g.numpy(), j, rtol=0, atol=4 * ulp)
