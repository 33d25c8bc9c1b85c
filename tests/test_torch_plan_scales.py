"""The W8A8 plan's scale tensors, made once a plan (``StageScales``).

``prepare_plan_params`` given the act_scales makes, on the weights'
device, every tensor the W8A8 step reads of a host value: each stage's
input and output scales, its conv's s_in * s_w, the rs, s0 and stem
kernels' folded scale and bias, the YOLO stem's uint8 terms; the engine
makes the decode's anchor tables once a device. On the CPU, with the JAX
package's weights and calibration carried across (YOLOv2-tiny at 64 px
under its pins, ResNet-18 at 64 px with 10 classes, batch 2):

- each prepared tensor equals, bit for bit, the expression the stage
  evaluated on every call before (written out here);
- the prepared forward's state at every stage entry and its head equal the
  JAX plan's (ResNet-18's logits within 1e-5 of the largest: the pool
  sums in another order), under the YOLO pins for b32, b1 and b8;
- a prepared forward and its postprocess call ``f32_scalar`` not once:
  nothing there hands it a Python number or a host tensor, so on the card
  the step copies nothing from the host;
- a plan run with act_scales other than those it was prepared for raises.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from dnn_inference_engine_tpu.models import build_model as jbuild
from dnn_inference_engine_tpu.quant.quantize import (
    calibrate as jcalibrate, quantize_model_params as jquantize)
from dnn_inference_engine_tpu.runtime import plan as jplan

from dnn_inference_engine_tpu_torch.config import (
    EngineConfig, YOLOV2_TINY_ANCHORS, YOLOV3_TINY_ANCHORS)
from dnn_inference_engine_tpu_torch.models import build_model
from dnn_inference_engine_tpu_torch.models.weights import params_from_numpy
from dnn_inference_engine_tpu_torch.postprocess import (
    decode_yolov2_cols, device_nms_cols)
from dnn_inference_engine_tpu_torch.quant import quantize
from dnn_inference_engine_tpu_torch.quant.quantize import (
    PlanScale, f32_scalar)
from dnn_inference_engine_tpu_torch.runtime import plan as tplan
from dnn_inference_engine_tpu_torch.runtime.engine import Engine

LOGIT_TOL = 1e-5          # ResNet-18's logits, of the largest
PINS = {"b32": jplan._YOLOV2_STRATEGY,
        "b1": jplan._BATCH_STRATEGIES[("yolov2-tiny", 1)],
        "b8": jplan._BATCH_STRATEGIES[("yolov2-tiny", 8)]}
MODELS = {"yolov2-tiny": dict(seed=7, key=0, classes=20),
          "resnet18": dict(seed=18, key=3, classes=10)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def nets(_one_thread):
    """Per model: the JAX model, weights and scales, and the port's."""
    out = {}
    for name, m in MODELS.items():
        rng = np.random.default_rng(m["seed"])
        jm = jbuild(name, num_classes=m["classes"])
        params = jm.init_params(jax.random.PRNGKey(m["key"]))
        imgs = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
        scales = jcalibrate(jm, params, imgs, batch=2)
        jq = jquantize(params, jm.layers)
        tq, tscales = params_from_numpy(jax.tree.map(np.asarray, jq),
                                        scales, device="cpu")
        u8 = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
        out[name] = dict(jm=jm, jq=jq, scales=scales, tq=tq,
                         tscales=tscales, u8=u8,
                         tm=build_model(name, num_classes=m["classes"]))
    return out


def _prepared(n, name, pin="b32"):
    st = tplan.build_plan(n["tm"], PINS[pin] if name == "yolov2-tiny"
                          else {})
    return st, tplan.prepare_plan_params(n["tm"], n["tq"], st, n["tscales"])


def _bits(t):
    return t.reshape(-1).view(torch.int32)


def _same_bits(a, b):
    return (a.dtype == b.dtype == torch.float32 and a.shape == b.shape
            and a.device == b.device and torch.equal(_bits(a), _bits(b)))


def _per_call(st, pp, s_in, s_next, dev):
    """What the stage computed of its scales on every call before they
    were made once a plan: {field: tensor}."""
    f = {"s_in": f32_scalar(s_in, dev)}
    so = None if s_next is None else f32_scalar(s_next, dev)
    if so is not None:
        f["s_out"] = so
    s_w = pp.get("s_w")
    if st.kind in ("stem_rs", "stem_dg"):
        s_in_t = f32_scalar(s_in, dev)
        f["scale"] = (s_in_t * s_w) / so
        f["bias"] = pp["b"] / so
        s255 = f32_scalar(1.0 / 255.0, dev)
        w1 = pp["wq"].reshape(-1, s_w.shape[0]).to(torch.float32).sum(0)
        f["u8"] = (s255, (s255 * s_w) / so,
                   (pp["b"] + 128.0 * s255 * s_w * w1) / so)
    elif st.kind in ("xla", "fold_xla", "fold_xla_k2", "fold_xla_s2"):
        f["scale"] = f32_scalar(s_in, dev) * s_w
    return f


# the fields each model's plan has (YOLO's stem has them all)
FIELDS = [("yolov2-tiny", k) for k in ("s_in", "s_out", "scale", "bias",
                                       "u8")] + \
         [("resnet18", k) for k in ("s_in", "s_out", "scale")]


@pytest.mark.parametrize("name,field", FIELDS)
def test_prepared_tensor_is_the_per_call_expression(nets, name, field):
    """Every stage's prepared tensor of ``field`` against the expression
    the stage evaluated per call, at the scales a forward carries into
    it (recorded from the prepared forward itself)."""
    n = nets[name]
    stages, pp = _prepared(n, name)
    states = []
    tplan.plan_forward_w8a8(n["tm"], stages, pp, n["tscales"], T(n["u8"]),
                            record_states=states)
    checked = 0
    for st, q, (_, cur, _, _) in zip(stages, pp, states):
        sc = q.get("scales")
        if sc is None or getattr(sc, field) is None:
            continue
        li = st.conv_li
        s_in = n["tscales"][li] if cur is None else float(cur)
        final = st.s_out_is_final and st.kind == "xla"
        want = _per_call(st, q, s_in, None if final
                         else n["tscales"][li + 1], "cpu")[field]
        got = getattr(sc, field)
        if isinstance(got, PlanScale):
            assert isinstance(got.v, float)
            got = got.t
        pairs = zip(got, want) if field == "u8" else [(got, want)]
        for g, w in pairs:
            assert _same_bits(g, w), (st, field)
        checked += 1
    assert checked


def _jax_states(n, stages, x):
    rec = []
    head = jplan.plan_forward_w8a8(n["jm"], stages, jplan.prepare_plan_params(
        n["jm"], n["jq"], stages), n["scales"], jnp.asarray(x),
        record_states=rec)
    return rec, np.asarray(head)


@pytest.mark.parametrize("name,pin,wire", [
    ("yolov2-tiny", "b32", "uint8"), ("yolov2-tiny", "b32", "f32"),
    ("yolov2-tiny", "b1", "uint8"), ("yolov2-tiny", "b8", "uint8"),
    ("resnet18", None, "uint8"), ("resnet18", None, "f32")])
def test_prepared_forward_matches_jax(nets, name, pin, wire):
    """The prepared plan's state at every stage entry (codes, scale, fold)
    and its head against the JAX plan run op by op on the same batch."""
    n = nets[name]
    stages, pp = _prepared(n, name, pin)
    x = n["u8"] if wire == "uint8" else (
        n["u8"].astype(np.float32) / np.float32(255.0))
    jrec, want = _jax_states(n, jplan.build_plan(
        n["jm"], PINS[pin] if pin else {}), x)
    trec = []
    got = tplan.plan_forward_w8a8(n["tm"], stages, pp, n["tscales"], T(x),
                                  record_states=trec)
    assert len(trec) == len(jrec) == len(stages)
    # past the global average pool ResNet-18's f32 sums run in another order
    last = ([st.kind for st in stages].index("gap") if name == "resnet18"
            else len(stages) - 1)
    for si, ((tx, ts, tf, tsv), (jx, js, jf, jsv)) in enumerate(
            zip(trec[:last + 1], jrec)):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx),
                                      err_msg=str(si))
        assert tf == jf and (ts is None) == (js is None), si
        if ts is not None:
            assert isinstance(ts, PlanScale)
            assert np.float32(ts) == np.float32(js)
        assert sorted(tsv) == sorted(jsv)
    if name == "yolov2-tiny":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert float(np.abs(got.numpy() - want).max()
                     / np.abs(want).max()) <= LOGIT_TOL


@pytest.fixture
def recorder(monkeypatch):
    """Every call of ``f32_scalar`` in the port's modules, as (value,
    device)."""
    calls = []
    orig = quantize.f32_scalar

    def rec(v, device):
        calls.append((v, device))
        return orig(v, device)
    rec.uploads = 0
    mods = [m for k, m in list(sys.modules.items())
            if k.startswith("dnn_inference_engine_tpu_torch")
            and getattr(m, "f32_scalar", None) is orig]
    assert quantize in mods
    for m in mods:
        monkeypatch.setattr(m, "f32_scalar", rec)
    return calls


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_prepared_detect_hands_f32_scalar_nothing(nets, recorder, batch):
    """A prepared YOLOv2-tiny engine under the b1, b32 and b8 pins: the
    forward and postprocess of a uint8 batch make no ``f32_scalar`` call,
    and give, bit for bit, the heads of the plan that makes its scales
    each call and the detections of the decode given the anchor tuple."""
    n = nets["yolov2-tiny"]
    eng = Engine(EngineConfig(model="yolov2-tiny", mode="w8a8", batch=batch,
                              input_size=64, score_thresh=0.02),
                 device="cpu").load_weights(
        params=jax.tree.map(np.asarray, n["jq"]),
        act_scales=n["scales"]).prepare()
    x = T(np.random.default_rng(batch).integers(
        0, 256, (batch, 64, 64, 3)).astype(np.uint8))
    del recorder[:]
    heads = eng._fwd(x)
    out = eng.postprocess(heads)
    assert recorder == []
    bare = tplan.prepare_plan_params(eng.model, eng.params, eng._plan)
    want = tplan.plan_forward_w8a8(eng.model, eng._plan, bare,
                                   eng.act_scales, x)
    assert torch.equal(heads, want)
    c = eng.config
    ref = device_nms_cols(*decode_yolov2_cols(
        want, YOLOV2_TINY_ANCHORS, c.num_classes, c.input_size),
        iou_thresh=c.nms_iou_thresh, score_thresh=c.score_thresh,
        topk=c.resolved_nms_topk(), max_det=c.max_detections)
    assert (ref[1] > 0).any()
    for g, w in zip(out, ref):
        assert torch.equal(g, w)


@pytest.mark.parametrize("wire", ["uint8", "f32"])
def test_prepared_classify_hands_f32_scalar_nothing(nets, recorder, wire):
    """ResNet-18's prepared plan forward (the uint8 wire into the small-Cin
    entry, or f32 quantized at the entry) makes no ``f32_scalar`` call,
    and gives what the per-call plan gives, bit for bit."""
    n = nets["resnet18"]
    stages, pp = _prepared(n, "resnet18")
    x = T(n["u8"] if wire == "uint8" else
          n["u8"].astype(np.float32) / np.float32(255.0))
    del recorder[:]
    got = tplan.plan_forward_w8a8(n["tm"], stages, pp, n["tscales"], x)
    assert recorder == []
    bare = tplan.prepare_plan_params(n["tm"], n["tq"], stages)
    if wire == "uint8":
        bare[0]["entry_codes"] = pp[0]["entry_codes"]
    want = tplan.plan_forward_w8a8(n["tm"], stages, bare, n["tscales"], x)
    assert recorder, "the per-call plan makes its scales each call"
    assert torch.equal(got, want)


def _moved(scales, i):
    out = list(scales)
    out[i] = out[i] * 1.25
    return out


# act_scales entries the plan reads: YOLO's stem input (0) and output (1,
# L2's input), L2's output (3); ResNet-18's entry (0), L2's output (3, L3's
# input) and the first shortcut's (5)
MOVED = [("yolov2-tiny", 0), ("yolov2-tiny", 1), ("yolov2-tiny", 3),
         ("resnet18", 0), ("resnet18", 3), ("resnet18", 5)]


@pytest.mark.parametrize("name,i", MOVED)
def test_plan_run_with_other_scales_raises(nets, name, i):
    """A plan prepared for one set of act_scales, run with a set whose
    entry ``i`` moved, raises instead of running on stale tensors."""
    n = nets[name]
    stages, pp = _prepared(n, name)
    x = T(n["u8"])
    if i == 0 and name == "resnet18":
        match = "entry_codes|prepare_plan_params"
    else:
        match = "prepare_plan_params"
    with pytest.raises(ValueError, match=match):
        tplan.plan_forward_w8a8(n["tm"], stages, pp,
                                _moved(n["tscales"], i), x)


def test_scale_the_plan_never_reads_moves_nothing(nets):
    """act_scales[2], the calibrated scale after YOLO's first pool, is one
    the b32 plan never reads (the stem folds that pool and carries its
    conv's output scale): moving it neither raises nor moves the head."""
    n = nets["yolov2-tiny"]
    stages, pp = _prepared(n, "yolov2-tiny")
    x = T(n["u8"])
    want = tplan.plan_forward_w8a8(n["tm"], stages, pp, n["tscales"], x)
    got = tplan.plan_forward_w8a8(n["tm"], stages, pp,
                                  _moved(n["tscales"], 2), x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("model,sets", [
    ("yolov2-tiny", [YOLOV2_TINY_ANCHORS]),
    ("yolov3-tiny", [YOLOV3_TINY_ANCHORS[3:], YOLOV3_TINY_ANCHORS[:3]])])
def test_anchor_tables_made_once_an_engine_and_device(model, sets):
    """``Engine.anchor_tables``: made by ``prepare``, the same tensors on
    every later call, each the float32 table ``f32_scalar`` makes of the
    anchors; a decode given the table equals one given the tuple."""
    eng = Engine(EngineConfig(model=model, mode="fp32", input_size=64),
                 device="cpu").load_weights(seed=0)
    assert eng._anchor_tables == {}
    eng.prepare()
    tables = eng.anchor_tables("cpu")
    assert list(eng._anchor_tables) == [torch.device("cpu")]
    assert eng.anchor_tables(torch.device("cpu")) is tables
    assert len(tables) == len(sets)
    for t, a in zip(tables, sets):
        assert _same_bits(t, f32_scalar(a, "cpu"))
    head = torch.randn((2, 2, 2, 25 * len(sets[0])),
                       generator=torch.Generator().manual_seed(5))
    for got, want in zip(decode_yolov2_cols(head, tables[0]),
                         decode_yolov2_cols(head, sets[0])):
        assert torch.equal(got, want)
