"""The port's fp32 and w8 modes and its generic kernel-tier forward against
the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through the JAX function
(Pallas kernels in interpret mode, as the JAX package's own tests run
them) and the port's counterpart, whose wrappers take their plain PyTorch
versions for CPU tensors. The tolerances, each with its reason:

- ``gemm_f32`` and the float convs: f32 sums taken in another order. Two
  orders of K float32 products differ by a few sqrt(K) roundings of the
  sum of the magnitudes: ``_sum_tol`` allows 8 sqrt(K) float32 half-ulps
  of max sum |a||b| (times |scale|), plus the JAX GEMM's one FMA rounding
  of acc*scale + bias against the port's two.
- Whole fp32 and strict-w8 forwards: 64 float32 ulps of the head's
  largest magnitude (reordered sums over 9-13 convs).
- bf16 paths (w8 ``auto`` and the w8 plan): every conv input is rounded
  to bf16. Where the two packages' f32 sums straddle a bf16 rounding edge
  one value moves by a bf16 ulp (2**-8 of it), in about 6e-5 of the
  first fold stage's outputs, and the moves spread. The generic forward
  run op by op is held within 2**-10 of the head's largest magnitude;
  the w8 plan, and any w8 engine (JAX jits it, and the jit's fused
  epilogues move other values across the edges), within 2**-7. The w8
  plan's entry stage, whose input holds no such straddle, is held bit
  for bit.
- W8A8: int8 codes are exact. The xla tier's head is exact; a gemm-tier
  head (``pallas``, and ``auto`` where the head is deep) within 2 ulps:
  the JAX GEMM rounds the head's acc*scale + bias once (ROADMAP "FMA
  contraction"), the port twice.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu.config import EngineConfig as JConfig
from dnn_inference_engine_tpu.models import build_model as jbuild
from dnn_inference_engine_tpu.ops import conv as jconv
from dnn_inference_engine_tpu.ops import conv_lowering as jlow
from dnn_inference_engine_tpu.ops import dispatch as jdispatch
from dnn_inference_engine_tpu.ops import pallas_gemm as jgemm
from dnn_inference_engine_tpu.quant.quantize import (
    calibrate as jcalibrate, quantize_model_params as jquantize)
from dnn_inference_engine_tpu.runtime import plan as jplan
from dnn_inference_engine_tpu.runtime.engine import Engine as JEngine

from dnn_inference_engine_tpu_torch import cli
from dnn_inference_engine_tpu_torch.config import EngineConfig
from dnn_inference_engine_tpu_torch.models import build_model
from dnn_inference_engine_tpu_torch.models.weights import params_from_numpy
from dnn_inference_engine_tpu_torch.ops import conv as tconv
from dnn_inference_engine_tpu_torch.ops import conv_lowering as tlow
from dnn_inference_engine_tpu_torch.ops import dispatch as tdispatch
from dnn_inference_engine_tpu_torch.ops import gemm as tgemm
from dnn_inference_engine_tpu_torch.runtime import plan as tplan
from dnn_inference_engine_tpu_torch.runtime.engine import Engine

MODELS = ["yolov2-tiny", "yolov3-tiny"]
U = 2.0 ** -24                      # float32 unit roundoff


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _heads(h):
    """A head or a tuple of heads (numpy, JAX or CPU torch) as numpy."""
    return tuple(np.asarray(t) for t in (h if isinstance(h, tuple) else (h,)))


def _close(got, want, atol_of_max):
    """Each head within ``atol_of_max(max |head|)``."""
    got, want = _heads(got), _heads(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=atol_of_max(np.abs(w).max()))


def ulps(n):
    return lambda m: n * np.spacing(np.float32(m))


def _sum_tol(abs_sum_max, k):
    """Two float32 sums of K products in different orders, plus the
    epilogue's FMA-vs-two roundings (see the module docstring)."""
    return 8 * np.sqrt(k) * U * abs_sum_max + 4 * U * abs_sum_max


# ---------------------------------------------------------------------------
# gemm_f32: the float form of gemm_fused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["leaky", "linear", "relu"])
@pytest.mark.parametrize("b_dtype", ["f32", "int8"])
@pytest.mark.parametrize("m,k,n", [(300, 576, 125), (37, 27, 16),
                                   (130, 1030, 70)])
def test_gemm_f32_plain_matches_jax(act, b_dtype, m, k, n):
    """Ragged M, N and K (K = 27: conv2d_w8_pallas at layer 0), f32 x f32
    and f32 x int8 codes (the weight-only form)."""
    r = np.random.default_rng(m + k + n)
    a = r.standard_normal((m, k)).astype(np.float32)
    b = (r.integers(-127, 128, (k, n)).astype(np.int8) if b_dtype == "int8"
         else r.standard_normal((k, n)).astype(np.float32))
    scale = r.uniform(0.5, 2, n).astype(np.float32)
    if b_dtype == "int8":
        scale *= np.float32(1e-2)
    bias = r.standard_normal(n).astype(np.float32)
    want = np.asarray(jgemm.gemm_fused(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(scale), jnp.asarray(bias),
                                       act=act))
    before = tgemm.gemm_f32.launches
    got = tgemm.gemm_f32(T(a), T(b.T), T(scale), T(bias), act=act)
    assert tgemm.gemm_f32.launches == before     # the CPU takes the plain
    assert torch.equal(got, tgemm.gemm_f32_plain(T(a), T(b.T), T(scale),
                                                 T(bias), act=act))
    bound = (np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
             * np.abs(scale)).max()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_sum_tol(bound, k))


def test_gemm_f32_refuses_what_it_does_not_take():
    a, bt = torch.zeros((4, 8)), torch.zeros((3, 8))
    s = torch.ones(3)
    with pytest.raises(TypeError, match="bf16.*B13"):
        tgemm.gemm_f32(a.to(torch.bfloat16), bt, s, s)
    with pytest.raises(TypeError, match="float32 A"):
        tgemm.gemm_f32(a.to(torch.int8), bt.to(torch.int8), s, s)
    with pytest.raises(ValueError, match="bt"):
        tgemm.gemm_f32(a, torch.zeros((3, 7)), s, s)
    with pytest.raises(ValueError, match="scale"):
        tgemm.gemm_f32(a, bt, torch.ones(4), s)


# ---------------------------------------------------------------------------
# the float convs: gemm tier (conv_lowering) and xla tier (conv)
# ---------------------------------------------------------------------------

CONV_SHAPES = [((2, 13, 13, 64), 3, 128, 1), ((2, 16, 16, 3), 3, 16, 1),
               ((2, 8, 8, 256), 1, 125, 1), ((2, 9, 10, 16), 3, 32, 2)]


@pytest.mark.parametrize("fn", ["conv2d_fp32_pallas", "conv2d_w8_pallas",
                                "conv2d_w8", "conv2d_w8_bf16"])
@pytest.mark.parametrize("shape,k,cout,stride", CONV_SHAPES)
def test_float_convs_match_jax(fn, shape, k, cout, stride):
    r = np.random.default_rng(sum(shape) + k + cout)
    x = r.uniform(-1, 2, shape).astype(np.float32)
    b = (r.standard_normal(cout) * 0.1).astype(np.float32)
    act = "leaky" if cout != 125 else "linear"
    if fn == "conv2d_fp32_pallas":
        w = (r.standard_normal((k, k, shape[-1], cout)) * 0.1).astype(
            np.float32)
        args, scale = (w,), np.ones(cout, np.float32)
    else:
        w = r.integers(-127, 128, (k, k, shape[-1], cout)).astype(np.int8)
        scale = (r.uniform(0.5, 2, cout) * 1e-3).astype(np.float32)
        args = (w, scale)
    jfn = getattr(jlow if fn.endswith("pallas") else jconv, fn)
    tfn = getattr(tlow if fn.endswith("pallas") else tconv, fn)
    want = np.asarray(jfn(jnp.asarray(x), *map(jnp.asarray, args),
                          jnp.asarray(b), act=act, stride=stride))
    got = tfn(T(x), *map(T, args), T(b), act=act, stride=stride).numpy()
    xs = x.astype(np.float64)
    if fn == "conv2d_w8_bf16":      # the bf16-rounded input is the operand
        xs = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
            jnp.float32), np.float64)
    patches = tlow.extract_patches(T(np.abs(xs)), k, k, stride).numpy()
    bound = (patches.reshape(-1, patches.shape[-1])
             @ np.abs(w.astype(np.float64)).reshape(-1, cout)
             * np.abs(scale)).max()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_sum_tol(bound, k * k * shape[-1]))


# ---------------------------------------------------------------------------
# tier choice (shapes only) and the generic forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("mode", ["fp32", "w8", "w8a8"])
@pytest.mark.parametrize("model", MODELS)
def test_tier_report_matches_jax(model, mode, batch):
    """416 px: the gemm tier is taken at YOLOv2-tiny L8-L14 and at
    YOLOv3-tiny L8-L14 and L20, exactly where JAX takes its Pallas GEMM."""
    want = jdispatch.tier_report(jbuild(model), batch=batch, mode=mode)
    got = tdispatch.tier_report(build_model(model), batch=batch, mode=mode)
    assert got == want
    pallas = [li for li, _, tier in got if tier == "pallas"]
    assert pallas == {"yolov2-tiny": [8, 10, 12, 13, 14],
                      "yolov3-tiny": [8, 10, 12, 13, 14, 20]}[model]


@pytest.fixture(scope="module")
def nets():
    """Per model: JAX params, quantized params and calibration scales at
    64 px, and the port's copies."""
    out = {}
    for name in MODELS:
        jm, tm = jbuild(name), build_model(name)
        jm.input_size = tm.input_size = 64
        params = jm.init_params(jax.random.PRNGKey(0))
        x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(
            np.float32)
        scales = jcalibrate(jm, params, x, batch=2)
        jq = jquantize(params, jm.layers)
        tp, _ = params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu")
        tq, ts = params_from_numpy(jax.tree.map(np.asarray, jq), scales,
                                   device="cpu")
        out[name] = dict(jm=jm, tm=tm, params=params, jq=jq, scales=scales,
                         tp=tp, tq=tq, ts=ts, x=x)
    return out


FORWARD_TOL = {("fp32", "xla"): ulps(64), ("fp32", "pallas"): ulps(64),
               ("fp32", "auto"): ulps(64), ("w8", "xla"): ulps(64),
               ("w8", "pallas"): ulps(64),
               ("w8", "auto"): lambda m: 2.0 ** -10 * m,
               ("w8a8", "xla"): ulps(0), ("w8a8", "pallas"): ulps(2),
               ("w8a8", "auto"): ulps(2)}


@pytest.mark.parametrize("kernel", ["xla", "pallas", "auto"])
@pytest.mark.parametrize("mode", ["fp32", "w8", "w8a8"])
@pytest.mark.parametrize("model", MODELS)
def test_model_forward_matches_jax(nets, model, mode, kernel):
    """Model.forward for every mode and tier, against the JAX forward run
    op by op (no jit around it)."""
    n = nets[model]
    jp, tp = ((n["params"], n["tp"]) if mode == "fp32"
              else (n["jq"], n["tq"]))
    want = n["jm"].forward(jp, jnp.asarray(n["x"]), mode=mode,
                           act_scales=n["scales"], kernel=kernel)
    got = n["tm"].forward(tp, T(n["x"]), mode=mode, act_scales=n["ts"],
                          kernel=kernel)
    _close(got, want, FORWARD_TOL[mode, kernel])


def test_forward_refuses_unknown_mode_and_tier(nets):
    n = nets["yolov2-tiny"]
    with pytest.raises(ValueError, match="unknown mode"):
        n["tm"].forward(n["tp"], T(n["x"]), mode="int4")
    with pytest.raises(ValueError, match="unknown kernel tier"):
        n["tm"].forward(n["tp"], T(n["x"]), mode="fp32", kernel="cudnn")
    with pytest.raises(ValueError, match="calibration scales"):
        n["tm"].forward(n["tq"], T(n["x"]), mode="w8a8")


# ---------------------------------------------------------------------------
# the w8 plan
# ---------------------------------------------------------------------------

def test_w8_batch_strategies_match_jax():
    assert tplan._W8_BATCH_STRATEGIES == jplan._W8_BATCH_STRATEGIES
    for model in MODELS:
        for batch in (None, 1, 8, 16, 32):
            for mode in ("w8", "w8a8"):
                assert (tplan.default_strategy(model, batch, mode)
                        == jplan.default_strategy(model, batch, mode)), (
                    model, batch, mode)


@pytest.mark.parametrize("model,batch", [("yolov2-tiny", 1),
                                         ("yolov3-tiny", 16)])
def test_plan_forward_w8_matches_jax(nets, model, batch):
    """Each model's w8 pin against the JAX w8 plan, op by op: the entry
    stage bit for bit, the heads within the bf16 tolerance."""
    n = nets[model]
    strategy = jplan.default_strategy(model, batch, "w8")
    jst = jplan.build_plan(n["jm"], strategy)
    tst = tplan.build_plan(n["tm"], strategy)
    assert [(s.kind, s.fold, s.k) for s in tst] == [
        (s.kind, s.fold, s.k) for s in jst]
    jpp = jplan.prepare_plan_params(n["jm"], n["jq"], jst)
    tpp = tplan.prepare_plan_params(n["tm"], n["tq"], tst)
    u8 = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3)).astype(
        np.uint8)
    # the entry stage alone (the plain layer-0 output of a one-stage plan
    # of the single-head model)
    if n["jm"].out_layers is None:
        want0 = jplan.plan_forward_w8(n["jm"], jst[:1], jpp[:1],
                                      jnp.asarray(u8))
        got0 = tplan.plan_forward_w8(n["tm"], tst[:1], tpp[:1], T(u8))
        np.testing.assert_array_equal(got0.numpy(), np.asarray(want0))
    want = jplan.plan_forward_w8(n["jm"], jst, jpp, jnp.asarray(u8))
    got = tplan.plan_forward_w8(n["tm"], tst, tpp, T(u8))
    _close(got, want, lambda m: 2.0 ** -7 * m)


def test_plan_forward_w8_refuses_int8_kernel_kinds(nets):
    n = nets["yolov2-tiny"]
    st = tplan.build_plan(n["tm"], {2: ("rs", 2)})
    pp = tplan.prepare_plan_params(n["tm"], n["tq"], st)
    with pytest.raises(ValueError, match="no w8 implementation"):
        tplan.plan_forward_w8(n["tm"], st, pp, T(n["x"]))


# ---------------------------------------------------------------------------
# the engine: fp32 (the default), w8, w8a8 generic tiers, the fallbacks
# ---------------------------------------------------------------------------

def _engines(model, mode, kernel="auto", strategy=None, batch=2,
             score_thresh=0.3):
    """The JAX engine with its own random weights and scales, and the
    port's engine with them carried across."""
    kw = dict(model=model, batch=batch, input_size=64,
              score_thresh=score_thresh, strategy=strategy)
    if mode is not None:
        kw.update(mode=mode, kernel=kernel)
    calib = np.random.default_rng(11).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = JEngine(JConfig(**kw)).load_weights(
            key=jax.random.PRNGKey(0)).prepare(calib)
    p = jeng.params if jeng.config.mode != "fp32" else jeng.fp32_params
    teng = Engine(EngineConfig(**kw), device="cpu").load_weights(
        params=jax.tree.map(np.asarray, p), act_scales=jeng.act_scales)
    return jeng, teng


def _jax_heads(jeng, imgs):
    return jeng.forward_fn()(jeng.exec_params, jeng._device_batch(imgs))


def _assert_detections_close(j, t, score_tol, box_tol, thresh):
    """Per image, every detection of one engine has one in the other with
    its class, its score within ``score_tol`` and its box within
    ``box_tol`` px, except a detection whose score lies within
    ``score_tol`` of the threshold."""
    (jb, js, jc), (tb, ts, tc) = j, t
    for i in range(len(js)):
        for (b1, s1, c1), (b2, s2, c2) in (
                ((jb[i], js[i], jc[i]), (tb[i], ts[i], tc[i])),
                ((tb[i], ts[i], tc[i]), (jb[i], js[i], jc[i]))):
            for d in np.flatnonzero(s1 > 0):
                match = ((c2 == c1[d]) & (s2 > 0)
                         & (np.abs(s2 - s1[d]) <= score_tol)
                         & (np.abs(b2 - b1[d]).max(axis=-1) <= box_tol))
                assert match.any() or abs(s1[d] - thresh) <= score_tol, (
                    i, d, s1[d], c1[d], b1[d])


@pytest.mark.parametrize("model", MODELS)
def test_default_fp32_engine_matches_jax(model):
    """EngineConfig() is fp32 with kernel auto in both packages: no plan,
    the generic forward with the gemm tier on the deep layers."""
    jeng, teng = _engines(model, None)
    assert teng.config.mode == jeng.config.mode == "fp32"
    assert teng.config.kernel == jeng.config.kernel == "auto"
    teng.prepare()
    assert teng._plan is None and jeng._plan is None
    imgs = np.random.default_rng(12).integers(
        0, 256, (2, 64, 64, 3)).astype(np.uint8)
    _close(teng.classify(imgs), _jax_heads(jeng, imgs), ulps(64))
    tol = float(ulps(64)(8.0))
    _assert_detections_close(jeng.detect(imgs), teng.detect(imgs),
                             score_tol=tol, box_tol=1e-2, thresh=0.3)


@pytest.mark.parametrize("model", MODELS)
def test_w8_engine_matches_jax(model):
    """w8 with kernel auto: the pinned w8 plan of the batch (b1 for
    YOLOv2-tiny; the YOLOv3-tiny pin is b16's, so b2 takes the w8a8
    default table, which the w8 walker runs in bf16)."""
    jeng, teng = _engines(model, "w8", batch=1 if model == "yolov2-tiny"
                          else 2)
    teng.prepare()
    assert [s.kind for s in teng._plan] == [s.kind for s in jeng._plan]
    n = teng.config.batch
    imgs = np.random.default_rng(12).integers(
        0, 256, (n, 64, 64, 3)).astype(np.uint8)
    want = _jax_heads(jeng, imgs)
    _close(teng.classify(imgs), want, lambda m: 2.0 ** -7 * m)
    tol = 2.0 ** -7 * max(np.abs(h).max() for h in _heads(want))
    _assert_detections_close(jeng.detect(imgs), teng.detect(imgs),
                             score_tol=tol, box_tol=8.0, thresh=0.3)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("model", MODELS)
def test_w8a8_generic_engine_matches_jax(model, kernel):
    """w8a8 with kernel xla or pallas: no plan, every conv on that tier;
    detections exact in class and count."""
    jeng, teng = _engines(model, "w8a8", kernel, score_thresh=0.02)
    teng.prepare()
    assert teng._plan is None and jeng._plan is None
    imgs = np.random.default_rng(12).integers(
        0, 256, (2, 64, 64, 3)).astype(np.uint8)
    _close(teng.classify(imgs), _jax_heads(jeng, imgs), ulps(2))
    jb, js, jc = jeng.detect(imgs)
    tb, ts, tc = teng.detect(imgs)
    np.testing.assert_array_equal((ts > 0).sum(1), (js > 0).sum(1))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-3)


def test_w8_plan_with_an_int8_kind_falls_back_as_jax(tmp_path):
    """A w8 strategy with an rs stage: both engines drop the plan and run
    the generic w8 forward (bf16 convs); the port says why."""
    path = tmp_path / "rs.json"
    path.write_text(json.dumps({"strategy": {"2": ["rs", 2]}}))
    jeng, teng = _engines("yolov2-tiny", "w8", strategy=str(path))
    with pytest.warns(UserWarning, match="rs.json.*layer 2: rs"):
        teng.prepare()
    assert teng._plan is None and jeng._plan is None
    imgs = np.random.default_rng(12).integers(
        0, 256, (2, 64, 64, 3)).astype(np.uint8)
    _close(teng.classify(imgs), _jax_heads(jeng, imgs),
           lambda m: 2.0 ** -7 * m)


def test_illegal_w8a8_strategy_falls_back_in_both_engines(tmp_path):
    """C1: a fold with no pool after it makes build_plan give None; both
    engines run the generic kernel='auto' forward; the port warns with
    the file and the layer."""
    path = tmp_path / "nopool.json"
    path.write_text(json.dumps({"strategy": {"6": ["fold_xla", 2],
                                             "10": ["fold_xla", 2]}}))
    jeng, teng = _engines("yolov3-tiny", "w8a8", strategy=str(path),
                          score_thresh=0.02)
    with pytest.warns(UserWarning, match="nopool.json.*layer 10"):
        teng.prepare()
    assert teng._plan is None and jeng._plan is None
    imgs = np.random.default_rng(12).integers(
        0, 256, (2, 64, 64, 3)).astype(np.uint8)
    _close(teng.classify(imgs), _jax_heads(jeng, imgs), ulps(2))


def test_engine_refuses_unknown_mode_and_tier():
    with pytest.raises(ValueError, match="unknown mode"):
        Engine(EngineConfig(mode="int4"), device="cpu")
    with pytest.raises(ValueError, match="unknown kernel tier"):
        Engine(EngineConfig(kernel="cudnn"), device="cpu")
    eng = Engine(EngineConfig(input_size=64), device="cpu")
    with pytest.raises(RuntimeError, match="prepare first"):
        eng.classify(np.zeros((1, 64, 64, 3), np.uint8))


def test_cli_w8_plan_sweep_writes_an_artifact_engine_takes(tmp_path,
                                                           capsys):
    out = tmp_path / "w8.json"
    assert cli.main(["plan-sweep", "--device", "cpu", "--mode", "w8",
                     "--batch", "2", "--input-size", "64", "--quick",
                     "--iters", "2,1", "--reps", "1", "--out",
                     str(out)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    art = json.loads(out.read_text())
    assert summary["mode"] == art["mode"] == "w8"
    assert summary["strategy"] == art["strategy"]
    eng = Engine(EngineConfig(mode="w8", batch=2, input_size=64,
                              strategy=str(out)),
                 device="cpu").load_weights(seed=0).prepare()
    by_li = {st.conv_li: st for st in eng._plan}
    for li, entry in art["strategy"].items():
        assert (by_li[int(li)].kind, by_li[int(li)].fold) == tuple(
            entry[:2])
    heads = eng.classify(np.zeros((2, 64, 64, 3), np.uint8))
    assert heads.shape == (2, 2, 2, 125) and np.isfinite(heads).all()
