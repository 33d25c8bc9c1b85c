"""The port's ResNet-18 against the JAX package, on the CPU.

ResNet-18 at 64 px with 10 classes, batch 2 (as the JAX package's own
``tests/test_plan.py`` runs it): random weights and calibration scales
made by the JAX package and carried across (``params_from_numpy``). It is
the port's first model with residual adds, stride-2 convs, a 1x1
projection skip, a global average pool and a dense head. Held against
JAX:

- the layer list at (1000, 224) and (10, 64);
- the W8A8 forward, every layer output up to the global average pool
  bit for bit (int8 codes and the linear convs' f32 outputs alike), the
  logits within 1e-5 of the largest (the mean sums in another order);
  fp32 within 2^-12 and w8 within 2^-7 of the largest logit;
- the plan (all ``xla`` stages, the pin ``{}``): its stages equal JAX
  ``build_plan``'s in w8a8 and w8, ``plan_forward_w8a8`` equal to the JAX
  plan run op by op (not jitted: XLA contracts an f32 epilogue into an
  FMA under jit, ROADMAP C) at every stage entry up to the pool,
  ``plan_forward_w8`` within the bf16 bound;
- the stride-2 SAME max pool (XLA's pads: none at the top of an even
  size) at 8, 7 and 112 px, f32 and int8;
- ``conv2d_w8a8_plain`` at stride 2 and with f32 output, and the route
  ``conv_w8a8_form`` gives each of ResNet-18's 20 convs at 224 px;
- the engine (``classify`` in three modes; ``detect`` refused, as the JAX
  engine refuses it), weight files with the dense layer, the tier report,
  the sweep and the CLI.

The port's int8 convs sum in float64 products here; the module pins one
thread (ROADMAP C5).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from dnn_inference_engine_tpu.config import EngineConfig as JConfig
from dnn_inference_engine_tpu.models import build_model as jbuild
from dnn_inference_engine_tpu.models import weights as jweights
from dnn_inference_engine_tpu.models.layers import (
    Conv as JConv, Dense as JDense, GlobalAvgPool as JGap)
from dnn_inference_engine_tpu.models.model import Model as JModel
from dnn_inference_engine_tpu.ops import conv as jconv
from dnn_inference_engine_tpu.ops.dispatch import tier_report as jtiers
from dnn_inference_engine_tpu.ops.pool import maxpool as jmaxpool
from dnn_inference_engine_tpu.quant.quantize import (
    calibrate as jcalibrate, quantize_model_params as jquantize)
from dnn_inference_engine_tpu.runtime import plan as jplan
from dnn_inference_engine_tpu.runtime.engine import Engine as JEngine

from dnn_inference_engine_tpu_torch import cli
from dnn_inference_engine_tpu_torch.config import EngineConfig
from dnn_inference_engine_tpu_torch.models import build_model
from dnn_inference_engine_tpu_torch.models import weights as tweights
from dnn_inference_engine_tpu_torch.models.layers import (
    Conv, Dense, GlobalAvgPool, Shortcut)
from dnn_inference_engine_tpu_torch.models.model import Model
from dnn_inference_engine_tpu_torch.ops import conv as tconv
from dnn_inference_engine_tpu_torch.ops.dispatch import tier_report
from dnn_inference_engine_tpu_torch.ops.pool import maxpool
from dnn_inference_engine_tpu_torch.quant.quantize import (
    calibrate as tcalibrate, quantize_model_params)
from dnn_inference_engine_tpu_torch.runtime import plan as tplan
from dnn_inference_engine_tpu_torch.runtime.engine import Engine

F32_EPS = float(np.finfo(np.float32).eps)
F32_REL_TOL = 2.0 ** -12
BF16_REL_TOL = 2.0 ** -7
LOGIT_TOL = 1e-5          # of the largest logit: the pool's summation order
GAP = 32                  # the global average pool's layer index


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(torch_threads)


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def nets(_one_thread):
    rng = np.random.default_rng(18)
    jm = jbuild("resnet18", num_classes=10)
    params = jm.init_params(jax.random.PRNGKey(3))
    imgs = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    scales = jcalibrate(jm, params, imgs, batch=2)
    jq = jquantize(params, jm.layers)
    tq, tscales = tweights.params_from_numpy(jax.tree.map(np.asarray, jq),
                                             scales, device="cpu")
    tp, _ = tweights.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
    return dict(jm=jm, params=params, jq=jq, scales=scales,
                tm=build_model("resnet18", num_classes=10), tp=tp, tq=tq,
                tscales=tscales, imgs=imgs)


@pytest.fixture(scope="module")
def w8a8_runs(nets):
    """The JAX and port W8A8 forwards with every layer's output."""
    x = nets["imgs"]
    jres, jouts = nets["jm"].forward_w8a8(nets["jq"], nets["scales"],
                                          jnp.asarray(x),
                                          capture_outputs=True)
    tres, touts = nets["tm"].forward_w8a8(nets["tq"], nets["tscales"],
                                          T(x), capture_outputs=True)
    return jres, jouts, tres, touts


def _layers(m):
    return [(type(a).__name__, dataclasses.asdict(a)) for a in m.layers]


@pytest.mark.parametrize("classes,size", [(1000, 224), (10, 64)])
def test_layer_list_matches_jax(classes, size):
    jm = jbuild("resnet18", num_classes=classes)
    tm = build_model("resnet18", num_classes=classes)
    assert _layers(tm) == _layers(jm) and len(tm.layers) == 34
    assert tm.out_channels() == jm.out_channels()
    assert (tm.name, tm.in_ch, tm.input_size, tm.out_layers) == \
        (jm.name, jm.in_ch, jm.input_size, jm.out_layers) == \
        ("resnet18", 3, 224, None)
    convs = [li for li, a in enumerate(tm.layers) if isinstance(a, Conv)]
    assert convs == [0, 2, 3, 5, 6, 8, 9, 11, 13, 14, 16, 17, 19, 21, 22,
                     24, 25, 27, 29, 30]
    assert isinstance(tm.layers[GAP], GlobalAvgPool)
    assert tm.layers[33] == Dense(classes)
    assert [li for li, a in enumerate(tm.layers)
            if isinstance(a, Shortcut)] == [4, 7, 12, 15, 20, 23, 28, 31]


def test_params_carry_and_init(nets):
    """The JAX params arrive unchanged (dense (512, 10), {} for the
    graph layers); the port's seeded He init has the same shapes."""
    for src, got in ((nets["params"], nets["tp"]), (nets["jq"], nets["tq"])):
        assert len(got) == 34
        for li, (a, b) in enumerate(zip(src, got)):
            assert set(a) == set(b), li
            for key in a:
                np.testing.assert_array_equal(b[key].numpy(),
                                              np.asarray(a[key]))
    assert tuple(nets["tq"][33]["wq"].shape) == (512, 10)
    p = nets["tm"].init_params(torch.Generator().manual_seed(0), "cpu")
    assert [tuple(d["w"].shape) if d else None for d in p] == \
        [tuple(np.asarray(d["w"]).shape) if d else None
         for d in nets["params"]]
    # He init: the dense weights' spread is sqrt(2 / Cin)
    assert abs(float(p[33]["w"].std()) - (2 / 512) ** 0.5) < 0.01


def test_dense_quantized_per_output_channel(nets):
    """quantize_model_params quantizes the (Cin, Cout) dense weights per
    output channel, as the JAX package does."""
    q = quantize_model_params(nets["tp"], nets["tm"].layers)
    for key in ("wq", "s_w", "b"):
        np.testing.assert_array_equal(q[33][key].numpy(),
                                      np.asarray(nets["jq"][33][key]))
    assert q[33]["s_w"].shape == (10,) and q[33]["wq"].dtype == torch.int8


def test_calibration_matches_jax(nets):
    """Every layer's input scale (the pool's and the dense layer's 2-D
    inputs among them) within 32 float32 ulps of JAX's."""
    got = tcalibrate(nets["tm"], nets["tp"], nets["imgs"], batch=2,
                     device="cpu")
    assert len(got) == 35
    np.testing.assert_allclose(got, nets["scales"], rtol=32 * F32_EPS,
                               atol=0)


def test_forward_w8a8_matches_jax_up_to_the_pool(w8a8_runs):
    jres, jouts, tres, touts = w8a8_runs
    assert len(touts) == len(jouts) == 34
    for li in range(GAP):
        np.testing.assert_array_equal(touts[li].numpy(),
                                      np.asarray(jouts[li]), err_msg=str(li))
    assert tres.shape == (2, 10)
    assert _rel(tres.numpy(), jres) <= LOGIT_TOL


def test_forward_fp32_and_w8_match_jax(nets):
    x = nets["imgs"]
    want = nets["jm"].forward_fp32(nets["params"], jnp.asarray(x))
    got = nets["tm"].forward_fp32(nets["tp"], T(x))
    assert got.shape == (2, 10) and _rel(got.numpy(), want) <= F32_REL_TOL
    want = nets["jm"].forward_w8(nets["jq"], jnp.asarray(x))
    got = nets["tm"].forward_w8(nets["tq"], T(x))
    assert _rel(got.numpy(), want) <= BF16_REL_TOL


def _stage_keys(stages):
    return [(s.kind, s.conv_li, s.pool_li, s.fold, s.k, s.act, s.stride,
             s.padding, s.s_out_is_final) for s in stages]


@pytest.mark.parametrize("batch", [32, 1])
@pytest.mark.parametrize("mode", ["w8a8", "w8"])
def test_plan_stages_match_jax(mode, batch):
    jm, tm = jbuild("resnet18"), build_model("resnet18")
    assert tplan.default_strategy("resnet18", batch, mode) == {}
    js = jplan.build_plan(jm, jplan.default_strategy("resnet18", batch,
                                                     mode))
    ts, why = tplan.plan_or_reason(tm, batch=batch, mode=mode)
    assert why == "" and _stage_keys(ts) == _stage_keys(js)
    assert [s.kind for s in ts].count("xla") == 20
    assert [s.kind for s in ts][-2:] == ["gap", "dense"]
    assert not tplan.plan_input_uint8_ok(ts)


def test_plan_w8a8_matches_jax_op_by_op(nets):
    jm, tm = nets["jm"], nets["tm"]
    js, ts = jplan.build_plan(jm, {}), tplan.build_plan(tm, {})
    jpp = jplan.prepare_plan_params(jm, nets["jq"], js)
    tpp = tplan.prepare_plan_params(tm, nets["tq"], ts)
    assert set(tpp[-1]) == {"wq", "s_w", "b", "w"}
    x = nets["imgs"]
    jrec, trec = [], []
    want = jplan.plan_forward_w8a8(jm, js, jpp, nets["scales"],
                                   jnp.asarray(x), record_states=jrec)
    got = tplan.plan_forward_w8a8(tm, ts, tpp, nets["tscales"], T(x),
                                  record_states=trec)
    gap = [s.kind for s in ts].index("gap")
    for si in range(gap + 1):
        (jx, js_, jf, jsaved), (tx, ts_, tf, tsaved) = jrec[si], trec[si]
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx),
                                      err_msg=str(si))
        assert (ts_ is None) == (js_ is None) and tf == jf
        if ts_ is not None:
            assert np.float32(ts_) == np.float32(js_)
        assert sorted(tsaved) == sorted(jsaved)
        for li, (t, s) in tsaved.items():
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(jsaved[li][0]))
    assert got.shape == (2, 10) and _rel(got.numpy(), want) <= LOGIT_TOL


def test_plan_w8_within_the_bf16_bound(nets):
    jm, tm = nets["jm"], nets["tm"]
    js, ts = jplan.build_plan(jm, {}), tplan.build_plan(tm, {})
    jpp = jplan.prepare_plan_params(jm, nets["jq"], js)
    tpp = tplan.prepare_plan_params(tm, nets["tq"], ts)
    u8 = np.round(nets["imgs"] * 255).astype(np.uint8)
    want = jplan.plan_forward_w8(jm, js, jpp, jnp.asarray(u8))
    got = tplan.plan_forward_w8(tm, ts, tpp, T(u8))
    assert got.shape == (2, 10) and _rel(got.numpy(), want) <= BF16_REL_TOL


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("size", [8, 7, 112])
def test_same_stride2_pool_matches_jax(size, dtype):
    """The 3x3/s2 SAME pool with XLA's pads and the dtype's minimum as the
    pad value: ceil(size / 2) outputs."""
    r = np.random.default_rng(size)
    shape = (2, size, size + 1, 8)
    if dtype == "int8":
        x = r.integers(-128, 128, shape).astype(np.int8)
    else:
        x = (r.standard_normal(shape) - 3.0).astype(np.float32)
    want = np.asarray(jmaxpool(jnp.asarray(x), 3, 2, "SAME"))
    got = maxpool(T(x), 3, 2, "SAME")
    assert got.dtype == T(x).dtype
    assert got.shape == (2, -(-size // 2), -(-(size + 1) // 2), 8)
    np.testing.assert_array_equal(got.numpy(), want)


# (x shape, k, stride, s_out): ResNet-18's new forms at toy size: the
# 3x3/s2 conv (int8 out), the 1x1/s2 projection and the linear 3x3 conv
# (f32 out), at even and odd sizes
FORMS = [((2, 8, 8, 64), 3, 2, 0.05), ((2, 7, 9, 64), 3, 2, 0.05),
         ((2, 8, 8, 128), 3, 2, None), ((2, 8, 6, 64), 1, 2, None),
         ((2, 7, 7, 32), 1, 2, None), ((2, 8, 8, 64), 3, 1, None),
         ((2, 5, 7, 128), 3, 1, None)]


@pytest.mark.parametrize("form", FORMS, ids=str)
def test_new_conv_forms_match_jax(form):
    xs, k, stride, s_out = form
    r = np.random.default_rng(sum(xs) + 7 * k + stride)
    cin, cout = xs[3], 96
    x = r.integers(-127, 128, xs).astype(np.int8)
    w = r.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    s_w = (r.uniform(0.5, 1.5, cout) * 1e-4).astype(np.float32)
    b = r.standard_normal(cout).astype(np.float32)
    act = "relu" if s_out else "linear"
    want = np.asarray(jconv.conv2d_w8a8(
        jnp.asarray(x), jnp.float32(0.02), jnp.asarray(w), jnp.asarray(s_w),
        jnp.asarray(b), act=act, stride=stride,
        s_out=None if s_out is None else jnp.float32(s_out)))
    for fn in (tconv.conv2d_w8a8_plain, tconv.conv2d_w8a8):
        got = fn(T(x), 0.02, T(w), T(s_w), T(b), act=act, stride=stride,
                 s_out=s_out)
        assert got.dtype == (torch.float32 if s_out is None else torch.int8)
        np.testing.assert_array_equal(got.numpy(), want)
    f = tconv.conv_w8a8_form(*xs, cout, k, k, stride, "SAME", None,
                             s_out is not None)
    assert f.route != "im2col"


def resnet_convs(batch, size=224):
    """(layer, n, h, w, Cin, Cout, k, stride, requantizes) of each conv of
    ResNet-18 at ``size`` px, by walking the layer list's shapes."""
    m = build_model("resnet18")
    chans = m.out_channels()
    sizes, out = [], []
    h, prev = size, m.in_ch
    for li, layer in enumerate(m.layers):
        if isinstance(layer, Conv):
            out.append((li, batch, h, h, prev, layer.out_ch, layer.ksize,
                        layer.stride, layer.act != "linear"))
            h = -(-h // layer.stride)
        elif type(layer).__name__ == "MaxPool":
            h = -(-h // layer.stride)
        elif type(layer).__name__ == "Route":
            h = sizes[layer.layers[0]]
        sizes.append(h)
        prev = chans[li]
    return out


@pytest.mark.parametrize("batch", [32, 1])
def test_conv_w8a8_form_at_resnet18_shapes(batch):
    """conv_w8a8_form at 224 px: no conv takes the im2col route; the stem
    (7x7/s2, Cin 3) takes the small-Cin kernel ("rows"); the 3x3/s2 convs
    take the kernel's stride-2 PATCH form; the linear 3x3 convs (f32 out)
    PATCH at 56 px, TAP at 28, 14 and 7; the 1x1/s2 projections the
    stride-2 PATCH form too."""
    convs = resnet_convs(batch)
    assert len(convs) == 20
    routes = {}
    for li, n, h, w, cin, cout, k, stride, quant in convs:
        f = tconv.conv_w8a8_form(n, h, w, cin, cout, k, k, stride, "SAME",
                                 None, quant)
        routes[li] = f.route
        if f.route in ("patch", "tap"):
            assert f.tiles > 0 and 0 < f.grid <= tconv.H100_SMS
    assert routes[0] == "rows"
    assert [li for li, r in routes.items() if r == "im2col"] == []
    assert {routes[li] for li in (8, 16, 24)} == {"patch"}
    assert {routes[li] for li in (11, 19, 27)} == {"patch"}
    assert [routes[li] for li in (2, 3, 5, 6)] == ["patch"] * 4
    assert {routes[li] for li in (9, 13, 14, 17, 21, 22, 25, 29, 30)} == \
        {"tap"}
    # eight linear 3x3 convs take the f32 form, three stride-2 3x3 convs
    assert sum(not q and k == 3 for _, _, _, _, _, _, k, _, q in convs) == 8
    assert sum(s == 2 and k == 3 for _, _, _, _, _, _, k, s, _ in convs) == 3


@pytest.mark.parametrize("batch", [32, 1])
def test_tier_report_matches_jax(batch):
    """The fp32 auto forward's gemm tier: the 3x3 convs at 28, 14 and 7 px
    with K >= 1024 (layer 8's K is 576); the stem and the projections on
    the float conv."""
    want = jtiers(jbuild("resnet18"), batch=batch)
    got = tier_report(build_model("resnet18"), batch=batch)
    assert got == want
    assert [li for li, _, t in got if t == "pallas"] == \
        [9, 13, 14, 16, 17, 21, 22, 24, 25, 29, 30]


@pytest.mark.parametrize("mode", ["fp32", "w8", "w8a8"])
def test_engine_classifies_and_refuses_detect(mode):
    cfg = EngineConfig(model="resnet18", mode=mode, batch=2, input_size=64,
                       num_classes=10)
    eng = Engine(cfg, device="cpu").load_weights(seed=0)
    with pytest.warns(UserWarning, match="uniform noise") if mode == \
            "w8a8" else _nothing():
        eng.prepare()
    assert (eng._plan is not None) == (mode != "fp32")
    u8 = np.random.default_rng(5).integers(0, 256, (2, 64, 64, 3),
                                           dtype=np.uint8)
    logits = eng.classify(u8)
    assert logits.shape == (2, 10) and np.isfinite(logits).all()
    # the uint8 batch is divided by 255 before the forward
    np.testing.assert_array_equal(
        eng.classify(u8.astype(np.float32) / np.float32(255)), logits)
    with pytest.raises(ValueError, match="resnet18 is not a detector"):
        eng.detect(u8)
    with pytest.raises(ValueError, match="resnet18 is not a detector"):
        eng.postprocess(torch.from_numpy(logits))


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_jax_engine_refuses_detect_too():
    jeng = JEngine(JConfig(model="resnet18", input_size=64, num_classes=10))
    with pytest.raises(ValueError, match="resnet18 is not a detector"):
        jeng.postprocess(jnp.zeros((2, 10), jnp.float32))


def test_checkpoint_round_trip_with_the_dense_layer(tmp_path):
    cfg = EngineConfig(model="resnet18", mode="w8a8", batch=2, input_size=64,
                       num_classes=10)
    calib = np.random.default_rng(6).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    eng = Engine(cfg, device="cpu").load_weights(seed=1).prepare(calib)
    path = str(tmp_path / "rn.npz")
    eng.save(path)
    params, scales = tweights.load_checkpoint(path)
    assert params[33]["wq"].shape == (512, 10) and len(scales) == 35
    jp, js = jweights.load_checkpoint(path)
    assert np.array_equal(jp[33]["wq"], params[33]["wq"]) and js == scales
    again = Engine(cfg, device="cpu").load_weights(path).prepare()
    np.testing.assert_array_equal(again.classify(calib), eng.classify(calib))


def test_darknet_loader_refuses_a_dense_layer(tmp_path):
    """Both loaders read the convs before a dense layer, then refuse it."""
    path = tmp_path / "tiny.weights"
    with open(path, "wb") as f:
        np.array([0, 2, 0], np.int32).tofile(f)
        np.array([0], np.int64).tofile(f)
        np.zeros(4 * 16 + 16 * 3, np.float32).tofile(f)
        np.zeros(10 + 16 * 10, np.float32).tofile(f)
    tm = Model("tiny", [Conv(16, ksize=1), GlobalAvgPool(), Dense(10)],
               input_size=8)
    jm = JModel("tiny", [JConv(16, ksize=1), JGap(), JDense(10)],
                input_size=8)
    with pytest.raises(NotImplementedError, match="dense"):
        tweights.load_darknet_weights(tm, str(path))
    with pytest.raises(NotImplementedError, match="dense"):
        jweights.load_darknet_weights(jm, str(path))


def test_config_round_trips_a_resnet_config(tmp_path):
    cfg = EngineConfig(model="resnet18", mode="w8", batch=32,
                       input_size=224, num_classes=1000)
    path = str(tmp_path / "c.json")
    cfg.to_json(path)
    assert EngineConfig.from_json(path) == cfg
    assert json.load(open(path))["model"] == "resnet18"


def test_cli_plan_sweep_writes_a_strategy_the_engine_loads(tmp_path,
                                                           capsys):
    out = str(tmp_path / "s.json")
    assert cli.main(["plan-sweep", "--model", "resnet18", "--device", "cpu",
                     "--mode", "w8a8", "--batch", "2", "--input-size", "64",
                     "--quick", "--iters", "2,1", "--reps", "1",
                     "--out", out]) == 0
    art = json.load(open(out))
    assert art["model"] == "resnet18" and art["input_size"] == 64
    assert set(art["strategy"]) == {str(li) for li, *_ in
                                    resnet_convs(1)}
    assert art["crashed_candidates"] == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["model"] == "resnet18" and summary["backend"] == "cpu"
    cfg = EngineConfig(model="resnet18", mode="w8a8", batch=2, input_size=64,
                       strategy=out)
    with pytest.warns(UserWarning, match="uniform noise"):
        eng = Engine(cfg, device="cpu").load_weights(seed=0).prepare()
    assert eng._plan is not None
    assert eng.classify(np.zeros((2, 64, 64, 3), np.uint8)).shape == (2, 20)


def test_cli_calibrates_and_refuses_detect(tmp_path, capsys):
    from PIL import Image
    imgs = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3),
                                             dtype=np.uint8)
    np.save(tmp_path / "calib.npy", imgs)
    cfg = str(tmp_path / "c.json")
    EngineConfig(model="resnet18", input_size=64, num_classes=10).to_json(cfg)
    ckpt = str(tmp_path / "rn.npz")
    assert cli.main(["calibrate", "--model", "resnet18", "--config", cfg,
                     "--device", "cpu", "--mode", "w8a8", "--images",
                     str(tmp_path / "calib.npy"), "--out", ckpt]) == 0
    params, scales = tweights.load_checkpoint(ckpt)
    assert len(params) == 34 and len(scales) == 35
    Image.fromarray(imgs[0]).save(tmp_path / "x.png")
    with pytest.raises(ValueError, match="resnet18 is not a detector"):
        cli.main(["detect", "--model", "resnet18", "--config", cfg,
                  "--device", "cpu", "--image", str(tmp_path / "x.png")])
