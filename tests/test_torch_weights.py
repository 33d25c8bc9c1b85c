"""The port's weight files, config files and file-loaded engines against
the JAX package.

Every file is written here from a seed: darknet ``.weights`` at the real
widths of YOLOv2-tiny and YOLOv3-tiny (with and without BN blocks, both
``seen`` headers), pickles (raw BN and pre-folded) and ``.npz``
checkpoints. Loaders must agree with the JAX ones bit for bit (keys,
dtypes, arrays); files written by either package load in the other to
the same arrays. File-loaded engines run YOLOv2-tiny W8A8 at 64 px:
params bit for bit, calibration scales from ``config.calib`` within 32
float32 ulps (as ``tests/test_torch_plan.py``), detections with classes
and survivor counts exact and boxes within 1e-3 px (the JAX engine's jit
rounds the f32 head once, an FMA; ``tests/test_torch_engine.py``).
"""

import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu.config import EngineConfig as JConfig
from dnn_inference_engine_tpu.models import build_model as jbuild
from dnn_inference_engine_tpu.models import layers as jlayers
from dnn_inference_engine_tpu.models import weights as jw
from dnn_inference_engine_tpu.models.model import Model as JModel
from dnn_inference_engine_tpu.runtime.engine import Engine as JEngine

from dnn_inference_engine_tpu_torch.config import EngineConfig
from dnn_inference_engine_tpu_torch.models import build_model
from dnn_inference_engine_tpu_torch.models import layers as tlayers
from dnn_inference_engine_tpu_torch.models import weights as tw
from dnn_inference_engine_tpu_torch.models.model import Model
from dnn_inference_engine_tpu_torch.runtime.engine import Engine

ULPS = 32
F32_EPS = float(np.finfo(np.float32).eps)
SIZE = 64


def write_darknet(model, path, seed, minor=2, extra=0, drop=0):
    """A darknet file for ``model`` from ``seed``: He-scaled weights so
    that heads stay finite, BN blocks where the layer has BN. ``extra``
    floats appended, the last ``drop`` floats left out."""
    rng = np.random.default_rng(seed)
    chans = model.out_channels()
    blobs = [np.asarray([0, minor, 5], np.int32).tobytes(),
             np.asarray([123456], np.int64 if minor >= 2 else np.int32)
             .tobytes()]
    prev = model.in_ch
    floats = []
    for li, layer in enumerate(model.layers):
        if type(layer).__name__ == "Conv":
            c, k = layer.out_ch, layer.ksize
            if layer.use_bn:
                floats += [rng.normal(0, 0.1, c), rng.uniform(0.5, 1.5, c),
                           rng.normal(0, 0.1, c), rng.uniform(0.5, 2.0, c)]
            else:
                floats.append(rng.normal(0, 0.01, c))
            floats.append(rng.normal(0, (2.0 / (k * k * prev)) ** 0.5,
                                     c * prev * k * k))
        prev = chans[li]
    flat = np.concatenate(floats + [np.ones(extra)]).astype(np.float32)
    blobs.append(flat[:flat.size - drop].tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(blobs))
    return path


def assert_params_equal(a, b):
    """Two per-layer lists of numpy arrays: same keys, dtypes, values."""
    assert len(a) == len(b)
    for li, (pa, pb) in enumerate(zip(a, b)):
        assert sorted(pa) == sorted(pb), li
        for k in pa:
            x, y = np.asarray(pa[k]), np.asarray(pb[k])
            assert x.dtype == y.dtype and x.shape == y.shape, (li, k)
            np.testing.assert_array_equal(x, y, err_msg=f"layer {li} {k}")


def host(params):
    return [{k: np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor)
                           else v) for k, v in p.items()} for p in params]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Darknet files of both models (minor 2 and minor 1 headers) and a
    calibration batch, written once for the module."""
    d = tmp_path_factory.mktemp("weights")
    out = {}
    for name, seed in (("yolov2-tiny", 1), ("yolov3-tiny", 2)):
        out[name] = write_darknet(build_model(name), str(d / f"{name}."
                                                        "weights"), seed)
    out["v2-minor1"] = write_darknet(build_model("yolov2-tiny"),
                                     str(d / "m1.weights"), 1, minor=1)
    calib = np.random.default_rng(3).integers(
        0, 256, (4, 80, 96, 3)).astype(np.uint8)
    out["calib"] = str(d / "calib.npy")
    np.save(out["calib"], calib)
    out["dir"] = d
    return out


def test_bn_eps_and_fold_bn_match_jax():
    assert tw.BN_EPS == jw.BN_EPS == 1e-6
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    b, mean = (rng.standard_normal(16).astype(np.float32) for _ in "ab")
    gamma, var = (rng.uniform(0.1, 3, 16).astype(np.float32) for _ in "ab")
    got, want = tw.fold_bn(w, b, gamma, mean, var), jw.fold_bn(
        w, b, gamma, mean, var)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("name", ["yolov2-tiny", "yolov3-tiny",
                                  "v2-minor1"])
def test_darknet_loader_matches_jax(files, name):
    model = name if name != "v2-minor1" else "yolov2-tiny"
    got = tw.load_darknet_weights(build_model(model), files[name])
    want = jw.load_darknet_weights(jbuild(model), files[name])
    assert_params_equal(got, want)
    # layers without weights (pools, YOLOv3's route and upsample) get {}
    for p, layer in zip(got, build_model(model).layers):
        assert bool(p) == isinstance(layer, tlayers.Conv)


def _tiny_models():
    """One BN conv, a pool and a biased linear 1x1 conv, in both
    packages: small files for the error cases."""
    def layers(m):
        return [m.Conv(4, 3), m.MaxPool(), m.Conv(6, 1, act="linear",
                                                 use_bn=False)]
    return (Model("tiny", layers(tlayers)), JModel("tiny", layers(jlayers)))


@pytest.mark.parametrize("minor", [1, 2])
def test_darknet_headers_and_bn_read_order(tmp_path, minor):
    """beta, gamma, mean, var then OIHW weights, after an int32 or int64
    ``seen``: the folded conv equals fold_bn of those blocks."""
    tm, jm = _tiny_models()
    path = write_darknet(tm, str(tmp_path / "t.weights"), 4, minor=minor)
    got = tw.load_darknet_weights(tm, path)
    assert_params_equal(got, jw.load_darknet_weights(jm, path))
    with open(path, "rb") as f:
        f.seek(12 + (8 if minor >= 2 else 4))
        buf = np.frombuffer(f.read(), np.float32)
    beta, gamma, mean, var = buf[:4], buf[4:8], buf[8:12], buf[12:16]
    w = buf[16:16 + 4 * 3 * 9].reshape(4, 3, 3, 3).transpose(2, 3, 1, 0)
    wf, bf = tw.fold_bn(w, beta, gamma, mean, var)
    np.testing.assert_array_equal(got[0]["w"], wf)
    np.testing.assert_array_equal(got[0]["b"], bf)
    rest = buf[16 + 108:]
    np.testing.assert_array_equal(got[2]["b"], rest[:6])
    np.testing.assert_array_equal(
        got[2]["w"], rest[6:].reshape(6, 4, 1, 1).transpose(2, 3, 1, 0))
    assert got[1] == {}


@pytest.mark.parametrize("extra,drop,match", [(0, 1, "truncated"),
                                              (3, 0, "3 unread floats")])
def test_darknet_bad_files_raise(tmp_path, extra, drop, match):
    tm, jm = _tiny_models()
    path = write_darknet(tm, str(tmp_path / "bad.weights"), 5, extra=extra,
                         drop=drop)
    with pytest.raises(ValueError, match=match):
        tw.load_darknet_weights(tm, path)
    with pytest.raises(AssertionError, match=match):
        jw.load_darknet_weights(jm, path)


def _raw_bn_params(seed):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((3, 3, 3, 8)).astype(np.float32),
             "b": rng.standard_normal(8).astype(np.float32),
             "gamma": rng.uniform(0.5, 2, 8).astype(np.float32),
             "mean": rng.standard_normal(8).astype(np.float32),
             "var": rng.uniform(0.5, 2, 8).astype(np.float32)},
            {},
            {"w": rng.standard_normal((1, 1, 8, 5)).astype(np.float32),
             "b": rng.standard_normal(5).astype(np.float32)}]


@pytest.mark.parametrize("fold", [True, False])
def test_pickle_raw_bn_matches_jax(tmp_path, fold):
    path = str(tmp_path / "p.pkl")
    with open(path, "wb") as f:
        pickle.dump(_raw_bn_params(6), f)
    got = tw.load_params(path, fold=fold)
    assert_params_equal(got, jw.load_params(path, fold=fold))
    assert sorted(got[0]) == (["b", "w"] if fold else
                              ["b", "gamma", "mean", "var", "w"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pickle_written_by_either_loads_in_both(tmp_path, writer):
    """Pre-folded params: the port writes torch tensors as numpy."""
    params = [{k: v for k, v in p.items() if k in ("w", "b")}
              for p in _raw_bn_params(7)]
    path = str(tmp_path / "p.pkl")
    if writer == "port":
        tw.save_params([{k: torch.from_numpy(v) for k, v in p.items()}
                        for p in params], path)
    else:
        jw.save_params(params, path)
    assert_params_equal(tw.load_params(path), params)
    assert_params_equal(jw.load_params(path), params)


@pytest.mark.parametrize("scales", [True, False])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_written_by_either_loads_in_both(tmp_path, writer,
                                                    scales):
    """Quantized params and scales, both directions: equal keys, dtypes
    and arrays (``np.savez`` stamps times, so files are not compared)."""
    from dnn_inference_engine_tpu.quant.quantize import (
        quantize_model_params as jquantize)
    fp32 = [{k: v for k, v in p.items() if k in ("w", "b")}
            for p in _raw_bn_params(8)]
    q = jax.tree.map(np.asarray, jquantize(fp32, [None] * 3))
    act = [0.01, 0.02, 0.03, 0.04] if scales else None
    path = str(tmp_path / "c.npz")
    if writer == "port":
        tw.save_checkpoint(path, [{k: torch.from_numpy(v) for k, v in
                                   p.items()} for p in q], act)
    else:
        jw.save_checkpoint(path, q, act)
    for load in (tw.load_checkpoint, jw.load_checkpoint):
        got, got_s = load(path)
        assert_params_equal(got, q)
        if scales:
            assert got_s == np.asarray(act, np.float32).tolist()
        else:
            assert got_s is None
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            ["n_layers", "l0.wq", "l0.s_w", "l0.b", "l2.wq", "l2.s_w",
             "l2.b"] + (["act_scales"] if scales else []))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_config_json_across_packages(tmp_path, writer):
    kw = dict(model="yolov3-tiny", mode="w8", batch=4, mesh_shape=(2, 4),
              sharding="channel", serve_max_batch=8, serve_timeout_ms=2.5,
              weights="w.weights", calib="c.npz", strategy="s.json",
              nms_topk=64)
    path = str(tmp_path / "c.json")
    (EngineConfig if writer == "port" else JConfig)(**kw).to_json(path)
    got, want = EngineConfig.from_json(path), JConfig.from_json(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(EngineConfig)] == [
        f.name for f in dataclasses.fields(JConfig)]
    assert got.mesh_shape == (2, 4) and got == EngineConfig(**kw)


@pytest.mark.parametrize("kw", [dict(mesh_shape=(2, 1)),
                                dict(mesh_shape=(1, 4)),
                                dict(mesh_shape=(1, 2), sharding="channel")])
def test_engine_refuses_a_mesh(kw):
    """A config's mesh reaches the engine, which builds its groups on the
    process group: with none up, it refuses the mesh and says how to
    bring one up."""
    with pytest.raises(RuntimeError, match="init_distributed.*torchrun"):
        Engine(EngineConfig(**kw), device="cpu")


def _jax_engine(cfg_kw, calib=None):
    return JEngine(JConfig(**cfg_kw)).load_weights().prepare(calib)


@pytest.fixture(scope="module")
def darknet_engines(files):
    """YOLOv2-tiny W8A8 at 64 px from the darknet file, calibrated through
    ``config.calib`` in both packages."""
    kw = dict(model="yolov2-tiny", mode="w8a8", batch=2, input_size=SIZE,
              weights=files["yolov2-tiny"], calib=files["calib"],
              score_thresh=0.02)
    jeng = _jax_engine(kw)
    teng = Engine(EngineConfig(**kw), device="cpu").load_weights().prepare()
    return jeng, teng, kw


def _detect_both(jeng, teng, seed=12):
    imgs = np.random.default_rng(seed).integers(
        0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
    jb, js, jc = jeng.detect(imgs)
    tb, ts, tc = teng.detect(imgs)
    assert ((ts > 0).sum(1) == (np.asarray(js) > 0).sum(1)).all()
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_allclose(tb, np.asarray(jb), atol=1e-3, rtol=0)
    np.testing.assert_allclose(ts, np.asarray(js), atol=1e-5, rtol=0)
    return int((ts > 0).sum())


def test_engine_calibrates_from_config_calib(darknet_engines):
    jeng, teng, _ = darknet_engines
    assert teng._weights_from_file and jeng._weights_from_file
    assert_params_equal(host(teng.fp32_params), jeng.fp32_params)
    np.testing.assert_allclose(teng.act_scales, jeng.act_scales,
                               rtol=ULPS * F32_EPS, atol=0)


def test_darknet_engine_detects_as_jax(darknet_engines):
    jeng, _, kw = darknet_engines
    # the JAX engine's scales carried, so the int8 codes are the same
    teng = Engine(EngineConfig(**{**kw, "calib": None}), device="cpu")
    teng.load_weights()
    teng.act_scales = list(jeng.act_scales)
    teng.prepare()
    assert_params_equal(host(teng.params),
                        jax.tree.map(np.asarray, jeng.params))
    assert _detect_both(jeng, teng) > 0


@pytest.mark.parametrize("suffix", [".pkl", ".npz"])
def test_engine_loads_pickle_and_checkpoint_as_jax(darknet_engines,
                                                   tmp_path, suffix):
    """A pickle of the darknet engine's fp32 params (the JAX engine
    calibrates it from the same images), and the JAX engine's own
    checkpoint (quantized params and scales: nothing calibrates)."""
    jeng, _, kw = darknet_engines
    path = str(tmp_path / f"w{suffix}")
    if suffix == ".pkl":
        jw.save_params(jeng.fp32_params, path)
    else:
        jeng.save(path)
    kw = {**kw, "weights": path}
    j2 = _jax_engine(kw) if suffix == ".pkl" else jeng
    teng = Engine(EngineConfig(**kw), device="cpu").load_weights()
    if suffix == ".npz":
        assert teng.fp32_params is None
        assert teng.act_scales == np.asarray(jeng.act_scales,
                                             np.float32).tolist()
    else:
        assert_params_equal(host(teng.fp32_params), jeng.fp32_params)
        teng.act_scales = list(j2.act_scales)
    teng.prepare()
    assert_params_equal(host(teng.params), jax.tree.map(np.asarray,
                                                        j2.params))
    _detect_both(j2, teng)


def test_engine_save_loads_in_the_jax_engine(darknet_engines, tmp_path):
    """The port's checkpoint in the JAX engine: the same params and scales
    as the JAX engine's own, detections as above."""
    jeng, teng, kw = darknet_engines
    path = str(tmp_path / "port.npz")
    teng.save(path)
    j2 = _jax_engine({**kw, "weights": path, "calib": None})
    assert_params_equal(jax.tree.map(np.asarray, j2.params),
                        host(teng.params))
    assert j2.act_scales == np.asarray(teng.act_scales,
                                       np.float32).tolist()
    t2 = Engine(EngineConfig(**{**kw, "weights": path, "calib": None}),
                device="cpu").load_weights().prepare()
    _detect_both(j2, t2)


def test_noise_calibration_refused_for_file_weights(files):
    kw = dict(mode="w8a8", batch=1, input_size=SIZE,
              weights=files["yolov2-tiny"])
    with pytest.raises(ValueError, match="needs real calibration images"):
        Engine(EngineConfig(**kw), device="cpu").load_weights().prepare()
    with pytest.raises(ValueError, match="needs real calibration images"):
        _jax_engine(kw)
    # random weights still take the noise batch, with a warning
    with pytest.warns(UserWarning, match="uniform noise"):
        Engine(EngineConfig(mode="w8a8", batch=1, input_size=SIZE),
               device="cpu").load_weights(seed=0).prepare()


def test_load_weights_keywords_still_work():
    """The keyword callers of the seeded and carried-across forms."""
    a = Engine(EngineConfig(input_size=SIZE), device="cpu").load_weights(
        seed=3)
    b = Engine(EngineConfig(input_size=SIZE), device="cpu").load_weights(
        params=host(a.fp32_params))
    assert not a._weights_from_file and not b._weights_from_file
    assert_params_equal(host(a.fp32_params), host(b.fp32_params))


def test_load_weights_arguments_win_over_config_weights(files):
    """``params`` carried across take the place of ``config.weights``; a
    file given together with ``params`` or ``act_scales`` raises."""
    seeded = Engine(EngineConfig(input_size=SIZE), device="cpu"
                    ).load_weights(seed=3)
    eng = Engine(EngineConfig(input_size=SIZE, weights=files["yolov2-tiny"]),
                 device="cpu")
    eng.load_weights(params=host(seeded.fp32_params))
    assert not eng._weights_from_file
    assert_params_equal(host(eng.fp32_params), host(seeded.fp32_params))
    eng.load_weights()
    assert eng._weights_from_file
    with pytest.raises(ValueError, match="not both"):
        eng.load_weights(files["yolov2-tiny"],
                         params=host(seeded.fp32_params))
    with pytest.raises(ValueError, match="not both"):
        eng.load_weights(files["yolov2-tiny"], act_scales=[1.0] * 15)
