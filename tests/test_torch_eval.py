"""The port's VOC evaluation and goldens against the JAX package's.

``voc_eval``/``voc_map`` (a numpy copy) on synthetic detections: within
1e-12. ``parse_voc_xml``: equal. ``evaluate_voc`` over a VOC tree written
here (JPEGs, XML, the split list) with YOLOv2-tiny W8A8 at 64 px, the
JAX engine's weights and scales carried across: mAP within 1e-6 of the
JAX one's (the detections differ only by the JAX jit's FMA rounding of
the f32 head). Goldens: the port's per-layer fp32 outputs against JAX's
dump within rtol/atol 1e-4 (the JAX CLI's ``check-goldens`` tolerance).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu.config import EngineConfig as JConfig
from dnn_inference_engine_tpu.eval import golden as jgolden
from dnn_inference_engine_tpu.eval import voc as jvoc
from dnn_inference_engine_tpu.eval import voc_dataset as jvd
from dnn_inference_engine_tpu.models import build_model as jbuild
from dnn_inference_engine_tpu.runtime.engine import Engine as JEngine

from dnn_inference_engine_tpu_torch.config import (
    SCORE_THRESH_EVAL, VOC_CLASSES, EngineConfig)
from dnn_inference_engine_tpu_torch.eval import golden as tgolden
from dnn_inference_engine_tpu_torch.eval import voc as tvoc
from dnn_inference_engine_tpu_torch.eval import voc_dataset as tvd
from dnn_inference_engine_tpu_torch.models import build_model
from dnn_inference_engine_tpu_torch.models.weights import params_from_numpy
from dnn_inference_engine_tpu_torch.runtime.engine import Engine

SIZE = 64

XML = """<annotation><filename>{name}.jpg</filename>{objects}</annotation>"""
OBJ = """<object><name>{cls}</name><difficult>{diff}</difficult>
<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax>
</bndbox></object>"""


def _synthetic(seed, n_img=6, n_det=30, n_gt=5, classes=4):
    """Detections and ground truth near each other, with difficult boxes,
    images without ground truth and classes without detections."""
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for i in range(n_img):
        g = rng.integers(0, n_gt + 1)
        xy = rng.uniform(0, 200, (g, 2))
        gb = np.concatenate([xy, xy + rng.uniform(20, 80, (g, 2))], 1)
        gc = rng.integers(0, classes, g)
        gts.append({"boxes": gb.astype(np.float32), "classes": gc,
                    "difficult": rng.uniform(0, 1, g) < 0.2})
        src = rng.integers(0, max(g, 1), n_det)
        jitter = rng.normal(0, 8, (n_det, 4))
        db = (gb[src] + jitter) if g else rng.uniform(0, 250, (n_det, 4))
        dets.append({"boxes": db.astype(np.float32),
                     "scores": rng.uniform(0, 1, n_det).astype(np.float32),
                     "classes": gc[src] if g else
                     rng.integers(0, classes, n_det)})
    return dets, gts


@pytest.mark.parametrize("use_07", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_voc_map_matches_jax(seed, use_07):
    dets, gts = _synthetic(seed)
    got_m, got = tvoc.voc_map(dets, gts, 20, use_07_metric=use_07)
    want_m, want = jvoc.voc_map(dets, gts, 20, use_07_metric=use_07)
    assert abs(got_m - want_m) <= 1e-12 and 0 < got_m < 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for c in range(4):
        assert abs(tvoc.voc_eval(dets, gts, c, 0.7, use_07)
                   - jvoc.voc_eval(dets, gts, c, 0.7, use_07)) <= 1e-12


def test_voc_helpers_match_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 100, (7, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b = a[::-1] + 3
    np.testing.assert_array_equal(tvoc._iou_matrix(a, b),
                                  jvoc._iou_matrix(a, b))
    assert tvoc._iou_matrix(a[:0], b).shape == (0, 7)
    rec = np.sort(rng.uniform(0, 1, 20))
    prec = rng.uniform(0, 1, 20)
    for m07 in (False, True):
        assert tvoc._average_precision(rec, prec, m07) == \
            jvoc._average_precision(rec, prec, m07)
    assert tvoc.voc_map([], [], 20) == (0.0, [0.0] * 20)


def _write_voc(root, images, gts):
    """A VOCdevkit tree: JPEGs, XML annotations and the test split."""
    from PIL import Image
    base = root / "VOC2007"
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        os.makedirs(base / d, exist_ok=True)
    ids = []
    for i, (img, objs) in enumerate(zip(images, gts)):
        name = f"{i:06d}"
        ids.append(name)
        Image.fromarray(img).save(base / "JPEGImages" / f"{name}.jpg")
        xml = "".join(OBJ.format(cls=c, diff=int(d), x1=b[0], y1=b[1],
                                 x2=b[2], y2=b[3]) for c, d, b in objs)
        (base / "Annotations" / f"{name}.xml").write_text(
            XML.format(name=name, objects=xml))
    (base / "ImageSets" / "Main" / "test.txt").write_text("\n".join(ids))
    return str(root)


def test_parse_voc_xml_matches_jax(tmp_path):
    img = np.zeros((30, 40, 3), np.uint8)
    objs = [("dog", False, (10, 20, 30, 28)), ("car", True, (1, 2, 3, 4)),
            ("unicorn", False, (5, 5, 9, 9)), ("person", False,
                                               (0.5, 1.5, 20, 25))]
    voc = _write_voc(tmp_path, [img], [objs])
    items = tvd.voc_image_list(voc, "2007_test")
    assert items == jvd.voc_image_list(voc, "2007_test")
    got, want = tvd.parse_voc_xml(items[0][2]), jvd.parse_voc_xml(
        items[0][2])
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["classes"].tolist() == [11, 6, 14]


@pytest.fixture(scope="module")
def engines():
    kw = dict(mode="w8a8", batch=2, input_size=SIZE)
    calib = np.random.default_rng(11).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    jeng = JEngine(JConfig(**kw)).load_weights(
        key=jax.random.PRNGKey(0)).prepare(calib)
    teng = Engine(EngineConfig(**kw), device="cpu").load_weights(
        params=jax.tree.map(np.asarray, jeng.params),
        act_scales=jeng.act_scales).prepare()
    return jeng, teng


def test_evaluate_voc_matches_jax(engines, tmp_path):
    """Ground truth made from the JAX engine's own eval-grade detections
    (some kept, some moved, some marked difficult, one class swapped), so
    that the mAP is neither 0 nor 1."""
    from dnn_inference_engine_tpu.preprocess import (
        boxes_to_original, preprocess_image)
    jeng, teng = engines
    rng = np.random.default_rng(15)
    images = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
              for h, w in [(80, 100), (64, 64), (90, 70), (75, 120),
                           (64, 96)]]
    voc = _write_voc(tmp_path, images, [[] for _ in images])
    items = jvd.voc_image_list(voc)
    jeng.config.score_thresh = SCORE_THRESH_EVAL
    try:
        gts = []
        for _id, jpg, _xml in items:
            from dnn_inference_engine_tpu.preprocess import load_image
            x, meta = preprocess_image(load_image(jpg), SIZE)
            b, s, c = (np.asarray(t)[0] for t in jeng.detect(
                np.stack([x, x])))
            keep = np.flatnonzero(s > 0)[:6]
            ob = boxes_to_original(b[keep], meta)
            objs = []
            for j, (box, cls) in enumerate(zip(ob, c[keep])):
                if j % 3 == 1:
                    box = box + rng.uniform(-6, 6, 4)
                if j == 4:
                    cls = (cls + 1) % 20
                objs.append((VOC_CLASSES[cls], j == 5, box.round(1)))
            gts.append(objs)
    finally:
        jeng.config.score_thresh = JConfig().score_thresh
        jeng._detect_fn = None
    voc = _write_voc(tmp_path, images, gts)
    thresh = teng.config.score_thresh
    got = tvd.evaluate_voc(teng, voc)
    want = jvd.evaluate_voc(jeng, voc)
    assert teng.config.score_thresh == thresh
    assert got["images"] == want["images"] == 5 and got["mode"] == "w8a8"
    assert abs(got["mAP@0.5"] - want["mAP@0.5"]) <= 1e-6
    assert 0 < got["mAP@0.5"] < 1
    np.testing.assert_allclose(list(got["per_class"].values()),
                               list(want["per_class"].values()), atol=1e-6,
                               rtol=0)
    assert abs(tvd.evaluate_voc(teng, voc, limit=3, use_07_metric=False)
               ["mAP@0.5"] - jvd.evaluate_voc(
                   jeng, voc, limit=3, use_07_metric=False)["mAP@0.5"]
               ) <= 1e-6


def test_evaluate_voc_restores_threshold_on_error(engines, tmp_path):
    _, teng = engines
    with pytest.raises(FileNotFoundError):
        tvd.evaluate_voc(teng, str(tmp_path / "missing"))
    assert teng.config.score_thresh == EngineConfig().score_thresh


@pytest.mark.parametrize("model", ["yolov2-tiny", "yolov3-tiny"])
def test_goldens_match_jax_dump(tmp_path, model):
    """JAX dumps; the port's fp32 forward (JAX's weights) is held to the
    dump per layer, and its own dump equals the JAX one within the same
    tolerance."""
    jm = jbuild(model)
    params = jm.init_params(jax.random.PRNGKey(1))
    x = np.random.default_rng(16).uniform(0, 1, (1, SIZE, SIZE, 3)).astype(
        np.float32)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jgolden.dump_goldens(jm, params, jnp.asarray(x), jpath)
    tm = build_model(model)
    tp, _ = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    out, layer_outs = tgolden.dump_goldens(tm, tp, torch.from_numpy(x),
                                           tpath)
    assert len(layer_outs) == len(tm.layers)
    jg, tg = jgolden.load_goldens(jpath), tgolden.load_goldens(tpath)
    assert sorted(jg) == sorted(tg) == list(range(len(tm.layers)))
    report = tgolden.compare_goldens(layer_outs, jg, rtol=1e-4, atol=1e-4)
    assert max(report.values()) <= 1e-3
    jgolden.compare_goldens([tg[i] for i in range(len(tg))], jg, rtol=1e-4,
                            atol=1e-4)
    with np.load(tpath) as z:
        np.testing.assert_array_equal(z["input"], x)
    heads = out if isinstance(out, tuple) else (out,)
    for h, li in zip(heads, tm.out_layers or [len(tm.layers) - 1]):
        np.testing.assert_array_equal(h.numpy(), tg[li])


def test_golden_reports_match_jax(engines):
    """The w8a8 per-layer outputs (capture_outputs) against the fp32
    dump: both packages' relative RMS reports agree, and a mismatch
    raises."""
    jeng, teng = engines
    x = np.random.default_rng(17).uniform(0, 1, (1, SIZE, SIZE, 3)).astype(
        np.float32)
    _, jf = jeng.model.forward_fp32(jeng.fp32_params, jnp.asarray(x),
                                    capture_outputs=True)
    goldens = {i: np.asarray(t) for i, t in enumerate(jf)}
    _, jq = jeng.model.forward(jeng.params, jnp.asarray(x), mode="w8a8",
                               act_scales=jeng.act_scales,
                               capture_outputs=True)
    _, tq = teng.model.forward(teng.params, torch.from_numpy(x),
                               mode="w8a8", act_scales=teng.act_scales,
                               capture_outputs=True)
    assert len(tq) == len(jq)
    for a, b in zip(tq, jq):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = tgolden.quant_error_report(tq, goldens)
    assert got == jgolden.quant_error_report(jq, goldens)
    assert 0 < max(got.values()) < 0.5
    with pytest.raises(AssertionError, match="layer 0 mismatch"):
        tgolden.compare_goldens(tq, goldens)
