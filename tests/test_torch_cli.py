"""The port's CLI against the JAX package's, on the CPU at 64 px.

Every file is written here from a seed: a pickle of seeded fp32 weights,
PNG and JPEG images, a config file (``input_size`` 64, written by the
port and read by both), a VOC tree. ``calibrate`` gives scales within 32
float32 ulps of the JAX CLI's; ``detect`` prints the JAX CLI's detection
lines (fp32 from the pickle, W8A8 from either package's checkpoint);
``eval`` its mAP within 1e-6; ``dump-goldens`` its layers within 1e-4
and ``check-goldens`` its report; ``serve`` answers a ``.npy`` POST with
the detections of a direct detect. The subcommands that wait for a
ROADMAP item, and multi-device flags, are refused naming it.

In W8A8 the JAX CLI runs with ``jax.jit`` taken out of its engine's
detect (``op_by_op``): jitted, XLA contracts an epilogue's
``acc*scale + bias`` into one FMA and flips int8 codes on these images
(ROADMAP section C, "FMA contraction"), and the port is held to the JAX
plan run op by op, as everywhere (tests/test_torch_engine.py).
"""

import io
import json
import urllib.request

import jax
import numpy as np
import pytest

from dnn_inference_engine_tpu import cli as jcli
from dnn_inference_engine_tpu.models import build_model as jbuild
from dnn_inference_engine_tpu.models import weights as jw

from dnn_inference_engine_tpu_torch import cli
from dnn_inference_engine_tpu_torch.config import EngineConfig

ULPS = 32
F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp("cli")
    out = {"dir": d}
    out["cfg"] = str(d / "cfg.json")
    EngineConfig(input_size=64).to_json(out["cfg"])
    out["pkl"] = str(d / "w.pkl")
    params = jbuild("yolov2-tiny").init_params(jax.random.PRNGKey(2))
    jw.save_params(params, out["pkl"])
    rng = np.random.default_rng(0)
    (d / "calib").mkdir()
    for i, (h, w) in enumerate([(70, 90), (64, 64), (100, 80)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
                        ).save(d / "calib" / f"{i}.png")
    out["img"] = str(d / "img.png")
    Image.fromarray(rng.integers(0, 256, (100, 120, 3)).astype(np.uint8)
                    ).save(out["img"])
    # the JAX CLI calibrates file weights only with --calib-images too
    # (its engine is prepared before --images are read)
    common = ["--mode", "w8a8", "--weights", out["pkl"], "--config",
              out["cfg"], "--images", str(d / "calib"), "--calib-images",
              str(d / "calib")]
    out["t_ckpt"], out["j_ckpt"] = str(d / "t.npz"), str(d / "j.npz")
    assert cli.main(["calibrate", *common, "--out", out["t_ckpt"],
                     "--device", "cpu"]) == 0
    jcli.main(["calibrate", *common, "--out", out["j_ckpt"]])
    return out


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


@pytest.fixture
def op_by_op(monkeypatch):
    """The JAX engine's detect and forward run op by op: ``jax.jit`` of a
    function at call time returns the function (functions jitted at
    import, the NMS among them, stay jitted)."""
    monkeypatch.setattr(jax, "jit", lambda f=None, **kw: f)


def test_calibrate_matches_jax(files, capsys):
    ts, js = (jw.load_checkpoint(files[k])[1] for k in ("t_ckpt", "j_ckpt"))
    assert len(ts) == len(js) == 16
    np.testing.assert_allclose(ts, js, rtol=ULPS * F32_EPS, atol=0)
    tp, jp = (jw.load_checkpoint(files[k])[0] for k in ("t_ckpt", "j_ckpt"))
    for a, b in zip(tp, jp):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("ckpt", ["j_ckpt", "t_ckpt", "pkl"])
def test_detect_prints_the_jax_detections(request, files, tmp_path, capsys,
                                          ckpt):
    mode = "fp32" if ckpt == "pkl" else "w8a8"
    args = ["detect", "--mode", mode, "--weights", files[ckpt],
            "--config", files["cfg"], "--image", files["img"],
            "--score-thresh", "0.02"]
    assert cli.main(args + ["--out", str(tmp_path / "t.png"), "--device",
                            "cpu"]) == 0
    got = _lines(capsys)
    if mode == "w8a8":
        request.getfixturevalue("op_by_op")
    jcli.main(args + ["--out", str(tmp_path / "j.png")])
    want = _lines(capsys)
    assert got[:-2] == want[:-2] and len(got) > 2
    n = lambda lines: lines[-2].split(" detections")[0]   # noqa: E731
    assert n(got) == n(want) == f"# {len(got) - 2}"
    assert got[-1] == f"# wrote {tmp_path / 't.png'}"
    from PIL import Image
    with Image.open(tmp_path / "t.png") as im:
        assert im.size == (120, 100)


def test_eval_matches_jax(files, tmp_path, capsys, op_by_op):
    from PIL import Image
    base = tmp_path / "VOC2007"
    for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (base / sub).mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (80, 96, 3)).astype(np.uint8)
                        ).save(base / "JPEGImages" / f"{i}.jpg")
        (base / "Annotations" / f"{i}.xml").write_text(
            "<annotation><object><name>dog</name><difficult>0</difficult>"
            f"<bndbox><xmin>{5 + i}</xmin><ymin>10</ymin><xmax>60</xmax>"
            "<ymax>70</ymax></bndbox></object></annotation>")
    (base / "ImageSets/Main/test.txt").write_text("0\n1\n2\n")
    args = ["eval", "--mode", "w8a8", "--weights", files["j_ckpt"],
            "--config", files["cfg"], "--voc-dir", str(tmp_path)]
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    jcli.main(args)
    want = json.loads(capsys.readouterr().out)
    assert got["images"] == want["images"] == 3
    assert abs(got["mAP@0.5"] - want["mAP@0.5"]) <= 1e-6
    assert sorted(got["per_class"]) == sorted(want["per_class"])


def test_goldens_match_jax(files, tmp_path, capsys):
    common = ["--weights", files["pkl"], "--config", files["cfg"]]
    tg, jg = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    assert cli.main(["dump-goldens", *common, "--seed", "4", "--out", tg,
                     "--device", "cpu"]) == 0
    assert _lines(capsys) == [f"# dumped 15 layer goldens -> {tg}"]
    jcli.main(["dump-goldens", *common, "--seed", "4", "--out", jg])
    capsys.readouterr()
    with np.load(tg) as t, np.load(jg) as j:
        assert sorted(t.files) == sorted(j.files)
        np.testing.assert_array_equal(t["input"], j["input"])
        for k in t.files:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-4)
    # fp32 against the JAX dump, then the checkpoint's w8a8 report
    assert cli.main(["check-goldens", *common, "--goldens", jg,
                     "--device", "cpu"]) == 0
    got = _lines(capsys)
    assert got[0] == "# exact comparison passed; per-layer max abs diff:"
    assert len(got) == 16
    q = ["check-goldens", "--mode", "w8a8", "--weights", files["j_ckpt"],
         "--config", files["cfg"], "--goldens", jg, "--tol", "10"]
    assert cli.main(q + ["--device", "cpu"]) == 0
    got = _lines(capsys)
    assert jcli.main(q) == 0
    assert got == _lines(capsys)
    assert cli.main(q[:-1] + ["0.0001", "--device", "cpu"]) == 1
    assert _lines(capsys)[-1].startswith("# FAIL: worst layer error")


def test_serve_answers_a_npy_post(files, monkeypatch, capsys):
    """`serve` until interrupted: one .npy POST and /stats while it
    sleeps, then Ctrl-C stops the server and the batcher."""
    from dnn_inference_engine_tpu_torch.preprocess import (
        boxes_to_original, preprocess_image)
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    img = np.random.default_rng(5).integers(0, 256, (64, 64, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    np.save(buf, img)
    seen = {}

    def sleep(_s):
        line = capsys.readouterr().out
        port = int(line.split(" on :")[1].split(" ")[0])
        base = f"http://127.0.0.1:{port}"
        req = urllib.request.Request(base + "/detect", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            seen["detect"] = json.loads(r.read())
        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            seen["stats"] = json.loads(r.read())
        raise KeyboardInterrupt

    monkeypatch.setattr(cli.time, "sleep", sleep)
    args = ["serve", "--mode", "w8a8", "--weights", files["j_ckpt"],
            "--config", files["cfg"], "--port", "0", "--score-thresh",
            "0.02", "--device", "cpu"]
    assert cli.main(args) == 0
    assert seen["stats"]["images"] == 1 and seen["stats"][
        "avg_batch_fill"] == 1
    cfg = EngineConfig.from_json(files["cfg"])
    cfg.mode, cfg.weights, cfg.score_thresh = "w8a8", files["j_ckpt"], 0.02
    eng = Engine(cfg, device="cpu").load_weights().prepare()
    x, meta = preprocess_image(img, 64)
    pad = np.zeros((32, 64, 64, 3), np.uint8)
    pad[0] = np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)
    b, s, c = (t[0] for t in eng.detect(pad))
    keep = s > 0
    assert seen["detect"]["boxes"] == boxes_to_original(b[keep],
                                                        meta).tolist()
    assert seen["detect"]["scores"] == s[keep].tolist()
    assert seen["detect"]["classes"] == c[keep].tolist()


@pytest.mark.parametrize("argv,item", [
    (["bench", "--mode", "w8a8"], "A8"),
    (["layer-times"], "A13"),
    (["trace", "--detect"], "A13"),
    (["detect", "--image", "x.png", "--mesh", "2,2"], "A14"),
    (["detect", "--image", "x.png", "--sharding", "channel"], "A14"),
    (["serve", "--num-processes", "2"], "A14")])
def test_refusals_name_the_roadmap_item(capsys, argv, item):
    with pytest.raises(SystemExit):
        cli.main(argv)
    assert f"ROADMAP item {item}" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["frobnicate"], ["detect"],
                                  ["calibrate", "--images", "d"]])
def test_unknown_subcommand_and_missing_args(argv):
    with pytest.raises(SystemExit):
        cli.main(argv)
