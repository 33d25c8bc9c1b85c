"""The port's CLI against the JAX package's, on the CPU at 64 px.

Every file is written here from a seed: a pickle of seeded fp32 weights,
PNG and JPEG images, a config file (``input_size`` 64, written by the
port and read by both), a VOC tree. ``calibrate`` gives scales within 32
float32 ulps of the JAX CLI's; ``detect`` prints the JAX CLI's detection
lines (fp32 from the pickle, W8A8 from either package's checkpoint);
``eval`` its mAP within 1e-6; ``dump-goldens`` its layers within 1e-4
and ``check-goldens`` its report; ``serve`` answers a ``.npy`` POST with
the detections of a direct detect. The subcommands that wait for a
ROADMAP item are refused naming it; the mesh flags reach the config of
every subcommand that builds an engine, ``detect`` under torchrun on a
(1, 2) channel mesh prints the single-device lines, and ``serve
--num-processes 2`` answers HTTP from the leader and stops its
follower.

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
    (["bench", "--mode", "w8a8"], "A8")])
def test_refusals_name_the_roadmap_item(capsys, argv, item):
    with pytest.raises(SystemExit):
        cli.main(argv)
    assert f"ROADMAP item {item}" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["detect", "--image", "x.png"], ["eval", "--voc-dir", "v"],
    ["serve"], ["calibrate", "--images", "d", "--out", "c.npz"],
    ["dump-goldens", "--out", "g.npz"], ["check-goldens", "--goldens", "g"]])
@pytest.mark.parametrize("mesh,sharding", [("2,2", "channel"),
                                           ("2,1", "replicated")])
def test_mesh_flags_reach_the_config(argv, mesh, sharding):
    """--mesh and --sharding on every subcommand that builds an engine,
    as the JAX CLI's ``_build_engine`` applies them."""
    args = cli._parser().parse_args(argv + ["--mesh", mesh, "--sharding",
                                            sharding])
    cfg = cli._config(args)
    assert cfg.mesh_shape == tuple(int(v) for v in mesh.split(","))
    assert cfg.sharding == sharding


@pytest.mark.parametrize("argv,msg", [
    (["serve", "--num-processes", "2"], "needs a --mesh of 2 ranks"),
    (["serve", "--num-processes", "4", "--mesh", "1,2"],
     "needs a --mesh of 4 ranks"),
    (["detect", "--image", "x.png", "--mesh", "2"], "give DP,MP")])
def test_process_flags_must_match_the_mesh(capsys, argv, msg):
    with pytest.raises(SystemExit):
        cli.main(argv)
    assert msg in capsys.readouterr().err


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cli_env():
    import os
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.mark.subproc
def test_torchrun_detect_on_a_mesh_prints_the_single_device_lines(
        files, capsys):
    """``torchrun --nproc-per-node 2 -m ...cli detect --mesh 1,2
    --sharding channel`` over gloo on the CPU: rank 0 prints the
    single-device CLI's detection lines, rank 1 nothing."""
    import subprocess
    import sys
    common = ["detect", "--device", "cpu", "--mode", "w8a8", "--weights",
              files["t_ckpt"], "--config", files["cfg"], "--image",
              files["img"], "--score-thresh", "0.02"]
    assert cli.main(common) == 0
    want = [ln for ln in _lines(capsys) if not ln.startswith("#")]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), "-m",
         "dnn_inference_engine_tpu_torch.cli", *common, "--mesh", "1,2",
         "--sharding", "channel", "--backend", "gloo"],
        capture_output=True, text=True, timeout=180, env=_cli_env())
    assert out.returncode == 0, out.stderr[-3000:]
    got = [ln for ln in out.stdout.strip().splitlines()
           if not ln.startswith("#")]
    assert want and got == want


@pytest.mark.subproc
def test_serve_num_processes_answers_http_and_stops_the_follower(files):
    """``serve --num-processes 2 --process-id P --coordinator ...``: rank
    0 serves HTTP, rank 1 mirrors its steps; a ``.npy`` POST answers the
    single-device engine's detections, and on SIGINT the leader stops and
    the follower exits 0 after the shutdown header."""
    import signal
    import subprocess
    import sys
    import time
    from dnn_inference_engine_tpu_torch.preprocess import (
        boxes_to_original, preprocess_image)
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    port, coord = _free_port(), f"127.0.0.1:{_free_port()}"
    args = ["serve", "--device", "cpu", "--mode", "w8a8", "--weights",
            files["t_ckpt"], "--config", files["cfg"], "--score-thresh",
            "0.02", "--mesh", "1,2", "--sharding", "channel", "--port",
            str(port), "--num-processes", "2", "--coordinator", coord,
            "--backend", "gloo"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dnn_inference_engine_tpu_torch.cli", *args,
         "--process-id", str(r)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_cli_env())
        for r in range(2)]
    try:
        img = np.random.default_rng(5).integers(0, 256, (64, 64, 3)).astype(
            np.uint8)
        buf = io.BytesIO()
        np.save(buf, img)
        deadline, out = time.time() + 120, None
        while out is None:
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/detect", data=buf.getvalue(),
                    method="POST")
                with urllib.request.urlopen(req, timeout=60) as r:
                    out = json.loads(r.read())
            except OSError:
                assert time.time() < deadline and all(
                    p.poll() is None for p in procs)
                time.sleep(0.5)
        procs[0].send_signal(signal.SIGINT)
        res = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], res
    assert "follower exiting after 1 batches" in res[1][0], res[1]
    cfg = EngineConfig.from_json(files["cfg"])
    cfg.mode, cfg.weights, cfg.score_thresh = "w8a8", files["t_ckpt"], 0.02
    eng = Engine(cfg, device="cpu").load_weights().prepare()
    x, meta = preprocess_image(img, 64)
    pad = np.zeros((cfg.serve_max_batch, 64, 64, 3), np.uint8)
    pad[0] = np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)
    b, s, c = (t[0] for t in eng.detect(pad))
    keep = s > 0
    assert out["boxes"] == boxes_to_original(b[keep], meta).tolist()
    assert out["scores"] == s[keep].tolist()
    assert out["classes"] == c[keep].tolist()


@pytest.mark.parametrize("argv", [["frobnicate"], ["detect"],
                                  ["calibrate", "--images", "d"]])
def test_unknown_subcommand_and_missing_args(argv):
    with pytest.raises(SystemExit):
        cli.main(argv)
