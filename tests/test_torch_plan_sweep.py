"""The port's plan sweep, strategy files and CLI against the JAX package.

``candidate_entries`` must equal the JAX function for every conv layer of
both models; ``load_strategy`` must read JAX-written artifacts (the
committed ``docs/SWEEP_*.json`` among them, read only) as the JAX one
does. The sweep itself runs here on the CPU at 64 px, batch 2, with
small loop counts: it exercises the greedy loop, the legality and parity
bookkeeping and the artifact, and says nothing about the card's choices.
"""

import glob
import json
import os

import numpy as np
import pytest
import threadpoolctl
import torch

from dnn_inference_engine_tpu.models import build_model as jbuild
from dnn_inference_engine_tpu.runtime import plan_sweep as jsweep

from dnn_inference_engine_tpu_torch import cli
from dnn_inference_engine_tpu_torch.config import EngineConfig
from dnn_inference_engine_tpu_torch.models import build_model
from dnn_inference_engine_tpu_torch.runtime import plan as tplan
from dnn_inference_engine_tpu_torch.runtime import plan_sweep as tsweep
from dnn_inference_engine_tpu_torch.runtime.engine import Engine

DOCS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "docs")
SWEEP_ARTIFACTS = sorted(os.path.basename(p) for p in
                         glob.glob(os.path.join(DOCS, "SWEEP_*.json")))
SMALL = dict(batch=2, input_size=64, iters=(4, 2), reps=1,
             auto_iters=False, verbose=False, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the sweeps run thousands of tiny ops: under ``-n 6`` a pool of
    # intra-op threads in every worker spins the host's cores
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(torch_threads)


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("mode", ["w8a8", "w8"])
@pytest.mark.parametrize("model", ["yolov2-tiny", "yolov3-tiny", "resnet18"])
def test_candidate_entries_match_jax(model, mode, quick):
    jm, tm = jbuild(model), build_model(model)
    convs = tsweep._conv_indices(tm)
    assert convs == jsweep._conv_indices(jm)
    for li in convs:
        assert (tsweep.candidate_entries(tm, li, mode, quick)
                == jsweep.candidate_entries(jm, li, mode, quick)), li
        assert tsweep._cand_name(tsweep.candidate_entries(tm, li, mode)[-1]) \
            == jsweep._cand_name(jsweep.candidate_entries(jm, li, mode)[-1])


def test_sweep_helpers_match_jax():
    for t in (1e-5, 3e-4, 2e-3, 0.05, 1.0):
        assert tsweep._iters_for(t) == jsweep._iters_for(t)
        assert tsweep._iters_for(t, (6, 2)) == jsweep._iters_for(t, (6, 2))
    strat = {4: ("fold_xla_k2", 2), 0: ("stem_rs", 4, {"cin_pad": 64}),
             2: ("rs", 2, {"s2d_out": True})}
    assert tsweep._strategy_jsonable(strat) == jsweep._strategy_jsonable(strat)


@pytest.mark.parametrize("name", SWEEP_ARTIFACTS)
def test_load_strategy_reads_committed_artifacts(name):
    path = os.path.join(DOCS, name)
    assert tsweep.load_strategy(path) == jsweep.load_strategy(path)


def test_load_strategy_reads_jax_written_artifact(tmp_path):
    """A JAX-written strategy (bare mapping, options included) gives the
    same mapping and the same plan in both packages."""
    strat = {0: ("fold_xla_k2", 4, {"cin_pad": 64}), 2: ("fold_xla_s2", 2),
             4: ("fold_xla_k2", 2), 6: ("rs2", 2),
             8: ("rs", 2, {"s2d_out": True}), 10: ("gemm", 1)}
    path = tmp_path / "s.json"
    path.write_text(json.dumps(jsweep._strategy_jsonable(strat)))
    got = tsweep.load_strategy(str(path))
    assert got == jsweep.load_strategy(str(path)) == strat
    from dnn_inference_engine_tpu.runtime.plan import build_plan
    want = build_plan(jbuild("yolov2-tiny"), got)
    tst = tplan.build_plan(build_model("yolov2-tiny"), got)
    assert [(s.kind, s.fold, s.k, s.s2d_out) for s in tst] == \
        [(s.kind, s.fold, s.k, s.s2d_out) for s in want]


@pytest.fixture(scope="module")
def quick_art():
    return tsweep.sweep("yolov2-tiny", "w8a8", quick=True, **SMALL)


def test_sweep_quick_cpu_and_engine_consumption(quick_art, tmp_path):
    """The tool runs end to end, the artifact has the keys of the JAX
    sweep's (its b8 artifact was written by the current JAX ``sweep``),
    and an Engine built from it runs its kinds stage by stage."""
    art = quick_art
    with open(os.path.join(DOCS, "SWEEP_yolov2_w8a8_b8.json")) as f:
        assert set(art) == set(json.load(f))
    assert art["backend"] == "cpu" and art["crashed_candidates"] == 0
    assert art["whole_net_ms"] >= 0 and art["passes"] >= 1
    assert set(art["strategy"]) == {"0", "2", "4", "6", "8", "10", "12",
                                    "13", "14"}
    for li, row in art["measurements"].items():
        assert any(v is not None for v in row.values()), (li, row)
        assert not any(isinstance(v, str) for v in row.values()), row
    path = tmp_path / "strategy.json"
    path.write_text(json.dumps(art))
    eng = Engine(EngineConfig(mode="w8a8", batch=2, input_size=64,
                              strategy=str(path)),
                 device="cpu").load_weights(seed=0)
    with pytest.warns(UserWarning, match="uniform noise"):
        eng.prepare()
    by_li = {st.conv_li: st for st in eng._plan}
    for li, entry in tsweep.load_strategy(str(path)).items():
        assert by_li[li].kind == {"rs2": "rs"}.get(entry[0], entry[0])
        assert by_li[li].fold == entry[1]
    b, s, c = eng.detect(np.random.default_rng(0).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    assert b.shape == (2, eng.config.max_detections, 4)


def test_sweep_full_candidates_cpu():
    """quick=False also measures gemm, rs, rs2 and the unpadded k2
    entry; fold_xla_s2 is null (illegal) until its consumer is
    fold_xla_k2 f=2. No candidate crashes or fails parity."""
    art = tsweep.sweep("yolov2-tiny", "w8a8", quick=False, **SMALL)
    assert art["crashed_candidates"] == 0
    row2 = art["measurements"]["2"]
    for name in ("gemm:1", "rs:2", "rs2:2", "fold_xla:2", "fold_xla_k2:2"):
        assert isinstance(row2[name], float), (name, row2)
    assert "fold_xla_k2:4" in art["measurements"]["0"]
    for row in art["measurements"].values():
        assert not any(isinstance(v, str) for v in row.values()), row


def test_sweep_records_candidate_crashes(monkeypatch):
    """A candidate whose kernel raises is recorded as 'CRASHED: ...', not
    null, and never chosen; the sweep completes."""
    def boom(*a, **kw):
        raise RuntimeError("deliberately broken stem kernel")

    monkeypatch.setattr(tplan, "stem_fused_k2", boom)
    art = tsweep.sweep("yolov2-tiny", "w8a8", quick=True, **SMALL)
    row0 = art["measurements"]["0"]
    crashed = [v for v in row0.values()
               if isinstance(v, str) and v.startswith("CRASHED")]
    assert crashed and "deliberately broken" in crashed[0]
    assert art["crashed_candidates"] >= 1
    assert art["strategy"]["0"][0] != "stem_rs"


def test_sweep_modes_and_inputs_that_raise(tmp_path):
    """fp32 has no plan; a weight file that is not there, and file weights
    without calibration images (the engine refuses the noise batch)."""
    with pytest.raises(ValueError, match="plan-sweep"):
        tsweep.sweep(mode="fp32", device="cpu")
    with pytest.raises(FileNotFoundError):
        tsweep.sweep(weights=str(tmp_path / "none.weights"), **SMALL)
    path = str(tmp_path / "w.pkl")
    from dnn_inference_engine_tpu_torch.models.weights import save_params
    eng = Engine(EngineConfig(input_size=64), device="cpu").load_weights(
        seed=1)
    save_params(eng.fp32_params, path)
    with pytest.raises(ValueError, match="needs real calibration images"):
        tsweep.sweep(weights=path, **SMALL)


def test_sweep_loads_weights_and_calib_images(tmp_path, capsys):
    """`plan-sweep --weights --calib-images`: the sweep's engine runs the
    file's weights with scales from the images, as an engine built from
    the same config calibrates them."""
    from dnn_inference_engine_tpu_torch.models.weights import save_params
    src = Engine(EngineConfig(input_size=64), device="cpu").load_weights(
        seed=1)
    wpath, cpath = str(tmp_path / "w.pkl"), str(tmp_path / "c.npy")
    save_params(src.fp32_params, wpath)
    np.save(cpath, np.random.default_rng(2).integers(
        0, 256, (3, 64, 64, 3)).astype(np.uint8))
    out = tmp_path / "s.json"
    assert cli.main(["plan-sweep", "--device", "cpu", "--mode", "w8a8",
                     "--batch", "2", "--input-size", "64", "--quick",
                     "--iters", "2,1", "--reps", "1", "--weights", wpath,
                     "--calib-images", cpath, "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["input_size"] == 64 and art["crashed_candidates"] == 0
    ctx = tsweep._SweepContext("yolov2-tiny", "w8a8", 2, 64, device="cpu",
                               weights=wpath, calib=cpath)
    ref = Engine(EngineConfig(mode="w8a8", batch=2, input_size=64,
                              weights=wpath, calib=cpath),
                 device="cpu").load_weights().prepare()
    assert ctx.eng.act_scales == ref.act_scales
    for a, b in zip(ctx.eng.params, ref.params):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_sweep_w8_runs_on_cpu():
    """The w8 sweep (bf16 plans): only the candidates JAX offers in w8,
    no int8 kernel kind in the result, and its engine runs the w8 plan.
    A fold_xla_k2:2 stage after a folded one raises, as in the JAX w8
    walker (docs/SWEEP_yolov2_w8_b1.json records it CRASHED too), so a
    candidate that makes that chain is recorded as crashed."""
    art = tsweep.sweep("yolov2-tiny", "w8", quick=True, **SMALL)
    assert art["mode"] == "w8" and art["backend"] == "cpu"
    int8_kinds = {"stem_rs", "stem_dg", "fold_xla_s2", "rs", "rs2", "s0"}
    for li, row in art["measurements"].items():
        names = {c.split(":")[0] for c in row}
        assert not names & int8_kinds, (li, row)
        for c, v in row.items():
            assert not isinstance(v, str) or (
                v.startswith("CRASHED") and "fold_xla_k2 reads the plain"
                in v), (li, c, v)
    assert not {e[0] for e in art["strategy"].values()} & int8_kinds


def test_cli_plan_sweep_writes_an_artifact_engine_consumes(tmp_path,
                                                          capsys):
    out = tmp_path / "s.json"
    assert cli.main(["plan-sweep", "--device", "cpu", "--mode", "w8a8",
                     "--batch", "2", "--input-size", "64", "--quick",
                     "--iters", "2,1", "--reps", "1", "--out",
                     str(out)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    art = json.loads(out.read_text())
    assert summary["strategy"] == art["strategy"]
    assert summary["device"] == "cpu" and art["input_size"] == 64
    eng = Engine(EngineConfig(mode="w8a8", batch=2, input_size=64,
                              strategy=str(out)),
                 device="cpu").load_weights(seed=0)
    with pytest.warns(UserWarning, match="uniform noise"):
        eng.prepare()
    assert [st.kind for st in eng._plan if st.kind != "pool"][0] == \
        art["strategy"]["0"][0]
    heads = eng.classify(np.zeros((2, 64, 64, 3), np.uint8))
    assert heads.shape == (2, 2, 2, 125) and np.isfinite(heads).all()


def test_cli_names_the_roadmap_item_of_other_commands(capsys):
    """No subcommand of the JAX CLI waits for a ROADMAP item any more: the
    bench (A8) was the last. The parser takes bench, trace and
    layer-times to their commands, and its help names no item."""
    for argv in (["bench", "--mode", "w8a8"],
                 ["trace", "--runs", "3", "--detect"],
                 ["layer-times", "--iters", "4,2"]):
        args = cli._parser().parse_args(argv)
        assert args.fn.__name__ == "cmd_" + argv[0].replace("-", "_")
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    assert "ROADMAP" not in capsys.readouterr().out


def test_engine_names_strategy_file_and_illegal_layer(tmp_path):
    """Where build_plan gives None both engines fall back to the generic
    kernel='auto' forward; the port warns, naming the file and the
    layer. The heads agree as the gemm tier's do: the JAX GEMM rounds the
    f32 head's acc*scale + bias once (an FMA), so within 2 ulps."""
    import jax
    from dnn_inference_engine_tpu.config import EngineConfig as JConfig
    from dnn_inference_engine_tpu.runtime.engine import Engine as JEngine
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"2": ["fold_xla_s2", 2], "4": ["xla", 1]}))
    kw = dict(mode="w8a8", batch=1, input_size=64, strategy=str(path))
    calib = np.random.default_rng(11).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32)
    jeng = JEngine(JConfig(**kw)).load_weights(
        key=jax.random.PRNGKey(0)).prepare(calib)
    eng = Engine(EngineConfig(**kw), device="cpu").load_weights(
        params=jax.tree.map(np.asarray, jeng.params),
        act_scales=jeng.act_scales)
    with pytest.warns(UserWarning, match="bad.json.*layer 2.*generic"):
        eng.prepare()
    assert eng._plan is None and jeng._plan is None
    imgs = np.random.default_rng(12).integers(
        0, 256, (1, 64, 64, 3)).astype(np.uint8)
    want = np.asarray(jeng.classify(imgs))
    np.testing.assert_allclose(eng.classify(imgs), want, rtol=0,
                               atol=2 * np.spacing(np.abs(want).max()))
