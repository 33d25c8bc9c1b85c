"""The port's profiling surface against the JAX package, on the CPU.

``stage_flops`` and ``_conv_flops`` are arithmetic and must equal the JAX
functions for every plan the port builds. The scopes the port opens (the
plans' stages, the generic forwards' convs, the decode and the NMS) are
collected from a CPU ``torch.profiler`` trace and must equal the scopes
the JAX package opens for the same stages and layers, read from the name
stacks of its functions as lowered. ``wall_time``, ``roofline_pct`` and
``binding_bound_s`` keep the JAX functions' contracts. ``Engine.stage_times``
at 64 px, batch 2, must give JAX's rows, work and traffic for the same
plan and weights; only the port's timing runs (the JAX side's loop
timing is replaced by a constant: its numbers are not compared, and each
of its stages would compile two loops). The attribution of device time
to scopes is held on hand-made profiler records: the device timeline
exists only on the card, where ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` take real traces.
"""

import contextlib
import functools
import glob
import json
import re
import time
import types

import jax
import numpy as np
import pytest
import threadpoolctl
import torch
from torch.profiler import ProfilerActivity, profile

from dnn_inference_engine_tpu import cli as jcli
from dnn_inference_engine_tpu.config import EngineConfig as JConfig
from dnn_inference_engine_tpu.models import build_model as jbuild
from dnn_inference_engine_tpu.parallel import sharding as jsharding
from dnn_inference_engine_tpu.runtime import benchlib as jbenchlib
from dnn_inference_engine_tpu.runtime import plan as jplan
from dnn_inference_engine_tpu.runtime.engine import Engine as JEngine

from dnn_inference_engine_tpu_torch import cli
from dnn_inference_engine_tpu_torch.config import EngineConfig
from dnn_inference_engine_tpu_torch.models import build_model
from dnn_inference_engine_tpu_torch.runtime import benchlib
from dnn_inference_engine_tpu_torch.runtime import plan as tplan
from dnn_inference_engine_tpu_torch.runtime import profiling as prof
from dnn_inference_engine_tpu_torch.runtime.engine import Engine

MODELS = ("yolov2-tiny", "yolov3-tiny", "resnet18")
# the plans the port builds: the YOLOv2 pins, the strategy files S1-S3 of
# chip_smoke.py, the YOLOv3 pin and ResNet-18's all-xla plan
PLANS = {
    "v2 b32": ("yolov2-tiny", None, 32),
    "v2 b8": ("yolov2-tiny", None, 8),
    "v2 b1": ("yolov2-tiny", None, 1),
    "S1": ("yolov2-tiny", {0: ("fold_xla_k2", 4, {"cin_pad": 64}),
                           2: ("fold_xla_s2", 2), 4: ("fold_xla_k2", 2),
                           6: ("rs2", 2), 8: ("rs", 2), 10: ("gemm", 1),
                           12: ("auto", 1), 13: ("auto", 1),
                           14: ("xla", 1)}, 32),
    "S2": ("yolov2-tiny", {0: ("fold_xla", 4, {"cin_pad": 64}),
                           2: ("rs", 2), 4: ("rs2", 2), 6: ("auto", 1),
                           8: ("auto", 1), 10: ("xla", 1), 12: ("gemm", 1),
                           13: ("xla", 1), 14: ("gemm", 1)}, 32),
    "S3": ("yolov2-tiny", {**jplan._YOLOV2_STRATEGY, 0: ("s0", 4)}, 32),
    "v3 b16": ("yolov3-tiny", None, 16),
    "resnet18 b32": ("resnet18", None, 32),
}
STAGE_FIELDS = {"name", "ms", "gop", "gop_exec", "mfu_pct", "hw_util_pct",
                "hbm_mb", "binding", "pct_of_binding"}
POST_SCOPES = ("post_decode", "nms_candidates", "nms_suppress", "nms_merge")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # many tiny ops and products: under ``-n 6`` a pool of threads in
    # every worker spins the host's cores (ROADMAP C5)
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(torch_threads)


@functools.lru_cache(maxsize=None)
def _jax_engine(model, mode, batch, kernel="auto"):
    """The JAX package's engine for the same config at 64 px."""
    jeng = JEngine(JConfig(**_config(model, mode=mode, batch=batch,
                                     kernel=kernel))).load_weights(
        key=jax.random.PRNGKey(0))
    if mode != "w8a8":
        return jeng.prepare()
    return jeng.prepare(np.random.default_rng(3).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))


def _jax_scopes(jfn, jeng, batch, pattern):
    """The scopes the JAX package itself opens in ``jfn`` (a jitted
    function of the engine's params and its bench batch) whose names
    match ``pattern``: read from the name stacks of ``jfn`` as lowered
    (its debug locations: ``.../scope/op``, ``vmap(scope)/op`` under a
    vmap), by the stage or layer number in the name."""
    x = jeng._bench_input(batch)
    text = jfn.lower(jeng.exec_params, x).as_text(debug_info=True)
    names = set(re.findall(rf"(?<=[/(])(?:{pattern})(?=[/)])", text))
    assert names, "the JAX function opens no such scope"
    return sorted(names, key=_scope_index)


def _scope_index(name):
    """The stage or layer number of a scope's name (0 where it has none)."""
    m = re.search(r"(?:stage|^L)(\d+)", name)
    return int(m.group(1)) if m else 0


def _scopes(fn, pattern):
    """Names of the ranges ``fn()`` opens under a CPU profiler that match
    ``pattern``, in order."""
    with profile(activities=[ProfilerActivity.CPU]) as p:
        fn()
    evs = sorted((e for e in p.events() if re.fullmatch(pattern, e.name)),
                 key=lambda e: e.time_range.start)
    return [e.name for e in evs]


def _config(model, **kw):
    extra = dict(num_classes=10) if model == "resnet18" else {}
    return dict(model=model, input_size=64, **extra, **kw)


def _engine(model, mode, batch, kernel="auto"):
    eng = Engine(EngineConfig(**_config(model, mode=mode, batch=batch,
                                        kernel=kernel)), device="cpu")
    with (pytest.warns(UserWarning, match="uniform noise")
          if mode == "w8a8" else contextlib.nullcontext()):
        return eng.load_weights(seed=0).prepare()


# ---------------------------------------------------------------------------
# work per stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [64, 224, 416])
@pytest.mark.parametrize("plan", list(PLANS))
def test_stage_flops_match_jax(plan, size):
    model, strategy, batch = PLANS[plan]
    jm, tm = jbuild(model), build_model(model)
    jst = jplan.build_plan(jm, strategy, batch=batch)
    tst = tplan.build_plan(tm, strategy, batch=batch)
    assert [s.kind for s in tst] == [s.kind for s in jst]
    got = tplan.stage_flops(tm, tst, input_size=size)
    assert got == jplan.stage_flops(jm, jst, input_size=size)
    assert all(e >= u >= 0 for u, e in got)


@pytest.mark.parametrize("size", [None, 64, 416])
@pytest.mark.parametrize("model", MODELS)
def test_conv_flops_match_jax(model, size):
    got = tplan._conv_flops(build_model(model), size)
    assert got == jsharding._conv_flops(jbuild(model), size)
    assert got and all(v > 0 for v in got.values())


# ---------------------------------------------------------------------------
# scope names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,mode,batch", [
    ("yolov2-tiny", "w8a8", 2), ("yolov2-tiny", "w8a8", 1),
    ("yolov3-tiny", "w8a8", 2), ("resnet18", "w8a8", 2),
    ("yolov2-tiny", "w8", 1), ("yolov3-tiny", "w8", 2)])
def test_stage_scopes_are_jax_names(model, mode, batch):
    """The plan forward opens one scope a stage, in order, named as the
    JAX plan forward names its stages (``w8stage...`` in w8)."""
    eng = _engine(model, mode, batch)
    jeng = _jax_engine(model, mode, batch)
    want = _jax_scopes(jax.jit(jeng._fwd), jeng, batch,
                       r"(?:w8)?stage\d+_[^/()\"]+")
    x = eng._bench_input(batch)
    got = _scopes(lambda: eng._fwd(x), r"(w8)?stage\d+_.*")
    assert len(got) == len(eng._plan)
    assert [n for n in got if n in want] == want
    # a JAX stage whose ops lower to nothing (a route of one layer hands
    # on the saved array itself) leaves no name behind
    assert all(eng._plan[_scope_index(n)].kind == "route"
               for n in got if n not in want)


@pytest.mark.parametrize("model,mode", [
    ("yolov2-tiny", "fp32"), ("yolov2-tiny", "w8"), ("yolov2-tiny", "w8a8"),
    ("yolov3-tiny", "w8a8"), ("resnet18", "fp32")])
def test_layer_scopes_are_jax_names(model, mode):
    """The generic forward opens a scope around each conv, in order, named
    as the JAX generic forward's ``layer_scope`` names it."""
    eng = _engine(model, mode, 2, kernel="xla")
    assert eng._plan is None
    jeng = _jax_engine(model, mode, 2, kernel="xla")
    want = _jax_scopes(jax.jit(jeng._fwd), jeng, 2, r"L\d+_[a-z]+")
    x = eng._bench_input(2)
    assert _scopes(lambda: eng._fwd(x), r"L\d+_[a-z]+") == want


@pytest.mark.parametrize("model,heads", [("yolov2-tiny", 1),
                                         ("yolov3-tiny", 2)])
def test_postprocess_scopes_under_detect(model, heads):
    """A detect opens the scopes the JAX detect opens: a ``post_decode``
    a head, then the NMS's three phases."""
    eng = _engine(model, "w8a8", 2)
    jeng = _jax_engine(model, "w8a8", 2)
    want = _jax_scopes(jeng.detect_fn(), jeng, 2, "|".join(POST_SCOPES))
    assert set(want) == set(POST_SCOPES)
    x = eng._bench_input(2)
    got = _scopes(lambda: eng.detect_fn()(x), "|".join(POST_SCOPES))
    assert got == ["post_decode"] * heads + list(POST_SCOPES[1:])


def test_scope_enters_no_range_without_a_profiler(monkeypatch):
    """With no profiler running, no ``record_function`` is entered on the
    main paths (the plan, the generic forward, decode and NMS)."""
    def boom(name):
        raise RuntimeError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    for mode, kernel in (("w8a8", "auto"), ("w8", "auto"),
                         ("fp32", "auto")):
        eng = _engine("yolov2-tiny", mode, 2, kernel=kernel)
        b, s, c = eng.detect(np.zeros((2, 64, 64, 3), np.uint8))
        assert b.shape == (2, 128, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="entered"):
            prof.scope("stage0_xla_L0")


# ---------------------------------------------------------------------------
# Engine.stage_times and layer_times
# ---------------------------------------------------------------------------

def _fixed_stats(fn, args, iters_hi=0, iters_lo=0, **kw):
    """The JAX side's loop timing, replaced: one call, constant numbers."""
    return {"min": 1e-3, "median": 1e-3, "spread_pct": 0.0,
            "iters": (iters_hi, iters_lo), "delta_work_s": 0.0}


@pytest.fixture(scope="module", params=["yolov2-tiny", "resnet18"])
def stage_rows(request):
    """The JAX engine's and the port's ``stage_times(batch=2, iters=(4,
    2))`` rows on the same weights and scales (one JAX run a model)."""
    model = request.param
    kw = _config(model, mode="w8a8", batch=2)
    mp = pytest.MonkeyPatch()
    mp.setattr(jbenchlib, "per_iter_time_stats", _fixed_stats)
    try:
        calib = np.random.default_rng(3).uniform(
            0, 1, (2, 64, 64, 3)).astype(np.float32)
        jeng = JEngine(JConfig(**kw)).load_weights(
            key=jax.random.PRNGKey(0)).prepare(calib)
        jrows = jeng.stage_times(batch=2, iters=(4, 2))
    finally:
        mp.undo()
    eng = Engine(EngineConfig(**kw), device="cpu").load_weights(
        params=jax.tree.map(np.asarray, jeng.params),
        act_scales=jeng.act_scales).prepare()
    return jrows, eng.stage_times(batch=2, iters=(4, 2)), eng


def test_stage_times_field_contract(stage_rows):
    jrows, rows, eng = stage_rows
    assert len(rows) == len(eng._plan) == len(jrows)
    for r in rows:
        assert STAGE_FIELDS <= set(r)
        assert r["ms"] >= 0
        assert r["gop_exec"] >= r["gop"] >= 0
        assert r["binding"] in ("tc", "hbm") and r["hbm_mb"] > 0
        assert r["iters"] == [4, 2]
        # a CPU time is no measure of the card: no percentages
        assert r["mfu_pct"] is r["hw_util_pct"] is r["pct_of_binding"] \
            is None


def test_stage_times_work_and_traffic_match_jax(stage_rows):
    """The port's stage rows carry JAX's work and traffic; where the port's
    entry stage reads the uint8 wire and JAX's the f32 batch (ResNet-18's
    stem, ``plan_entry_u8_rows``), its input is 1 byte a value, not 4."""
    jrows, rows, eng = stage_rows
    u8_entry = (tplan.plan_entry_u8_rows(eng.model, eng._plan)
                and not tplan.plan_input_uint8_ok(eng._plan))
    assert u8_entry == (eng.config.model == "resnet18")
    values = eng._bench_input(2).numel()
    for j, t in zip(jrows, rows):
        assert (t["stage"], t["name"], t["kind"]) == \
            (j["stage"], j["name"], j["kind"])
        assert (t["gop"], t["gop_exec"]) == (j["gop"], j["gop_exec"])
        less = 3 * values / 1e6 if u8_entry and t["stage"] == 0 else 0.0
        assert abs(t["hbm_mb"] + less - j["hbm_mb"]) <= 0.01, t["name"]


def test_stage_times_needs_the_w8a8_plan():
    eng = _engine("yolov2-tiny", "w8", 2)
    with pytest.raises(ValueError, match="w8a8 plan"):
        eng.stage_times(batch=2, iters=(4, 2))


@pytest.mark.parametrize("mode", ["fp32", "w8", "w8a8"])
def test_layer_times_names_match_jax(mode, monkeypatch):
    monkeypatch.setattr(jbenchlib, "per_iter_time",
                        lambda fn, args, **kw: 1e-3)
    kw = _config("yolov2-tiny", mode=mode, batch=2, kernel="xla")
    jeng = JEngine(JConfig(**kw)).load_weights(
        key=jax.random.PRNGKey(0))
    jeng.prepare(np.random.default_rng(3).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    want = [n for n, _ in jeng.layer_times(batch=2)]
    got = _engine("yolov2-tiny", mode, 2, kernel="xla").layer_times(
        batch=2, iters=(4, 2))
    # a loop difference of (4, 2) calls on the CPU is noise, of either sign
    assert [n for n, _ in got] == want
    assert all(np.isfinite(t) for _, t in got)


# ---------------------------------------------------------------------------
# attribution of device time to scopes
# ---------------------------------------------------------------------------

CONV = "void (anonymous namespace)::conv_patch_kernel<128, true, 3, 1>"
MUL = "void at::native::elementwise_kernel<128, 2>"


def test_attribute_takes_the_innermost_scope():
    recs = [(CONV, ("stage1_fold_xla_L2_fold2", "stage0_xla_L0"), 10.0),
            (MUL, ("aten::mul", "nms_suppress", "stage9_xla_L12"), 4.0),
            (MUL, ("aten::mul", "L6_conv", "stage3_xla_L6"), 2.0)]
    art = prof.attribute(recs, runs=2)
    assert art["by_scope_us"] == {"stage1_fold_xla_L2_fold2": 5.0,
                                  "nms_suppress": 2.0,
                                  "stage3_xla_L6": 1.0}
    assert art["top_ops"][0] == {
        "op": CONV, "us": 5.0, "group": "conv_w8a8",
        "scope": "stage1_fold_xla_L2_fold2",
        "op_name": "stage0_xla_L0/stage1_fold_xla_L2_fold2"}


def test_attribute_files_unscoped_events_by_kernel_group():
    recs = [(CONV, (), 3.0), ("Memcpy HtoD (Pageable -> Device)",
                              ("aten::copy_",), 1.5),
            ("some_library_kernel", ("aten::mm",), 0.5),
            (MUL, ("stage0_stem_rs_L0_fold4",), 5.0)]
    art = prof.attribute(recs, runs=1)
    assert art["by_scope_us"] == {
        "stage0_stem_rs_L0_fold4": 5.0, "unattributed/conv_w8a8": 3.0,
        "unattributed/host-to-device copies": 1.5,
        "unattributed/other": 0.5}
    assert art["sum_of_ops_us_per_run"] == 10.0
    assert sum(art["by_scope_us"].values()) == pytest.approx(10.0)


def _ev(id_, name, dev, start, end, parent=None, user=False):
    cpu = torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(
        id=id_, name=name,
        device_type=cpu if dev == "cpu" else torch.autograd.DeviceType.CUDA,
        time_range=types.SimpleNamespace(start=start, end=end),
        cpu_parent=parent, is_user_annotation=user)


def test_device_records_link_each_event_through_its_launch_call():
    """A kernel is found by its launch call's correlation id, the call's
    enclosing ranges are its chain; a ctypes launch has no ATen op around
    it, and the device-side copy of a range is skipped."""
    stage = _ev(1, "stage0_xla_L0", "cpu", 0, 100, user=True)
    mul = _ev(10, "aten::mul", "cpu", 5, 20, parent=stage)
    launch_mul = _ev(24, "cudaLaunchKernel", "cpu", 6, 9, parent=mul)
    launch_conv = _ev(39, "cudaLaunchKernel", "cpu", 30, 35, parent=stage)
    events = [stage, mul, launch_mul, launch_conv,
              _ev(1, "stage0_xla_L0", "cuda", 40, 80, user=True),
              _ev(24, MUL, "cuda", 40, 42), _ev(39, CONV, "cuda", 50, 68),
              _ev(77, "Memset (Device)", "cuda", 70, 71)]
    records, spans = prof.device_records(events)
    assert records == [(MUL, ("aten::mul", "stage0_xla_L0"), 2),
                       (CONV, ("stage0_xla_L0",), 18),
                       ("Memset (Device)", (), 1)]
    assert spans == [(40, 42), (50, 68), (70, 71)]


def test_busy_time_is_the_union_of_spans():
    assert prof._busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    assert prof._busy_us([]) == 0


def test_lost_kernel_events_retake_then_raise(capsys):
    calls = []

    def take():
        calls.append(1)
        return "art", {"conv_w8a8": 6}, {"conv_w8a8": 7, "gemm_fused": 0}
    with pytest.raises(AssertionError, match="3 traces"):
        prof._retaking(take, "2 runs")
    assert len(calls) == 3
    assert "lost kernel events" in capsys.readouterr().out

    def take_second():
        calls.append(1)
        n = 7 if len(calls) >= 2 else 5
        return "art", {"conv_w8a8": n}, {"conv_w8a8": 7}
    calls.clear()
    assert prof._retaking(take_second, "2 runs") == "art"
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# benchlib: wall_time, roofline_pct, binding_bound_s
# ---------------------------------------------------------------------------

def _sleeper(delays, ones):
    """A call that sleeps the next of ``delays`` and returns ``ones + 1``."""
    it = iter(delays)

    def fn(a):
        time.sleep(next(it))
        return a + ones
    return fn


def test_wall_time_keeps_the_jax_contract():
    """As JAX's ``wall_time``: one untimed warm-up call, then the median
    of ``reps`` calls, each timed to its result."""
    delays = (0.3, 0.02, 0.2, 0.02)           # the warm-up, then 3 reps
    jt = jbenchlib.wall_time(_sleeper(delays, 1), (jax.numpy.ones(4),),
                             reps=3)
    t = benchlib.wall_time(_sleeper(delays, 1), (torch.ones(4),), reps=3)
    for got in (jt, t):
        assert 0.02 <= got < 0.2


@pytest.mark.parametrize("ops,nbytes", [(1e12, 1e6), (1e6, 1e9)])
def test_binding_bound_and_roofline_match_jax(ops, nbytes):
    """The same floors and shares as JAX's functions at the same peaks;
    the compute floor is the tensor cores' ("tc") where JAX's is the
    MXU's."""
    peak, bps = benchlib.peaks("NVIDIA H100 80GB HBM3")
    s, by = benchlib.binding_bound_s(ops, nbytes, peak, bps)
    js, jby = jbenchlib.binding_bound_s(ops, nbytes, peak, bps)
    assert s == js and by == {"mxu": "tc", "hbm": "hbm"}[jby]
    assert benchlib.roofline_pct(ops, 2 * s, peak) == \
        jbenchlib.roofline_pct(ops, 2 * s, peak)


def test_trace_attribution_on_the_cpu_names_the_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        prof.trace_attribution(lambda x: x + 1, torch.zeros(2), runs=2)


def test_trace_writes_a_chrome_trace(tmp_path):
    out = prof.trace(str(tmp_path), lambda a, b: a + b, torch.ones(3),
                     b=torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0))
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(open(files[0]).read())


def test_debug_checks_raise_on_nan_inside_only():
    z = torch.zeros(2)
    assert torch.isnan(z / z).all()             # outside: no check
    with prof.debug_checks():
        with pytest.raises(FloatingPointError, match="NaN"):
            z / z
        torch.ones(2) / z                       # Inf: not checked
    with prof.debug_checks(nans=False, infs=True):
        with pytest.raises(FloatingPointError, match="Inf"):
            torch.ones(2) / z


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

_ROW = re.compile(r"^\s*\d+ L\d+_\S+\s")


def test_cli_layer_times_prints_jax_stage_rows(tmp_path, capsys,
                                                monkeypatch):
    """``layer-times`` on the CPU prints as many stage rows as the JAX
    CLI for the same flags (``--config`` carries the 64 px size: neither
    CLI has ``--input-size`` there)."""
    path = tmp_path / "c.json"
    EngineConfig(input_size=64).to_json(str(path))
    flags = ["layer-times", "--mode", "w8a8", "--batch", "2", "--iters",
             "4,2", "--config", str(path)]
    with pytest.warns(UserWarning, match="uniform noise"):
        assert cli.main(flags + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(jbenchlib, "per_iter_time_stats", _fixed_stats)
    with pytest.warns(UserWarning):
        jcli.main(flags)
    want = capsys.readouterr().out.splitlines()
    rows = [ln for ln in got if _ROW.match(ln)]
    assert len(rows) == len([ln for ln in want if _ROW.match(ln)]) == 12
    assert got[0] == want[0] and got[1].split() == want[1].split()
    assert got[-1].startswith("# TOTAL stages")


def test_cli_layer_times_generic_forward(tmp_path, capsys):
    path = tmp_path / "c.json"
    EngineConfig(input_size=64).to_json(str(path))
    assert cli.main(["layer-times", "--device", "cpu", "--mode", "fp32",
                     "--batch", "1", "--iters", "4,2", "--config",
                     str(path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("layer") for ln in out) == 9
    assert out[-1].startswith("TOTAL conv")


def test_cli_trace_on_the_cpu_names_the_card(tmp_path):
    path = tmp_path / "c.json"
    EngineConfig(input_size=64).to_json(str(path))
    with pytest.warns(UserWarning, match="uniform noise"):
        with pytest.raises(RuntimeError, match="CUDA card"):
            cli.main(["trace", "--device", "cpu", "--mode", "w8a8",
                      "--batch", "1", "--detect", "--runs", "2",
                      "--config", str(path)])
