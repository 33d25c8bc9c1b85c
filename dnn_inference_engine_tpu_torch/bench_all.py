"""The benchmark sweep over the BASELINE.json measurement configs.

Counterpart of the repo root's ``bench_all.py`` (the JAX package's), with
its eleven config names. Prints one JSON line a config and writes the
whole to ``--out`` (default ``chiprun_out/bench_all.json``):

    python -m dnn_inference_engine_tpu_torch.bench_all [--out PATH]
        [--configs 3,6,8] [--device cpu --input-size 64]

  1. YOLOv2-tiny fp32 b1, with the same forward on the host CPU
     (``cpu_reference``);
  2. YOLOv2-tiny w8 b1;
  3. YOLOv2-tiny W8A8 b32 (the headline);
  4. YOLOv3-tiny and ResNet-18 (224 px) in w8 and W8A8;
  5. scaling: with two or more cards, dp=1 against dp=2 on NCCL (a rank
     a card) and its efficiency; with one, the note that scaling is not
     measurable, the (1, 1) mesh's sharded forward against the plain one,
     and the dp1/dp2 harness on CPU gloo ranks at 96 px (``cpu_sim_*``,
     no efficiency);
  6. the W8A8 b32 plan's stages in context (``stage_times_traced``);
  7. continuous-batching serving, b32, 2048 images;
  8. the b1 detect: forward, decode and NMS device time from the trace,
     and the wall p50.

It runs on the card unless ``--device`` names another device. A config
that raises records ``{"error": ...}`` and the sweep goes on, as in the
JAX sweep; the run then exits 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

# (name, bench_model's arguments): the JAX sweep's ``runs``
RUNS = (
    ("1_yolov2_fp32_b1", dict(model="yolov2-tiny", mode="fp32", batch=1)),
    ("2_yolov2_w8_b1", dict(model="yolov2-tiny", mode="w8", batch=1)),
    ("3_yolov2_w8a8_b32", dict(model="yolov2-tiny", mode="w8a8", batch=32)),
    ("4a_yolov3_w8_b16", dict(model="yolov3-tiny", mode="w8", batch=16)),
    ("4b_resnet18_w8_b32", dict(model="resnet18", mode="w8", batch=32,
                                input_size=224)),
    ("4c_yolov3_w8a8_b16", dict(model="yolov3-tiny", mode="w8a8",
                                batch=16)),
    ("4d_resnet18_w8a8_b32", dict(model="resnet18", mode="w8a8", batch=32,
                                  input_size=224)),
)
CONFIGS = tuple(n for n, _ in RUNS) + (
    "5_scaling", "6_stage_roofline", "7_serve", "8_b1_detect_latency")
SIM_SIZE, SIM_PER_DEV = 96, 2       # config 5's CPU harness
CARD_PER_DEV = 8                    # config 5 on cards, 416 px
SCALING_TIMEOUT_S = 600             # a group of config 5's ranks
DEFAULT_OUT = os.path.join("chiprun_out", "bench_all.json")
_MODULE = "dnn_inference_engine_tpu_torch.bench_all"
_ROOT = str(Path(__file__).resolve().parents[1])     # the package's parent


def _engine(model, mode, batch, kernel="auto", input_size=None, device=None,
            **cfg):
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    if input_size:
        cfg["input_size"] = input_size
    return Engine(EngineConfig(model=model, mode=mode, kernel=kernel,
                               batch=batch, **cfg),
                  device=device).load_weights(seed=0).prepare()


def _batch(eng, batch, mode):
    import torch
    from dnn_inference_engine_tpu_torch.bench import wire_batch
    return torch.as_tensor(wire_batch(batch, eng.config.input_size, mode),
                           device=eng.device)


def bench_model(model, mode, batch, kernel="auto", input_size=None,
                device=None) -> dict:
    """The forward's per-batch time by loop difference (auto-scaled
    counts, 4 reps): the JAX sweep's min, with the median and the reps'
    spread beside it."""
    from dnn_inference_engine_tpu_torch.runtime.benchlib import (
        per_iter_time_stats)
    eng = _engine(model, mode, batch, kernel, input_size, device)
    x = _batch(eng, batch, mode)
    s = per_iter_time_stats(eng._fwd, (x,), reps=4)
    return {
        "model": model, "mode": mode, "batch": batch,
        "input_size": eng.config.input_size,
        "ms_per_batch": round(s["min"] * 1e3, 3),
        "images_per_s": round(batch / s["min"], 1),
        "ms_per_batch_median": round(s["median"] * 1e3, 3),
        "spread_pct": round(s["spread_pct"], 2),
    }


def bench_cpu_reference(input_size=None, n_iters=10) -> dict:
    """Config 1's CPU reference: the port's fp32 b1 forward on the host
    CPU (the plain PyTorch versions), each call timed to its result."""
    eng = _engine("yolov2-tiny", "fp32", 1, input_size=input_size,
                  device="cpu")
    x = _batch(eng, 1, "fp32")
    eng._fwd(x)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        eng._fwd(x)
    dt = (time.perf_counter() - t0) / n_iters
    return {"backend": "cpu", "ms_per_batch": round(dt * 1e3, 2),
            "images_per_s": round(1 / dt, 1), "n_iters": n_iters,
            "input_size": eng.config.input_size,
            "note": "the port's fp32 b1 forward on the host CPU, the "
                    "plain PyTorch versions: the CPU-reference role "
                    "BASELINE config 1 names"}


def bench_shardmap_anchor(batch=32, input_size=None, device=None) -> dict:
    """The single-device anchor of scaling: the same W8A8 engine's forward
    through the sharded path over a (1, 1) mesh (``make_sharded_forward_fn``)
    against the plain forward; the gap is the sharded path's own cost.
    Each is timed in turns (plain, sharded, sharded, plain; min of 3 reps
    a turn) and keeps its fastest turn: the back-to-back forward is bound
    by the host, whose speed can shift between two turns."""
    from dnn_inference_engine_tpu_torch.parallel.mesh import make_mesh
    from dnn_inference_engine_tpu_torch.parallel.sharded_engine import (
        make_sharded_forward_fn)
    from dnn_inference_engine_tpu_torch.runtime.benchlib import (
        per_iter_time)
    eng = _engine("yolov2-tiny", "w8a8", batch, input_size=input_size,
                  device=device)
    x = _batch(eng, batch, "w8a8")
    fns = {"plain": eng._fwd,
           "sharded": make_sharded_forward_fn(eng, make_mesh((1, 1)))}
    best = {}
    for turn in ("plain", "sharded", "sharded", "plain"):
        t = per_iter_time(fns[turn], (x,), iters_hi=40, iters_lo=8, reps=3,
                          stat="min")
        best[turn] = min(t, best.get(turn, t))
    t_plain, t_shard = best["plain"], best["sharded"]
    return {
        "plain_images_per_s": round(batch / t_plain, 1),
        "sharded_1x1_images_per_s": round(batch / t_shard, 1),
        "sharded_overhead_pct": round(100 * (t_shard - t_plain) / t_plain,
                                      1),
    }


def _scaling_rank(spec: dict) -> int:
    """One rank of config 5's dp harness (``--scaling-rank``): the W8A8
    YOLOv2-tiny forward, weights replicated, on a (dp, 1) mesh; rank 0
    writes ``SCALING {...}`` to its output. On the CPU (``spec["device"]``
    "cpu") gloo ranks at SIM_SIZE; on cards NCCL, a card a rank."""
    import torch
    from dnn_inference_engine_tpu_torch.models import build_model
    from dnn_inference_engine_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh)
    from dnn_inference_engine_tpu_torch.parallel.shard_map_forward import (
        make_shardmap_forward)
    from dnn_inference_engine_tpu_torch.parallel.sharding import (
        input_sharding, shard_params)
    from dnn_inference_engine_tpu_torch.quant.quantize import (
        calibrate, quantize_model_params)
    from dnn_inference_engine_tpu_torch.runtime.benchlib import (
        per_iter_time)
    dp, rank, size = spec["dp"], spec["rank"], spec["size"]
    on_card = spec["device"] == "cuda"
    dev = torch.device(f"cuda:{rank}" if on_card else "cpu")
    if on_card:
        torch.cuda.set_device(dev)
    init_distributed(spec["init"], dp, rank,
                     backend="nccl" if on_card else "gloo",
                     timeout_s=SCALING_TIMEOUT_S)
    model = build_model("yolov2-tiny")
    params = model.init_params(torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    scales = calibrate(model, params, imgs, batch=2, device=dev)
    qparams = quantize_model_params(params, model.layers)
    mesh = make_mesh((dp, 1))
    sharded = shard_params(qparams, mesh, model, "replicated")
    fwd = make_shardmap_forward(model, mesh, scales, "replicated")
    batch = spec["per_dev"] * dp
    x = torch.as_tensor(rng.uniform(0, 1, (batch, size, size, 3)).astype(
        np.float32))[input_sharding(mesh, batch)].to(dev)
    hi, lo = (20, 4) if on_card else (6, 2)
    t = per_iter_time(lambda xx: fwd(sharded, xx), (x,), iters_hi=hi,
                      iters_lo=lo, reps=3, stat="min", agree_ranks=dp > 1)
    if rank == 0:
        print("SCALING " + json.dumps({
            "dp": dp, "batch": batch, "input_size": size,
            "images_per_s": round(batch / t, 1)}), flush=True)
    if dp > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


def _spawn_ranks(spec: dict, world: int, d: Path, tag: str) -> dict:
    """``world`` ranks of ``_scaling_rank`` at once, each a process of this
    module writing its output to a file in ``d`` (a rank blocked on a full
    pipe that no one reads would hold up the ranks that wait on it in a
    collective); all waited for together until SCALING_TIMEOUT_S, then
    killed. Returns rank 0's ``SCALING`` object; raises with the ranks'
    output tails where a rank failed or timed out."""
    procs, logs = [], []
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    for r in range(world):
        log = d / f"{tag}_rank{r}.log"
        logs.append(log)
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", _MODULE, "--scaling-rank",
                 json.dumps(dict(spec, rank=r, init=f"file://{d}/{tag}"))],
                stdout=f, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + SCALING_TIMEOUT_S
    rcs = []
    try:
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0, deadline
                                              - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = [log.read_text() for log in logs]
    if any(rc != 0 for rc in rcs):
        raise RuntimeError(
            f"config 5 {tag}: rank exit codes {rcs} (None: killed after "
            f"{SCALING_TIMEOUT_S} s):\n" + "\n".join(
                f"-- rank {r}:\n{t[-1500:]}" for r, t in enumerate(texts)))
    line = [ln for ln in texts[0].splitlines() if ln.startswith("SCALING ")]
    return json.loads(line[-1][len("SCALING "):])


def _dp_harness(device: str, size: int, per_dev: int) -> dict:
    """Config 5's dp=1 group, then its dp=2 group, ``per_dev`` images a
    rank at ``size`` px: {dp: rank 0's ``SCALING`` object}."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory(prefix="bench_scaling_") as d:
        for dp in (1, 2):
            spec = dict(dp=dp, size=size, per_dev=per_dev, device=device)
            out[dp] = _spawn_ranks(spec, dp, Path(d), f"dp{dp}")
    return out


def bench_scaling(device=None, input_size=None) -> dict:
    """dp=1 against dp=2. With two or more cards: NCCL ranks at the
    model's size, and ``scaling_efficiency``. With one card (or on the
    CPU): the note, the (1, 1) mesh anchor, and the harness on CPU gloo
    ranks at SIM_SIZE under ``cpu_sim_*`` names, with no efficiency (a
    CPU's number says nothing of the card's scaling)."""
    import torch
    from dnn_inference_engine_tpu_torch.runtime.engine import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        from dnn_inference_engine_tpu_torch.ops import _build
        _build.build_all()          # the ranks load what is built here
        size = input_size or 416
        res = _dp_harness("cuda", size, CARD_PER_DEV)
        d1, d2 = res[1]["images_per_s"], res[2]["images_per_s"]
        return {"input_size": size, "simulated": False,
                "cards": torch.cuda.device_count(), "backend": "nccl",
                "dp1_images_per_s": d1, "dp2_images_per_s": d2,
                "scaling_efficiency": round(d2 / (2 * d1), 3)}
    out = {"note": ("one device: scaling efficiency is not measurable "
                    "here; the cpu_sim_* fields only run the dp1/dp2 "
                    "harness on CPU gloo ranks and say nothing about the "
                    "card's scaling")}
    out["single_device_anchor"] = bench_shardmap_anchor(
        input_size=input_size, device=dev)
    res = _dp_harness("cpu", SIM_SIZE, SIM_PER_DEV)
    out["cpu_sim_input_size"] = SIM_SIZE
    out["cpu_sim_dp1_images_per_s"] = res[1]["images_per_s"]
    out["cpu_sim_dp2_images_per_s"] = res[2]["images_per_s"]
    return out


def bench_stage_roofline(model="yolov2-tiny", batch=32, input_size=None,
                         device=None) -> dict:
    """The W8A8 plan's stages, each in context from the trace of the
    whole forward and looped alone (``Engine.stage_times_traced``), and
    ``e2e_mfu_pct``: the plan's useful work over the traced module time
    against the card's int8 peak (``benchlib.peaks``). Needs the card: a
    trace that fails is the config's error."""
    import torch
    from dnn_inference_engine_tpu_torch.runtime.benchlib import peaks
    from dnn_inference_engine_tpu_torch.runtime.engine import resolve_device
    if resolve_device(device).type != "cuda":
        raise RuntimeError("config 6 traces the card's timeline: it needs "
                           "the card")
    eng = _engine(model, "w8a8", batch, input_size=input_size, device=device)
    rep = eng.stage_times_traced(batch=batch)
    gop = sum(r.get("gop", 0) for r in rep["stages"])
    peak_ops = peaks(torch.cuda.get_device_name(eng.device))[0]
    rep.update({
        "model": model,
        "peak_int8_tops": peak_ops / 1e12,
        "e2e_mfu_pct": round(gop * 1e9 / (rep["module_ms"] / 1e3)
                             / peak_ops * 100, 2),
    })
    return rep


def _served(eng, imgs, n_images: int):
    """``n_images`` of ``imgs`` (cycled) through a ``ContinuousBatcher``
    (max_batch 32, timeout_ms 2.0), all submitted at once after a warm-up
    request: (images/s, the batcher's stats)."""
    from dnn_inference_engine_tpu_torch.runtime.serve import (
        ContinuousBatcher)
    b = ContinuousBatcher(eng, max_batch=32, timeout_ms=2.0).start()
    try:
        b.infer(imgs[0], timeout=120.0)          # warm-up
        t0 = time.perf_counter()
        futs = [b.submit(imgs[i % len(imgs)]) for i in range(n_images)]
        for f in futs:
            f.result(timeout=120.0)
        dt = time.perf_counter() - t0
        return n_images / dt, b.stats()
    finally:
        b.stop()


def bench_serve(n_images: int = 2048, input_size=None, device=None) -> dict:
    """Continuous-batching serving on one device: the W8A8 b32 engine
    behind ``ContinuousBatcher``, every image submitted at once; images/s
    over the run and the batcher's p50 and p99 request latency. The JAX
    sweep's f32 images first (the batcher rounds each to uint8 codes on
    the host), then the same images as uint8 codes, the serving wire
    format, under ``uint8``."""
    eng = _engine("yolov2-tiny", "w8a8", 32, input_size=input_size,
                  device=device)
    size = eng.config.input_size
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
            for _ in range(32)]
    out = {"n_images": n_images}
    for key, batch in (("f32", imgs), ("uint8", [
            np.clip(np.round(im * 255), 0, 255).astype(np.uint8)
            for im in imgs])):
        ips, stats = _served(eng, batch, n_images)
        row = {"images_per_s": round(ips, 1), "p50_ms": stats["p50_ms"],
               "p99_ms": stats["p99_ms"],
               "avg_batch_fill": stats["avg_batch_fill"]}
        if key == "f32":
            out.update(row)
        else:
            out["uint8"] = row
    out["note"] = ("in-process batcher, one device; every image submitted "
                   "at once, so p50 and p99 include the queue")
    return out


def bench_b1_detect_latency(input_size=None, device=None) -> dict:
    """The b1 detect (forward, decode, NMS) of the W8A8 pin: device time
    from the profiler's trace, split into forward, decode and NMS
    (``bench.detect_device_split``; None on the CPU, which has no device
    timeline), and the wall p50 from the call to its result."""
    import torch
    from dnn_inference_engine_tpu_torch.bench import detect_device_split
    from dnn_inference_engine_tpu_torch.runtime.benchlib import wall_time
    eng = _engine("yolov2-tiny", "w8a8", 1, input_size=input_size,
                  device=device)
    size = eng.config.input_size
    x = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (1, size, size, 3)).astype(np.uint8), device=eng.device)
    det = eng.detect_fn()
    split = (detect_device_split(det, x) if eng.device.type == "cuda"
             else None)
    t_wall = wall_time(det, (x,), reps=50)
    out = {k: split and split[k] for k in (
        "forward_device_ms", "detect_device_ms", "decode_device_ms",
        "nms_device_ms")}
    out["postprocess_device_ms"] = split and round(
        split["decode_device_ms"] + split["nms_device_ms"], 4)
    out.update({
        "p50_wall_ms": round(t_wall * 1e3, 2),
        "nms": "nms_suppress: one kernel a detect, no host read; the pool "
               "256 at the serving threshold "
               "(EngineConfig.resolved_nms_topk)",
        "note": "device ms: busy time in the trace of 30 detects; the wall "
                "p50 adds the host's launches and its wait on the "
                "forward's scale uploads"})
    return out


def _config(name: str, input_size, device) -> dict:
    runs = dict(RUNS)
    if name in runs:
        kw = dict(runs[name])
        if input_size:
            kw["input_size"] = input_size
        r = bench_model(device=device, **kw)
        if name == "1_yolov2_fp32_b1":
            r["cpu_reference"] = bench_cpu_reference(input_size)
        return r
    fn = {"5_scaling": bench_scaling,
          "6_stage_roofline": bench_stage_roofline,
          "7_serve": bench_serve,
          "8_b1_detect_latency": bench_b1_detect_latency}[name]
    return fn(input_size=input_size, device=device)


def _pick(text: str):
    """``--configs``: names, or their leading tokens ("3", "4b"), comma
    separated; all eleven when empty."""
    if not text:
        return list(CONFIGS)
    out = []
    for tok in text.split(","):
        hit = [n for n in CONFIGS if tok in (n, n.split("_")[0])]
        if not hit:
            raise SystemExit(f"unknown config {tok!r}; have "
                             + ", ".join(CONFIGS))
        out += hit
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="dnn_inference_engine_tpu_torch.bench_all")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"the whole sweep as JSON (default {DEFAULT_OUT})")
    ap.add_argument("--configs", default="",
                    help="names or leading tokens, comma separated "
                         "(default: all eleven)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' times the "
                         "plain PyTorch versions)")
    ap.add_argument("--input-size", type=int, default=None,
                    help="every config's input size (default: each "
                         "model's)")
    ap.add_argument("--scaling-rank", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.scaling_rank:
        return _scaling_rank(json.loads(args.scaling_rank))
    from dnn_inference_engine_tpu_torch.runtime import benchlib
    from dnn_inference_engine_tpu_torch.runtime.engine import resolve_device
    names = _pick(args.configs)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    results = {"backend": dev.type,
               "card": benchlib.card_line(dev) if on_card else None,
               "clocks_before": benchlib.clocks(dev) if on_card else None,
               "configs": {}}
    failed = []
    for name in names:
        t0 = time.time()
        try:
            r = _config(name, args.input_size, dev)
        except Exception as e:              # noqa: BLE001 — keep sweeping
            traceback.print_exc()
            r = {"error": f"{type(e).__name__}: {e}"[:2000]}
            failed.append(name)
        r["seconds"] = round(time.time() - t0, 1)
        results["configs"][name] = r
        print(json.dumps({name: r}), flush=True)
    results["clocks_after"] = benchlib.clocks(dev) if on_card else None
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    if failed:
        print(f"# configs that failed: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
