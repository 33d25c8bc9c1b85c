"""One run of one cell: set-up, the timed window, with ``--trace 1`` a
traced window after it, and the judgement against the plain reference.

Set-up makes the weights, the calibration images and the pool from the
seed on the device, hands the weights and images to the engine
(``load_weights(params=...)``, ``prepare(calib_images=...)``) and warms up
every pool batch through the window's own call. The window is a closed
loop, one client and one batch in flight: the next pool batch is
dispatched once the last one's results are on the host. It keeps, for
the judgement, the last results of each pool batch and a sample of
``sample_batches`` batches drawn from the seed (their heads cloned on the
device). Once the window has closed and the memory peak is read, the
engine is freed, and the reference works out its own weights, scales and
outputs from the same seed.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import families, inputs, judge, metrics, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "dnn_inference_engine_tpu")
SAMPLE = 3                      # the reservoir's stream of the seed
_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range while a profiler runs, else nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _on_card(device):
        torch.cuda.synchronize(device)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        t0: float, device="cuda", sizes: Optional[Dict] = None,
        fault: Optional[Callable] = None) -> Dict:
    """The result line's object. ``sizes`` replaces the configuration's
    and traffic's sizes (tests at a small size); ``fault`` wraps the
    window's call (tests that break the timed path)."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic = cell.config, cell.traffic
    sz = {"input_size": cfg["input_size"], **{
        k: traffic[k] for k in ("batch", "pool_batches", "sample_batches",
                                "trace_batches")}, **(sizes or {})}
    size, batch = sz["input_size"], sz["batch"]
    task = importlib.import_module(f"benchmark.tasks.{cfg['task']}")

    # -- set-up -------------------------------------------------------------
    marks = [("imports", time.perf_counter())]
    calib = inputs.calib_images(cfg, seed, device, size)
    params = inputs.to_numpy(inputs.weights(cfg, seed, device, calib))
    calib = calib.cpu().numpy()
    pool = inputs.pool(cfg, seed, device, size, batch, sz["pool_batches"])
    _sync(device)
    marks.append(("inputs", time.perf_counter()))
    ecfg = EngineConfig(model=cfg["model"], mode=cfg["mode"], batch=batch,
                        input_size=size, num_classes=cfg["num_classes"],
                        **task.engine_config(cfg, traffic))
    engine = Engine(ecfg, device=device).load_weights(
        params=params).prepare(calib_images=calib)
    _sync(device)
    marks.append(("engine", time.perf_counter()))
    call = task.window_call(engine, span)
    if fault is not None:
        call = fault(call)
    for x in pool + pool[:1]:
        call(x)
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    # the window's host work is one Python thread dispatching to the card:
    # no intra-op pool beside it, and the set-up's objects kept out of the
    # collector's scans
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gc.collect()
    gc.freeze()

    # -- the timed window ---------------------------------------------------
    rng = np.random.default_rng(inputs.stream_seed(seed, SAMPLE))
    k = sz["sample_batches"]
    sample: List = []              # (pool index, host outputs, head clone)
    last: Dict[int, object] = {}   # pool index -> host outputs
    lat: List[float] = []
    start = time.perf_counter()
    setup_s = start - t0
    i, now = 0, start
    while now - start < seconds:
        pi = i % len(pool)
        t1 = time.perf_counter()
        out, head = call(pool[pi])
        now = time.perf_counter()
        lat.append(now - t1)
        last[pi] = out
        j = i if i < k else int(rng.integers(0, i + 1))
        if j < k:
            kept = (pi, out, None if head is None else head.clone())
            if j == len(sample):
                sample.append(kept)
            else:
                sample[j] = kept
        i += 1
    window_s = now - start
    print("set-up s: " + ", ".join(
        f"{name} {t - prev:.3f}" for (name, t), prev in
        zip(marks, [t0] + [t for _, t in marks])), file=sys.stderr)
    print(window_line(lat, window_s), file=sys.stderr)
    on_card = _on_card(device)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips}
    ctx = {"cfg": cfg, "traffic": traffic, "batch": batch,
           "device_name": dev["kind"], "setup_s": setup_s, "timed": {
               "latencies_s": lat, "batches": len(lat),
               "images": len(lat) * batch, "seconds": window_s}}
    result: Dict = {}
    if traced:
        tr = traced_window(call, pool, sz["trace_batches"], device)
        ctx["trace"] = tr
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = tr["breakdown"]
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the port must not load: "
                           f"{found}")
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if on_card else 0)

    # -- the judgement ------------------------------------------------------
    prog_params, prog_scales = families.of(cfg).program_codes(engine)
    del engine, call
    torch.set_num_threads(threads)
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = judge_outputs(cell, task, (params, calib), device, size,
                            pool, sample, last, prog_params, prog_scales)
    print(f"judgement: {len(sample)} sampled and {len(last)} last batches "
          f"against the reference in {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    correct, rows = judge.verdict(numbers, cell.limits)
    names = cell.per_layer if traced else cell.end_to_end
    ms = {}
    for m in names:
        v = metrics.read(m["name"], ctx)
        if v is not None:
            ms[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(lat) * batch,
              "failed": 0, "metrics": ms, "device": dev, **result,
              "checks": {n: {"value": v, "limit": lim}
                         for n, v, lim in rows}}
    return result


def window_line(lat: List[float], window_s: float) -> str:
    """How the window's batch times spread, for the log."""
    ms = np.asarray(lat) * 1e3
    p50, p95, p99 = np.percentile(ms, [50, 95, 99])
    slow = ms[ms > 1.5 * p50]
    h = max(len(ms) // 2, 1) if len(ms) > 1 else 0
    return (f"window: {len(ms)} batches in {window_s:.3f} s, "
            f"{ms.sum() / 1e3 / window_s:.4f} of it in calls; batch ms "
            f"p50 {p50:.4f} p95 {p95:.4f} p99 {p99:.4f} max {ms.max():.4f}; "
            f"{len(slow)} over 1.5x p50 ({slow.sum():.1f} ms); mean ms "
            f"first half {ms[:h].mean() if h else p50:.4f}, second "
            f"{ms[h:].mean():.4f}")


@torch.no_grad()
def judge_outputs(cell, task, given, device, size, pool, sample, last,
                  prog_params, prog_scales) -> Dict[str, float]:
    """The reference of the configuration's family on what the program
    was given (the float32 weights and calibration images, on the host),
    and every number compared."""
    cfg, traffic = cell.config, cell.traffic
    params, calib = given
    ref = families.of(cfg).reference(cfg, inputs.to_torch(params, device),
                                     judge.INT8)
    ref.calibrate(torch.as_tensor(calib, device=device))
    numbers = judge.weight_numbers(prog_params, ref.qparams, prog_scales,
                                   ref.scales)
    heads, outs = {}, {}
    for pi in sorted({s[0] for s in sample} | set(last)):
        heads[pi] = ref.forward(pool[pi])
        outs[pi] = task.reference_outputs(heads[pi], cfg, traffic, size)
    gaps = []
    for pi, out, head in sample + [(p, o, None) for p, o in last.items()]:
        h = head if head is not None else task.head_of(out)
        if h is not None:
            gaps.append(judge.head_gap(h, heads[pi]))
        for name, v in task.compare(out, outs[pi]).items():
            how = task.COMBINE[name]
            prev = numbers.get(name, 0.0)
            numbers[name] = prev + v if how == "sum" else max(prev, v)
    numbers["head_gap"] = max(gaps) if gaps else float("inf")
    return numbers


def traced_window(call, pool, batches: int, device, tries: int = 3) -> Dict:
    """``batches`` calls under ``torch.profiler`` after one call that is
    left out, held to the engine's launch counters: a trace that lost a
    kernel's events is taken again, at most ``tries`` times."""
    from dnn_inference_engine_tpu_torch.runtime import profiling
    for attempt in range(1, tries + 1):
        tr, lost = _trace_once(call, pool, batches, device, profiling)
        if not lost:
            return tr
        print(f"trace {attempt} of {tries} lost kernel events (traced, "
              f"launched): {lost}", file=sys.stderr)
    return tr


def _trace_once(call, pool, batches, device, profiling):
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.first"):
            call(pool[0])
            _sync(device)
        profiling.reset_counts()
        with record_function("bench.window"):
            w0 = time.perf_counter()
            for i in range(batches):
                with record_function(trace.CALL):
                    call(pool[i % len(pool)])
            _sync(device)
            w1 = time.perf_counter()
    launched = profiling.read_counts()
    events = prof.events()
    win = next(fe for fe in events if fe.name == "bench.window")
    lo, hi = win.time_range.start, win.time_range.end
    devs = [ev for ev in trace.device_events(events) if ev.start_us >= lo]
    traced: Dict[str, int] = {}
    for ev in devs:
        g = profiling.kernel_group(ev.name)
        traced[g] = traced.get(g, 0) + 1
    lost = {k: (traced.get(k, 0), n) for k, n in launched.items()
            if traced.get(k, 0) != n}
    spans = [(max(s, lo), min(e, hi)) for s, e in trace.busy_spans(devs)
             if e > lo and s < hi]
    busy_us = sum(e - s for s, e in spans)
    hosts = trace.host_events(events, win.thread)
    return {"events": devs, "batches": batches,
            "busy_s": busy_us / 1e6, "window_s": (hi - lo) / 1e6,
            "host_window_s": w1 - w0, "launches": launched,
            "breakdown": {"device_ops": trace.top_ops(devs),
                          "idle_gaps": trace.idle_gaps(spans, (lo, hi),
                                                       hosts)}}, lost
