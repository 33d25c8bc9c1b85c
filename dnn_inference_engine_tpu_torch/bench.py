"""The bench: YOLOv2-tiny W8A8 batch-32 images/s on one card.

Counterpart of the repo root's ``bench.py`` (the JAX package's, which
imports JAX). Prints ONE JSON line:

  {"metric": ..., "value": N, "unit": "images/s/chip", "vs_baseline": N,
   "detail": {...}}

    python -m dnn_inference_engine_tpu_torch.bench [--mode w8a8]
        [--batch 32] [--model yolov2-tiny] [--kernel auto]
        [--device cpu --input-size 64] [--verbose]

It runs on the card unless ``--device`` names another device; on the CPU
it times the plain PyTorch versions and leaves the card's fields (device
times, card line, clocks) None: a CPU time is no measure of the card.

``vs_baseline``: the speedup over the fp32 engine's forward at the same
batch, as in the JAX bench (the reference publishes no numbers, so the
in-repo fp32 model is the baseline).
"""

from __future__ import annotations

import json
import sys

import numpy as np

# what the port's fp32 baseline computes, on the card and on the CPU
FP32_PRECISION = {
    "cuda": ("float32 sums throughout: the fp32 gemm tier's convs on "
             "gemm_f32 (three TF32 products, a float32's error), the rest "
             "on cuDNN with TF32 off (ops/conv.py _conv_nhwc, "
             "models/model.py dense_f32: matmul precision 'highest')"),
    "cpu": "float32 (the plain PyTorch versions on the CPU)",
}
POST_SCOPES = ("post_decode", "nms_candidates", "nms_suppress", "nms_merge")


def wire_batch(batch: int, size: int, mode: str) -> np.ndarray:
    """The JAX bench's seeded batch: uniform [0, 1) f32, rounded to uint8
    codes (the serving wire format) for a quantized mode."""
    x = np.random.default_rng(0).uniform(
        0, 1, (batch, size, size, 3)).astype(np.float32)
    if mode != "fp32":
        x = np.clip(np.round(x * 255), 0, 255).astype(np.uint8)
    return x


def detect_device_split(det, x1, runs: int = 30) -> dict:
    """The device time of ``det(x1)`` (a detect) from ``torch.profiler``'s
    trace of ``runs`` calls (``trace_attribution``: each kernel held to its
    launch counter), split by the postprocess scopes: ``decode_device_ms``
    (``post_decode``), ``nms_device_ms`` (the ``nms_*`` scopes) and
    ``forward_device_ms`` (the rest). Device busy time: the host's gaps
    between launches are not in it. Needs the card."""
    from dnn_inference_engine_tpu_torch.runtime.profiling import (
        trace_attribution)
    art = trace_attribution(det, x1, runs=runs)
    by = art["by_scope_us"]
    detect = art["module_device_us_per_run"] / 1e3
    decode = by.get("post_decode", 0.0) / 1e3
    nms = sum(by.get(k, 0.0) for k in POST_SCOPES[1:]) / 1e3
    return {"detect_device_ms": round(detect, 4),
            "forward_device_ms": round(detect - decode - nms, 4),
            "decode_device_ms": round(decode, 4),
            "nms_device_ms": round(nms, 4),
            "runs_traced": art["runs_traced"]}


def run_bench(model: str = "yolov2-tiny", mode: str = "w8a8",
              kernel: str = "auto", batch: int = 32,
              baseline_mode: str = "fp32", verbose: bool = False,
              device=None, input_size=None) -> dict:
    """The JAX ``run_bench``'s dict, measured on ``device`` (default the
    card; ``"cpu"`` runs the plain versions) at ``input_size`` (default
    the model's).

    ``value``: ``batch`` over the median per-batch time of the forward by
    loop difference (``per_iter_time_stats``, 60 and 10 calls, 3 reps):
    calls back to back, the host's gaps between launches included, which
    is what a stream of batches gets. ``p50_single_image_ms``: the median
    wall time of a b1 detect (forward, decode, NMS) from the call to its
    result on the host. ``single_image_device_ms``: that detect's device
    busy time from the profiler's trace (``detect_device_split``), since
    the eager port's back-to-back b1 detects are bound by the host, not
    the device; the trace's forward, decode and NMS split stands beside
    it. On the CPU the device fields, ``card`` and the clocks are None."""
    import torch
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime import benchlib
    from dnn_inference_engine_tpu_torch.runtime.engine import (
        Engine, resolve_device)

    def log(*a):
        if verbose:
            print(*a, file=sys.stderr, flush=True)

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    card = benchlib.card_line(dev) if on_card else None
    clocks_before = benchlib.clocks(dev) if on_card else None

    def build(m, b):
        kw = {"input_size": input_size} if input_size else {}
        cfg = EngineConfig(model=model, mode=m, kernel=kernel, batch=b, **kw)
        return Engine(cfg, device=dev).load_weights(seed=0).prepare()

    eng = build(mode, batch)
    size = eng.config.input_size
    xs = wire_batch(batch, size, mode)
    x = torch.as_tensor(xs, device=dev)
    log(f"timing {model} {mode} kernel={kernel} batch={batch} at {size} px "
        f"on {dev}" + (f" ({card})" if card else ""))
    st = benchlib.per_iter_time_stats(eng._fwd, (x,), iters_hi=60,
                                      iters_lo=10)
    t = st["median"]
    log(f"{mode}: {t * 1e3:.3f} ms/batch -> {batch / t:.0f} images/s "
        f"(spread {st['spread_pct']:.1f}%)")

    # b1: the first image of the batch as uint8 codes, detected (forward,
    # decode, NMS) and synced; its device time from the trace
    eng1 = build(mode, 1)
    x1 = torch.as_tensor(wire_batch(1, size, "w8a8"), device=dev)
    det = eng1.detect_fn()
    t_lat = benchlib.wall_time(det, (x1,), reps=50)
    split = detect_device_split(det, x1) if on_card else None
    log(f"p50 single-image detect latency: {t_lat * 1e3:.2f} ms wall"
        + (f" ({split['detect_device_ms']:.4f} ms device: forward "
           f"{split['forward_device_ms']:.4f}, decode "
           f"{split['decode_device_ms']:.4f}, NMS "
           f"{split['nms_device_ms']:.4f})" if split else ""))

    # baseline: the fp32 engine's forward, same batch and input
    engb = build(baseline_mode, batch)
    sb = benchlib.per_iter_time_stats(engb._fwd, (x,), iters_hi=60,
                                      iters_lo=10)
    tb = sb["median"]
    log(f"{baseline_mode} baseline: {tb * 1e3:.3f} ms/batch -> "
        f"{batch / tb:.0f} images/s (spread {sb['spread_pct']:.1f}%)")
    clocks_after = benchlib.clocks(dev) if on_card else None

    return {
        "metric": f"{model} {mode.upper()} images/sec/chip (batch {batch})",
        "value": round(batch / t, 1),
        "unit": "images/s/chip",
        "vs_baseline": round(tb / t, 3),
        "detail": {
            "ms_per_batch": round(t * 1e3, 3),
            "ms_per_batch_min": round(st["min"] * 1e3, 3),
            "ms_per_batch_spread_pct": round(st["spread_pct"], 2),
            "p50_single_image_ms": round(t_lat * 1e3, 2),
            "single_image_device_ms": (split["detect_device_ms"]
                                       if split else None),
            "single_image_split_device_ms": (
                {k: split[k] for k in ("forward_device_ms",
                                       "decode_device_ms",
                                       "nms_device_ms")}
                if split else None),
            "fp32_images_per_s": round(batch / tb, 1),
            "fp32_ms_per_batch": round(tb * 1e3, 3),
            "fp32_ms_per_batch_spread_pct": round(sb["spread_pct"], 2),
            "fp32_precision": FP32_PRECISION[dev.type],
            "kernel": kernel,
            "backend": dev.type,
            "input_size": size,
            "card": card,
            "clocks_before": clocks_before,
            "clocks_after": clocks_after,
        },
    }


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="dnn_inference_engine_tpu_torch.bench")
    ap.add_argument("--model", default="yolov2-tiny")
    ap.add_argument("--mode", default="w8a8")
    ap.add_argument("--kernel", default="auto")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' times the "
                         "plain PyTorch versions)")
    ap.add_argument("--input-size", type=int, default=None)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    result = run_bench(model=args.model, mode=args.mode, kernel=args.kernel,
                       batch=args.batch, verbose=args.verbose,
                       device=args.device, input_size=args.input_size)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
