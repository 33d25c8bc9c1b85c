"""Command line of the port.

Counterpart of ``dnn_inference_engine_tpu/cli.py``, with its subcommands,
flags and output lines, and ``--device`` (default: the card; ``cpu`` runs
the plain PyTorch versions):

  python -m dnn_inference_engine_tpu_torch.cli detect --image img.jpg [--mode w8a8]
  python -m dnn_inference_engine_tpu_torch.cli calibrate --images dir --out ckpt.npz
  python -m dnn_inference_engine_tpu_torch.cli serve --port 8000
  python -m dnn_inference_engine_tpu_torch.cli eval --voc-dir ... --mode w8a8
  python -m dnn_inference_engine_tpu_torch.cli dump-goldens --out g.npz
  python -m dnn_inference_engine_tpu_torch.cli check-goldens --goldens g.npz
  python -m dnn_inference_engine_tpu_torch.cli plan-sweep --mode w8a8 --batch 8 --out s.json

``bench`` waits for the card's bench (ROADMAP item A8), ``layer-times``
and ``trace`` for profiling (A13); a mesh, the channel sharding and
several serving processes for multi-device (A14).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# subcommands of the JAX CLI that wait for a ROADMAP item
_LATER = {"bench": "A8", "layer-times": "A13", "trace": "A13"}


def _add_common(p):
    p.add_argument("--model", default="yolov2-tiny")
    p.add_argument("--mode", default="fp32", choices=["fp32", "w8", "w8a8"])
    p.add_argument("--kernel", default="auto",
                   choices=["auto", "xla", "pallas"])
    p.add_argument("--weights", default=None,
                   help=".npz checkpoint / .pkl pytree / darknet .weights; "
                        "random weights if omitted")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--config", default=None, help="JSON EngineConfig file")
    p.add_argument("--score-thresh", type=float, default=None)
    p.add_argument("--nms-topk", type=int, default=None,
                   help="NMS candidate pool (default 256 at serving "
                        "thresholds, uncapped at eval thresholds)")
    p.add_argument("--mesh", default=None, metavar="DP,MP",
                   help="(data, model) mesh shape; one device only "
                        "(ROADMAP item A14)")
    p.add_argument("--sharding", default=None,
                   choices=["replicated", "channel"],
                   help="weight sharding for --mesh (channel: ROADMAP "
                        "item A14)")
    p.add_argument("--calib-images", default=None, metavar="DIR",
                   help="calibration images (a directory, .npy or .npz) "
                        "for w8a8 with real weights")
    p.add_argument("--strategy", default=None, metavar="JSON",
                   help="measured plan strategy from `plan-sweep` "
                        "(overrides the pinned table)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch versions)")


def _config(args):
    """The ``EngineConfig`` of the flags, over ``--config``'s file."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    cfg = EngineConfig.from_json(args.config) if args.config \
        else EngineConfig()
    cfg.model = args.model
    cfg.mode = args.mode
    cfg.kernel = args.kernel
    cfg.batch = args.batch
    cfg.weights = args.weights or cfg.weights
    if args.score_thresh is not None:
        cfg.score_thresh = args.score_thresh
    if args.nms_topk is not None:
        cfg.nms_topk = args.nms_topk
    if args.strategy:
        cfg.strategy = args.strategy
    if args.mesh:
        cfg.mesh_shape = tuple(int(v) for v in args.mesh.split(","))
        if args.sharding:
            cfg.sharding = args.sharding
    return cfg


def _build_engine(args):
    """The engine of the flags, weights loaded and prepared (calibrated
    from ``--calib-images`` where given)."""
    from dnn_inference_engine_tpu_torch.preprocess import load_calib_images
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    cfg = _config(args)
    calib = (load_calib_images(args.calib_images, cfg.input_size)
             if args.calib_images else None)
    return Engine(cfg, device=args.device).load_weights().prepare(
        calib_images=calib)


def cmd_detect(args) -> int:
    from dnn_inference_engine_tpu_torch.config import VOC_CLASSES
    from dnn_inference_engine_tpu_torch.preprocess import (
        boxes_to_original, draw_boxes, load_image, preprocess_image)
    eng = _build_engine(args)
    img = load_image(args.image)
    x, meta = preprocess_image(img, eng.config.input_size)
    t0 = time.perf_counter()
    boxes, scores, classes = eng.detect(x[None])
    dt = time.perf_counter() - t0
    n = int((scores[0] > 0).sum())
    orig = boxes_to_original(boxes[0][:n], meta)
    for b, s, c in zip(orig, scores[0][:n], classes[0][:n]):
        name = VOC_CLASSES[c] if c < len(VOC_CLASSES) else str(c)
        print(f"{name:14s} {s:.3f}  [{b[0]:.0f}, {b[1]:.0f}, {b[2]:.0f}, "
              f"{b[3]:.0f}]")
    print(f"# {n} detections in {dt * 1e3:.1f} ms (incl. first-call kernel "
          "builds)")
    if args.out:
        from PIL import Image
        out = draw_boxes(img, orig, scores[0][:n], classes[0][:n],
                         VOC_CLASSES)
        Image.fromarray(out).save(args.out)
        print(f"# wrote {args.out}")
    return 0


def cmd_calibrate(args) -> int:
    """Calibrate on ``--images`` (scales a checkpoint carries are
    replaced) and save the checkpoint. The engine is prepared once, on
    these images, so weights from a file need no ``--calib-images``."""
    from dnn_inference_engine_tpu_torch.preprocess import load_calib_images
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    cfg = _config(args)
    imgs = load_calib_images(args.images, cfg.input_size, limit=args.limit)
    eng = Engine(cfg, device=args.device).load_weights()
    eng.act_scales = None
    eng.prepare(calib_images=imgs)
    eng.save(args.out)
    print(f"# calibrated on {len(imgs)} images -> {args.out}")
    return 0


def cmd_eval(args) -> int:
    from dnn_inference_engine_tpu_torch.eval.voc_dataset import evaluate_voc
    eng = _build_engine(args)
    res = evaluate_voc(eng, args.voc_dir, split=args.split,
                       limit=args.limit)
    print(json.dumps(res, indent=2))
    return 0


def cmd_serve(args) -> int:
    from dnn_inference_engine_tpu_torch.runtime.serve import (
        ContinuousBatcher)
    eng = _build_engine(args)
    batcher = ContinuousBatcher(eng).start()
    srv = batcher.serve_http(args.port)
    print(f"# serving {args.model} {args.mode} on "
          f":{srv.server_address[1]} (max_batch={batcher.max_batch}); "
          "POST /detect, GET /stats", flush=True)
    try:
        while True:
            time.sleep(10)
            print(json.dumps(batcher.stats()), flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop()
    return 0


def cmd_dump_goldens(args) -> int:
    """Dump every layer's fp32 output for one image (or a seeded one)."""
    from dnn_inference_engine_tpu_torch.eval.golden import dump_goldens
    from dnn_inference_engine_tpu_torch.preprocess import (
        load_image, preprocess_image)
    import torch
    args.mode = "fp32"                      # goldens are always fp32
    eng = _build_engine(args)
    if args.image:
        x, _ = preprocess_image(load_image(args.image),
                                eng.config.input_size)
        x = x[None]
    else:
        rng = np.random.default_rng(args.seed)
        s = eng.config.input_size
        x = rng.uniform(0, 1, (1, s, s, 3)).astype(np.float32)
    dump_goldens(eng.model, eng.fp32_params,
                 torch.as_tensor(x, device=eng.device), args.out)
    print(f"# dumped {len(eng.model.layers)} layer goldens -> {args.out}")
    return 0


def cmd_check_goldens(args) -> int:
    """Diff the configured mode's per-layer outputs against goldens."""
    from dnn_inference_engine_tpu_torch.eval.golden import (
        compare_goldens, load_goldens, quant_error_report)
    import torch
    eng = _build_engine(args)
    goldens = load_goldens(args.goldens)
    with np.load(args.goldens) as z:
        x = torch.as_tensor(z["input"], device=eng.device)
    _, outs = eng.model.forward(
        eng.params, x, mode=eng.config.mode, act_scales=eng.act_scales,
        capture_outputs=True)
    if eng.config.mode == "fp32":
        report = compare_goldens(outs, goldens, rtol=1e-4, atol=1e-4)
        print("# exact comparison passed; per-layer max abs diff:")
        for li, d in report.items():
            print(f"  layer{li:3d}: {d:.3e}")
        return 0
    report = quant_error_report(outs, goldens)
    worst = max(report.values())
    print(f"# quantization path vs FP32 goldens (relative RMS/layer), "
          f"worst {worst:.4f}:")
    for li, d in report.items():
        print(f"  layer{li:3d}: {d:.4f}")
    if worst > args.tol:
        print(f"# FAIL: worst layer error {worst:.4f} > tol {args.tol}")
        return 1
    return 0


def cmd_plan_sweep(args) -> int:
    """Measure each conv layer's legal plan kinds and emit the fastest
    strategy as JSON."""
    from dnn_inference_engine_tpu_torch.runtime.plan_sweep import sweep
    iters = tuple(int(v) for v in args.iters.split(","))
    art = sweep(model_name=args.model, mode=args.mode, batch=args.batch,
                input_size=args.input_size, quick=args.quick, iters=iters,
                reps=args.reps, weights=args.weights,
                calib=args.calib_images, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(art, f, indent=2)
        print(f"# wrote {args.out}")
    print(json.dumps({k: art[k] for k in
                      ("model", "mode", "batch", "input_size", "backend",
                       "device", "whole_net_ms", "images_per_s",
                       "strategy")}))
    return 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dnn_inference_engine_tpu_torch.cli",
        epilog="not ported yet: " + ", ".join(
            f"{c} (ROADMAP item {i})" for c, i in _LATER.items()))
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("detect", help="run detection on one image")
    _add_common(p)
    p.add_argument("--image", required=True)
    p.add_argument("--out", default=None, help="write annotated image here")
    p.set_defaults(fn=cmd_detect)

    p = sub.add_parser("eval", help="VOC mAP evaluation")
    _add_common(p)
    p.add_argument("--voc-dir", required=True)
    p.add_argument("--split", default="2007_test")
    p.add_argument("--limit", type=int, default=None)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("serve", help="continuous-batching server")
    _add_common(p)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--num-processes", type=int, default=None,
                   help="several server processes (ROADMAP item A14)")
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--coordinator", default=None)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("dump-goldens",
                       help="dump FP32 per-layer golden tensors")
    _add_common(p)
    p.add_argument("--image", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_dump_goldens)

    p = sub.add_parser("check-goldens",
                       help="diff the current mode's layers vs goldens")
    _add_common(p)
    p.add_argument("--goldens", required=True)
    p.add_argument("--tol", type=float, default=0.15,
                   help="max per-layer relative RMS for quantized modes")
    p.set_defaults(fn=cmd_check_goldens)

    p = sub.add_parser("plan-sweep",
                       help="measure per-layer kernel strategies, emit "
                            "the fastest as JSON")
    _add_common(p)
    p.add_argument("--input-size", type=int, default=None)
    p.add_argument("--out", default=None, help="write the artifact here")
    p.add_argument("--quick", action="store_true",
                   help="skip the long-shot candidates (gemm tier, "
                        "unpadded folds, rs kinds)")
    p.add_argument("--iters", default="60,10", metavar="HI,LO",
                   help="loop-difference iteration counts per candidate")
    p.add_argument("--reps", type=int, default=3)
    p.set_defaults(fn=cmd_plan_sweep)

    p = sub.add_parser("calibrate", help="calibrate activation scales")
    _add_common(p)
    p.add_argument("--images", required=True)
    p.add_argument("--limit", type=int, default=64)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_calibrate)
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = _parser()
    if argv and argv[0] in _LATER:
        ap.error(f"{argv[0]!r} is not ported yet (ROADMAP item "
                 f"{_LATER[argv[0]]})")
    args = ap.parse_args(argv)
    if args.mesh and tuple(int(v) for v in args.mesh.split(",")) != (1, 1):
        ap.error(f"--mesh {args.mesh}: the port runs on one device "
                 "(multi-device is ROADMAP item A14)")
    if args.sharding == "channel":
        ap.error("--sharding channel: multi-device is ROADMAP item A14")
    if getattr(args, "num_processes", None) and args.num_processes > 1:
        ap.error(f"--num-processes {args.num_processes}: several serving "
                 "processes are ROADMAP item A14")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
