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
  python -m dnn_inference_engine_tpu_torch.cli layer-times --mode w8a8 --batch 32
  python -m dnn_inference_engine_tpu_torch.cli trace --mode w8a8 --detect --out t.json
  python -m dnn_inference_engine_tpu_torch.cli bench --mode w8a8 --batch 32

``layer-times`` with ``--device cpu`` times the plain versions on the
CPU (no percentages of the card); ``trace`` needs the card. ``bench``
prints ``bench.run_bench``'s one JSON line (the images/s of the mode's
forward at ``--batch``, the b1 detect's wall p50 and device time, the
fp32 baseline and ``vs_baseline``); on the CPU the card's fields are None.

A mesh runs one process a rank. Under torchrun every rank runs the same
command and rank 0 prints:

  torchrun --nproc-per-node 2 -m dnn_inference_engine_tpu_torch.cli detect
      --mesh 1,2 --sharding channel --mode w8a8 --image img.jpg   (one line)

(``--backend gloo`` where the ranks share a card, or on the CPU with
``--device cpu``). ``serve --num-processes N --process-id P --coordinator
host:port`` starts one rank of a serving mesh without torchrun: rank 0
serves HTTP, the others mirror its steps (runtime/serve_distributed.py).
``trace --mesh`` and ``layer-times --mesh`` run on every rank, each
timing its own shard; rank 0 prints its table and one line per rank.
``plan-sweep --mesh`` sweeps one device, as the JAX CLI's does: rank 0
sweeps its card while the other ranks wait.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


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
                   help="(data, model) mesh of DP*MP ranks, a process each "
                        "(torchrun, or serve --num-processes): the batch "
                        "split over data")
    p.add_argument("--sharding", default=None,
                   choices=["replicated", "channel"],
                   help="weight sharding for --mesh (channel, w8a8: the "
                        "heaviest conv pair split over model, its int32 "
                        "sums added across ranks)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend for a mesh (default: "
                        "NCCL when every rank has a card of its own, gloo "
                        "without a card; ranks that share a card need gloo)")
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
    """Serve HTTP on one device, or on a mesh: rank 0 serves HTTP through
    ``DistributedBatcher``, every other rank mirrors its steps in
    ``follower_loop`` and exits when the leader stops or is gone."""
    from dnn_inference_engine_tpu_torch.runtime.serve_distributed import (
        DistributedBatcher, follower_loop)
    eng = _build_engine(args)
    if eng.mesh is not None and eng.mesh.rank != 0:
        print(f"# follower rank {eng.mesh.rank}: serving lockstep steps "
              "(no HTTP)", flush=True)
        served = follower_loop(eng)
        print(f"# follower exiting after {served} batches", flush=True)
        return 0
    batcher = DistributedBatcher(eng).start()
    srv = batcher.serve_http(args.port)
    mesh = (f" mesh={tuple(eng.config.mesh_shape)} {eng.config.sharding}"
            if eng.mesh is not None else "")
    print(f"# serving {args.model} {args.mode}{mesh} on "
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


def cmd_bench(args) -> int:
    """``bench.run_bench`` on the flags' model, mode, tier and batch, on
    ``--device``; prints its JSON line (progress on stderr)."""
    from dnn_inference_engine_tpu_torch.bench import run_bench
    result = run_bench(model=args.model, mode=args.mode, kernel=args.kernel,
                       batch=args.batch, verbose=True, device=args.device,
                       input_size=args.input_size)
    print(json.dumps(result))
    return 0


def _iters(text):
    return tuple(int(v) for v in text.split(",")) if text else None


def _per_rank(eng, value: float, what: str) -> None:
    """On a mesh, one line a rank: its ``value`` (gathered over the world
    group; every rank calls this, rank 0 prints)."""
    if eng.mesh is None:
        return
    from dnn_inference_engine_tpu_torch.parallel.mesh import gather_floats
    for r, v in enumerate(gather_floats(value)):
        print(f"# rank {r}: {what} {v:.4f}")


def cmd_layer_times(args) -> int:
    """The W8A8 plan's stages (``Engine.stage_times``, with their
    roofline) where the engine runs one, else each conv of the generic
    forward (``Engine.layer_times``). On a mesh every rank times its
    shard; rank 0 prints its own rows and each rank's total."""
    eng = _build_engine(args)
    iters = _iters(args.iters)
    if eng._plan is not None and eng.config.mode == "w8a8":
        print(f"# per-stage steady-state times of the executed plan, "
              f"batch={args.batch}"
              + (" (auto-scaled iteration counts)" if iters is None else ""))
        print(f"{'stage':>5s} {'name':18s} {'ms':>9s} {'GOP':>8s} "
              f"{'GOPexec':>8s} {'MFU%':>7s} {'HWutil%':>8s} "
              f"{'HBM MB':>7s} {'bind':>4s} {'bind%':>7s} {'noise%':>7s}")
        total = 0.0
        for r in eng.stage_times(batch=args.batch, iters=iters):
            # None: under the resolution floor, or timed on the CPU
            na = "<res." if r["sub_resolution"] else "n/a"
            mfu = (f"{na:>7s}" if r["mfu_pct"] is None
                   else f"{r['mfu_pct']:7.2f}")
            hwu = (f"{na:>8s}" if r["hw_util_pct"] is None
                   else f"{r['hw_util_pct']:8.2f}")
            bnd = (f"{na:>7s}" if r["pct_of_binding"] is None
                   else f"{r['pct_of_binding']:7.2f}")
            sus = "  SUSPECT" if r["suspect"] else ""
            print(f"{r['stage']:5d} {r['name']:18s} {r['ms']:9.4f} "
                  f"{r['gop']:8.3f} {r['gop_exec']:8.3f} {mfu} {hwu} "
                  f"{r['hbm_mb']:7.2f} {r['binding']:>4s} {bnd} "
                  f"{r['noise_pct']:7.1f}{sus}")
            total += r["ms"]
        print(f"# TOTAL stages {total:.4f} ms")
        _per_rank(eng, total, "TOTAL stages ms")
        return 0
    print(f"# per-layer steady-state times, batch={args.batch}, "
          f"mode={args.mode}, kernel={args.kernel}")
    total = 0.0
    for name, t in eng.layer_times(batch=args.batch,
                                   **({"iters": iters} if iters else {})):
        print(f"{name:32s} {t * 1e6:10.1f} us")
        total += t
    print(f"{'TOTAL conv':32s} {total * 1e6:10.1f} us")
    _per_rank(eng, total * 1e6, "TOTAL conv us")
    return 0


def cmd_trace(args) -> int:
    """Trace the engine's forward (or, with ``--detect``, the detect:
    forward, decode and NMS) on the card and print the device time of
    each stage and postprocess scope (``trace_attribution``), with the
    host time inside it, then the host time of the other spans
    (``engine.*``, ``host.*``). On a mesh every rank traces its shard over
    as many runs; rank 0 prints its own scopes and each rank's module
    time, and writes ``--out``."""
    from dnn_inference_engine_tpu_torch.runtime.profiling import (
        trace_attribution)
    eng = _build_engine(args)
    x = eng._bench_rows(args.batch)
    fn = eng.detect_fn() if args.detect else eng._fwd
    art = trace_attribution(fn, x, runs=args.runs,
                            agree_ranks=eng.mesh is not None)
    print(f"# module device time {art['module_device_us_per_run']:.1f} us"
          f" over {art['runs_traced']} runs; ops sum "
          f"{art['sum_of_ops_us_per_run']:.1f} us")
    host = art["host_by_scope_us"]
    print(f"# {'device us':>10s}  {'host us':>10s}  scope")
    for k, v in art["by_scope_us"].items():
        h = f"{host[k]:10.2f}" if k in host else f"{'-':>10s}"
        print(f"{v:10.2f} us  {h} us  {k}")
    for k, h in host.items():
        if k not in art["by_scope_us"]:
            print(f"{'-':>10s} us  {h:10.2f} us  {k}")
    _per_rank(eng, art["module_device_us_per_run"], "module device us")
    if args.out and (eng.mesh is None or eng.mesh.rank == 0):
        with open(args.out, "w") as f:
            json.dump(art, f, indent=1)
        print(f"# wrote {args.out}")
    return 0


def cmd_plan_sweep(args) -> int:
    """Measure each conv layer's legal plan kinds and emit the fastest
    strategy as JSON. The sweep is single-device: with ``--mesh``, as
    the JAX CLI's, rank 0 sweeps its card and writes ``--out``, and the
    other ranks wait for it at a barrier."""
    import torch.distributed as dist
    from dnn_inference_engine_tpu_torch.runtime.plan_sweep import sweep
    try:
        if dist.is_initialized() and dist.get_rank() != 0:
            return 0
        iters = tuple(int(v) for v in args.iters.split(","))
        art = sweep(model_name=args.model, mode=args.mode, batch=args.batch,
                    input_size=args.input_size, quick=args.quick,
                    iters=iters, reps=args.reps, weights=args.weights,
                    calib=args.calib_images, device=args.device)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(art, f, indent=2)
            print(f"# wrote {args.out}")
        print(json.dumps({k: art[k] for k in
                          ("model", "mode", "batch", "input_size",
                           "backend", "device", "whole_net_ms",
                           "images_per_s", "strategy")}))
        return 0
    finally:
        if dist.is_initialized():
            dist.barrier()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dnn_inference_engine_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("detect", help="run detection on one image")
    _add_common(p)
    p.add_argument("--image", required=True)
    p.add_argument("--out", default=None, help="write annotated image here")
    p.set_defaults(fn=cmd_detect)

    p = sub.add_parser("bench", help="throughput/latency benchmark (one "
                       "device: not with --mesh)")
    _add_common(p)
    p.add_argument("--input-size", type=int, default=None)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("layer-times", help="per-stage (W8A8 plan) or "
                       "per-layer timing report; with --mesh, every rank "
                       "times its shard with rank 0's loop counts")
    _add_common(p)
    p.add_argument("--iters", default=None, metavar="HI,LO",
                   help="fixed loop-difference counts (quick but noisy); "
                        "default auto-scales per stage")
    p.set_defaults(fn=cmd_layer_times)

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
                   help="server processes, one a rank of --mesh (rank 0 "
                        "serves HTTP); default: torchrun's WORLD_SIZE")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (default: torchrun's RANK)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rank 0's address for the process group")
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
                            "the fastest as JSON; single-device: with "
                            "--mesh rank 0 sweeps its card, the other "
                            "ranks wait")
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

    p = sub.add_parser("trace",
                       help="per-scope device time of the forward on the "
                            "card (torch.profiler); with --mesh, every rank "
                            "traces its shard")
    _add_common(p)
    p.add_argument("--runs", type=int, default=30)
    p.add_argument("--detect", action="store_true",
                   help="trace the detect (forward + decode + NMS); the "
                        "postprocess shows as post_decode / nms_* scopes")
    p.add_argument("--out", default=None, metavar="JSON")
    p.set_defaults(fn=cmd_trace)

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
    args = ap.parse_args(argv)
    mesh = tuple(int(v) for v in args.mesh.split(",")) if args.mesh \
        else (1, 1)
    if len(mesh) != 2 or min(mesh) < 1:
        ap.error(f"--mesh {args.mesh}: give DP,MP, both >= 1")
    if args.cmd == "bench" and args.mesh:
        ap.error("bench times one device; scaling over ranks is "
                 "bench_all's config 5_scaling")
    n = getattr(args, "num_processes", None)
    if n and n > 1 and mesh[0] * mesh[1] != n:
        ap.error(f"--num-processes {n} needs a --mesh of {n} ranks")
    return _run(args, mesh)


def _run(args, mesh) -> int:
    """The command; on a mesh of several ranks, the process group is
    brought up first (from ``serve``'s process flags, else torchrun's
    environment) and taken down at the end, and every rank but 0 runs the
    command with its standard output silenced (but ``serve``, whose
    followers say what they do)."""
    import contextlib
    import io
    import torch.distributed as dist
    if mesh != (1, 1):
        from dnn_inference_engine_tpu_torch.parallel.mesh import (
            init_distributed)
        init_distributed(getattr(args, "coordinator", None),
                         getattr(args, "num_processes", None),
                         getattr(args, "process_id", None),
                         backend=args.backend)
    try:
        quiet = (args.cmd != "serve" and dist.is_initialized()
                 and dist.get_rank() != 0)
        with contextlib.redirect_stdout(io.StringIO()) if quiet \
                else contextlib.nullcontext():
            return args.fn(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
