"""Command line of the port: ``plan-sweep``.

Counterpart of ``dnn_inference_engine_tpu/cli.py``'s ``plan-sweep``
subcommand, with its flags and ``--device`` (default: the card; ``cpu``
runs the plain PyTorch versions):

    python -m dnn_inference_engine_tpu_torch.cli plan-sweep \
        --model yolov2-tiny --mode w8a8 --batch 8 --out s.json

The artifact feeds ``EngineConfig(strategy="s.json")``. The JAX CLI's
other subcommands are ROADMAP item A11.
"""

from __future__ import annotations

import argparse
import json
import sys

# the JAX CLI's subcommands that are not ported yet
_LATER = ("detect", "bench", "layer-times", "eval", "serve", "dump-goldens",
          "check-goldens", "trace", "calibrate")


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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(
        prog="dnn_inference_engine_tpu_torch.cli",
        epilog="not ported yet (ROADMAP item A11): " + ", ".join(_LATER))
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("plan-sweep",
                       help="measure per-layer kernel strategies, emit "
                            "the fastest as JSON")
    p.add_argument("--model", default="yolov2-tiny")
    p.add_argument("--mode", default="fp32", choices=["fp32", "w8", "w8a8"])
    p.add_argument("--weights", default=None,
                   help="weight file (ROADMAP item A4; not ported)")
    p.add_argument("--calib-images", default=None, metavar="DIR",
                   help="calibration images (ROADMAP item A11; not ported)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--input-size", type=int, default=None)
    p.add_argument("--out", default=None, help="write the artifact here")
    p.add_argument("--quick", action="store_true",
                   help="skip the long-shot candidates (gemm tier, "
                        "unpadded folds, rs kinds)")
    p.add_argument("--iters", default="60,10", metavar="HI,LO",
                   help="loop-difference iteration counts per candidate")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch versions)")
    p.set_defaults(fn=cmd_plan_sweep)
    if argv and argv[0] in _LATER:
        ap.error(f"{argv[0]!r} is not ported yet (ROADMAP item A11); the "
                 "port's CLI has plan-sweep")
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
