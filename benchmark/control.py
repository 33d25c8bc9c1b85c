"""The readings that a cell's limits are set from, for many seeds in one
process. Not part of a benchmark run.

- ``--side control`` (the upper readings): the reference computed a step
  of precision below the configuration's (int4: qmax 7 for weights and
  activations) put in the program's place, judged by the same numbers
  against the int8 reference. It has to come out not correct.
- ``--side decode16`` (detection cells; the upper readings of the
  detections' own numbers): the int8 reference in the program's place
  with its decode computed in float16, a step below the float32 that the
  engine's decode runs in. It has to come out not correct too.
- ``--side program`` (the lower readings): a run of the cell at its own
  sizes and load with a short window (``--seconds``), judged as a run
  judges it.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 \
        [--side control|decode16|program] [--seconds 2]

prints one JSON line a seed with each number, and whether the cell's
limits pass it. Runs on the card at the cell's sizes.
"""

from __future__ import annotations

import argparse
import importlib
import json
import time
from typing import Dict, Optional

import torch

from benchmark import families, inputs, judge, spec

INT4 = 7.0                       # qmax of the control


@torch.no_grad()
def readings(cell: spec.Cell, seed: int, device,
             sizes: Optional[Dict] = None,
             side: str = "control") -> Dict[str, float]:
    """The numbers of a run whose program is the reference in int4
    (``side`` "control") or with a float16 decode ("decode16")."""
    cfg, traffic = cell.config, cell.traffic
    sz = {"input_size": cfg["input_size"], "batch": traffic["batch"],
          "pool_batches": traffic["pool_batches"], **(sizes or {})}
    size = sz["input_size"]
    task = importlib.import_module(f"benchmark.tasks.{cfg['task']}")
    pool = inputs.pool(cfg, seed, device, size, sz["batch"],
                       sz["pool_batches"])
    calib = inputs.calib_images(cfg, seed, device, size)
    params = inputs.weights(cfg, seed, device, calib)
    family = families.of(cfg)
    ref = family.reference(cfg, params, judge.INT8)
    ref.calibrate(calib)
    low, decode = ref, torch.float16
    if side == "control":
        low, decode = family.reference(cfg, params, INT4), torch.float32
        low.calibrate(calib)
    numbers = judge.weight_numbers(low.qparams, ref.qparams, low.scales,
                                   ref.scales)
    gaps = []
    for x in pool:
        h_ref = ref.forward(x)
        h_low = h_ref if low is ref else low.forward(x)
        gaps.append(judge.head_gap(h_low, h_ref))
        out = task.reference_outputs(h_low, cfg, traffic, size, decode)
        host = (tuple(t.cpu().numpy() for t in out) if isinstance(out, tuple)
                else out.cpu().numpy())
        for name, v in task.compare(
                host, task.reference_outputs(h_ref, cfg, traffic,
                                             size)).items():
            prev = numbers.get(name, 0.0)
            numbers[name] = (prev + v if task.COMBINE[name] == "sum"
                             else max(prev, v))
    numbers["head_gap"] = max(gaps)
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--side", choices=("control", "decode16", "program"),
                   default="control")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(spec.load(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.side != "program":
            numbers = readings(cell, seed, "cuda", side=args.side)
        else:
            from benchmark import cell as cell_run
            r = cell_run.run(cell, seed, args.seconds, False,
                             time.perf_counter())
            numbers = {k: v["value"] for k, v in r["checks"].items()}
        ok, _ = judge.verdict(numbers, cell.limits)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "side": args.side, "passes_limits": ok,
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
