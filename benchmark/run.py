"""Run one cell of the benchmark on the card and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` names the cells). The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the
reference beside its limit, also the last lines of standard error. The
card's name, power limit and clocks (read after the window, under load)
come before it. Without the cards the cell asks for, or where the
program is missing, or where the process loaded JAX or the JAX package,
it exits non-zero and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import numpy  # noqa: E402,F401
import torch  # noqa: E402,F401

T_LIBS = time.perf_counter()             # the program's import starts here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import spec
    cell = spec.cell(spec.load(), args.workload)
    # the program under test, beside the benchmark in the checkout
    import dnn_inference_engine_tpu_torch.runtime.engine  # noqa: F401
    t_prog = time.perf_counter()
    from benchmark import card
    try:
        card.require(cell.chips)
    except card.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    t_driver = time.perf_counter()
    card.open_contexts(cell.chips)
    t_context = time.perf_counter()
    print(f"start-up s: libraries {T_LIBS - T_PROCESS:.3f}, program "
          f"{t_prog - T_LIBS:.3f}, driver {t_driver - t_prog:.3f}, "
          f"context {t_context - t_driver:.3f}", file=sys.stderr)
    from benchmark import cell as cell_run
    # set-up counts the program's import and all after the card's context
    # is made: the libraries' import, the driver's start and the context
    # do no work of the program, and stall for seconds now and then
    t0 = T_LIBS + (t_context - t_prog)
    result = cell_run.run(cell, args.seed, args.seconds, bool(args.trace),
                          t0)
    card.print_card("after the window")
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
