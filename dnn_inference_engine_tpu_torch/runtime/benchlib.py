"""Steady-state timing by loop difference.

Counterpart of ``dnn_inference_engine_tpu/runtime/benchlib.py``
(``per_iter_time_stats``, ``per_iter_time``), with the same contract: two
back-to-back loops of ``iters_lo`` and ``iters_hi`` calls each run from an
idle device to their last result; the per-call time is the difference of
their times over ``iters_hi - iters_lo``, so the constant costs (the
first launch, the final sync) cancel; the result is the min or median of
``reps`` such differences. On the card the loops are timed with CUDA
events after a sync, on the CPU with ``time.perf_counter``.

The JAX version chains each iteration's input to the last one's output
so that XLA can neither hoist the body out of its loop nor overlap
iterations. PyTorch runs eagerly and hoists nothing, so the calls here
are plain repeated calls.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _loop_s(fn: Callable, args: Sequence, n: int, dev: torch.device) -> float:
    """Seconds for ``n`` back-to-back calls, from an idle device to the
    last result."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    return time.perf_counter() - t0


def per_iter_time_stats(fn: Callable, args: Sequence, iters_hi: int = 0,
                        iters_lo: int = 0, reps: int = 3,
                        target_delta_s: float = 0.12,
                        max_iters: int = 2000) -> dict:
    """Steady-state seconds per call of ``fn(*args)``, with spread.

    Without iteration counts, they are scaled so that the timed loop
    difference is about ``target_delta_s`` of work (a 5- and a 105-call
    probe first). Returns::

        {"min": s, "median": s, "spread_pct": 100*(max-min)/min,
         "iters": (hi, lo), "delta_work_s": min * (hi - lo)}
    """
    dev = _device_of(args)
    fn(*args)                                       # warm-up
    if not iters_hi:
        t_lo = _loop_s(fn, args, 5, dev)
        t_hi = _loop_s(fn, args, 105, dev)
        est = max((t_hi - t_lo) / 100, 2e-7)
        delta_iters = int(min(max(100, target_delta_s / est), max_iters))
        iters_lo = max(delta_iters // 10, 2)
        iters_hi = iters_lo + delta_iters
    deltas = []
    for _ in range(reps):
        t_lo = _loop_s(fn, args, iters_lo, dev)
        t_hi = _loop_s(fn, args, iters_hi, dev)
        deltas.append((t_hi - t_lo) / (iters_hi - iters_lo))
    t_min = float(max(np.min(deltas), 1e-12))
    return {
        "min": t_min,
        "median": float(np.median(deltas)),
        "spread_pct": float(100.0 * (np.max(deltas) - t_min) / t_min),
        "iters": (iters_hi, iters_lo),
        "delta_work_s": t_min * (iters_hi - iters_lo),
    }


def per_iter_time(fn: Callable, args: Sequence, iters_hi: int = 0,
                  iters_lo: int = 0, reps: int = 3,
                  target_delta_s: float = 0.12, max_iters: int = 2000,
                  stat: str = "median") -> float:
    """Median (or min) steady-state seconds per call of ``fn``; 'min'
    approximates the uncontended speed on a shared host."""
    s = per_iter_time_stats(fn, args, iters_hi=iters_hi, iters_lo=iters_lo,
                            reps=reps, target_delta_s=target_delta_s,
                            max_iters=max_iters)
    return s["min"] if stat == "min" else s["median"]
