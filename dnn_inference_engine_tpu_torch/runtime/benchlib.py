"""Steady-state timing by loop difference, wall clock, and the card's
roofline.

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

On a mesh every rank times its own shard, and a rank-local call may hold
a collective (the row-parallel conv's ``all_reduce``): each collective
must then run as many times on every rank, or the ranks wait on each
other forever. So with ``agree_ranks`` the auto-scaled loop counts are
rank 0's on every rank (``parallel.mesh.broadcast_ints``), broadcast
before any timed loop; the probes before them run the same counts (5
and 105) on every rank.

The roofline (``roofline_pct``, ``binding_bound_s``) takes the peaks of
NVIDIA's data sheets for the H100 variant the card's name gives
(``peaks``, ``tf32_peak``, ``f32_peak``), not the JAX package's TPU v5e
constants; the compute floor is the tensor cores' (``"tc"``), the
bandwidth floor the HBM's (``"hbm"``).

The card's own timers have no JAX counterpart (XLA times a whole
executable; the port runs eagerly, one launch at a time), and each
raises on any device but a CUDA card rather than time the CPU:

- ``device_ms``: one call's device time, the host's launch work hidden
  behind a spin kernel (a kernel's time);
- ``throughput_ms``: calls back to back between one pair of CUDA events,
  host gaps included (what a stream of batches gets);
- ``latency_ms``: each call from an idle card to its result (what one
  request waits);
- ``card_line`` and ``clocks``: the card's name and power limit, and its
  SM and memory clocks, from ``nvidia-smi``, to stand beside a number.
"""

from __future__ import annotations

import subprocess
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
                        max_iters: int = 2000,
                        agree_ranks: bool = False) -> dict:
    """Steady-state seconds per call of ``fn(*args)``, with spread.

    Without iteration counts, they are scaled so that the timed loop
    difference is about ``target_delta_s`` of work (a 5- and a 105-call
    probe first); with ``agree_ranks`` (every rank of the default process
    group calls this, as on a mesh), rank 0's counts on every rank.
    Returns::

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
        if agree_ranks:
            from dnn_inference_engine_tpu_torch.parallel.mesh import (
                broadcast_ints)
            iters_hi, iters_lo = broadcast_ints((iters_hi, iters_lo))
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
                  stat: str = "median", agree_ranks: bool = False) -> float:
    """Median (or min) steady-state seconds per call of ``fn``; 'min'
    approximates the uncontended speed on a shared host."""
    s = per_iter_time_stats(fn, args, iters_hi=iters_hi, iters_lo=iters_lo,
                            reps=reps, target_delta_s=target_delta_s,
                            max_iters=max_iters, agree_ranks=agree_ranks)
    return s["min"] if stat == "min" else s["median"]


def wall_time(fn: Callable, args: Sequence, reps: int = 5) -> float:
    """Median wall-clock seconds of one call, from the call to its result
    on the host (the device synced): what a single-image client waits."""
    dev = _device_of(args)

    def once():
        fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    once()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def peaks(name: str):
    """(dense int8 ops/s, HBM bytes/s) from NVIDIA's data sheets for the
    H100 variant the card's name gives (the SXM part for any other
    name)."""
    if "PCIe" in name:
        return 1513e12, 2.0e12
    if "NVL" in name:
        return 1671e12, 3.9e12
    return 1979e12, 3.35e12          # SXM


def f32_peak(name: str) -> float:
    """Float32 FMA operations/s outside the tensor cores (NVIDIA's data
    sheets), for the same variants as ``peaks``."""
    if "PCIe" in name:
        return 51e12
    if "NVL" in name:
        return 60e12
    return 67e12                     # SXM


def tf32_peak(name: str) -> float:
    """Dense TF32 tensor-core operations/s (NVIDIA's data sheets), for the
    same variants as ``peaks``."""
    if "PCIe" in name:
        return 378e12
    if "NVL" in name:
        return 417e12
    return 495e12                    # SXM


def device_peaks(device) -> tuple:
    """``peaks`` of the card ``device`` names; of the H100 SXM's data
    sheet for any other device (a CPU run times nothing of the card)."""
    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "")
    return peaks(name)


def roofline_pct(ops: float, seconds: float, peak: float) -> float:
    """``ops`` done in ``seconds`` as a percentage of ``peak`` ops/s."""
    return 100.0 * ops / seconds / peak


def binding_bound_s(ops: float, hbm_bytes: float, peak_ops: float,
                    hbm_bps: float):
    """(bound seconds, "tc" | "hbm"): the larger of the tensor cores'
    floor (``ops`` at ``peak_ops``) and the bandwidth floor (``hbm_bytes``
    at ``hbm_bps``), the binding roofline of work that must execute
    ``ops`` operations and move at least ``hbm_bytes``. ``bound /
    measured`` is then auditable against 100% for every stage, bandwidth
    bound or not."""
    t_tc = ops / peak_ops
    t_hbm = hbm_bytes / hbm_bps
    return (t_tc, "tc") if t_tc >= t_hbm else (t_hbm, "hbm")


# ---------------------------------------------------------------------------
# the card's timers and identity
# ---------------------------------------------------------------------------

def _card(on=None) -> torch.device:
    """The CUDA device of ``on`` (a tensor, a device or its name; None:
    the current card). Any other device raises: a CPU time is no measure
    of the card, and these timers never fall back to one."""
    if isinstance(on, torch.Tensor):
        on = on.device
    dev = torch.device("cuda" if on is None else on)
    if dev.type != "cuda":
        raise RuntimeError(f"the card's timers need a CUDA device, not "
                           f"{dev}: they time with CUDA events (use "
                           "per_iter_time or wall_time on the CPU)")
    if not torch.cuda.is_available():
        raise RuntimeError("the card's timers need a CUDA device and none "
                           "is available")
    return dev


def device_ms(fn: Callable, reps: int, device=None) -> float:
    """Median device time of ``reps`` calls of ``fn()`` after one warm-up:
    a spin kernel holds the card while the host queues every call, each
    between its own pair of CUDA events, so the host's launch work is
    hidden. ``device``: the card the calls run on (a tensor on it, a
    device or its name; default the current card)."""
    with torch.cuda.device(_card(device)):
        fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        torch.cuda._sleep(50_000_000)        # ~25-30 ms of clock cycles
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))


def throughput_ms(fn: Callable, reps: int, device=None) -> float:
    """Time per call of ``reps`` calls run back to back between one pair
    of CUDA events, from an idle card to the last result (host gaps and
    stalls included): what a stream of batches gets."""
    with torch.cuda.device(_card(device)):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps


def latency_ms(fn: Callable, reps: int, device=None) -> float:
    """Median of ``reps`` calls, each from an idle card to its result,
    between its own pair of CUDA events and synced before the next: what
    one request waits."""
    with torch.cuda.device(_card(device)):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def _smi(query: str, device=None) -> str:
    dev = _card(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         "-i", str(index)], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_line(device=None) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, for
    example "NVIDIA H100 80GB HBM3, 700.00 W": a card may be set below its
    maximum power and then runs slower under load."""
    return _smi("name,power.limit", device)


def clocks(device=None) -> dict:
    """The card's SM and memory clocks now, in MHz (``nvidia-smi
    --query-gpu=clocks.sm,clocks.mem``): {"sm_mhz": ..., "mem_mhz": ...}.
    An idle card idles its SM clock down, so read them right after the
    work they stand beside."""
    sm, mem = (int(v.split()[0]) for v in
               _smi("clocks.sm,clocks.mem", device).split(","))
    return {"sm_mhz": sm, "mem_mhz": mem}
