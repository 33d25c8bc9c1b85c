"""Tracing and profiling on the card.

Counterpart of ``dnn_inference_engine_tpu/runtime/profiling.py``, in
PyTorch's idiom:

- ``scope`` and ``layer_scope``: the named scopes of the JAX package.
  The plans open ``stage{si}_{kind}_L{li}`` around each stage
  (runtime/plan.py), the generic forwards ``L{li}_conv`` around each
  conv (models/model.py), the decode and NMS ``post_decode`` and
  ``nms_*`` (postprocess.py). A scope is a
  ``torch.profiler.record_function`` range while a profiler runs and
  nothing otherwise: a range costs a few microseconds of host time, and
  the W8A8 forwards are short of host time already;
- ``trace``: a ``torch.profiler`` trace (CPU and CUDA) around any
  callable, written as a Chrome trace JSON (``chrome://tracing``,
  Perfetto);
- ``debug_checks``: NaN/Inf checks on every floating output of a torch
  op inside the context, as the JAX package's ``jax_debug_nans`` /
  ``jax_debug_infs``;
- ``trace_attribution``: the device time of a forward per stage scope,
  each kernel held to its launch counter (``device_breakdown`` does the
  same by kernel group);
- the launch counters of the port's kernels (``kernel_counters``,
  ``reset_counts``, ``read_counts``) and ``KERNEL_GROUPS``, which names
  the kernel group of a traced device event.

The JAX package's ``hlo_scope_map`` reads XLA's HLO text to find each
op's scope; PyTorch has no HLO, and ``trace_attribution`` reads the
enclosing ranges from the profiler's own event tree instead, so it has
no counterpart here.
"""

from __future__ import annotations

import collections
import contextlib
import os
import re
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

_NULL = contextlib.nullcontext()


def scope(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler runs; otherwise a context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def layer_scope(li: int, layer):
    """The scope of layer ``li``: ``L{li}_{type name, lower case}``."""
    return scope(f"L{li}_{type(layer).__name__.lower()}")


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def trace(out_dir: str, fn: Callable, *args, **kw):
    """Run ``fn(*args, **kw)`` under ``torch.profiler`` (CPU, and CUDA
    where there is a card), wait for the device, and write the trace to
    ``out_dir/trace_<time>_<pid>.json`` (Chrome trace format: open it in
    ``chrome://tracing`` or ui.perfetto.dev). Returns ``fn``'s result."""
    from torch.profiler import profile
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        out = fn(*args, **kw)
        _sync()
    path = os.path.join(out_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}"
                                 f"_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return out


class _NonFiniteCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` when a torch op's floating output
    holds a NaN (``nans``) or an infinity (``infs``)."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _pytree.tree_leaves(out):
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"Inf in the output of {func}")
        return out


@contextlib.contextmanager
def debug_checks(nans: bool = True, infs: bool = False):
    """Inside the context, every torch op whose floating output holds a
    NaN (with ``nans``) or an Inf (with ``infs``) raises
    ``FloatingPointError``, as the JAX package's ``jax_debug_nans`` and
    ``jax_debug_infs``. Each check reads the device (a sync per op), so
    this is for tests and CI, not for timing. The port's kernels write
    their outputs through ``ctypes``, unseen by PyTorch's dispatch: a NaN
    a kernel writes is caught at the next torch op that reads it."""
    with _NonFiniteCheck(nans, infs):
        yield


# ---------------------------------------------------------------------------
# launch counters and kernel groups
# ---------------------------------------------------------------------------

def kernel_counters() -> Dict[str, Callable]:
    """Each port kernel's name -> its wrapper, whose ``launches`` counts
    the kernel's launches."""
    from dnn_inference_engine_tpu_torch import postprocess as post
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops import fused_conv as fc
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    from dnn_inference_engine_tpu_torch.ops.attic import stage0, tail
    from dnn_inference_engine_tpu_torch.tools import probe_dma_rules as pr
    from dnn_inference_engine_tpu_torch.tools import proto_conv_dma as pc
    return {"gemm_fused": gm.gemm_fused, "gemm_f32": gm.gemm_f32,
            "stem_fused_k2": fc.stem_fused_k2,
            "shift_s2d2": fc.shift_s2d2, "stem_fused_dg": fc.stem_fused_dg,
            "quant_space_to_depth4": fc.quant_space_to_depth4,
            "gmax_shift_s2d2": fc.gmax_shift_s2d2,
            "conv3x3_rs": fc.conv3x3_rs,
            "stage0_fused": stage0.stage0_fused,
            "conv3x3_bt": tail.conv3x3_bt,
            "conv_dma": pc.conv_dma, "tma_probe": pr.probe,
            "conv_w8a8": cv.conv2d_w8a8, "conv_w8a8_rows": cv.conv_w8a8_rows,
            "nms_suppress": post.nms_suppress}


def reset_counts() -> None:
    """Sets every launch counter (and the wrappers' form counters) to 0."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    for fn in kernel_counters().values():
        fn.launches = 0
    cv.conv2d_w8a8.im2col_launches = 0
    cv.conv2d_w8a8.acc_launches = 0
    gm.gemm_fused.folded_launches = 0
    gm.gemm_fused.ragged_launches = 0
    gm.gemm_f32.ragged_launches = 0


def read_counts() -> Dict[str, int]:
    return {k: fn.launches for k, fn in kernel_counters().items()}


# (group, substring of the kernel's name); first match wins, so
# gmax_shift_s2d2 comes before shift_s2d2. The three stems are
# instantiations of one mainloop (csrc/stem_common.cuh), each under its own
# kernel name. The port's kernels come first, under their counters' names.
KERNEL_GROUPS = (("gemm_fused", "gemm_fused_kernel"),
                 ("gemm_f32", "gemm_f32_kernel"),
                 ("stem_fused_k2", "stem_k2_kernel"),
                 ("stem_fused_dg", "stem_dg_kernel"),
                 ("quant_space_to_depth4", "qs2d4_kernel"),
                 ("gmax_shift_s2d2", "gmax_shift_s2d2_kernel"),
                 ("conv3x3_rs", "conv_rs_kernel"),
                 ("stage0_fused", "stage0_kernel"),
                 ("conv3x3_bt", "conv_bt_kernel"),
                 ("conv_dma", "conv_dma_kernel"),
                 ("tma_probe", "tma_probe_kernel"),
                 ("conv_w8a8", "conv_patch_kernel"),
                 ("conv_w8a8", "conv_window_kernel"),
                 ("conv_w8a8", "conv_tap_kernel"),
                 ("conv_w8a8_rows", "conv_rows_kernel"),
                 ("shift_s2d2", "shift_s2d2_kernel"),
                 ("nms_suppress", "nms_suppress_kernel"),
                 ("im2col and route torch.cat", "CatArrayBatchedCopy"),
                 ("host-to-device copies", "Memcpy HtoD"),
                 # PyTorch's strided copies: im2col is one, of a window view
                 ("strided copies (im2col)", "direct_copy_kernel"),
                 # the layout transposes around cuDNN's convs (NHWC views
                 # in, NCHW kernels), then cuDNN's float convs (the fp32
                 # and w8 xla tiers), then PyTorch's elementwise passes
                 ("NCHW/NHWC transposes", "nchwToNhwc"),
                 ("NCHW/NHWC transposes", "nhwcToNchw"),
                 ("cuDNN conv", "conv"), ("cuDNN conv", "xmma"),
                 ("cuDNN conv", "fprop"), ("cuDNN conv", "winograd"),
                 ("cuDNN conv", "implicit"), ("cuDNN conv", "cudnn"),
                 ("torch elementwise", "elementwise_kernel"))


def kernel_group(name: str) -> str:
    """The ``KERNEL_GROUPS`` group of a device event's name, or "other"."""
    return next((g for g, key in KERNEL_GROUPS if key in name), "other")


def _lost_events(traced: Dict[str, int], launched: Dict[str, int]):
    """{kernel: (traced, launched)} where the trace holds another count
    of a port kernel than its launch counter."""
    return {k: (traced.get(k, 0), n) for k, n in launched.items()
            if traced.get(k, 0) != n}


def _retaking(take: Callable, what: str, tries: int = 3,
              agree_ranks: bool = False):
    """``take()`` -> (result, traced counts by group, launched counts),
    taken again while the trace lost kernel events (C4 in ROADMAP.md),
    at most ``tries`` times; then raises. With ``agree_ranks`` (every rank
    of the default process group calls this, as on a mesh) a trace lost on
    any rank is taken again on all of them (``parallel.mesh.any_rank``),
    so that the collectives inside ``take`` run as often on every rank."""
    for attempt in range(1, tries + 1):
        result, traced, launched = take()
        lost = _lost_events(traced, launched)
        retake = bool(lost)
        if agree_ranks:
            from dnn_inference_engine_tpu_torch.parallel.mesh import (
                any_rank)
            retake = any_rank(retake)
        if not retake:
            return result
        if lost:
            print(f"  trace {attempt} of {tries} lost kernel events over "
                  f"{what} (traced, launched): {lost}; all ops traced "
                  f"{sum(traced.values())}")
        else:
            print(f"  trace {attempt} of {tries} over {what} taken again: "
                  "another rank's trace lost kernel events")
    raise AssertionError(f"{tries} traces of {what} lost kernel events")


def device_breakdown(fn: Callable, reps: int = 5):
    """Device time and device operations per call by kernel group, from
    ``torch.profiler`` over ``reps`` calls: ({group: ms}, {group: ops}).
    The trace now and then lacks a run of one call's kernels, so it must
    hold every port kernel exactly as many times as its launch counter
    counted it: a trace that does not is printed, dropped and taken
    again, and the function raises after three such traces."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()

    def take():
        reset_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launched = read_counts()
        names = [g for g, _ in KERNEL_GROUPS] + ["other"]
        groups, ops = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
        for ev in prof.key_averages():
            if (ev.device_type != torch.autograd.DeviceType.CUDA
                    or getattr(ev, "is_user_annotation", False)):
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            group = kernel_group(ev.key)
            groups[group] += us / 1e3 / reps
            ops[group] += ev.count
        return ((groups, {g: n / reps for g, n in ops.items()}), ops,
                launched)
    return _retaking(take, f"{reps} calls")


# ---------------------------------------------------------------------------
# device time by scope
# ---------------------------------------------------------------------------

_STAGE_RE = re.compile(
    r"(stage\d+_[a-z0-9_]+?_L\d+(?:_fold\d+)?"
    r"|post_decode|nms_candidates|nms_suppress|nms_merge)")

# one device event: (kernel name, names of the CPU ranges enclosing its
# launch, innermost first, device microseconds)
Record = Tuple[str, Sequence[str], float]


def attribute(records: Iterable[Record], runs: int = 1) -> dict:
    """Device time per scope of ``records`` over ``runs`` runs: each
    event goes to the innermost enclosing range whose name matches a
    stage or postprocess scope (``_STAGE_RE``, the JAX package's), or to
    ``unattributed/<kernel group>``. Returns ``by_scope_us`` (per run,
    largest first), ``sum_of_ops_us_per_run`` (their sum) and
    ``top_ops`` (per kernel and scope, largest first)."""
    by_scope: Dict[str, float] = collections.Counter()
    per_op: Dict[Tuple[str, Optional[str]], List] = {}
    for name, chain, us in records:
        scope_name = next((m.group(1) for m in map(_STAGE_RE.search, chain)
                           if m), None)
        by_scope[scope_name or f"unattributed/{kernel_group(name)}"] += us
        row = per_op.setdefault((name, scope_name), [0.0, "/".join(
            reversed(chain))])
        row[0] += us
    rows = [{"op": name, "us": round(us / runs, 2),
             "group": kernel_group(name), "scope": sc,
             "op_name": path[:160]}
            for (name, sc), (us, path) in per_op.items()]
    rows.sort(key=lambda r: -r["us"])
    return {
        "sum_of_ops_us_per_run": round(sum(by_scope.values()) / runs, 2),
        "by_scope_us": {k: round(v / runs, 2)
                        for k, v in by_scope.most_common()},
        "top_ops": rows[:40],
    }


def device_records(events) -> Tuple[List[Record], List[Tuple[float, float]]]:
    """The device events (kernels, copies, sets) of a ``torch.profiler``
    event list as ``Record`` s, with their (start, end) spans in
    microseconds.

    A device event's launching call is found by its correlation id: the
    CUDA API call that launched it (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ...), a CPU event of the same id; the names of the CPU ranges enclosing that call (its
    ``cpu_parent`` chain) are the event's chain. Kineto links a kernel
    to the innermost ATen op around its launch, and the port's kernels
    are launched through ``ctypes`` with no ATen op around them: such a
    kernel is linked to no op, but its ``cudaLaunchKernel`` call is
    traced inside the range that made it (the CUDA runtime is linked
    statically into each kernel library, and CUPTI sees its calls all
    the same). The device-side copies of the ranges (user annotations on
    the device's timeline) are no device work and are skipped."""
    cpu = torch.autograd.DeviceType.CPU
    calls = {fe.id: fe for fe in events
             if fe.device_type == cpu and fe.name.startswith("cu")}
    records: List[Record] = []
    spans: List[Tuple[float, float]] = []
    for fe in events:
        if fe.device_type == cpu or getattr(fe, "is_user_annotation", False):
            continue
        chain = []
        call = calls.get(fe.id)
        op = call.cpu_parent if call is not None else None
        while op is not None:
            chain.append(op.name)
            op = op.cpu_parent
        start, end = fe.time_range.start, fe.time_range.end
        records.append((fe.name, tuple(chain), end - start))
        spans.append((start, end))
    return records, spans


def _busy_us(spans: Iterable[Tuple[float, float]]) -> float:
    """Microseconds covered by the union of the (start, end) spans."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def trace_attribution(fn: Callable, x: torch.Tensor, runs: int = 30,
                      agree_ranks: bool = False) -> dict:
    """Device time of ``fn(x)`` per stage scope, from ``torch.profiler``
    over ``runs`` calls after a warm-up: the keys of the JAX package's
    ``trace_attribution``. ``module_device_us_per_run``: the device busy
    time per run (the union of every kernel, copy and set's span);
    ``by_scope_us`` (``attribute``) sums to it where no two device events
    overlap. Each traced kernel count is held to its launch counter: a
    trace that lost kernel events is reported and taken again, at most 3
    times, then the function raises; with ``agree_ranks`` (on a mesh,
    where ``fn`` is this rank's shard and may hold collectives) every rank
    traces the same ``runs`` and retakes when any rank lost events. Needs
    the card (the CPU has no device timeline)."""
    if x.device.type != "cuda":
        raise RuntimeError(
            "trace_attribution needs the CUDA card: the profiler times "
            f"kernels on the device's timeline, and x is on {x.device} "
            "(run it on the H100)")
    from torch.profiler import profile

    fn(x)
    torch.cuda.synchronize()

    def take():
        reset_counts()
        with profile(activities=_activities()) as prof:
            for _ in range(runs):
                fn(x)
            torch.cuda.synchronize()
        launched = read_counts()
        records, spans = device_records(prof.events())
        traced = collections.Counter(kernel_group(r[0]) for r in records)
        art = attribute(records, runs)
        art["runs_traced"] = runs
        art["module_device_us_per_run"] = round(_busy_us(spans) / runs, 2)
        return art, traced, launched
    return _retaking(take, f"{runs} runs", agree_ranks=agree_ranks)
