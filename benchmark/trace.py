"""From a ``torch.profiler`` trace of the window to the records that the
per-layer readers read.

A device event (kernel, copy, set) is found by its correlation id: the
CUDA runtime call that launched it is a CPU event of the same id, and
the names of the CPU ranges around that call (its ``cpu_parent`` chain,
innermost first) are the event's scopes. The engine's own kernels are
launched through ``ctypes`` with no PyTorch op around them; their launch
calls are traced inside the ranges that made them all the same. The
device-side copies of the ranges (user annotations) are no device work
and are left out.
"""

from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, Iterable, List, NamedTuple, Sequence, Tuple

import torch

# the engine's stage and postprocess scopes (runtime/plan.py,
# postprocess.py): stage{si}_{kind}_L{li}[_fold{f}], post_decode, nms_*
SCOPE_RE = re.compile(r"^(stage\d+_([a-z0-9_]+?)_L\d+(?:_fold\d+)?"
                      r"|post_decode|nms_candidates|nms_suppress|nms_merge)$")

# the harness's own ranges around each call into the engine
CALL, FORWARD, POSTPROCESS, TO_HOST = ("bench.call", "bench.forward",
                                       "bench.postprocess", "bench.to_host")


class DeviceEvent(NamedTuple):
    name: str
    scopes: Tuple[str, ...]      # enclosing CPU ranges, innermost first
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


class HostEvent(NamedTuple):
    name: str
    start_us: float
    end_us: float
    depth: int


def device_events(events) -> List[DeviceEvent]:
    cpu = torch.autograd.DeviceType.CPU
    calls = {fe.id: fe for fe in events
             if fe.device_type == cpu and fe.name.startswith("cu")}
    out = []
    for fe in events:
        if fe.device_type == cpu or getattr(fe, "is_user_annotation", False):
            continue
        chain, call = [], calls.get(fe.id)
        op = call.cpu_parent if call is not None else None
        while op is not None:
            chain.append(op.name)
            op = op.cpu_parent
        out.append(DeviceEvent(fe.name, tuple(chain), fe.time_range.start,
                               fe.time_range.end))
    return out


def host_events(events, thread: int) -> List[HostEvent]:
    """The CPU events of one thread, with their nesting depth."""
    cpu = torch.autograd.DeviceType.CPU
    out = []
    for fe in events:
        if fe.device_type != cpu or fe.thread != thread:
            continue
        depth, op = 0, fe.cpu_parent
        while op is not None:
            depth, op = depth + 1, op.cpu_parent
        out.append(HostEvent(fe.name, fe.time_range.start,
                             fe.time_range.end, depth))
    return out


def busy_spans(evs: Iterable[DeviceEvent]) -> List[Tuple[float, float]]:
    """The union of the events' spans, as sorted disjoint intervals."""
    merged: List[List[float]] = []
    for s, e in sorted((ev.start_us, ev.end_us) for ev in evs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def scope_of(ev: DeviceEvent):
    """(scope, stage kind or None) of the innermost engine scope around
    the event, or (None, None)."""
    for name in ev.scopes:
        m = SCOPE_RE.match(name)
        if m:
            return m.group(1), m.group(2)
    return None, None


def top_ops(evs: Sequence[DeviceEvent], n: int = 10) -> List[List]:
    """The ``n`` device operations (by name) that took most time: [[name,
    seconds], ...] over the traced window."""
    tot: Dict[str, float] = collections.Counter()
    for ev in evs:
        tot[ev.name[:120]] += ev.us / 1e6
    return [[k, v] for k, v in tot.most_common(n)]


def idle_gaps(spans: Sequence[Tuple[float, float]], window: Tuple[float,
              float], hosts: Sequence[HostEvent], n: int = 10) -> List[List]:
    """The device's idle time in ``window`` (its start and end, us),
    summed by what the host was doing at each gap's middle: the innermost
    CPU event of the traced thread there, named with the harness or
    engine range around it. [[name, seconds], ...], the ``n`` largest."""
    lo, hi = window
    gaps, prev = [], lo
    for s, e in spans:
        if s > prev:
            gaps.append((prev, min(s, hi)))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    hosts = sorted(hosts, key=lambda h: h.start_us)
    starts = [h.start_us for h in hosts]
    tot: Dict[str, float] = collections.Counter()
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        i = bisect.bisect_right(starts, mid)
        # the covering events end after mid; the deepest is innermost
        cover = [h for h in hosts[max(0, i - 400):i] if h.end_us >= mid]
        tot[_host_label(cover)] += (g1 - g0) / 1e6
    return [[k, v] for k, v in tot.most_common(n)]


def _host_label(cover: Sequence[HostEvent]) -> str:
    if not cover:
        return "host outside any traced op"
    cover = sorted(cover, key=lambda h: h.depth)
    inner = cover[-1].name
    ranges = [h.name for h in cover if h.name.startswith("bench.")
              or SCOPE_RE.match(h.name)]
    return f"{ranges[-1]} > {inner}" if ranges and ranges[-1] != inner \
        else inner
