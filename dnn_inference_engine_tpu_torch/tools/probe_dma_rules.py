"""Probe the copy engine's rules on an NVIDIA Hopper card: which int8
tensor maps and boxes does TMA accept, and does the box it copies equal
the slice?

Counterpart of the JAX repo's ``tools/probe_dma_rules.py``, which asks
which (offset, extent) slices Mosaic accepts for a VMEM->VMEM DMA on a
TPU. The port's copy engine is TMA, global -> shared memory, fed by a
tensor map that ``cuTensorMapEncodeTiled`` encodes on the host. Each case
encodes a map (the encode's verdict); where the encode accepts it, one
block copies the box into shared memory through an ``mbarrier`` and
writes it out (``csrc/tma_probe.cu``), and the box must equal
``probe_plain``: the slice, with zeros where the box leaves the source.
``tma_box_legal`` writes the documented rules down, and the encode's
verdict must equal it case by case. ``proto_conv_dma`` relies on the
rules for its halo and its padded rows.

    python -m dnn_inference_engine_tpu_torch.tools.probe_dma_rules [--device cpu]

prints one line per case and exits non-zero on any mismatch. On the CPU
the verdict is ``tma_box_legal``'s and the box ``probe_plain``'s.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dnn_inference_engine_tpu_torch.ops import _build
from dnn_inference_engine_tpu_torch.runtime.engine import resolve_device
from dnn_inference_engine_tpu_torch.runtime.profiling import launch_span

MAX_BOX = 256                   # elements of a box, in each dimension
SMEM_LIMIT = 232_448            # bytes of shared memory a block can use
CUDA_SUCCESS = 0


class Case(NamedTuple):
    """A source tensor and the box to copy from it, outermost dimension
    first (numpy order); ``start`` may leave the source on either side.
    ``base_offset`` shifts the source's first byte off the allocation's
    16-byte alignment."""
    name: str
    shape: Tuple[int, ...]
    start: Tuple[int, ...]
    box: Tuple[int, ...]
    base_offset: int = 0


CASES = [
    # The JAX probe's nine (its pl.ds(start, size) per dimension). Its 2-D
    # cases have a 1152- and a 1280-byte inner extent, above TMA's 256.
    Case("lead-off1", (16, 16, 128), (1, 0, 0), (8, 16, 128)),
    Case("sub-off1-ext8", (16, 16, 128), (0, 1, 0), (8, 8, 128)),
    Case("sub-off0-ext8", (16, 16, 128), (0, 0, 0), (8, 8, 128)),
    Case("sub-ext13", (16, 16, 128), (0, 0, 0), (8, 13, 128)),
    Case("lane-off128", (16, 16, 256), (0, 0, 128), (8, 16, 128)),
    Case("lane-off64", (16, 16, 256), (0, 0, 64), (8, 16, 128)),
    Case("lane-ext64", (16, 16, 256), (0, 0, 0), (8, 16, 64)),
    Case("2d-sub-off1", (64, 1280), (1, 0), (8, 1280)),
    Case("2d-sub-off2e8", (64, 1280), (2, 128), (8, 1152)),
    # One case per rule of tma_box_legal.
    Case("inner-8B", (16, 16, 128), (0, 0, 0), (8, 16, 8)),
    Case("box-257", (300, 16), (0, 0), (257, 16)),
    Case("base+1", (16, 16, 128), (0, 0, 0), (8, 16, 128), base_offset=1),
    Case("stride-100", (16, 100), (0, 0), (8, 64)),
    Case("oob-neg1", (16, 16, 128), (-1, -1, 0), (8, 16, 128)),
    Case("oob-past-end", (16, 16, 128), (12, 8, 64), (8, 16, 128)),
    Case("rank1-past-end", (1024,), (896,), (256,)),
    Case("rank5", (2, 3, 4, 5, 32), (0, 1, 0, 2, 0), (2, 2, 4, 3, 32)),
    # proto_conv_dma's tap box: (N, H, W, Cin) from column -1, rows
    # padded from 64 to 80 bytes by the zero fill past Cin.
    Case("conv-halo", (2, 8, 104, 64), (1, 3, -1, 0), (1, 2, 104, 80)),
]


def tma_box_legal(shape: Sequence[int], strides: Sequence[int],
                  box: Sequence[int], base_offset: int,
                  swizzle: int = 0) -> Tuple[bool, str]:
    """The documented rules of ``cuTensorMapEncodeTiled`` for an int8
    tensor (no interleave): ``(legal, the first rule broken, or "")``.
    ``shape``, ``strides`` (bytes) and ``box`` are outermost first; the
    innermost stride is 1. ``base_offset`` is the source address modulo
    16. ``swizzle``: the shared-memory swizzle's span in bytes (32, 64 or
    128; 0 for none), which the box's inner extent may not exceed.
    Coordinates are unconstrained: box elements outside the source read as
    zeros."""
    rank = len(shape)
    if not 1 <= rank <= 5:
        return False, f"rank {rank} is not 1-5"
    if base_offset % 16:
        return False, f"global address is {base_offset % 16} bytes off " \
                      f"16-byte alignment"
    for d in shape:
        if not 1 <= d <= 2 ** 32:
            return False, f"dimension {d} is not 1..2^32"
    for s in strides[:-1]:
        if s % 16 or s >= 2 ** 40:
            return False, f"global stride {s} bytes is not a multiple of " \
                          f"16 below 2^40"
    for b in box:
        if not 1 <= b <= MAX_BOX:
            return False, f"box extent {b} is not 1..{MAX_BOX}"
    if box[-1] % 16:
        return False, f"the box's inner extent is {box[-1]} bytes, not a " \
                      f"multiple of 16"
    if swizzle not in (0, 32, 64, 128):
        return False, f"swizzle span {swizzle} is not 0, 32, 64 or 128"
    if swizzle and box[-1] > swizzle:
        return False, f"the box's inner extent is {box[-1]} bytes, above " \
                      f"the {swizzle}-byte swizzle span"
    return True, ""


def probe_plain(src: torch.Tensor, start: Sequence[int],
                box: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of ``probe``'s copy: the box of ``src`` at
    ``start`` (outermost first), zeros where it leaves ``src``."""
    out = torch.zeros(tuple(box), dtype=src.dtype, device=src.device)
    take, put = [], []
    for s, b, n in zip(start, box, src.shape):
        lo, hi = max(s, 0), min(s + b, n)
        if hi <= lo:
            return out
        take.append(slice(lo, hi))
        put.append(slice(lo - s, hi - s))
    out[tuple(put)] = src[tuple(take)]
    return out


class Verdict(NamedTuple):
    accepted: bool              # the encode's (on the CPU: the rules')
    cu_result: Optional[int]    # CUresult of the encode (None on the CPU)
    out: Optional[torch.Tensor]  # the copied box where it was launched


def _layout(src: torch.Tensor):
    """(shape, byte strides, base offset) of an int8 source."""
    if src.dtype != torch.int8 or not 1 <= src.ndim <= 5:
        raise TypeError(f"probe takes an int8 tensor of rank 1-5, got "
                        f"{src.dtype} of rank {src.ndim}")
    if src.stride(-1) != 1:
        raise ValueError(f"probe: the innermost dimension must be dense, "
                         f"got strides {src.stride()}")
    return tuple(src.shape), tuple(src.stride()), src.data_ptr() % 16


def _inner(seq, ctype):
    """A ctypes array of five, ``seq`` innermost first."""
    return (ctype * 5)(*reversed(seq))


@launch_span("tma_probe")
def probe(src: torch.Tensor, start: Sequence[int],
          box: Sequence[int]) -> Verdict:
    """Encode a TMA tensor map of ``src`` with ``box``; if the encode
    accepts it and ``tma_box_legal`` agrees, copy the box at ``start``
    (outermost first, any int32 coordinates) through shared memory.

    The copy is launched only where the rules and the encode both accept,
    so that no case can fault the card; a case they disagree on comes back
    accepted with no box. One device-side rule the encode does not check
    is refused here, on every device: a box may leave an inner dimension
    only if its bytes are a multiple of 16 (on an H100 a copy that leaves
    a 1000-byte one faults). A CPU tensor takes the rules' verdict and the
    plain copy."""
    shape, strides, offset = _layout(src)
    if len(start) != len(shape) or len(box) != len(shape):
        raise ValueError(f"probe: start {start} and box {box} need one "
                         f"entry per dimension of {shape}")
    legal, _ = tma_box_legal(shape, strides, box, offset)
    if legal and shape[-1] % 16 and not 0 <= start[-1] <= \
            start[-1] + box[-1] <= shape[-1]:
        raise ValueError(
            f"probe: the box leaves an inner dimension of {shape[-1]} bytes, "
            f"not a multiple of 16: the encode accepts such a map, but the "
            f"copy faults the card (an illegal instruction)")
    if src.device.type == "cpu":
        return Verdict(legal, None,
                       probe_plain(src, start, box) if legal else None)
    if src.device.type != "cuda":
        raise ValueError(f"probe: unsupported device {src.device}")
    nbytes = int(np.prod(box))
    if legal and (nbytes + 128 + 8 > SMEM_LIMIT):
        raise ValueError(f"probe: a {nbytes}-byte box does not fit one "
                         f"block's shared memory")
    out = torch.empty(tuple(box), dtype=torch.int8, device=src.device) \
        if legal else None
    cu = ctypes.c_int(-1)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("tma_probe", "tma_probe",
                         [p, i, p, p, p, p, i, p, p, p])
    err = fn(src.data_ptr(), len(shape), _inner(shape, ctypes.c_longlong),
             _inner(strides[:-1], ctypes.c_longlong),
             _inner(box, ctypes.c_int), _inner(start, ctypes.c_int),
             int(legal),
             out.data_ptr() if legal else None, ctypes.byref(cu),
             _build.stream_ptr(src.device))
    accepted = cu.value == CUDA_SUCCESS
    if accepted and legal:
        probe.launches += 1
        _build.check(err, "tma_probe")
        return Verdict(True, cu.value, out)
    return Verdict(accepted, cu.value, None)


probe.launches = 0


def case_source(case: Case, device, seed: int = 0) -> torch.Tensor:
    """The case's int8 source, seeded random codes, ``base_offset`` bytes
    into its allocation."""
    n = int(np.prod(case.shape))
    codes = np.random.default_rng(seed).integers(-128, 128, n + 16,
                                                 dtype=np.int8)
    flat = torch.from_numpy(codes).to(device, copy=True)
    return flat[case.base_offset:case.base_offset + n].view(case.shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' takes "
                         "the rules' verdicts and the plain copy)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    bad = []
    for case in CASES:
        src = case_source(case, dev)
        shape, strides, offset = _layout(src)
        legal, why = tma_box_legal(shape, strides, case.box, offset)
        v = probe(src, case.start, case.box)
        res = "rules" if v.cu_result is None else f"CUresult {v.cu_result}"
        if v.accepted != legal:
            said = "accepts" if v.accepted else "refuses"
            bad.append(f"{case.name}: the encode {said}, the rules say "
                       f"{why or 'legal'}")
            print(f"MISM  {case.name}  {res}  rules: {why or 'legal'}",
                  flush=True)
        elif v.accepted:
            exact = torch.equal(v.out, probe_plain(src, case.start,
                                                   case.box))
            if not exact:
                bad.append(f"{case.name}: box != slice")
            print(f"OK    {case.name}  exact={exact}  {res}", flush=True)
        else:
            print(f"REJ   {case.name}  {res}  ({why})", flush=True)
    if bad:
        raise AssertionError("probe_dma_rules: " + "; ".join(bad))
    return 0


if __name__ == "__main__":
    sys.exit(main())
