"""Prototype: 3x3 int8 conv whose implicit-im2col matrix the copy engine
assembles (+ the fused pool-major group-max).

Counterpart of the JAX repo's ``tools/proto_conv_dma.py``, which asks
whether the TPU's DMA engines, rather than its vector unit, can build the
A matrix of ``conv3x3_rs``. On an NVIDIA Hopper card the copy engine is
TMA: ``conv_dma`` (``csrc/conv_dma.cu``) copies each tap of a tile of
output pixels as one box straight from x into ``wgmma``'s swizzled
operand layout, the SAME halo zero-filled by the copy engine, and
multiplies it against the weights (resident where they fit) on the
Hopper int8 mainloop; ``conv_dma_form`` says how it launches.

It computes ``conv3x3_rs(x, w, scale4, bias4, pool=("gmaxm", 2, go))``
with scale and bias tiled 4x: the int32 3x3 SAME conv, the max over the
4 pool groups of ``go`` channels, then ``leaky(m*scale + bias)`` rounded
half to even and clipped to +-127. ``main`` runs it at the conv2-fold
shape (32,104,104,64) -> 128 with go 32 (S2's L2 ``rs`` stage) for each
``ht``, with ``conv3x3_rs`` on the same inputs beside it:

    python -m dnn_inference_engine_tpu_torch.tools.proto_conv_dma [--device cpu] [--batch N]

one line ``<us> us  exact=<bool>  <name>`` per variant; any inexact
variant makes it raise (exit non-zero). The JAX variant ``aligned`` only
spaced the tap blocks at 128-lane offsets and has no counterpart here.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from typing import NamedTuple

import numpy as np
import torch

from dnn_inference_engine_tpu_torch.ops import _build
from dnn_inference_engine_tpu_torch.ops.activations import apply_activation
from dnn_inference_engine_tpu_torch.ops.fused_conv import (
    _pad_hw, conv3x3_rs, rs_tile_matrix)
from dnn_inference_engine_tpu_torch.ops.gemm import H100_SMS, int32_acc_plain
from dnn_inference_engine_tpu_torch.runtime.benchlib import per_iter_time
from dnn_inference_engine_tpu_torch.runtime.engine import resolve_device
from dnn_inference_engine_tpu_torch.tools.probe_dma_rules import (
    MAX_BOX, tma_box_legal)

N, H, W, CIN, COUT = 32, 104, 104, 64, 128
GO = 32          # gmax output channels (pool-major f=2)
HTS = (13, 26, 8)
TR, TC = 16, 8   # a tile's output rows and columns (csrc/conv_dma.cu): the
                 # ht of the JAX tool does not shape them
BN = 128         # accumulator columns of a tile (4 pool groups x 32)
# A ring stages by (bytes of Cin a step, B resident): csrc/conv_dma.cu Cfg
STAGES = {(64, True): 12, (128, True): 3, (128, False): 3}


class DmaForm(NamedTuple):
    """How ``conv_dma`` launches on tiles of TR x TC output pixels of one
    image by 128 accumulator columns: ``kb`` bytes of Cin a step (the
    boxes' inner extent and their swizzle), ``steps`` steps a tile (3 tap
    rows x ceil(Cin / kb): one patch box of x each); B ``resident`` or
    streamed with the patches; the ring of ``stages`` stages; ``smem``
    bytes of shared memory; ``units`` tiles in all (pixel tiles x column
    blocks) over ``grid`` persistent blocks."""
    kb: int
    steps: int
    resident: bool
    stages: int
    smem: int
    units: int
    grid: int


def conv_dma_form(n: int, h: int, w: int, cin: int, go: int,
                  sms: int = H100_SMS) -> DmaForm:
    """The launch of ``conv_dma`` on an (n, h, w, cin) input with ``go``
    channels a pool group: 64-byte steps up to Cin 64, else 128; B
    resident where one column block of it (9 taps x 128 x kb bytes a step
    of a tap) fits, that is Cin <= 128, else streamed: each step's three
    taps of it with the step's patch."""
    kb = 64 if cin <= 64 else 128
    kc = -(-cin // kb)
    resident = kc == 1
    stages = STAGES[kb, resident]
    stage = TR * (TC + 2) * kb + (0 if resident else 3 * BN * kb)
    smem = (1024 + (9 * kc * BN * kb if resident else 0) + stages * stage
            + (2 * stages + 4) * 8)
    units = (n * -(-h // TR) * -(-w // TC)) * -(-go // 32)
    return DmaForm(kb, 3 * kc, resident, stages, smem, units,
                   min(units, sms))


def conv_dma_maps(x_shape, x_strides, go: int, f: DmaForm):
    """The two tensor maps the kernel encodes, as (shape, strides, box)
    outermost first: x (N, H, W, Cin) by patch boxes (a tile's rows by
    its columns and the two halo columns, kb bytes), and the
    (ceil(go/32)*128, 9*Cin) tile matrix of B by boxes of 128 rows and kb
    bytes."""
    cin = x_shape[3]
    rows = -(-go // 32) * BN
    return [(tuple(x_shape), tuple(x_strides), (1, TR, TC + 2, f.kb)),
            ((rows, 9 * cin), (9 * cin, 1), (BN, f.kb))]


def _check(x, w, scale, bias) -> int:
    """The contract's shapes and types; returns go."""
    if x.dtype != torch.int8 or w.dtype != torch.int8 or x.ndim != 4:
        raise TypeError(f"conv_dma takes int8 x (N,H,W,Cin) and w, got "
                        f"{x.dtype} {tuple(x.shape)} and {w.dtype}")
    cin = int(x.shape[3])
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"conv_dma: w must be (3,3,{cin},Cout), got "
                         f"{tuple(w.shape)}")
    cout = int(w.shape[3])
    go = int(scale.shape[0]) if scale.ndim == 1 else -1
    if cout != 4 * go:
        raise ValueError(f"conv_dma: Cout ({cout}) must be 4 x go, the "
                         f"length of scale ({tuple(scale.shape)})")
    for arg, v in (("scale", scale), ("bias", bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (go,):
            raise ValueError(f"conv_dma: {arg} must be float32 ({go},), got "
                             f"{v.dtype} {tuple(v.shape)}")
    return go


def _card_check(x, go, ht):
    """What the card kernel does not take, refused on every device;
    returns its form."""
    n, h, wd, cin = x.shape
    if cin % 16 or cin > MAX_BOX:
        raise ValueError(f"conv_dma: Cin must be a multiple of 16 up to "
                         f"{MAX_BOX} (two 128-byte steps a tap), got {cin}")
    if wd > MAX_BOX:
        raise ValueError(f"conv_dma: W must be at most {MAX_BOX}, got {wd}")
    if ht < 1:
        raise ValueError(f"conv_dma: ht must be >= 1, got {ht}")
    return conv_dma_form(n, h, wd, cin, go)


def conv_dma_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``conv_dma``: im2col of the zero-padded
    input, the exact int32 product, the max over the 4 pool groups, then
    the epilogue."""
    go = _check(x, w, scale, bias)
    n, h, wd, cin = x.shape
    xp = _pad_hw(x, 1, 1, 1, 1)
    a = torch.cat([xp[:, dh:dh + h, dw:dw + wd]
                   for dh in range(3) for dw in range(3)], dim=-1)
    acc = int32_acc_plain(a.reshape(-1, 9 * cin), w.reshape(9 * cin, -1).T)
    m = acc.reshape(-1, 4, go).amax(dim=1)
    y = apply_activation(m.to(torch.float32) * scale + bias, "leaky")
    y = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return y.reshape(n, h, wd, go)


def conv_dma(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor, ht: int = 13) -> torch.Tensor:
    """3x3/s1/SAME int8 conv + pool-major group-max + leaky + requant.

    x: (N, H, W, Cin) int8; w: (3, 3, Cin, 4*go) int8; scale, bias: (go,)
    float32. Returns (N, H, W, go) int8. ``ht``: output rows of a band
    of the JAX tool (any H; the last band may be short), checked and the
    same codes for every value; the card kernel's tiles do not depend on
    it (``conv_dma_form``). The card kernel reads w as ``rs_tile_matrix(w,
    go)`` (made once, cached on w) and takes Cin % 16 == 0 up to 256 and
    W up to 256: refused on every device, by name."""
    go = _check(x, w, scale, bias)
    f = _card_check(x, go, ht)
    if x.device.type == "cpu":
        return conv_dma_plain(x, w, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv_dma: the kernel needs CUDA tensors, got "
                         f"{x.device}")
    f = f._replace(grid=min(f.units, _build.sm_count(x.device)))
    if any(t.device != x.device for t in (w, scale, bias)):
        raise ValueError("conv_dma: all operands on one device")
    x = x.contiguous()
    if x.data_ptr() % 16:                 # the tensor map's base address
        x = x.clone()
    n, h, wd, cin = x.shape
    wt = rs_tile_matrix(w, go)
    for shape, strides, box in conv_dma_maps(x.shape, x.stride(), go, f):
        legal, why = tma_box_legal(shape, strides, box, 0, swizzle=f.kb)
        if not legal:
            raise ValueError(f"conv_dma: a tensor map breaks a TMA rule: "
                             f"{why}")
    scale, bias = scale.contiguous(), bias.contiguous()
    out = torch.empty((n, h, wd, go), dtype=torch.int8, device=x.device)
    cu = ctypes.c_int(-1)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("conv_dma", "conv_dma",
                         [p, p, p, p, p] + [i] * 7 + [p, p])
    err = fn(x.data_ptr(), wt.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             out.data_ptr(), n, h, wd, cin, go, f.kb, f.grid,
             ctypes.byref(cu), _build.stream_ptr(x.device))
    if cu.value != 0:
        raise RuntimeError(f"conv_dma: cuTensorMapEncodeTiled refused a map "
                           f"(CUresult {cu.value})")
    _build.check(err, "conv_dma")
    conv_dma.launches += 1
    return out


conv_dma.launches = 0


def inputs(batch: int, device):
    """main's seeded inputs (the JAX main's at batch 32): x, w, scale,
    bias."""
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (batch, H, W, CIN), dtype=np.int8)
    w = rng.integers(-20, 21, (3, 3, CIN, COUT), dtype=np.int8)
    return (torch.from_numpy(x).to(device), torch.from_numpy(w).to(device),
            torch.full((GO,), 1e-4, dtype=torch.float32, device=device),
            torch.zeros((GO,), dtype=torch.float32, device=device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain version)")
    ap.add_argument("--batch", type=int, default=N)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # timed loop counts (per_iter_time): the plain version on the CPU only
    # shows that each variant runs
    hi, lo, reps = (200, 40, 3) if dev.type == "cuda" else (2, 1, 1)
    x, w, scale, bias = inputs(args.batch, dev)
    want = conv_dma_plain(x, w, scale, bias)
    s4, b4 = scale.repeat(4), bias.repeat(4)
    variants = [(f"dma ht{ht}",
                 lambda xx, ht=ht: conv_dma(xx, w, scale, bias, ht=ht))
                for ht in HTS]
    variants.append(("conv3x3_rs gmaxm", lambda xx: conv3x3_rs(
        xx, w, s4, b4, pool=("gmaxm", 2, GO))))
    print(f"({args.batch},{H},{W},{CIN}) -> {COUT}, go {GO}, on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}",
          flush=True)
    inexact = []
    for name, fn in variants:
        ok = torch.equal(fn(x), want)
        us = per_iter_time(fn, (x,), iters_hi=hi, iters_lo=lo,
                           reps=reps, stat="min") * 1e6
        print(f"{us:9.1f} us  exact={ok}  {name}", flush=True)
        if not ok:
            inexact.append(name)
    if inexact:
        raise AssertionError(f"proto_conv_dma: inexact variants {inexact}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
