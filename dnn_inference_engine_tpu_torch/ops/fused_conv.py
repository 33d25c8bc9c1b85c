"""Space-to-depth fold transforms, the fused stems, the relayouts and the
implicit-im2col int8 conv.

Counterpart of ``dnn_inference_engine_tpu/ops/pallas_conv.py``. The
weight folds are its numpy code, copied verbatim; the layout ops are
torch. Six of its Pallas kernels have Hopper ports here, each a wrapper
beside its plain PyTorch version:

- ``stem_fused_k2`` (``csrc/stem_fused_k2.cu``): quantize + shifted
  s2d(4) + 2x2 folded int8 conv + int32 group-max + epilogue, in one pass
  of a persistent ``wgmma`` kernel (its weights laid out once,
  ``stem_tile_matrix``; its schedule ``stem_k2_schedule``);
- ``stem_fused_dg`` (``csrc/stem_fused_dg.cu``): the same function from
  the per-tap weight slabs, which the kernel lays into the k2 stem's
  shared-memory tile itself, on the same mainloop
  (``csrc/stem_common.cuh``) and schedule;
- ``shift_s2d2`` (``csrc/shift_s2d2.cu``, for ``shift_s2d2_pallas``):
  pad + shifted space-to-depth(2) of an int8 tensor;
- ``quant_space_to_depth4`` (``csrc/quant_space_to_depth4.cu``):
  quantize (uint8 wire or f32) + space-to-depth(4), optional lane pad,
  one block a run of an output row (``qs2d4_grid``), uint8 codes from a
  table built in the block (``qs2d4_code_table`` mirrors it);
- ``gmax_shift_s2d2`` (``csrc/gmax_shift_s2d2.cu``): pool-major
  group-max + shifted space-to-depth(2);
- ``conv3x3_rs`` (``csrc/conv3x3_rs.cu``): implicit-im2col k x k int8
  conv with a fused epilogue, group-max and s2d(2) output.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel or raises.

Space-to-depth folding (fold f): a 3x3/s1 conv on (H, W, Cin) equals a
3x3/s1 conv on (H/f, W/f, f^2*Cin) with f^2*Cout outputs, exactly in
int8 (the same multiply-accumulate set, reassociated). Pooling a fold-f
output by 2x2/s2 is a channel group-max that yields the fold-(f/2)
layout of the pooled tensor, so folds chain through pools.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from dnn_inference_engine_tpu_torch.config import QMAX
from dnn_inference_engine_tpu_torch.ops import _build
from dnn_inference_engine_tpu_torch.ops.activations import (
    KERNEL_ACT_CODES, apply_activation)
from dnn_inference_engine_tpu_torch.ops.gemm import (
    H100_SMS, WG_BK, WG_BM, GemmForm, int32_acc_plain, k_splits,
    kmajor_weights, ptr_or_none, split_buffers)
from dnn_inference_engine_tpu_torch.quant.quantize import f32_scalar
from dnn_inference_engine_tpu_torch.runtime.profiling import launch_span


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_hw(x: torch.Tensor, top: int, bottom: int, left: int,
            right: int, value=0) -> torch.Tensor:
    """Constant-pad the H and W dims of an NHWC tensor of any dtype."""
    n, h, w, c = x.shape
    out = torch.full((n, h + top + bottom, w + left + right, c), value,
                     dtype=x.dtype, device=x.device)
    out[:, top:top + h, left:left + w] = x
    return out


def _pad_channels(x: torch.Tensor, c_to: int) -> torch.Tensor:
    """Zero-pad the last dim up to ``c_to`` channels."""
    c = x.shape[-1]
    if c >= c_to:
        return x
    z = torch.zeros(x.shape[:-1] + (c_to - c,), dtype=x.dtype,
                    device=x.device)
    return torch.cat([x, z], dim=-1)


# ---------------------------------------------------------------------------
# Fold transforms
# ---------------------------------------------------------------------------

def space_to_depth(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """(N,H,W,C) -> (N,H/f,W/f,f*f*C), channel order (p, q, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // f, f, w // f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // f, w // f, f * f * c)


def depth_to_space(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """Inverse of space_to_depth."""
    n, h, w, c = x.shape
    c0 = c // (f * f)
    x = x.reshape(n, h, w, f, f, c0)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * f, w * f, c0)


def _fold_group(r: int, s: int, f: int, pool_major: bool) -> int:
    """Output channel group for position (r, s).

    pool_major orders groups (u, v, a, b) where r = 2a+u, s = 2b+v: the 4
    pooling operands of every (a, b) become 4 contiguous channel slices.
    """
    if not pool_major:
        return r * f + s
    fo = f // 2
    a, u = r // 2, r % 2
    b, v = s // 2, s % 2
    return (u * 2 + v) * fo * fo + a * fo + b


def fold_conv3x3_weights(w: np.ndarray, f: int = 2,
                         pool_major: bool = False) -> np.ndarray:
    """(3,3,Cin,Cout) -> (3,3,f^2*Cin,f^2*Cout) folded weights.

    Wf[di+1, dj+1, (p*f+q)*Cin+c, (r*f+s)*Cout+co] = W[dh+1, dw+1, c, co]
    with dh = f*di + p - r, dw = f*dj + q - s when both lie in {-1,0,1}
    (zero otherwise).
    """
    assert w.shape[0] == w.shape[1] == 3
    cin, cout = int(w.shape[2]), int(w.shape[3])
    w = np.asarray(w)
    wf = np.zeros((3, 3, f * f * cin, f * f * cout), w.dtype)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for p in range(f):
                for q in range(f):
                    for r in range(f):
                        for s in range(f):
                            dh = f * di + p - r
                            dw = f * dj + q - s
                            if dh in (-1, 0, 1) and dw in (-1, 0, 1):
                                g = _fold_group(r, s, f, pool_major)
                                wf[di + 1, dj + 1,
                                   (p * f + q) * cin:(p * f + q + 1) * cin,
                                   g * cout:(g + 1) * cout] \
                                    = w[dh + 1, dw + 1]
    return wf


def shift_space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """Shifted s2d for the k=2 folded formulation: pad 1 row/col on the
    top/left (the SAME halo) and f-1 bottom/right, then fold. Output
    (N, H/f+1, W/f+1, f*f*C); block i holds original rows f*i-1..f*i+f-2."""
    return space_to_depth(_pad_hw(x, 1, f - 1, 1, f - 1), f)


def fold_conv3x3_k2_weights(w: np.ndarray, f: int,
                            pool_major: bool = False) -> np.ndarray:
    """(3,3,Cin,Cout) -> (2,2,f^2*Cin,f^2*Cout) folded weights for the
    shifted layout: tap (di,dj) in {0,1}^2 uses dh = f*di + p - 1 - r
    (valid when in {-1,0,1})."""
    assert w.shape[0] == w.shape[1] == 3 and f >= 2
    cin, cout = int(w.shape[2]), int(w.shape[3])
    w = np.asarray(w)
    wf = np.zeros((2, 2, f * f * cin, f * f * cout), w.dtype)
    for di in (0, 1):
        for dj in (0, 1):
            for p in range(f):
                for q in range(f):
                    for r in range(f):
                        for s in range(f):
                            dh = f * di + p - 1 - r
                            dw = f * dj + q - 1 - s
                            if dh in (-1, 0, 1) and dw in (-1, 0, 1):
                                g = _fold_group(r, s, f, pool_major)
                                wf[di, dj,
                                   (p * f + q) * cin:(p * f + q + 1) * cin,
                                   g * cout:(g + 1) * cout] \
                                    = w[dh + 1, dw + 1]
    return wf


def fold_group_pool_channels(y: torch.Tensor, f: int,
                             cout: int) -> torch.Tensor:
    """Pool a fold-f layer's output (groups r*f+s, not pool-major) by the
    original 2x2/s2 maxpool: (..., f*f*cout) -> (..., (f/2)^2*cout) in
    fold-(f/2) layout."""
    fo = f // 2
    lead = y.shape[:-1]
    y = y.reshape(*lead, fo, 2, fo, 2, cout)
    y = torch.amax(y, dim=(-4, -2))
    return y.reshape(*lead, fo * fo * cout)


def folded_stage_params(wq: np.ndarray, s_w: np.ndarray, b: np.ndarray,
                        f: int):
    """Fold a quantized conv's params: weights fold; per-channel scale and
    bias tile across the f^2 position groups."""
    wf = fold_conv3x3_weights(np.asarray(wq), f)
    reps = f * f
    return wf, np.tile(np.asarray(s_w), reps), np.tile(np.asarray(b), reps)


def group_max4(y: torch.Tensor) -> torch.Tensor:
    """Pool-major group-max: the max of the 4 contiguous channel quarters
    (the 2x2/s2 pool of a pool-major folded output)."""
    go = y.shape[-1] // 4
    return torch.maximum(
        torch.maximum(y[..., :go], y[..., go:2 * go]),
        torch.maximum(y[..., 2 * go:3 * go], y[..., 3 * go:]))


# ---------------------------------------------------------------------------
# Fused stem (kernel 2)
# ---------------------------------------------------------------------------

def _stem_quant(x: torch.Tensor, s_in, exact_u8: bool) -> torch.Tensor:
    """Input codes of the stem: u - 128 (the int8 view of u XOR 0x80)
    for exact uint8 ingestion, else clip(round(x / s_in))."""
    if exact_u8:
        return (x.to(torch.int16) - 128).to(torch.int8)
    s = f32_scalar(s_in, x.device)
    return torch.clamp(torch.round(x / s), -QMAX, QMAX).to(torch.int8)


def stem_fused_k2_plain(x, w, scale, bias, s_in, act="leaky",
                        exact_u8=False):
    """Plain PyTorch version of ``stem_fused_k2`` (same arguments)."""
    f = 4
    n, h, wd, _ = x.shape
    cin, coutf = int(w.shape[2]), int(w.shape[3])
    go = coutf // 4
    hout, wout = h // f, wd // f
    xq = _stem_quant(_pad_hw(x, 1, 2 * f - 1, 1, 2 * f - 1), s_in, exact_u8)
    xs = _pad_channels(space_to_depth(xq, f), cin)   # lanes 48.. are zero
    a = torch.cat([xs[:, dh:dh + hout, dw:dw + wout]
                   for dh in (0, 1) for dw in (0, 1)], dim=-1)
    acc = int32_acc_plain(a.reshape(-1, 4 * cin),
                          w.reshape(4 * cin, coutf).T)
    acc = group_max4(acc)
    y = apply_activation(acc.to(torch.float32) * scale[:go] + bias[:go], act)
    y = torch.clamp(torch.round(y), -QMAX, QMAX).to(torch.int8)
    return y.reshape(n, hout, wout, go)


def _stem_check(x, w, scale, bias, exact_u8, name):
    if x.ndim != 4 or x.shape[3] != 3 or x.shape[1] % 8 or x.shape[2] % 8:
        raise ValueError(f"{name}: x must be (N,H,W,3) with H, W "
                         f"multiples of 8, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"{name}: x must be f32 or uint8, got {x.dtype}")
    if exact_u8 != (x.dtype == torch.uint8):
        raise TypeError("uint8 input is taken with exact_u8 ingestion only "
                        "(the plan's stem stages); f32 input without it")
    if (w.dtype != torch.int8 or w.ndim != 4 or tuple(w.shape[:2]) != (2, 2)
            or w.shape[2] < 48 or w.shape[3] % 4):
        raise ValueError(f"{name}: w must be (2,2,C>=48,4*go) int8, "
                         f"got {w.dtype} {tuple(w.shape)}")
    for arg, v in (("scale", scale), ("bias", bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (w.shape[3],):
            raise ValueError(f"{name}: {arg} must be float32 "
                             f"({w.shape[3]},)")


def _stem_card_check(x, w, scale, bias, name):
    """What both stem kernels take beyond the plain contract."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if w.shape[3] != 256:
        raise ValueError("the stem kernels are built for 16*Cout1 == 256 "
                         f"folded outputs, got {w.shape[3]}")
    if any(t.device != x.device for t in (w, scale, bias)):
        raise ValueError(f"{name}: all operands on one device")


@launch_span("stem_fused_k2")
def stem_fused_k2(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, s_in, act: str = "leaky",
                  exact_u8: bool = False) -> torch.Tensor:
    """Whole stage 0 of a YOLO w8a8 plan: a 3x3/s1 conv + 2x2/s2 maxpool
    stem at fold f=4, in one pass.

    x: (N, H, W, 3) uint8 (serving wire, with exact_u8) or f32 in [0,1],
       H, W % 8 == 0.
    w: (2, 2, C, 16*Cout1) int8 — fold_conv3x3_k2_weights(w1, 4,
       pool_major=True), Cin lane-padded to C (48 or 64).
    scale: (16*Cout1,) f32 = s_in * tile(s_w) / s_out;
    bias:  (16*Cout1,) f32 = tile(b) / s_out.
    exact_u8: the codes are u - 128; the caller folds 128 * the weight
    row-sums into ``bias``.
    Returns (N, H/4, W/4, 4*Cout1) int8 in pool-major fold-2 layout.
    """
    _stem_check(x, w, scale, bias, exact_u8, "stem_fused_k2")
    if x.device.type == "cpu":
        return stem_fused_k2_plain(x, w, scale, bias, s_in, act, exact_u8)
    _stem_card_check(x, w, scale, bias, "stem_fused_k2")
    x = x.contiguous()
    # the kernel reads x in 4-element vectors
    if x.data_ptr() % 16:
        x = x.clone()
    scale, bias = scale.contiguous(), bias.contiguous()
    n, h, wd, _ = x.shape
    go = w.shape[3] // 4
    out = torch.empty((n, h // 4, wd // 4, go), dtype=torch.int8,
                      device=x.device)
    s = float(s_in) if not exact_u8 else 1.0
    rows, grid = stem_grid(n, h // 4, wd // 4, _build.sm_count(x.device),
                           8 if exact_u8 else 4)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("stem_fused_k2", "stem_fused_k2",
                         [p, p, p, p, ctypes.c_float, p, i, i, i, i, i, i, i,
                          p])
    err = fn(x.data_ptr(), stem_tile_matrix(w).data_ptr(), scale.data_ptr(),
             bias.data_ptr(), s, out.data_ptr(), n, h, wd, rows, grid,
             int(exact_u8), KERNEL_ACT_CODES[act],
             _build.stream_ptr(x.device))
    stem_fused_k2.launches += 1
    _build.check(err, "stem_fused_k2")
    return out


stem_fused_k2.launches = 0


# The persistent stem mainloop's shared-memory layout of the folded
# weights (csrc/stem_common.cuh; the k2 and dg stems): 256 rows (the
# pool-major outputs) of two 128-byte K atoms, 128-byte swizzle.
STEM_K2_TILE_BYTES = 2 * 256 * 128
STEM_K2_TILE = 64                # output pixels of one wgmma tile


def _stem_k2_rows(n: int, hout: int, wout: int, sms: int,
                  max_rows: int = 8) -> int:
    """Output rows of one unit (an image's band) of the persistent stem
    mainloop (the k2 and dg stems, ``stage0_fused``) on ``sms`` SMs: of
    8, 4, 2 and 1 (at most ``max_rows``: 4 for f32 input, whose raw rows
    take four times the shared memory), the one
    whose busiest block runs the fewest 64-pixel tiles (units are dealt
    out in turn; a band's last tile may be ragged), the most rows on a tie
    (less halo to stage)."""
    def cost(rows):
        units = n * -(-hout // rows)
        return (-(-units // sms) * -(-(rows * wout) // STEM_K2_TILE), -rows)
    return min((r for r in (8, 4, 2, 1) if r <= max_rows), key=cost)


def stem_grid(n: int, hout: int, wout: int, sms: int,
              max_rows: int) -> Tuple[int, int]:
    """(rows, grid) of a launch of the persistent stem mainloop: the band
    height ``_stem_k2_rows`` picks and one block an SM, at most one a
    unit."""
    rows = _stem_k2_rows(n, hout, wout, sms, max_rows)
    return rows, max(1, min(n * -(-hout // rows), sms))


def stem_k2_schedule(n: int, hout: int, wout: int, rows: int,
                     grid: int) -> List[List[Tuple[int, int, int, int]]]:
    """The persistent stem mainloop's schedule (the k2 and dg stems,
    ``stage0_fused``), as the kernel walks it: for each
    block, its (image, first output row, consumer, first pixel of the
    band) tiles in order. Block b takes units b, b + grid, ... (unit u:
    image u // bands, band u % bands); consumer c takes the band's 64-pixel
    tiles c, c + 2, ..."""
    bands = -(-hout // rows)
    blocks = []
    for b in range(grid):
        tiles = []
        for u in range(b, n * bands, grid):
            img, y0 = u // bands, (u % bands) * rows
            band_px = min(rows, hout - y0) * wout
            for c in (0, 1):
                tiles += [(img, y0, c, m0) for m0 in
                          range(STEM_K2_TILE * c, band_px, 2 * STEM_K2_TILE)]
        blocks.append(tiles)
    return blocks


def stem_k2_row(o: torch.Tensor) -> torch.Tensor:
    """The shared-memory row of pool-major folded output ``o`` (group o //
    64, channel o % 64) in the persistent k2 stem's weights: half hf =
    channel // 32 holds rows 128 hf .. 128 hf + 127, channel c of group gi
    at row 128 hf + 32 gi + c % 32. Each half is one wgmma n128 tile, and
    under wgmma's accumulator layout a thread holds the same channel of
    all four groups."""
    return (o % 64) // 32 * 128 + (o // 64) * 32 + o % 32


def stem_k2_tile_index() -> torch.Tensor:
    """(256, 192) int64: where byte (o, k) of the folded weight matrix
    (output o, K index k = tap*48 + lane) lies in ``stem_tile_matrix``:
    K atom k // 128, row ``stem_k2_row(o)``, 16-byte chunk (k % 128) // 16
    XOR row % 8 (the 128-byte swizzle)."""
    row = stem_k2_row(torch.arange(256)).view(-1, 1)
    k = torch.arange(192).view(1, -1)
    kk = k % 128
    return ((k // 128) * 256 * 128 + row * 128
            + (((kk // 16) ^ (row % 8)) * 16) + kk % 16)


def stem_tile_matrix(w: torch.Tensor) -> torch.Tensor:
    """(2, 2, C>=48, 256) folded stem weights -> the STEM_K2_TILE_BYTES
    the persistent k2 stem loads into shared memory once a block: lanes
    0..47 of the 4 taps (tap = 2 dh + dw) as a (256, 192) K-major matrix
    in wgmma's 128-byte swizzled layout (``stem_k2_tile_index``), zeros
    elsewhere. Made once and cached on ``w`` (until ``w`` is written in
    place)."""
    cached = getattr(w, "_stem_tiles", None)
    if cached is not None and cached[0] == w._version:
        return cached[1]
    b = w[:, :, :48, :].reshape(4 * 48, 256).T
    out = w.new_zeros(STEM_K2_TILE_BYTES)
    out[stem_k2_tile_index().reshape(-1).to(w.device)] = b.reshape(-1)
    w._stem_tiles = (w._version, out)
    return out


# ---------------------------------------------------------------------------
# Fused stem, per-tap formulation (kernel 4)
# ---------------------------------------------------------------------------

def stem_fused_dg_plain(x, w, scale, bias, s_in, act="leaky",
                        exact_u8=False):
    """Plain PyTorch version of ``stem_fused_dg``: four K=48 int32
    products, one per (dh, dw) tap, accumulated; then the group-max on
    the accumulator and the epilogue."""
    f = 4
    n, h, wd, _ = x.shape
    go = int(w.shape[3]) // 4
    hout, wout = h // f, wd // f
    xq = _stem_quant(_pad_hw(x, 1, 2 * f - 1, 1, 2 * f - 1), s_in, exact_u8)
    xs = space_to_depth(xq, f)                   # 48 real lanes
    acc = sum(int32_acc_plain(xs[:, dh:dh + hout, dw:dw + wout]
                              .reshape(-1, 48), w[dh, dw, :48].T)
              for dh in (0, 1) for dw in (0, 1))
    acc = group_max4(acc)
    y = apply_activation(acc.to(torch.float32) * scale[:go] + bias[:go], act)
    y = torch.clamp(torch.round(y), -QMAX, QMAX).to(torch.int8)
    return y.reshape(n, hout, wout, go)


def stem_dg_weight_slabs(w: torch.Tensor) -> torch.Tensor:
    """(2, 2, C, 256) folded stem weights -> the (4, 256, 48) per-tap
    slabs, K-major, which the dg kernel reads: slab row (tap, o) is the
    16-byte chunks 3 tap .. 3 tap + 2 of ``stem_tile_matrix``'s K for
    output o, and the kernel lays each chunk into that tile in shared
    memory (``csrc/stem_common.cuh`` lay_slabs). Rows 48.. (a cin_pad)
    are dropped. Made once and cached on ``w`` (until ``w`` is written in
    place)."""
    cached = getattr(w, "_dg_slabs", None)
    if cached is not None and cached[0] == w._version:
        return cached[1]
    slabs = (w[:, :, :48, :].reshape(4, 48, w.shape[3]).transpose(1, 2)
             .contiguous())
    w._dg_slabs = (w._version, slabs)
    return slabs


@launch_span("stem_fused_dg")
def stem_fused_dg(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, s_in, act: str = "leaky",
                  exact_u8: bool = False) -> torch.Tensor:
    """``stem_fused_k2`` in the per-tap formulation: the same arguments
    and the same result, bit for bit. Any cin_pad rows of ``w`` are
    dropped (their input lanes are zero). On the card the kernel reads
    the weights as ``stem_dg_weight_slabs(w)`` and runs the k2 stem's
    mainloop, band height and grid (``stem_grid``)."""
    _stem_check(x, w, scale, bias, exact_u8, "stem_fused_dg")
    if x.device.type == "cpu":
        return stem_fused_dg_plain(x, w, scale, bias, s_in, act, exact_u8)
    _stem_card_check(x, w, scale, bias, "stem_fused_dg")
    slabs = stem_dg_weight_slabs(w)
    if slabs.data_ptr() % 16:        # read 16 bytes at a time
        raise ValueError("stem_fused_dg: weight slabs not 16-byte aligned")
    x = x.contiguous()
    if x.data_ptr() % 16:            # read in 4-element vectors
        x = x.clone()
    scale, bias = scale.contiguous(), bias.contiguous()
    n, h, wd, _ = x.shape
    out = torch.empty((n, h // 4, wd // 4, 64), dtype=torch.int8,
                      device=x.device)
    s = float(s_in) if not exact_u8 else 1.0
    rows, grid = stem_grid(n, h // 4, wd // 4, _build.sm_count(x.device),
                           8 if exact_u8 else 4)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("stem_fused_dg", "stem_fused_dg",
                         [p, p, p, p, ctypes.c_float, p, i, i, i, i, i, i, i,
                          p])
    err = fn(x.data_ptr(), slabs.data_ptr(), scale.data_ptr(),
             bias.data_ptr(), s, out.data_ptr(), n, h, wd, rows, grid,
             int(exact_u8), KERNEL_ACT_CODES[act],
             _build.stream_ptr(x.device))
    stem_fused_dg.launches += 1
    _build.check(err, "stem_fused_dg")
    return out


stem_fused_dg.launches = 0


# ---------------------------------------------------------------------------
# Shifted space-to-depth(2) (kernel 3)
# ---------------------------------------------------------------------------

def shift_s2d2_shape(h: int, w: int):
    """(rows incl. zero junk rows, valid rows, columns) of shift_s2d2."""
    hout = h // 2 + 1
    return _round_up(hout, 8), hout, w // 2 + 1


def shift_s2d2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``shift_s2d2``."""
    n, h, wd, c = x.shape
    hout_p, _, _ = shift_s2d2_shape(h, wd)
    return space_to_depth(_pad_hw(x, 1, 2 * hout_p - h - 1, 1, 1), 2)


@launch_span("shift_s2d2")
def shift_s2d2(x: torch.Tensor) -> torch.Tensor:
    """Pad + SHIFTED space_to_depth(2): (N, H, W, C) int8 ->
    (N, roundup(H/2+1, 8), W/2+1, 4C) with
    out[n, y, x, (p*2+q)*C + c] = xpad[n, 2y+p, 2x+q, c], where xpad has
    one zero row/col top/left and one bottom/right; rows past H/2+1 are
    zero. Rows [:H/2+1] equal ``shift_space_to_depth(x, 2)``; the
    consumer's VALID conv trims its output to (H/2, W/2)."""
    if x.ndim != 4 or x.dtype != torch.int8 or x.shape[1] % 2 \
            or x.shape[2] % 2:
        raise ValueError(f"shift_s2d2: need (N,H,W,C) int8 with even H, W, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return shift_s2d2_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"shift_s2d2: unsupported device {x.device}")
    x = x.contiguous()
    n, h, wd, c = x.shape
    hout_p, hout, wout = shift_s2d2_shape(h, wd)
    out = torch.empty((n, hout_p, wout, 4 * c), dtype=torch.int8,
                      device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("shift_s2d2", "shift_s2d2",
                         [p, p, i, i, i, i, i, p])
    vec = int(c % 16 == 0 and x.data_ptr() % 16 == 0)
    err = fn(x.data_ptr(), out.data_ptr(), n, h, wd, c, vec,
             _build.stream_ptr(x.device))
    shift_s2d2.launches += 1
    _build.check(err, "shift_s2d2")
    return out


shift_s2d2.launches = 0


# ---------------------------------------------------------------------------
# Fused quantize + space-to-depth(4) (kernel 5)
# ---------------------------------------------------------------------------

# f32(1/255): the JAX kernel's uint8 normalise u / 255.0 is compiled by XLA
# into a multiply by this constant, jitted or not
INV255 = 1 / 255.0

def quant_space_to_depth4_plain(x, s_in, pad_to=0, pad_hw=(0, 0, 0, 0)):
    """Plain PyTorch version of ``quant_space_to_depth4`` (same
    arguments): pad, normalize uint8 by x f32(1/255), quantize, fold,
    lane-pad."""
    if any(pad_hw):
        x = _pad_hw(x, *pad_hw)
    if x.dtype == torch.uint8:
        x = x.to(torch.float32) * f32_scalar(INV255, x.device)
    s = f32_scalar(s_in, x.device)
    xq = torch.clamp(torch.round(x / s), -QMAX, QMAX).to(torch.int8)
    return _pad_channels(space_to_depth(xq, 4), max(pad_to, 48))


# pixels of a unit at most: a block's four staged f32 rows and its code
# rows within the 48 KB of shared memory a block gets without opting in
QS2D4_MAX_RUN = 128


def qs2d4_grid(n: int, h4: int, w4: int,
               sms: int = H100_SMS) -> Tuple[int, int, int]:
    """(segments a row, pixels a run, blocks) of a ``quant_space_to_depth4``
    launch on ``sms`` SMs, a block a unit: each of the n * h4 output rows is
    cut into the fewest runs of at most ``QS2D4_MAX_RUN`` pixels that give
    at least two units an SM (batch 1), the last run possibly shorter."""
    rows = n * h4
    segs = min(w4, max(-(-w4 // QS2D4_MAX_RUN),
                       -(-2 * sms // max(rows, 1))))
    run = -(-w4 // segs)
    segs = -(-w4 // run)
    return segs, run, rows * segs


def qs2d4_row_bytes(run: int, elem: int) -> int:
    """Bytes of one of the kernel's four staged row buffers (``row_bytes``
    in ``csrc/quant_space_to_depth4.cu``): a run's 12 * run elements of
    ``elem`` bytes, up to 15 bytes of the copy's leading alignment and a
    funnel shift's second word."""
    return _round_up(12 * run * elem, 16) + 32


def qs2d4_code_bytes(run: int) -> int:
    """Bytes of one of the kernel's four code rows (``code_bytes``): a
    run's 12 * run codes."""
    return _round_up(12 * run, 16)


def qs2d4_code_table(s_in) -> np.ndarray:
    """The uint8 codes the kernel's table holds, built as the kernel builds
    it: code[u] = clip(rint((u * f32(1/255)) / s), +-127), the product and
    the division each correctly rounded in float32, ties to even."""
    v = np.arange(256, dtype=np.float32) * np.float32(INV255)
    q = np.rint(v / np.float32(s_in))
    return np.clip(q, -QMAX, QMAX).astype(np.int8)


@launch_span("quant_space_to_depth4")
def quant_space_to_depth4(x: torch.Tensor, s_in, pad_to: int = 0,
                          pad_hw=(0, 0, 0, 0)) -> torch.Tensor:
    """Fused quantize + space_to_depth(4): (N,H,W,3) uint8 or f32 ->
    (N,H/4,W/4,max(48,pad_to)) int8, lanes 48.. zero.

    uint8 input is the serving wire format: v = u * f32(1/255) first,
    then the division by ``s_in``, each correctly rounded, as the JAX
    kernel computes them (XLA turns its u / 255.0 into that product) and
    ``quantize_act`` divides. ``pad_hw`` = (top, bottom, left, right):
    the result equals ``quant_space_to_depth4(_pad_hw(x, *pad_hw), ...)``,
    but the card kernel reads zeros outside ``x`` instead of making the
    padded copy. The padded H and W must be multiples of 8."""
    top, bottom, left, right = pad_hw
    if (x.ndim != 4 or x.shape[3] != 3 or (x.shape[1] + top + bottom) % 8
            or (x.shape[2] + left + right) % 8 or min(pad_hw) < 0):
        raise ValueError("quant_space_to_depth4: need (N,H,W,3) with padded "
                         f"H, W multiples of 8, got {tuple(x.shape)} "
                         f"padded by {pad_hw}")
    if x.dtype not in (torch.float32, torch.uint8):
        raise TypeError("quant_space_to_depth4: x must be f32 or uint8, "
                        f"got {x.dtype}")
    if x.device.type == "cpu":
        return quant_space_to_depth4_plain(x, s_in, pad_to, pad_hw)
    if x.device.type != "cuda":
        raise ValueError(f"quant_space_to_depth4: unsupported device "
                         f"{x.device}")
    c_out = max(pad_to, 48)
    x = x.contiguous()
    n, h, wd, _ = x.shape
    hp, wp = h + top + bottom, wd + left + right
    out = torch.empty((n, hp // 4, wp // 4, c_out), dtype=torch.int8,
                      device=x.device)
    u8 = x.dtype == torch.uint8
    segs, run, _ = qs2d4_grid(n, hp // 4, wp // 4,
                              _build.sm_count(x.device))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("quant_space_to_depth4", "quant_space_to_depth4",
                         [p, ctypes.c_float, p] + [i] * 11 + [p])
    err = fn(x.data_ptr(), float(s_in), out.data_ptr(), n, h, wd, top, left,
             hp, wp, c_out, segs, run, int(u8),
             _build.stream_ptr(x.device))
    quant_space_to_depth4.launches += 1
    _build.check(err, "quant_space_to_depth4")
    return out


quant_space_to_depth4.launches = 0


# ---------------------------------------------------------------------------
# Fused group-max + shifted space-to-depth(2) (kernel 6)
# ---------------------------------------------------------------------------

def gmax_shift_s2d2_plain(y: torch.Tensor, go: int) -> torch.Tensor:
    """Plain PyTorch version of ``gmax_shift_s2d2``."""
    return shift_s2d2_plain(group_max4(y))


@launch_span("gmax_shift_s2d2")
def gmax_shift_s2d2(y: torch.Tensor, go: int) -> torch.Tensor:
    """Pool-major group-max + SHIFTED space_to_depth(2), one pass:
    (N, H, W, 4*go) int8, the pre-group-max output of a fold-2 stage ->
    (N, roundup(H/2+1, 8), W/2+1, 4*go) with
    out[n, i, j, (2p+q)*go + c] = max_k y[n, 2i+p-1, 2j+q-1, k*go+c],
    zero where that pixel lies outside y; rows past H/2+1 are zero.
    Rows [:H/2+1] equal ``shift_space_to_depth(group_max4(y), 2)``."""
    if (y.ndim != 4 or y.dtype != torch.int8 or y.shape[3] != 4 * go
            or y.shape[1] % 2 or y.shape[2] % 2):
        raise ValueError(f"gmax_shift_s2d2: need (N,H,W,4*go) int8 with even "
                         f"H, W; got {y.dtype} {tuple(y.shape)}, go={go}")
    if y.device.type == "cpu":
        return gmax_shift_s2d2_plain(y, go)
    if y.device.type != "cuda":
        raise ValueError(f"gmax_shift_s2d2: unsupported device {y.device}")
    y = y.contiguous()
    n, h, wd, c = y.shape
    hout_p, _, wout = shift_s2d2_shape(h, wd)
    out = torch.empty((n, hout_p, wout, c), dtype=torch.int8, device=y.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("gmax_shift_s2d2", "gmax_shift_s2d2",
                         [p, p, i, i, i, i, i, p])
    vec = int(go % 16 == 0 and y.data_ptr() % 16 == 0)
    err = fn(y.data_ptr(), out.data_ptr(), n, h, wd, go, vec,
             _build.stream_ptr(y.device))
    gmax_shift_s2d2.launches += 1
    _build.check(err, "gmax_shift_s2d2")
    return out


gmax_shift_s2d2.launches = 0


# ---------------------------------------------------------------------------
# Implicit-im2col int8 conv (kernel 7)
# ---------------------------------------------------------------------------

def _rs_pool_groups(pool, cout: int):
    """(kind, f, co, output channels) of a conv3x3_rs pool argument."""
    if pool is None or pool == "pool2":
        return pool, 0, 0, cout
    if not (isinstance(pool, tuple) and len(pool) == 3
            and pool[0] in ("gmax", "gmaxm")):
        raise ValueError(f"conv3x3_rs: pool must be None, 'pool2' or "
                         f"('gmax'|'gmaxm', f, co), got {pool!r}")
    kind, f, co = pool
    if f % 2 or f * f * co != cout:
        raise ValueError(f"conv3x3_rs: pool {pool!r} needs f*f*co == Cout "
                         f"({cout}) with f even")
    return kind, f, co, (f // 2) ** 2 * co


def _rs_check(x, w, scale, bias, pool, ksize, s2d_out):
    if ksize not in (2, 3):
        raise ValueError(f"conv3x3_rs: ksize must be 2 or 3, got {ksize}")
    if x.dtype != torch.int8 or w.dtype != torch.int8 or x.ndim != 4:
        raise TypeError(f"conv3x3_rs takes int8 x (N,H,W,Cin) and w, got "
                        f"{x.dtype} {tuple(x.shape)} and {w.dtype}")
    if tuple(w.shape[:3]) != (ksize, ksize, x.shape[3]) or w.ndim != 4:
        raise ValueError(f"conv3x3_rs: w must be ({ksize},{ksize},"
                         f"{x.shape[3]},Cout), got {tuple(w.shape)}")
    cout = int(w.shape[3])
    for arg, v in (("scale", scale), ("bias", bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (cout,):
            raise ValueError(f"conv3x3_rs: {arg} must be float32 ({cout},)")
    kind, _, _, cg = _rs_pool_groups(pool, cout)
    ho = x.shape[1] - (ksize == 2)
    if kind == "pool2" and (ho % 2 or s2d_out):
        raise ValueError("conv3x3_rs: 'pool2' needs an even output height "
                         "and no s2d_out")
    if s2d_out and ho % 2:
        raise ValueError("conv3x3_rs: s2d_out needs an even output height")
    return kind, cg


def conv3x3_rs_plain(x, w, scale, bias, act="leaky", quantize_out=True,
                     pool=None, ksize=3, s2d_out=False):
    """Plain PyTorch version of ``conv3x3_rs`` (same arguments)."""
    kind, cg = _rs_check(x, w, scale, bias, pool, ksize, s2d_out)
    n, h, wd, cin = x.shape
    cout = int(w.shape[3])
    ho, wo = (h, wd) if ksize == 3 else (h - 1, wd - 1)
    xp = _pad_hw(x, 1, 1, 1, 1) if ksize == 3 else x
    a = torch.cat([xp[:, dh:dh + ho, dw:dw + wo]
                   for dh in range(ksize) for dw in range(ksize)], dim=-1)
    k = ksize * ksize * cin
    acc = int32_acc_plain(a.reshape(-1, k), w.reshape(k, cout).T)
    if kind == "gmaxm" and quantize_out:
        # group-max on the int32 accumulator: the epilogue is monotone and
        # its params are the same in every pool group
        acc, scale, bias, kind = (group_max4(acc), scale[:cg], bias[:cg],
                                  "done")
    y = apply_activation(acc.to(torch.float32) * scale + bias, act)
    if quantize_out:
        y = torch.clamp(torch.round(y), -QMAX, QMAX)
    if kind == "gmaxm":
        y = group_max4(y)
    elif kind == "gmax":
        y = fold_group_pool_channels(y, pool[1], pool[2])
    y = y.reshape(n, ho, wo, y.shape[-1])
    if kind == "pool2":
        y = y[:, :, :wo // 2 * 2].reshape(n, ho // 2, 2, wo // 2, 2, cg)
        y = torch.amax(y, dim=(2, 4))
    elif s2d_out:
        y = space_to_depth(y[:, :, :wo // 2 * 2], 2)
    return y.to(torch.int8) if quantize_out else y


def rs_weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """(k, k, Cin, Cout) weights -> the (Cout, k*k*Cin) K-major matrix the
    conv3x3_rs kernel reads. Made once and cached on ``w`` (until ``w`` is
    written in place)."""
    return kmajor_weights(w)


def rs_tile_matrix(w: torch.Tensor, go: int) -> torch.Tensor:
    """The weight rows the conv3x3_rs kernel reads, one 128-row block per
    tile of output columns. Without a pool (``go`` 0) that is
    ``rs_weight_matrix(w)``. With 'gmaxm' (``go`` > 0 channels in each of
    the 4 pool groups) block j holds channels 32j..32j+31 of every group:
    row 128j + 32k + i is column k*go + 32j + i (zeros past ``go``), so a
    tile's weights come in one TMA box, and under wgmma's accumulator
    layout a thread holds the same channel of all four groups. Made once
    per ``go`` and cached on ``w`` (until ``w`` is written in place)."""
    wt = rs_weight_matrix(w)
    if not go:
        return wt
    cached = getattr(w, "_rs_tiles", None)
    if cached is not None and cached[:2] == (w._version, go):
        return cached[2]
    n_tiles = _round_up(go, 32) // 32
    ch = (32 * torch.arange(n_tiles).view(-1, 1, 1)
          + torch.arange(32).view(1, 1, -1)).expand(n_tiles, 4, 32)
    rows = (torch.arange(4).view(1, -1, 1) * go + ch).reshape(-1)
    valid = (ch < go).reshape(-1)
    out = wt.new_zeros((n_tiles * 128, wt.shape[1]))
    out[valid.to(wt.device)] = wt[rows[valid].to(wt.device)]
    w._rs_tiles = (w._version, go, out)
    return out


def rs_form(m: int, cout: int, go: int, k: int,
            sms: int = H100_SMS) -> GemmForm:
    """How ``conv3x3_rs`` launches on a card of ``sms`` SMs: M = ``m``
    output pixels, K = ``k`` bytes (k*k*Cin), tiles of 128 pixels x 128
    accumulator columns (with 'gmaxm', ``go`` > 0, 32 channels of each of
    the 4 pool groups), K split as ``gemm_fused`` splits it."""
    n_tiles = _round_up(go, 32) // 32 if go else _round_up(cout, 128) // 128
    tiles = _round_up(m, WG_BM) // WG_BM * n_tiles
    splits = k_splits(tiles, _round_up(k, WG_BK) // WG_BK, sms)
    return GemmForm("wgmma", splits, tiles, min(tiles * splits, sms))


@launch_span("conv3x3_rs")
def conv3x3_rs(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, act: str = "leaky",
               quantize_out: bool = True, pool=None, ksize: int = 3,
               s2d_out: bool = False) -> torch.Tensor:
    """Fused int8 conv (+ pool): the implicit-im2col conv of the ``rs``
    plan stages.

    x: (N, H, W, Cin) int8; w: (k, k, Cin, Cout) int8.
    ksize=3: 3x3/s1/SAME conv; ksize=2: 2x2/s1/VALID conv over a shifted
    fold (output spatial = input - 1).
    y = act(acc * scale + bias) with scale and bias already folding
    1/s_out (the folded order); ``quantize_out``: clip(round(y)) int8,
    else f32.
    pool: None -> (N,Ho,Wo,Cout); 'pool2' -> the 2x2/s2 maxpool
    (N,Ho/2,Wo//2,Cout); ('gmax'|'gmaxm', f, co) -> the group-max of a
    fold-f output (plain or pool-major groups), (N,Ho,Wo,(f/2)^2*co).
    'gmaxm' with ``quantize_out`` takes the max on the int32 accumulator
    and the epilogue with scale[:go], bias[:go].
    s2d_out: the output in space_to_depth(2) layout (odd trailing column
    dropped).

    The card kernel takes pool None and 'gmaxm', with Cin % 16 == 0; the
    plain version covers the whole contract.
    """
    kind, cg = _rs_check(x, w, scale, bias, pool, ksize, s2d_out)
    if x.device.type == "cpu":
        return conv3x3_rs_plain(x, w, scale, bias, act, quantize_out, pool,
                                ksize, s2d_out)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_rs: unsupported device {x.device}")
    if any(t.device != x.device for t in (w, scale, bias)):
        raise ValueError("conv3x3_rs: all operands on one device")
    if kind not in (None, "gmaxm"):
        raise ValueError(f"conv3x3_rs: the card kernel takes pool None or "
                         f"'gmaxm', not {pool!r} (ROADMAP B4)")
    n, h, wd, cin = x.shape
    if cin % 16:
        raise ValueError(f"conv3x3_rs: the card kernel reads 16-byte chunks, "
                         f"Cin must be a multiple of 16, got {cin}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    go = cg if kind == "gmaxm" else 0
    wt = rs_tile_matrix(w, go)
    scale, bias = scale.contiguous(), bias.contiguous()
    ho, wo = (h, wd) if ksize == 3 else (h - 1, wd - 1)
    shape = ((n, ho // 2, wo // 2, 4 * cg) if s2d_out else (n, ho, wo, cg))
    out = torch.empty(shape, device=x.device,
                      dtype=torch.int8 if quantize_out else torch.float32)
    f = rs_form(n * ho * wo, int(w.shape[3]), go, ksize * ksize * cin,
                _build.sm_count(x.device))
    ws, cnt = split_buffers(x.device, f)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("conv3x3_rs", "conv3x3_rs",
                         [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i,
                          p, p, p])
    err = fn(x.data_ptr(), wt.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             out.data_ptr(), n, h, wd, cin, int(w.shape[3]), ksize, go,
             int(quantize_out), KERNEL_ACT_CODES[act], int(s2d_out),
             f.splits, f.grid, ptr_or_none(ws), ptr_or_none(cnt),
             _build.stream_ptr(x.device))
    conv3x3_rs.launches += 1
    _build.check(err, "conv3x3_rs")
    return out


conv3x3_rs.launches = 0


def conv2d_w8a8_rs(xq, s_in, wq, s_w, b, act="leaky", s_out=None,
                   pool=None):
    """W8A8 3x3 SAME conv (+ fused pool) through ``conv3x3_rs``, with
    1/s_out folded into scale and bias (the folded order); f32 output
    without ``s_out``."""
    dev = xq.device
    scale = f32_scalar(s_in, dev) * s_w
    bias = b.to(torch.float32)
    if s_out is not None:
        so = f32_scalar(s_out, dev)
        scale, bias = scale / so, bias / so
    return conv3x3_rs(xq, wq, scale, bias, act=act,
                      quantize_out=s_out is not None, pool=pool)
