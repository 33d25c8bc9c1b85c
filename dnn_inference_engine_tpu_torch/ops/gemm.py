"""Fused GEMMs: act(A @ B * scale[col] + bias[col]).

Counterpart of ``dnn_inference_engine_tpu/ops/pallas_gemm.py``, whose
``gemm_fused`` takes int8 or float operands. The port has one kernel per
form:

- int8 x int8 -> int32, with int8 requantization, f32 output or the raw
  accumulator: ``gemm_fused`` (``csrc/gemm_fused.cu``), in two forms
  that ``gemm_form`` picks from the shape alone: the ``wgmma`` form
  (Hopper's warpgroup product fed by TMA, K split across blocks where the
  tiles alone leave SMs idle) for K % 16 == 0 and 16-byte aligned
  operands, every main-path shape; the ``ragged`` form (``mma.sync``,
  byte loads) for the rest;
- f32 x f32, or f32 x int8 codes (the weight-only form), accumulated in
  f32, f32 out: ``gemm_f32`` (``csrc/gemm_f32.cu``), in two forms that
  ``gemm_f32_form`` picks from the shape alone: the ``wgmma`` form (three
  TF32 tensor-core products of the operands' halves, two for int8 codes;
  B split once by ``tf32_split``, A in the kernel as ``tf32_split_a``
  gives it; K split where the tiles leave SMs idle) for K % 4 == 0 and
  16-byte aligned operands, every detect shape; the ``ragged`` form
  (float32 FMA) for the rest. The JAX kernel's raw f32 accumulator
  (``raw_acc`` of a float product) has no caller in either package: the
  row-parallel conv of the channel-sharded forward (parallel/) reads the
  int8 product's int32 one. A bf16 A has no caller in the JAX package and
  is refused (ROADMAP B13).

Beside each kernel, ``gemm_fused_plain`` and ``gemm_f32_plain`` are the
plain PyTorch versions of the same functions, which the CPU path and the
tests use. B is passed K-major, as ``bt`` of shape (N, K), which is the
layout the kernels read; the plan stores that copy once per layer.

Epilogue orders (both exist in the JAX package and differ by 1 LSB near
round-half boundaries, so each caller gets its own):

- ``s_out`` given: the conv order of ``conv2d_w8a8`` and the fold stages,
  ``clip(round(act(acc*scale + bias) / s_out))``;
- ``quantize_out=True``: the folded order of ``gemm_fused``, where the
  caller already divided scale and bias by s_out: ``clip(round(act(...)))``;
- ``raw_acc=True``: the int32 accumulator (the gemm tier's row-parallel
  conv, ``conv_lowering.conv2d_int8_acc``);
- otherwise the f32 ``act(acc*scale + bias)``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from dnn_inference_engine_tpu_torch.config import QMAX
from dnn_inference_engine_tpu_torch.ops import _build
from dnn_inference_engine_tpu_torch.ops.activations import (
    KERNEL_ACT_CODES, apply_activation)
from dnn_inference_engine_tpu_torch.quant.quantize import Scale, quantize_act


# The block tile of the wgmma mainloop (csrc/wgmma_s8.cuh): 128 x 128, K
# in stages of 128 bytes.
WG_BM = 128
WG_BN = 128
WG_BK = 128
H100_SMS = 132                  # SMs of an H100 SXM


class GemmForm(NamedTuple):
    """How a product is launched: ``form`` "wgmma" or "ragged" (both on
    128 x 128 block tiles), ``splits`` of K across blocks, ``tiles`` block
    tiles, ``grid`` blocks (persistent in the wgmma form)."""
    form: str
    splits: int
    tiles: int
    grid: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k_splits(tiles: int, kt: int, sms: int) -> int:
    """K-splits for ``tiles`` block tiles over ``kt`` stages of K: none
    when the tiles fill the card. Else each split costs its mainloop,
    about kt/splits stages, plus its share of the split-K fixup, about two
    stages' worth for each other split (the last unit of a tile reads
    every other partial sum): splits near sqrt(kt/2) balance the two. At
    least 2 splits (the heads' short K too), each at least 2 stages; no
    more than fill the card."""
    if tiles >= sms:
        return 1
    best = max(2, int(math.sqrt(kt / 2) + 0.5))
    return max(1, min(sms // tiles, kt // 2, best, 16))


def split_ranges(k: int, splits: int) -> List[Tuple[int, int]]:
    """The byte ranges [k0, k1) of K that the ``splits`` splits of the
    wgmma form sum (``wg::unit`` in csrc/wgmma_s8.cuh)."""
    kt = _cdiv(k, WG_BK)
    return [(s * kt // splits * WG_BK, min((s + 1) * kt // splits * WG_BK, k))
            for s in range(splits)]


def gemm_form(m: int, n: int, k: int, aligned: bool,
              sms: int = H100_SMS) -> GemmForm:
    """The form ``gemm_fused`` launches for an (m, k) x (k, n) product on
    a card of ``sms`` SMs. ``aligned``: both operands start on 16 bytes.
    The wgmma form splits K when the tiles alone leave SMs idle."""
    tiles = _cdiv(m, WG_BM) * _cdiv(n, WG_BN)
    if not aligned or k % 16:
        return GemmForm("ragged", 1, tiles, tiles)
    splits = k_splits(tiles, _cdiv(k, WG_BK), sms)
    return GemmForm("wgmma", splits, tiles, min(tiles * splits, sms))


# The block tile of gemm_f32's wgmma form (csrc/gemm_f32.cu): 128 x 128,
# K in stages of 16 floats (64 bytes); a fixup's read of one partial sum
# (64 KB, from L2) costs about as much as two stages (24-32 KB each, three
# TF32 products)
F32_BK = 16
F32_FIXUP_STAGES = 2.0
F32_MAX_SPLITS = 8              # MAXS in csrc/gemm_f32.cu


def f32_k_splits(tiles: int, kt: int, sms: int) -> int:
    """K-splits of gemm_f32's wgmma form for ``tiles`` block tiles over
    ``kt`` stages of 16 floats on ``sms`` SMs: the split s (1..8, each
    split at least 2 stages) that minimises the busiest SM's work, waves
    ceil(tiles s / sms) times a unit's kt/s stages plus the fixup's
    ``F32_FIXUP_STAGES`` for each other split (the last unit of a tile
    adds every other partial sum), if that beats no split by 15%. The
    batch-1 shapes split to fill the SMs; a tile count just past a wave
    (172 tiles on 132 SMs) splits to even the waves out; nearly full
    waves do not split."""
    def cost(s):
        waves = -(-tiles * s // sms)
        return waves * (kt / s + F32_FIXUP_STAGES * (s - 1))
    best = min(range(1, max(1, min(F32_MAX_SPLITS, kt // 2)) + 1),
               key=lambda s: (cost(s), s))
    # a split costs workspace and an epilogue's worth of traffic the
    # model leaves out: take one only for a clear gain
    return best if cost(best) < 0.85 * cost(1) else 1


def f32_split_ranges(k: int, splits: int) -> List[Tuple[int, int]]:
    """The element ranges [k0, k1) of K that the ``splits`` splits of
    gemm_f32's wgmma form sum (``wg::unit`` over stages of 16 floats)."""
    kt = _cdiv(k, F32_BK)
    return [(s * kt // splits * F32_BK, min((s + 1) * kt // splits * F32_BK,
                                            k))
            for s in range(splits)]


def gemm_f32_form(m: int, n: int, k: int, aligned: bool,
                  sms: int = H100_SMS) -> GemmForm:
    """The form ``gemm_f32`` launches for an (m, k) x (k, n) float product
    on a card of ``sms`` SMs. ``aligned``: every operand starts on 16
    bytes. The wgmma form needs K % 4 == 0 (a TMA row stride is a multiple
    of 16 bytes) and splits K when the tiles alone leave SMs idle."""
    tiles = _cdiv(m, WG_BM) * _cdiv(n, WG_BN)
    if not aligned or k % 4:
        return GemmForm("ragged", 1, tiles, tiles)
    splits = f32_k_splits(tiles, _cdiv(k, F32_BK), sms)
    return GemmForm("wgmma", splits, tiles, min(tiles * splits, sms))


_counter_bufs: Dict[torch.device, torch.Tensor] = {}


def split_buffers(device: torch.device, f: GemmForm):
    """(workspace, counters) for a launch of form ``f``: the int32 partial
    sums of its splits (``torch.empty``, per call) and the per-tile
    arrival counters, one zeroed buffer per device that every kernel
    leaves zero; (None, None) without a split."""
    if f.splits == 1:
        return None, None
    ws = torch.empty(f.tiles * f.splits * WG_BM * WG_BN, dtype=torch.int32,
                     device=device)
    cnt = _counter_bufs.get(device)
    if cnt is None or cnt.numel() < f.tiles:
        cnt = torch.zeros(max(f.tiles, 4096), dtype=torch.int32,
                          device=device)
        _counter_bufs[device] = cnt
    return ws, cnt


def ptr_or_none(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _mode(quantize_out: bool, raw_acc: bool, s_out) -> int:
    if raw_acc:
        if quantize_out or s_out is not None:
            raise ValueError("raw_acc returns the accumulator: no requant")
        return 3
    if s_out is not None:
        if quantize_out:
            raise ValueError("pass s_out (conv order) or quantize_out "
                             "(folded order), not both")
        return 0
    return 1 if quantize_out else 2


def int32_acc_plain(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product via a float64 matmul: every
    partial sum is an integer below 2**53 (|acc| <= K * 127 * 128)."""
    return (a.to(torch.float64) @ bt.to(torch.float64).T).to(torch.int32)


def epilogue_plain(acc: torch.Tensor, scale, bias, act="leaky",
                   quantize_out=False, s_out: Optional[Scale] = None):
    """``gemm_fused``'s epilogue on an int32 accumulator whose last axis
    holds the columns, in PyTorch passes, each rounded as the kernels
    round it: y = act(acc*scale + bias); with ``s_out`` the conv order's
    codes ``clip(rint(y / s_out))``, with ``quantize_out`` the folded
    order's ``clip(rint(y))``, else y."""
    y = apply_activation(acc.to(torch.float32) * scale + bias, act)
    if s_out is not None:
        return quantize_act(y, s_out)
    if quantize_out:
        return torch.clamp(torch.round(y), -QMAX, QMAX).to(torch.int8)
    return y


def gemm_fused_plain(a, bt, scale, bias, act="leaky", quantize_out=False,
                     raw_acc=False, s_out: Optional[Scale] = None):
    """Plain PyTorch version of ``gemm_fused`` (same arguments)."""
    mode = _mode(quantize_out, raw_acc, s_out)
    acc = int32_acc_plain(a, bt)
    if mode == 3:
        return acc
    return epilogue_plain(acc, scale, bias, act, quantize_out, s_out)


def _check(a, bt, scale, bias):
    if a.dtype != torch.int8 or bt.dtype != torch.int8:
        raise TypeError(f"gemm_fused takes int8 operands, got {a.dtype} and "
                        f"{bt.dtype}")
    if a.ndim != 2 or bt.ndim != 2 or a.shape[1] != bt.shape[1]:
        raise ValueError(f"need a (M,K) and bt (N,K), got {tuple(a.shape)} "
                         f"and {tuple(bt.shape)}")
    n = bt.shape[0]
    for name, v in (("scale", scale), ("bias", bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be float32 ({n},), got "
                             f"{v.dtype} {tuple(v.shape)}")


def gemm_fused(a: torch.Tensor, bt: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, act: str = "leaky",
               quantize_out: bool = False, raw_acc: bool = False,
               s_out: Optional[Scale] = None) -> torch.Tensor:
    """a (M,K) int8, bt (N,K) int8, scale/bias (N,) f32 -> (M,N).

    On a CPU tensor this is the plain version; on a CUDA tensor it
    launches the kernel (or raises)."""
    _check(a, bt, scale, bias)
    mode = _mode(quantize_out, raw_acc, s_out)
    if a.device.type == "cpu":
        return gemm_fused_plain(a, bt, scale, bias, act, quantize_out,
                                raw_acc, s_out)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_fused: unsupported device {a.device}")
    for t in (bt, scale, bias):
        if t.device != a.device:
            raise ValueError("gemm_fused: all operands on one device")
    a, bt = a.contiguous(), bt.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    m, k = a.shape
    n = bt.shape[0]
    out_dtype = {0: torch.int8, 1: torch.int8, 2: torch.float32,
                 3: torch.int32}[mode]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    aligned = a.data_ptr() % 16 == 0 and bt.data_ptr() % 16 == 0
    f = gemm_form(m, n, k, aligned, _build.sm_count(a.device))
    ws, cnt = split_buffers(a.device, f)
    s = float(s_out) if s_out is not None else 1.0
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("gemm_fused", "gemm_fused_s8",
                         [p, p, p, p, ctypes.c_float, p, i, i, i, i, i, i, i,
                          i, p, p, p])
    err = fn(a.data_ptr(), bt.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             s, out.data_ptr(), m, n, k, mode, KERNEL_ACT_CODES[act],
             int(f.form == "wgmma"), f.splits, f.grid, ptr_or_none(ws),
             ptr_or_none(cnt), _build.stream_ptr(a.device))
    gemm_fused.launches += 1
    gemm_fused.ragged_launches += f.form == "ragged"
    gemm_fused.folded_launches += mode == 1
    _build.check(err, "gemm_fused")
    return out


gemm_fused.launches = 0
# launches of the ragged form (gemm_form): K % 16 != 0 or a misaligned
# operand; every main-path shape takes the wgmma form
gemm_fused.ragged_launches = 0
# launches in the folded order (quantize_out): the int8 convs of the gemm
# tier (conv_lowering.conv2d_w8a8_gemm), which the xla tier never makes
gemm_fused.folded_launches = 0


def int8_gemm_fused(a_q, bt_q, scale, bias, act="leaky", s_out=None):
    """Quantized GEMM with ``int8_gemm_fused``'s contract: with ``s_out``
    the output is requantized to int8 by folding 1/s_out into scale and
    bias (the folded order); without it the output is f32. ``s_out`` is a
    Python float, or a float32 tensor on the data's device (then 1/s_out
    is a float32 division, as for a ``jnp.float32``)."""
    if s_out is not None:
        inv = 1.0 / s_out
        return gemm_fused(a_q, bt_q, scale * inv, bias * inv, act=act,
                          quantize_out=True)
    return gemm_fused(a_q, bt_q, scale, bias, act=act)


def gemm_f32_plain(a, bt, scale, bias, act="leaky"):
    """Plain PyTorch version of ``gemm_f32`` (same arguments). The product
    is summed in float64 and rounded once to float32, so it is the exact
    product to within one rounding; the kernel's and the JAX package's
    float32 sums differ from it by their own summation error."""
    acc = (a.to(torch.float64) @ bt.to(torch.float64).T).to(torch.float32)
    return apply_activation(acc * scale + bias, act)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits,
    ties to even): the low 13 bits of each word zero. Subnormals round the
    same way; inf passes through and a NaN stays a quiet NaN; a finite
    value that would round past the largest float is truncated instead
    (``tf32_rn`` in csrc/gemm_f32.cu)."""
    b = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    b = b & 0xFFFFFFFF
    special = (b & 0x7F800000) == 0x7F800000
    r = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    r = torch.where((r & 0x7F800000) == 0x7F800000, b & ~0x1FFF, r)
    nan = special & ((b & 0x7FFFFF) != 0)
    r = torch.where(special, torch.where(nan, (b | 0x400000) & ~0x1FFF, b),
                    r)
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    return r.view(torch.float32).view(x.shape)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32_round(x) and lo = tf32_round(x - hi) (0
    where hi is inf or NaN): hi + lo is x to within 2**-22 |x|, and the
    three TF32 products hi*hi + hi*lo + lo*hi of two such splits are the
    float32 product to a few 2**-22 of |a||b|. The split of B that
    ``tf32_operands`` caches."""
    hi = tf32_round(x)
    lo = torch.where(torch.isfinite(hi), tf32_round(x.to(torch.float32)
                                                    - hi),
                     torch.zeros((), dtype=torch.float32, device=x.device))
    return hi, lo


def tf32_split_a(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split of A (plain version of ``lo_of`` in
    csrc/gemm_f32.cu): the tensor cores read a float32 operand as TF32 by
    dropping its low 13 bits, so hi = trunc(x) is A as it lies, and lo =
    tf32_round(x - hi) (0 where x is inf or NaN) is all the kernel
    computes (into registers): hi + lo is x to within 2**-21 |x|."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    hi = (b & ~0x1FFF).view(torch.float32).view(x.shape)
    lo = torch.where(torch.isfinite(x), tf32_round(x.to(torch.float32) - hi),
                     torch.zeros((), dtype=torch.float32, device=x.device))
    return hi, lo


def tf32_operands(bt: torch.Tensor) -> Tuple[torch.Tensor,
                                             Optional[torch.Tensor]]:
    """The B operands of gemm_f32's wgmma form: ``tf32_split(bt)`` for a
    float32 bt, or (its codes as float32, None) for int8 codes (exact in
    TF32: no lo half). Made once and cached on ``bt`` (until ``bt`` is
    written in place): the forwards pass the cached weight matrix
    (``kmajor_weights``), so a weight tensor is split once."""
    cached = getattr(bt, "_tf32_ops", None)
    if cached is not None and cached[0] == bt._version:
        return cached[1]
    if bt.dtype == torch.int8:
        ops = (bt.to(torch.float32).contiguous(), None)
    else:
        hi, lo = tf32_split(bt)
        ops = (hi.contiguous(), lo.contiguous())
    bt._tf32_ops = (bt._version, ops)
    return ops


def kmajor_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO (kh,kw,Cin,Cout) weights -> the (Cout, kh*kw*Cin) K-major
    matrix the GEMM kernels read. Made once and cached on ``w`` (until
    ``w`` is written in place)."""
    cached = getattr(w, "_kmajor", None)
    if cached is not None and cached[0] == w._version:
        return cached[1]
    kh, kw, cin, cout = w.shape
    wt = w.reshape(kh * kw * cin, cout).T.contiguous()
    w._kmajor = (w._version, wt)
    return wt


def _check_f32(a, bt, scale, bias):
    if torch.bfloat16 in (a.dtype, bt.dtype):
        raise TypeError("gemm_f32: the bf16 form of gemm_fused has no "
                        "caller in the JAX package and is not ported "
                        "(ROADMAP B13)")
    if a.dtype != torch.float32 or bt.dtype not in (torch.float32,
                                                    torch.int8):
        raise TypeError(f"gemm_f32 takes a float32 A and a float32 or int8 "
                        f"B, got {a.dtype} and {bt.dtype}")
    if a.ndim != 2 or bt.ndim != 2 or a.shape[1] != bt.shape[1]:
        raise ValueError(f"need a (M,K) and bt (N,K), got {tuple(a.shape)} "
                         f"and {tuple(bt.shape)}")
    n = bt.shape[0]
    for name, v in (("scale", scale), ("bias", bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be float32 ({n},), got "
                             f"{v.dtype} {tuple(v.shape)}")


def gemm_f32(a: torch.Tensor, bt: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor, act: str = "leaky") -> torch.Tensor:
    """a (M,K) f32, bt (N,K) f32 or int8 codes, scale/bias (N,) f32 ->
    (M,N) f32 ``act(a @ bt.T * scale + bias)``.

    On a CPU tensor this is the plain version; on a CUDA tensor it
    launches the kernel (or raises), in the form ``gemm_f32_form`` picks:
    three TF32 products of the operands' halves in the wgmma form, float32
    FMA in the ragged one. Both keep the JAX kernel's Precision.HIGHEST
    to within the float32 sum's own error."""
    _check_f32(a, bt, scale, bias)
    if a.device.type == "cpu":
        return gemm_f32_plain(a, bt, scale, bias, act)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_f32: unsupported device {a.device}")
    for t in (bt, scale, bias):
        if t.device != a.device:
            raise ValueError("gemm_f32: all operands on one device")
    a = a.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    m, k = a.shape
    n = bt.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    f = gemm_f32_form(m, n, k, a.data_ptr() % 16 == 0,
                      _build.sm_count(a.device))
    # the wgmma form reads B's halves (tf32_operands: fresh tensors,
    # 16-byte aligned), the ragged form B as it is
    if f.form == "wgmma":
        b0, b1 = tf32_operands(bt)
    else:
        b0, b1 = bt.contiguous(), None
    ws, cnt = split_buffers(a.device, f)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("gemm_f32", "gemm_f32",
                         [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p])
    err = fn(a.data_ptr(), b0.data_ptr(), ptr_or_none(b1), scale.data_ptr(),
             bias.data_ptr(), out.data_ptr(), m, n, k, KERNEL_ACT_CODES[act],
             int(bt.dtype == torch.int8), int(f.form == "wgmma"), f.splits,
             f.grid, ptr_or_none(ws), ptr_or_none(cnt),
             _build.stream_ptr(a.device))
    gemm_f32.launches += 1
    gemm_f32.ragged_launches += f.form == "ragged"
    _build.check(err, "gemm_f32")
    return out


gemm_f32.launches = 0
# launches of the ragged form (gemm_f32_form): K % 4 != 0 or a misaligned
# A; every fp32 and w8 detect shape takes the wgmma form
gemm_f32.ragged_launches = 0
