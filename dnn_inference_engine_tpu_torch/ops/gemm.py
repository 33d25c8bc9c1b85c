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
  f32, f32 out: ``gemm_f32`` (``csrc/gemm_f32.cu``). Its raw f32
  accumulator (``raw_acc``) has no ported caller yet: the tensor-parallel
  conv that reads it is ROADMAP item A14. A bf16 A has no caller in the
  JAX package and is refused (ROADMAP B13).

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
- ``raw_acc=True``: the int32 accumulator;
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


def gemm_fused_plain(a, bt, scale, bias, act="leaky", quantize_out=False,
                     raw_acc=False, s_out: Optional[Scale] = None):
    """Plain PyTorch version of ``gemm_fused`` (same arguments)."""
    mode = _mode(quantize_out, raw_acc, s_out)
    acc = int32_acc_plain(a, bt)
    if mode == 3:
        return acc
    y = apply_activation(acc.to(torch.float32) * scale + bias, act)
    if mode == 0:
        return quantize_act(y, s_out)
    if mode == 1:
        return torch.clamp(torch.round(y), -QMAX, QMAX).to(torch.int8)
    return y


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
    launches the kernel (or raises), which sums in float32 with no TF32:
    the JAX kernel runs at Precision.HIGHEST."""
    _check_f32(a, bt, scale, bias)
    if a.device.type == "cpu":
        return gemm_f32_plain(a, bt, scale, bias, act)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_f32: unsupported device {a.device}")
    for t in (bt, scale, bias):
        if t.device != a.device:
            raise ValueError("gemm_f32: all operands on one device")
    a, bt = a.contiguous(), bt.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    m, k = a.shape
    n = bt.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("gemm_f32", "gemm_f32",
                         [p, p, p, p, p, i, i, i, i, i, p])
    err = fn(a.data_ptr(), bt.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             out.data_ptr(), m, n, k, KERNEL_ACT_CODES[act],
             int(bt.dtype == torch.int8), _build.stream_ptr(a.device))
    gemm_f32.launches += 1
    _build.check(err, "gemm_f32")
    return out


gemm_f32.launches = 0
