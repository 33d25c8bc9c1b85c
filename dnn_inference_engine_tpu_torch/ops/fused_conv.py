"""Space-to-depth fold transforms, the fused stem and the shifted s2d(2).

Counterpart of ``dnn_inference_engine_tpu/ops/pallas_conv.py``. The
weight folds are its numpy code, copied verbatim; the layout ops are
torch. Three of its Pallas kernels have Hopper ports here, each a wrapper
beside its plain PyTorch version:

- ``stem_fused_k2`` (``csrc/stem_fused_k2.cu``): quantize + shifted
  s2d(4) + 2x2 folded int8 conv + int32 group-max + epilogue, in one pass;
- ``stem_fused_dg`` (``csrc/stem_fused_dg.cu``): the same function in the
  per-tap formulation, reading host-prepared K-major weight slabs;
- ``shift_s2d2`` (``csrc/shift_s2d2.cu``, for ``shift_s2d2_pallas``):
  pad + shifted space-to-depth(2) of an int8 tensor.

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

import numpy as np
import torch

from dnn_inference_engine_tpu_torch.config import QMAX
from dnn_inference_engine_tpu_torch.ops import _build
from dnn_inference_engine_tpu_torch.ops.activations import (
    KERNEL_ACT_CODES, apply_activation)
from dnn_inference_engine_tpu_torch.ops.gemm import int32_acc_plain
from dnn_inference_engine_tpu_torch.quant.quantize import f32_scalar


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
    x, w = x.contiguous(), w.contiguous()
    # the kernel reads w in 32-bit words and x in 4-element vectors
    if w.data_ptr() % 4:
        w = w.clone()
    if x.data_ptr() % 16:
        x = x.clone()
    scale, bias = scale.contiguous(), bias.contiguous()
    n, h, wd, _ = x.shape
    go = w.shape[3] // 4
    out = torch.empty((n, h // 4, wd // 4, go), dtype=torch.int8,
                      device=x.device)
    s = float(s_in) if not exact_u8 else 1.0
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("stem_fused_k2", "stem_fused_k2",
                         [p, p, p, p, ctypes.c_float, p, i, i, i, i, i, i, i,
                          p])
    err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             s, out.data_ptr(), n, h, wd, int(w.shape[2]),
             _stem_band_rows(n, h // 4, sms), int(exact_u8),
             KERNEL_ACT_CODES[act], _build.stream_ptr(x.device))
    stem_fused_k2.launches += 1
    _build.check(err, "stem_fused_k2")
    return out


stem_fused_k2.launches = 0


def _stem_band_rows(n: int, hout: int, sms: int) -> int:
    """Output rows per block of the stem kernel: 4, or fewer while the grid
    would not give every SM two blocks (one block stages its band's input
    rows and the folded weights once)."""
    rows = 4
    while rows > 1 and n * -(-hout // rows) < 2 * sms:
        rows //= 2
    return rows


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
    slabs, K-major: the dg kernel's shared-memory layout. Rows 48.. (a
    cin_pad) are dropped. Made once and cached on ``w`` (until ``w`` is
    written in place)."""
    cached = getattr(w, "_dg_slabs", None)
    if cached is not None and cached[0] == w._version:
        return cached[1]
    slabs = (w[:, :, :48, :].reshape(4, 48, w.shape[3]).transpose(1, 2)
             .contiguous())
    w._dg_slabs = (w._version, slabs)
    return slabs


def stem_fused_dg(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, s_in, act: str = "leaky",
                  exact_u8: bool = False) -> torch.Tensor:
    """``stem_fused_k2`` in the per-tap formulation: the same arguments
    and the same result, bit for bit. Any cin_pad rows of ``w`` are
    dropped (their input lanes are zero). On the card the kernel reads
    the weights as ``stem_dg_weight_slabs(w)``."""
    _stem_check(x, w, scale, bias, exact_u8, "stem_fused_dg")
    if x.device.type == "cpu":
        return stem_fused_dg_plain(x, w, scale, bias, s_in, act, exact_u8)
    _stem_card_check(x, w, scale, bias, "stem_fused_dg")
    slabs = stem_dg_weight_slabs(w)
    if slabs.data_ptr() % 16:        # read by 16-byte cp.async
        raise ValueError("stem_fused_dg: weight slabs not 16-byte aligned")
    x = x.contiguous()
    if x.data_ptr() % 16:            # read in 4-element vectors
        x = x.clone()
    scale, bias = scale.contiguous(), bias.contiguous()
    n, h, wd, _ = x.shape
    out = torch.empty((n, h // 4, wd // 4, 64), dtype=torch.int8,
                      device=x.device)
    s = float(s_in) if not exact_u8 else 1.0
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("stem_fused_dg", "stem_fused_dg",
                         [p, p, p, p, ctypes.c_float, p, i, i, i, i, i, i, p])
    err = fn(x.data_ptr(), slabs.data_ptr(), scale.data_ptr(),
             bias.data_ptr(), s, out.data_ptr(), n, h, wd,
             _stem_band_rows(n, h // 4, sms), int(exact_u8),
             KERNEL_ACT_CODES[act], _build.stream_ptr(x.device))
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
