"""Batch-folded tap-shift 3x3 int8 conv for the small-spatial tail layers.

Counterpart of ``dnn_inference_engine_tpu/ops/attic/pallas_tail.py``.
All N*H*W output pixels of the batch form one flat GEMM M-axis; the 3x3
SAME conv is the sum over the 9 taps (dh, dw) of the flat activation
shifted by dh*W + dw rows, times the tap's (Cin, Cout) weights, where a
(row, tap) whose source pixel lies outside its image, row range or column
range contributes zero. Then the fused epilogue ``y = act(acc*scale[co] +
bias[co])`` and, with ``quantize_out``, ``clip(round(y))``.

``conv3x3_bt`` is the wrapper of the Hopper kernel ``csrc/conv3x3_bt.cu``
beside its plain PyTorch version; a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises. The TPU kernel's tiling
arguments (``tm``, ``tn``, ``interpret``) have no counterpart here: the
kernel's tile is 128 flat rows x 128 channels, and ``bt_form`` says how
it launches (K split in chunks of 128 channels where the tiles alone
leave SMs idle).
"""

from __future__ import annotations

import ctypes

import torch

from dnn_inference_engine_tpu_torch.config import QMAX
from dnn_inference_engine_tpu_torch.ops import _build
from dnn_inference_engine_tpu_torch.ops.activations import (
    KERNEL_ACT_CODES, apply_activation)
from dnn_inference_engine_tpu_torch.ops.fused_conv import rs_weight_matrix
from dnn_inference_engine_tpu_torch.ops.gemm import (
    H100_SMS, WG_BM, WG_BN, GemmForm, int32_acc_plain, k_splits, ptr_or_none,
    split_buffers)
from dnn_inference_engine_tpu_torch.quant.quantize import f32_scalar
from dnn_inference_engine_tpu_torch.runtime.profiling import launch_span


def _bt_check(x, w, scale, bias):
    """The JAX kernel's preconditions (asserts there, raises here)."""
    if x.dtype != torch.int8 or w.dtype != torch.int8 or x.ndim != 4:
        raise TypeError(f"conv3x3_bt takes int8 x (N,H,W,Cin) and w, got "
                        f"{x.dtype} {tuple(x.shape)} and {w.dtype}")
    n, h, wd, c = x.shape
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"conv3x3_bt: w must be (3,3,{c},Cout), got "
                         f"{tuple(w.shape)}")
    if c % 128:
        raise ValueError(f"conv3x3_bt wants lane-tiled Cin (a multiple of "
                         f"128), got {c}")
    if wd + 1 > 32:
        raise ValueError(f"conv3x3_bt supports W <= 31, got {wd}")
    cout = int(w.shape[3])
    for arg, v in (("scale", scale), ("bias", bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (cout,):
            raise ValueError(f"conv3x3_bt: {arg} must be float32 ({cout},)")


def conv3x3_bt_plain(x, w, scale, bias, act="leaky", quantize_out=True):
    """Plain PyTorch version of ``conv3x3_bt``, in its own formulation:
    nine row-shifted products of the flat activation, each masked per
    (row, tap), summed in int32."""
    n, h, wd, c = x.shape
    cout = int(w.shape[3])
    m = n * h * wd
    pad = wd + 1                          # the largest |tap row offset|
    z = torch.zeros((pad, c), dtype=x.dtype, device=x.device)
    xf = torch.cat([z, x.reshape(m, c), z])
    g = torch.arange(m, device=x.device)
    yy, xx = (g // wd) % h, g % wd
    acc = torch.zeros((m, cout), dtype=torch.int32, device=x.device)
    for dh in (-1, 0, 1):
        for dw in (-1, 0, 1):
            off = pad + dh * wd + dw
            ok = ((yy + dh >= 0) & (yy + dh < h)
                  & (xx + dw >= 0) & (xx + dw < wd))
            p = int32_acc_plain(xf[off:off + m], w[dh + 1, dw + 1].t())
            acc += p * ok[:, None].to(torch.int32)
    y = apply_activation(acc.to(torch.float32) * scale + bias, act)
    if quantize_out:
        y = torch.clamp(torch.round(y), -QMAX, QMAX).to(torch.int8)
    return y.reshape(n, h, wd, cout)


BT_KC = 128                      # bytes of Cin a window chunk


def bt_form(m: int, cout: int, cin: int, sms: int = H100_SMS) -> GemmForm:
    """How ``conv3x3_bt`` launches on a card of ``sms`` SMs: tiles of 128
    of the ``m`` flat output rows x 128 of ``cout`` channels; K (9 taps of
    ``cin`` channels) split in whole window chunks of 128 channels, as
    ``gemm_fused`` splits its 128-byte stages where the tiles alone leave
    SMs idle (each chunk is 9 stages of the ring), at most one split a
    chunk."""
    tiles = -(-m // WG_BM) * -(-cout // WG_BN)
    chunks = cin // BT_KC
    splits = max(1, min(k_splits(tiles, 9 * chunks, sms), chunks))
    return GemmForm("wgmma", splits, tiles, min(tiles * splits, sms))


@launch_span("conv3x3_bt")
def conv3x3_bt(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, act: str = "leaky",
               quantize_out: bool = True) -> torch.Tensor:
    """Batch-folded 3x3/s1/SAME int8 conv with a fused epilogue.

    x: (N, H, W, Cin) int8 with Cin % 128 == 0 and W <= 31; w: (3, 3, Cin,
    Cout) int8; scale, bias: (Cout,) f32 (already folding 1/s_out where
    the output is requantized). Returns (N, H, W, Cout), int8 with
    ``quantize_out``, else f32. On the card the kernel reads the weights
    K-major as ``rs_weight_matrix(w)`` (made once, cached on ``w``)."""
    _bt_check(x, w, scale, bias)
    if x.device.type == "cpu":
        return conv3x3_bt_plain(x, w, scale, bias, act, quantize_out)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bt: unsupported device {x.device}")
    if any(t.device != x.device for t in (w, scale, bias)):
        raise ValueError("conv3x3_bt: all operands on one device")
    x = x.contiguous()
    if x.data_ptr() % 16:                 # the tensor map's base address
        x = x.clone()
    wt = rs_weight_matrix(w)
    scale, bias = scale.contiguous(), bias.contiguous()
    n, h, wd, cin = x.shape
    cout = int(w.shape[3])
    out = torch.empty((n, h, wd, cout), device=x.device,
                      dtype=torch.int8 if quantize_out else torch.float32)
    f = bt_form(n * h * wd, cout, cin, _build.sm_count(x.device))
    ws, cnt = split_buffers(x.device, f)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("conv3x3_bt", "conv3x3_bt",
                         [p, p, p, p, p] + [i] * 9 + [p, p, p])
    err = fn(x.data_ptr(), wt.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             out.data_ptr(), n, h, wd, cin, cout, int(quantize_out),
             KERNEL_ACT_CODES[act], f.splits, f.grid, ptr_or_none(ws),
             ptr_or_none(cnt), _build.stream_ptr(x.device))
    conv3x3_bt.launches += 1
    _build.check(err, "conv3x3_bt")
    return out


conv3x3_bt.launches = 0


def conv2d_w8a8_bt(xq, s_in, wq, s_w, b, act="leaky", stride=1,
                   padding="SAME", s_out=None):
    """W8A8 tail conv through ``conv3x3_bt``, in the JAX entry's order:
    scale = f32(s_in)*s_w, then /s_out; bias = b/s_out (f32 tensors on
    the data's device). int8 output with ``s_out``, f32 without."""
    if stride != 1 or padding != "SAME":
        raise ValueError(f"conv2d_w8a8_bt is 3x3/s1/SAME, got stride "
                         f"{stride}, padding {padding!r}")
    dev = xq.device
    scale = f32_scalar(s_in, dev) * s_w
    bias = b.to(torch.float32)
    if s_out is not None:
        so = f32_scalar(s_out, dev)
        scale, bias = scale / so, bias / so
    return conv3x3_bt(xq, wq, scale, bias, act=act,
                      quantize_out=s_out is not None)
