"""Convolutions, the xla tier: fp32, w8 (strict f32 and bf16) and W8A8.

Counterpart of ``dnn_inference_engine_tpu/ops/conv.py``. NHWC
activations, HWIO weights. The float convs are cuDNN's, as the JAX
package's are XLA's. PyTorch has no int8-in, int32-accumulate conv on
CUDA (and ``F.conv2d`` on int8 wraps around), so ``conv2d_w8a8`` is
im2col plus the fused int8 GEMM (ops/gemm.py) with the epilogue in
``conv2d_w8a8``'s order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from dnn_inference_engine_tpu_torch.ops.activations import apply_activation
from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
    _same_pads, extract_patches, gemm_weights)
from dnn_inference_engine_tpu_torch.ops.gemm import gemm_fused
from dnn_inference_engine_tpu_torch.quant.quantize import Scale, f32_scalar


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int, padding,
               allow_tf32: bool = False) -> torch.Tensor:
    """NHWC f32 x HWIO f32 -> NHWC f32 with XLA's padding rules, on cuDNN
    on the card. The float32 matmul precision is "highest" throughout;
    ``allow_tf32`` only for operands that TF32 holds exactly
    (conv2d_w8_bf16)."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    n, h, wd, _ = x.shape
    if padding == "SAME":
        ph, pw = _same_pads(h, kh, stride), _same_pads(wd, kw, stride)
    elif padding == "VALID":
        ph = pw = (0, 0)
    else:
        ph, pw = padding
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.backends.cudnn.flags(enabled=True,
                                        allow_tf32=allow_tf32):
            y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    finally:
        torch.set_float32_matmul_precision(prev)
    return y.permute(0, 2, 3, 1)


def conv2d_fp32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                act: str = "leaky", stride: int = 1,
                padding="SAME") -> torch.Tensor:
    """FP32 reference conv (calibration's forward) in full float32: TF32
    is off for cuDNN and matmul, matching the JAX path's HIGHEST
    precision."""
    return apply_activation(_conv_nhwc(x, w, stride, padding) + b, act)


def conv2d_w8(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
              b: torch.Tensor, act: str = "leaky", stride: int = 1,
              padding="SAME") -> torch.Tensor:
    """INT8 weight-only conv, strict f32: f32 activations convolved with
    the int8 codes as f32 (TF32 off, as the JAX conv's HIGHEST), then the
    per-output-channel ``y * s_w + b`` and the activation."""
    y = _conv_nhwc(x, wq.to(torch.float32), stride, padding)
    return apply_activation(y * s_w + b, act)


def conv2d_w8_bf16(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                   b: torch.Tensor, act: str = "leaky", stride: int = 1,
                   padding="SAME") -> torch.Tensor:
    """The fast weight-only conv, with the JAX ``conv2d_w8_bf16``'s
    semantics: activations rounded to bf16, int8 codes (exact in bf16),
    products summed in f32, then ``y * s_w + b`` and the activation.

    ``F.conv2d`` on bf16 tensors would round its f32 sums to bf16 on the
    way out, which JAX (``preferred_element_type=float32``) does not. So
    x is rounded to bf16 and back, and the conv runs on f32 tensors with
    cuDNN's TF32 allowed: a bf16 value (8 significant bits) and an int8
    code (7) fit TF32's 11 exactly, so the tensor cores form the same
    products as an f32 conv and sum them in f32, at tensor-core speed.
    This is XLA's conv in the JAX package, not a Pallas kernel, so cuDNN
    carries it. On the CPU the flag does nothing: the conv is plain
    f32."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    y = _conv_nhwc(xb, wq.to(torch.float32), stride, padding,
                   allow_tf32=True)
    return apply_activation(y * s_w + b, act)


def conv2d_w8a8(xq: torch.Tensor, s_in: Scale, wq: torch.Tensor,
                s_w: torch.Tensor, b: torch.Tensor, act: str = "leaky",
                stride: int = 1, padding="SAME",
                s_out: Optional[Scale] = None,
                wt: Optional[torch.Tensor] = None, out_hw=None):
    """Full W8A8 conv: int8 x int8 -> int32, then acc * (s_in * s_w) + b,
    the activation, and (with ``s_out``) requantization to int8 —
    otherwise the f32 output. ``wt`` is the precomputed
    ``gemm_weights(wq)``; ``out_hw`` trims the output (see
    extract_patches)."""
    kh, kw, _, cout = wq.shape
    patches = extract_patches(xq, kh, kw, stride, padding, out_hw)
    n, ho, wo, k = patches.shape
    if wt is None:
        wt = gemm_weights(wq)
    scale = f32_scalar(s_in, xq.device) * s_w
    out = gemm_fused(patches.reshape(n * ho * wo, k), wt, scale, b,
                     act=act, s_out=s_out)
    return out.reshape(n, ho, wo, cout)
