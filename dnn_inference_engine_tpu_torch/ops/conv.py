"""Convolutions: the fp32 reference conv and the W8A8 int8 conv.

Counterpart of ``dnn_inference_engine_tpu/ops/conv.py``. NHWC
activations, HWIO weights. PyTorch has no int8-in, int32-accumulate conv
on CUDA (and ``F.conv2d`` on int8 wraps around), so ``conv2d_w8a8`` is
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


def conv2d_fp32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                act: str = "leaky", stride: int = 1,
                padding="SAME") -> torch.Tensor:
    """FP32 reference conv (calibration's forward) in full float32: TF32
    is off for cuDNN and matmul, matching the JAX path's HIGHEST
    precision."""
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
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    finally:
        torch.set_float32_matmul_precision(prev)
    return apply_activation(y.permute(0, 2, 3, 1) + b, act)


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
