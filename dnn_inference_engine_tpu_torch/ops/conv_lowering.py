"""Conv -> GEMM lowering: im2col patch extraction and the gemm conv tiers.

Counterpart of ``dnn_inference_engine_tpu/ops/conv_lowering.py``. Patches
are ordered (kh-major, kw, cin) along K, matching a plain
``w.reshape(kh*kw*cin, cout)`` of HWIO weights. Zero padding is exact for
f32 and for symmetric int8 (zero-point 0).

The gemm tiers stay im2col + GEMM, as their JAX counterparts are (im2col +
the Pallas GEMM): ``conv2d_w8a8_gemm`` is ``conv2d_w8a8_pallas``. The xla
tier's W8A8 conv (``ops/conv.conv2d_w8a8``) takes ``extract_patches`` only
for the forms its kernel refuses (``ops/conv.conv_w8a8_form``) and in its
plain version.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from dnn_inference_engine_tpu_torch.ops.fused_conv import _pad_hw
from dnn_inference_engine_tpu_torch.ops.gemm import gemm_f32, int8_gemm_fused
from dnn_inference_engine_tpu_torch.quant.quantize import Scale, f32_scalar


def _same_pads(h: int, k: int, s: int) -> Tuple[int, int]:
    """XLA 'SAME' padding (lo, hi) for one spatial dim."""
    out = -(-h // s)
    total = max((out - 1) * s + k - h, 0)
    lo = total // 2
    return lo, total - lo


def extract_patches(x: torch.Tensor, kh: int, kw: int, stride: int,
                    padding="SAME",
                    out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(N,H,W,C) -> (N,Ho,Wo,kh*kw*C) patch tensor (im2col).

    ``out_hw`` keeps only the first (Ho, Wo) output positions — the
    shifted-fold stages trim their VALID conv's junk rows and columns, so
    their patches are never built.
    """
    n, h, w, c = x.shape
    if padding == "SAME":
        ph = _same_pads(h, kh, stride)
        pw = _same_pads(w, kw, stride)
    elif padding == "VALID":
        ph = pw = (0, 0)
    else:
        ph, pw = padding
    xp = _pad_hw(x, ph[0], ph[1], pw[0], pw[1]) if any(ph + pw) else x
    ho = (xp.shape[1] - kh) // stride + 1
    wo = (xp.shape[2] - kw) // stride + 1
    if out_hw is not None:
        ho, wo = min(ho, out_hw[0]), min(wo, out_hw[1])
    if kh == kw == 1 and stride == 1:
        return xp[:, :ho, :wo]
    # one copy of the (N, Ho, Wo, kh, kw, C) window view
    win = xp.unfold(1, kh, stride).unfold(2, kw, stride)[:, :ho, :wo]
    return win.permute(0, 1, 2, 4, 5, 3).reshape(n, ho, wo, kh * kw * c)


def gemm_weights(wq: torch.Tensor) -> torch.Tensor:
    """HWIO (kh,kw,Cin,Cout) -> the (Cout, kh*kw*Cin) K-major matrix the
    GEMM kernel reads."""
    kh, kw, cin, cout = wq.shape
    return wq.reshape(kh * kw * cin, cout).T.contiguous()


def conv2d_w8a8_gemm(xq: torch.Tensor, s_in: Scale, wq: torch.Tensor,
                     s_w: torch.Tensor, b: torch.Tensor, act: str = "leaky",
                     stride: int = 1, padding="SAME",
                     s_out: Optional[Scale] = None,
                     wt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gemm conv tier: counterpart of the JAX package's
    ``conv_lowering.conv2d_w8a8_pallas``. im2col, then ``int8_gemm_fused``
    (the gemm_fused kernel on the card), which folds 1/s_out into scale
    and bias — the folded order, not ``conv2d_w8a8``'s conv order; f32
    output without ``s_out``. ``wt``: the precomputed
    ``gemm_weights(wq)``."""
    kh, kw, _, cout = wq.shape
    patches = extract_patches(xq, kh, kw, stride, padding)
    n, ho, wo, k = patches.shape
    if wt is None:
        wt = gemm_weights(wq)
    dev = xq.device
    if s_out is not None:
        s_out = f32_scalar(s_out, dev)     # 1/s_out in float32, as jnp
    out = int8_gemm_fused(patches.reshape(n * ho * wo, k), wt,
                          f32_scalar(s_in, dev) * s_w, b, act=act,
                          s_out=s_out)
    return out.reshape(n, ho, wo, cout)


def conv2d_w8_pallas(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                     b: torch.Tensor, act: str = "leaky", stride: int = 1,
                     padding="SAME",
                     wt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The weight-only gemm tier: f32 activations x int8 codes, im2col
    then ``gemm_f32`` with an int8 B (the codes become exact f32 in the
    kernel), ``s_w`` as the column scale. Counterpart of the JAX
    ``conv_lowering.conv2d_w8_pallas``. ``wt``: the precomputed
    ``gemm_weights(wq)`` (the forwards pass ``kmajor_weights(wq)``, made
    once, whose float32 codes ``gemm_f32`` also caches)."""
    kh, kw, _, cout = wq.shape
    patches = extract_patches(x, kh, kw, stride, padding)
    n, ho, wo, k = patches.shape
    if wt is None:
        wt = gemm_weights(wq)
    out = gemm_f32(patches.reshape(n * ho * wo, k), wt,
                   s_w.to(torch.float32), b, act=act)
    return out.reshape(n, ho, wo, cout)


_unit_scales: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def unit_scale(n: int, device) -> torch.Tensor:
    """The (n,) float32 column scale of ones, made once per (n, device)."""
    key = (n, torch.device(device))
    ones = _unit_scales.get(key)
    if ones is None:
        ones = torch.ones(n, dtype=torch.float32, device=device)
        _unit_scales[key] = ones
    return ones


def conv2d_fp32_pallas(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       act: str = "leaky", stride: int = 1,
                       padding="SAME",
                       wt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fp32 gemm tier: im2col then ``gemm_f32`` with unit column
    scales. Counterpart of the JAX ``conv_lowering.conv2d_fp32_pallas``.
    ``wt``: the precomputed ``gemm_weights(w)`` (the forwards pass
    ``kmajor_weights(w)``, made once, whose TF32 split ``gemm_f32`` also
    caches)."""
    kh, kw, _, cout = w.shape
    patches = extract_patches(x, kh, kw, stride, padding)
    n, ho, wo, k = patches.shape
    if wt is None:
        wt = gemm_weights(w)
    out = gemm_f32(patches.reshape(n * ho * wo, k), wt,
                   unit_scale(cout, x.device), b, act=act)
    return out.reshape(n, ho, wo, cout)
