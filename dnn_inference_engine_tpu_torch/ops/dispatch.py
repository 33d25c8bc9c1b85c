"""Per-layer conv tier selection: the gemm tier or the xla tier.

Counterpart of ``dnn_inference_engine_tpu/ops/dispatch.py``, with its
thresholds. The JAX package's tiers are XLA's native int8 conv and the
Pallas im2col + GEMM; the port's are ``ops/conv.conv2d_w8a8`` (im2col +
gemm_fused in the conv order) and ``ops/conv_lowering.conv2d_w8a8_gemm``
(im2col + gemm_fused in the folded order). Each tier keeps its own
epilogue order, so ``auto`` picks the same codes as the JAX package.
"""

from __future__ import annotations

from dnn_inference_engine_tpu_torch.ops.conv import conv2d_w8a8
from dnn_inference_engine_tpu_torch.ops.conv_lowering import conv2d_w8a8_gemm

# auto-policy thresholds
_MAX_SPATIAL = 32 * 32      # output positions per image
_MIN_K = 1024               # contraction depth kh*kw*cin


def use_pallas(x_shape, w_shape, stride) -> bool:
    """True where the JAX package's ``auto`` takes its Pallas GEMM tier
    (the port's gemm tier): small spatial output and a deep contraction."""
    kh, kw, cin, _ = w_shape
    _, h, w, _ = x_shape
    ho, wo = -(-h // stride), -(-w // stride)
    return ho * wo <= _MAX_SPATIAL and kh * kw * cin >= _MIN_K


def conv2d_w8a8_dispatch(xq, s_in, wq, s_w, b, act="leaky", stride=1,
                         padding="SAME", s_out=None, wt=None):
    """The ``auto`` conv: the gemm tier where ``use_pallas`` says so, else
    the xla tier."""
    conv = (conv2d_w8a8_gemm if use_pallas(xq.shape, wq.shape, stride)
            else conv2d_w8a8)
    return conv(xq, s_in, wq, s_w, b, act=act, stride=stride,
                padding=padding, s_out=s_out, wt=wt)
