"""Per-layer conv tier selection: the gemm tier or the xla tier.

Counterpart of ``dnn_inference_engine_tpu/ops/dispatch.py``, with its
thresholds and its tier names: ``xla`` (the JAX package's XLA convs),
``pallas`` (its im2col + Pallas GEMM: the port's gemm tier) and ``auto``
(per layer). The port's tiers, per mode:

- fp32: ``ops/conv.conv2d_fp32`` (cuDNN) or
  ``ops/conv_lowering.conv2d_fp32_pallas`` (im2col + gemm_f32);
- w8: ``auto`` is ``ops/conv.conv2d_w8_bf16`` everywhere, as in the JAX
  package; only ``force_pallas`` takes ``conv2d_w8_pallas`` (im2col +
  gemm_f32 with int8 codes);
- w8a8: ``ops/conv.conv2d_w8a8`` (im2col + gemm_fused in the conv order)
  or ``ops/conv_lowering.conv2d_w8a8_gemm`` (im2col + gemm_fused in the
  folded order). Each keeps its own epilogue order, so ``auto`` picks the
  same codes as the JAX package.
"""

from __future__ import annotations

from dnn_inference_engine_tpu_torch.ops.conv import (
    conv2d_fp32, conv2d_w8_bf16, conv2d_w8a8)
from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
    conv2d_fp32_pallas, conv2d_w8_pallas, conv2d_w8a8_gemm)

# auto-policy thresholds
_MAX_SPATIAL = 32 * 32      # output positions per image
_MIN_K = 1024               # contraction depth kh*kw*cin


def _conv_out_hw(h, w, stride):
    return -(-h // stride), -(-w // stride)


def use_pallas(x_shape, w_shape, stride) -> bool:
    """True where the JAX package's ``auto`` takes its Pallas GEMM tier
    (the port's gemm tier): small spatial output and a deep contraction."""
    kh, kw, cin, _ = w_shape
    _, h, w, _ = x_shape
    ho, wo = _conv_out_hw(h, w, stride)
    return ho * wo <= _MAX_SPATIAL and kh * kw * cin >= _MIN_K


def conv2d_w8a8_dispatch(xq, s_in, wq, s_w, b, act="leaky", stride=1,
                         padding="SAME", s_out=None, force_pallas=False,
                         wt=None):
    """The ``auto`` W8A8 conv: the gemm tier where ``use_pallas`` says so
    (or ``force_pallas``), else the xla tier."""
    conv = (conv2d_w8a8_gemm
            if force_pallas or use_pallas(xq.shape, wq.shape, stride)
            else conv2d_w8a8)
    return conv(xq, s_in, wq, s_w, b, act=act, stride=stride,
                padding=padding, s_out=s_out, wt=wt)


def conv2d_w8_dispatch(x, wq, s_w, b, act="leaky", stride=1, padding="SAME",
                       force_pallas=False):
    """The w8 conv of the ``auto`` and ``pallas`` tiers: the bf16 conv
    everywhere, the gemm tier only when forced."""
    conv = conv2d_w8_pallas if force_pallas else conv2d_w8_bf16
    return conv(x, wq, s_w, b, act=act, stride=stride, padding=padding)


def conv2d_fp32_dispatch(x, w, b, act="leaky", stride=1, padding="SAME",
                         force_pallas=False):
    """The ``auto`` fp32 conv: the gemm tier where ``use_pallas`` says so
    (or ``force_pallas``), else cuDNN's conv."""
    conv = (conv2d_fp32_pallas
            if force_pallas or use_pallas(x.shape, w.shape, stride)
            else conv2d_fp32)
    return conv(x, w, b, act=act, stride=stride, padding=padding)


def tier_report(model, batch: int = 1, mode: str = "w8a8"):
    """Which tier ``auto`` picks for every conv layer, as the JAX
    package's ``tier_report`` gives it: ``(layer, description, tier)``
    with tier ``pallas`` or ``xla``. Like the JAX report it reads shapes
    only, and ``mode`` does not change it (w8's ``auto`` takes the bf16
    conv whatever the report says)."""
    # imported here: the models package imports this module
    from dnn_inference_engine_tpu_torch.models.layers import (
        Conv, MaxPool, Route, Upsample)
    chans = model.out_channels()
    report = []
    sizes = []                      # (h, w) of each layer's output
    h = w = model.input_size
    prev_c = model.in_ch
    for li, layer in enumerate(model.layers):
        if isinstance(layer, Conv):
            wshape = (layer.ksize, layer.ksize, prev_c, layer.out_ch)
            tier = ("pallas" if use_pallas((batch, h, w, prev_c), wshape,
                                           layer.stride) else "xla")
            report.append((li, f"conv{layer.ksize}x{layer.ksize}"
                           f" {prev_c}->{layer.out_ch} @{h}x{w}", tier))
            h, w = _conv_out_hw(h, w, layer.stride)
        elif isinstance(layer, MaxPool) and layer.stride > 1:
            h, w = -(-h // layer.stride), -(-w // layer.stride)
        elif isinstance(layer, Upsample):
            h, w = h * layer.stride, w * layer.stride
        elif isinstance(layer, Route):
            h, w = sizes[layer.layers[0]]
        sizes.append((h, w))
        prev_c = chans[li]
    return report
