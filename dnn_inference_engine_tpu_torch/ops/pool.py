"""Max pooling over NHWC tensors, int8 or f32.

Counterpart of ``dnn_inference_engine_tpu/ops/pool.py``. Written with
slices and ``torch.maximum`` because ``max_pool2d`` takes no int8.
Pooling is scale-preserving on int8 codes (max commutes with the
monotone requantization).
"""

from __future__ import annotations

import torch

from dnn_inference_engine_tpu_torch.ops.conv_lowering import _same_pads


def _lowest(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def maxpool(x: torch.Tensor, size: int = 2, stride: int = 2,
            padding: str = "VALID") -> torch.Tensor:
    """stride == size: the non-overlapping VALID pool.
    stride == 1: darknet's 'same' pool — the window runs past the right
    and bottom edges only, which are padded with the dtype's minimum
    (-inf for f32, -128 for int8), so the output keeps the input's size.
    padding "SAME" with stride > 1 (the ResNet-18 stem's 3x3/s2 pool):
    XLA's SAME pads, ceil(H / stride) outputs, the padding split with
    the smaller half first (112 px, 3x3/s2: 0 rows top and left, 1
    bottom and right), filled with the dtype's minimum.
    """
    n, h, w, c = x.shape
    if stride == 1:
        ph, pw = (0, size - 1), (0, size - 1)
    elif padding == "SAME":
        ph, pw = _same_pads(h, size, stride), _same_pads(w, size, stride)
    else:
        ph = pw = (0, 0)
    if any(ph + pw):
        xp = torch.full((n, h + sum(ph), w + sum(pw), c), _lowest(x.dtype),
                        dtype=x.dtype, device=x.device)
        xp[:, ph[0]:ph[0] + h, pw[0]:pw[0] + w] = x
    else:
        xp = x
    ho = (xp.shape[1] - size) // stride + 1
    wo = (xp.shape[2] - size) // stride + 1
    out = None
    for i in range(size):
        for j in range(size):
            sl = xp[:, i:i + (ho - 1) * stride + 1:stride,
                    j:j + (wo - 1) * stride + 1:stride]
            out = sl if out is None else torch.maximum(out, sl)
    return out.contiguous()
