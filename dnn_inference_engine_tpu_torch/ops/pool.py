"""Max pooling over NHWC tensors, int8 or f32.

Counterpart of ``dnn_inference_engine_tpu/ops/pool.py``. Written with
slices and ``torch.maximum`` because ``max_pool2d`` takes no int8.
Pooling is scale-preserving on int8 codes (max commutes with the
monotone requantization).
"""

from __future__ import annotations

import torch


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
    """
    if padding == "SAME" and stride != 1:
        raise NotImplementedError(
            "symmetric SAME max-pool (ResNet-18 stem) is ported with the "
            "stretch models, ROADMAP item A10")
    n, h, w, c = x.shape
    if stride == 1:
        xp = torch.full((n, h + size - 1, w + size - 1, c), _lowest(x.dtype),
                        dtype=x.dtype, device=x.device)
        xp[:, :h, :w] = x
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
