"""Quantization: per-channel weight quant, activation calibration, requant.

Counterpart of ``dnn_inference_engine_tpu/quant/quantize.py``. Symmetric
int8 clipped to [-127, 127]; weights per output channel
(``s_c = max|W_c| / 127``), activations per tensor.

Scales stay float32 tensors on the data's device: a division by a Python
number or a CPU scalar may be lowered to a multiply by its reciprocal on
CUDA, which rounds differently from the division the JAX package does.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

from dnn_inference_engine_tpu_torch.config import QMAX

Scale = Union[float, torch.Tensor]


def f32_scalar(v: Scale, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device`` (rounds a Python float to f32
    exactly as ``jnp.float32`` does)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.tensor(v, dtype=torch.float32, device=device)


def quantize_weights_per_channel(w: torch.Tensor):
    """(..., Cout) f32 -> int8 codes + (Cout,) f32 scales (HWIO or dense)."""
    absmax = torch.amax(torch.abs(w), dim=tuple(range(w.ndim - 1)))
    s_w = torch.clamp_min(absmax, 1e-12) / f32_scalar(QMAX, w.device)
    wq = torch.clamp(torch.round(w / s_w), -QMAX, QMAX).to(torch.int8)
    return wq, s_w.to(torch.float32)


def quantize_act(x: torch.Tensor, scale: Scale) -> torch.Tensor:
    """f32 -> int8 with a per-tensor scale: divide, round half to even,
    clip to +-127."""
    s = f32_scalar(scale, x.device)
    return torch.clamp(torch.round(x / s), -QMAX, QMAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale: Scale) -> torch.Tensor:
    return q.to(torch.float32) * f32_scalar(scale, q.device)


@torch.no_grad()
def calibrate(model, params, images: np.ndarray, batch: int = 8,
              device="cuda") -> List[float]:
    """Per-layer input activation scales for W8A8: the max-abs of every
    layer's input over the fp32 forward of ``images``, divided by 127.
    One scale per layer plus one for the final output."""
    absmax = np.zeros((len(model.layers) + 1,), np.float64)
    for i in range(0, len(images), batch):
        chunk = torch.as_tensor(np.asarray(images[i:i + batch], np.float32),
                                device=device)
        _, captured = model.forward_fp32(params, chunk, capture_inputs=True)
        for li, t in enumerate(captured):
            absmax[li] = max(absmax[li], float(torch.amax(torch.abs(t))))
    scales = np.maximum(absmax, 1e-12) / QMAX
    return [float(s) for s in scales]


def quantize_model_params(params: List[Dict], layers) -> List[Dict]:
    """Quantize every conv/dense layer's weights: ``{"wq", "s_w", "b"}``;
    other layers pass through."""
    out = []
    for p in params:
        if p and "w" in p:
            wq, s_w = quantize_weights_per_channel(p["w"])
            q = {"wq": wq, "s_w": s_w}
            if "b" in p:
                q["b"] = p["b"]
            out.append(q)
        else:
            out.append(p)
    return out
