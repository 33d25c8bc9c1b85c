"""Activation functions, in f32.

Counterpart of ``dnn_inference_engine_tpu/ops/activations.py``.
"""

from __future__ import annotations

import torch

from dnn_inference_engine_tpu_torch.config import LEAKY_SLOPE

# The activation codes the CUDA kernels take (csrc/*.cu epilogues).
KERNEL_ACT_CODES = {"linear": 0, "leaky": 1, "relu": 2}


def leaky_relu(x: torch.Tensor, slope: float = LEAKY_SLOPE) -> torch.Tensor:
    return torch.where(x > 0, x, slope * x)


def apply_activation(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "leaky":
        return leaky_relu(x)
    if act == "relu":
        return torch.clamp_min(x, 0.0)
    if act == "linear":
        return x
    raise ValueError(f"unknown activation: {act}")
