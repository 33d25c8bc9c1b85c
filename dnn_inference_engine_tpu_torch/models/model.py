"""Generic layer-list model with fp32 and w8a8 forward passes.

Counterpart of ``dnn_inference_engine_tpu/models/model.py``. Params are
a list with one dict per layer:
  Conv fp32:  {"w": f32 HWIO, "b": f32}
  Conv int8:  {"wq": int8 HWIO, "s_w": f32 (Cout,), "b": f32}
  otherwise:  {}

``act_scales[li]`` is the calibrated scale of the tensor entering layer
li (``act_scales[n_layers]``: the final output). The w8a8 forward keeps
tensors int8 between convs; max pools are scale-preserving.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from dnn_inference_engine_tpu_torch.models.layers import Conv, Dense, MaxPool, Route
from dnn_inference_engine_tpu_torch.ops.conv import conv2d_fp32, conv2d_w8a8
from dnn_inference_engine_tpu_torch.ops.pool import maxpool
from dnn_inference_engine_tpu_torch.quant.quantize import dequantize, quantize_act


def _unported(layer):
    return NotImplementedError(
        f"{type(layer).__name__} layers are ported with the stretch models "
        "(ROADMAP item A10)")


class Model:
    """A named tuple-of-layers model (see models/yolov2_tiny.py)."""

    def __init__(self, name: str, layers: Sequence, in_ch: int = 3,
                 input_size: int = 416):
        self.name = name
        self.layers = tuple(layers)
        self.in_ch = in_ch
        self.input_size = input_size

    def out_channels(self) -> List[int]:
        """Output channel count of every layer."""
        chans: List[int] = []
        prev = self.in_ch
        for layer in self.layers:
            if isinstance(layer, Conv):
                prev = layer.out_ch
            elif isinstance(layer, Route):
                prev = sum(chans[j] for j in layer.layers)
            elif isinstance(layer, Dense):
                prev = layer.out
            chans.append(prev)
        return chans

    def init_params(self, generator: torch.Generator,
                    device="cuda") -> List[Dict]:
        """Random fp32 params (He init). Drawn on the CPU from
        ``generator`` and then moved, so one seed gives the same weights
        on every device."""
        chans = self.out_channels()
        params: List[Dict] = []
        prev = self.in_ch
        for li, layer in enumerate(self.layers):
            if isinstance(layer, Conv):
                fan_in = layer.ksize * layer.ksize * prev
                w = torch.randn(layer.ksize, layer.ksize, prev, layer.out_ch,
                                generator=generator) * (2.0 / fan_in) ** 0.5
                b = 0.01 * torch.randn(layer.out_ch, generator=generator)
                params.append({"w": w.to(device), "b": b.to(device)})
            elif isinstance(layer, MaxPool):
                params.append({})
            else:
                raise _unported(layer)
            prev = chans[li]
        return params

    @torch.no_grad()
    def forward_fp32(self, params, x, capture_inputs: bool = False):
        """FP32 forward. ``capture_inputs``: also return the tensor
        entering every layer plus the final output (calibration)."""
        captured: List[torch.Tensor] = []
        for li, layer in enumerate(self.layers):
            captured.append(x)
            p = params[li]
            if isinstance(layer, Conv):
                x = conv2d_fp32(x, p["w"], p["b"], act=layer.act,
                                stride=layer.stride, padding=layer.padding)
            elif isinstance(layer, MaxPool):
                x = maxpool(x, layer.size, layer.stride, layer.padding)
            else:
                raise _unported(layer)
        captured.append(x)
        if capture_inputs:
            return x, tuple(captured)
        return x

    @torch.no_grad()
    def forward_w8a8(self, qparams, act_scales, x):
        """Layer-by-layer W8A8 forward: x enters f32, is quantized with
        the first conv's input scale and stays int8 across the chain;
        linear convs (the head) emit f32."""
        cur_scale: Optional[float] = None
        for li, layer in enumerate(self.layers):
            s_next = act_scales[li + 1]
            if isinstance(layer, Conv):
                p = qparams[li]
                if cur_scale is None:
                    cur_scale = act_scales[li]
                    x = quantize_act(x, cur_scale)
                requant = layer.act != "linear"
                x = conv2d_w8a8(x, cur_scale, p["wq"], p["s_w"], p["b"],
                                act=layer.act, stride=layer.stride,
                                padding=layer.padding,
                                s_out=s_next if requant else None)
                cur_scale = s_next if requant else None
            elif isinstance(layer, MaxPool):
                x = maxpool(x, layer.size, layer.stride, layer.padding)
            else:
                raise _unported(layer)
        return x if cur_scale is None else dequantize(x, cur_scale)
