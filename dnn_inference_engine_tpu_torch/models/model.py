"""Generic layer-list model with fp32 and w8a8 forward passes.

Counterpart of ``dnn_inference_engine_tpu/models/model.py``. Params are
a list with one dict per layer:
  Conv fp32:  {"w": f32 HWIO, "b": f32}
  Conv int8:  {"wq": int8 HWIO, "s_w": f32 (Cout,), "b": f32}
  otherwise:  {}

``act_scales[li]`` is the calibrated scale of the tensor entering layer
li (``act_scales[n_layers]``: the final output). The w8a8 forward keeps
tensors int8 between convs; max pools and upsamples are scale-preserving,
and a route rescales its pieces to its own output scale in f32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dnn_inference_engine_tpu_torch.models.layers import (
    Conv, Dense, MaxPool, Route, Shortcut, Upsample,
)
from dnn_inference_engine_tpu_torch.ops.conv import conv2d_fp32, conv2d_w8a8
from dnn_inference_engine_tpu_torch.ops.pool import maxpool
from dnn_inference_engine_tpu_torch.quant.quantize import dequantize, quantize_act


def _unported(layer):
    return NotImplementedError(
        f"{type(layer).__name__} layers are ported with ResNet-18 "
        "(ROADMAP item A10)")


def _upsample_nearest(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Nearest-neighbour upsample of an NHWC tensor of any dtype."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, stride, w, stride, c)
    return x.reshape(n, h * stride, w * stride, c)


def _to_f32(t: torch.Tensor, s) -> torch.Tensor:
    return t if s is None else dequantize(t, s)


class Model:
    """A named tuple-of-layers model (see models/yolov2_tiny.py)."""

    def __init__(self, name: str, layers: Sequence, in_ch: int = 3,
                 input_size: int = 416,
                 out_layers: Optional[Tuple[int, ...]] = None):
        """``out_layers``: the layers whose outputs form the result (the
        two heads of YOLOv3-tiny); None means the last layer's output."""
        self.name = name
        self.layers = tuple(layers)
        self.in_ch = in_ch
        self.input_size = input_size
        self.out_layers = tuple(out_layers) if out_layers is not None else None
        for li, layer in enumerate(self.layers):
            if isinstance(layer, Route) and not all(
                    0 <= j < li for j in layer.layers):
                raise ValueError(f"layer {li}: route {layer.layers} must "
                                 "name earlier layers")
            if isinstance(layer, Shortcut) and not 0 <= layer.frm < li:
                raise ValueError(f"layer {li}: shortcut from {layer.frm} "
                                 "must name an earlier layer")

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
            elif isinstance(layer, (MaxPool, Route, Upsample)):
                params.append({})
            else:
                raise _unported(layer)
            prev = chans[li]
        return params

    def _select_outputs(self, outs, x):
        if self.out_layers is not None:
            return tuple(outs[j] for j in self.out_layers)
        return x

    @torch.no_grad()
    def forward_fp32(self, params, x, capture_inputs: bool = False):
        """FP32 forward: the head, or the tuple of ``out_layers`` outputs.
        ``capture_inputs``: also return the tensor entering every layer
        plus the final output (calibration)."""
        captured: List[torch.Tensor] = []
        outs: List[torch.Tensor] = []
        for li, layer in enumerate(self.layers):
            captured.append(x)
            p = params[li]
            if isinstance(layer, Conv):
                x = conv2d_fp32(x, p["w"], p["b"], act=layer.act,
                                stride=layer.stride, padding=layer.padding)
            elif isinstance(layer, MaxPool):
                x = maxpool(x, layer.size, layer.stride, layer.padding)
            elif isinstance(layer, Route):
                x = torch.cat([outs[j] for j in layer.layers], dim=-1)
            elif isinstance(layer, Upsample):
                x = _upsample_nearest(x, layer.stride)
            else:
                raise _unported(layer)
            outs.append(x)
        captured.append(x)
        result = self._select_outputs(outs, x)
        if capture_inputs:
            return result, tuple(captured)
        return result

    @torch.no_grad()
    def forward_w8a8(self, qparams, act_scales, x):
        """Layer-by-layer W8A8 forward: x enters f32, is quantized with
        the first conv's input scale and stays int8 across the chain;
        linear convs (the heads) emit f32. Returns the head, or the tuple
        of ``out_layers`` outputs."""
        cur_scale: Optional[float] = None      # None: x is f32
        outs: List[Tuple[torch.Tensor, Optional[float]]] = []
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
            elif isinstance(layer, Upsample):
                x = _upsample_nearest(x, layer.stride)
            elif isinstance(layer, Route):
                x = torch.cat([_to_f32(*outs[j]) for j in layer.layers],
                              dim=-1)
                x = quantize_act(x, s_next)
                cur_scale = s_next
            else:
                raise _unported(layer)
            outs.append((x, cur_scale))
        if self.out_layers is not None:
            return tuple(_to_f32(*outs[j]) for j in self.out_layers)
        return _to_f32(x, cur_scale)
