"""Generic layer-list model with fp32, w8 and w8a8 forward passes.

Counterpart of ``dnn_inference_engine_tpu/models/model.py``. Params are
a list with one dict per layer:
  Conv/Dense fp32:  {"w": f32 HWIO or (Cin, Cout), "b": f32}
  Conv/Dense int8:  {"wq": int8, "s_w": f32 (Cout,), "b": f32}
  otherwise:        {}

``act_scales[li]`` is the calibrated scale of the tensor entering layer
li (``act_scales[n_layers]``: the final output). The w8a8 forward keeps
tensors int8 between convs; max pools and upsamples are scale-preserving,
a route rescales its pieces to its own output scale in f32, and a
shortcut adds its two sides in f32 and requantizes; the global average
pool and the dense head are f32.

Each conv runs in the profiler scope ``L{li}_conv``
(runtime/profiling.layer_scope), opened only while a profiler runs.
Every forward takes the JAX package's ``kernel`` tier: ``xla`` (the
default), ``pallas`` (the port's gemm tier, forced on every conv) or
``auto`` (per layer, ops/dispatch.py).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dnn_inference_engine_tpu_torch.models.layers import (
    Conv, Dense, GlobalAvgPool, MaxPool, Route, Shortcut, Upsample,
)
from dnn_inference_engine_tpu_torch.ops.conv import (
    conv2d_fp32, conv2d_w8, conv2d_w8a8)
from dnn_inference_engine_tpu_torch.ops.dispatch import (
    conv2d_fp32_dispatch, conv2d_w8_dispatch, conv2d_w8a8_dispatch)
from dnn_inference_engine_tpu_torch.ops.activations import apply_activation
from dnn_inference_engine_tpu_torch.ops.pool import maxpool
from dnn_inference_engine_tpu_torch.quant.quantize import dequantize, quantize_act
from dnn_inference_engine_tpu_torch.runtime.profiling import layer_scope


def _upsample_nearest(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Nearest-neighbour upsample of an NHWC tensor of any dtype."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, stride, w, stride, c)
    return x.reshape(n, h * stride, w * stride, c)


def _to_f32(t: torch.Tensor, s) -> torch.Tensor:
    return t if s is None else dequantize(t, s)


def dense_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, Cin) @ (Cin, Cout) in full float32, TF32 off whatever the
    caller's setting: the JAX package's ``Precision.HIGHEST``."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return x @ w
    finally:
        torch.set_float32_matmul_precision(prev)


def dense_weights(q: Dict) -> torch.Tensor:
    """A quantized dense layer's f32 weights, ``wq * s_w`` per output
    column (the JAX forwards' order)."""
    return q["wq"].to(torch.float32) * q["s_w"]


def _graph_layer(layer, x, outs):
    """The fp32 and w8 forwards' non-conv layers (all f32 tensors)."""
    if isinstance(layer, MaxPool):
        return maxpool(x, layer.size, layer.stride, layer.padding)
    if isinstance(layer, Route):
        return torch.cat([outs[j] for j in layer.layers], dim=-1)
    if isinstance(layer, Shortcut):
        return apply_activation(x + outs[layer.frm], layer.act)
    if isinstance(layer, Upsample):
        return _upsample_nearest(x, layer.stride)
    if isinstance(layer, GlobalAvgPool):
        return torch.mean(x, dim=(1, 2))
    raise TypeError(f"unknown layer {layer!r}")


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
            elif isinstance(layer, Dense):
                w = torch.randn(prev, layer.out,
                                generator=generator) * (2.0 / prev) ** 0.5
                b = 0.01 * torch.randn(layer.out, generator=generator)
                params.append({"w": w.to(device), "b": b.to(device)})
            else:
                params.append({})
            prev = chans[li]
        return params

    def _select_outputs(self, outs, x):
        if self.out_layers is not None:
            return tuple(outs[j] for j in self.out_layers)
        return x

    @torch.no_grad()
    def forward_fp32(self, params, x, capture_inputs: bool = False,
                     capture_outputs: bool = False, kernel: str = "xla"):
        """FP32 forward: the head, or the tuple of ``out_layers`` outputs.
        ``capture_inputs``: also return the tensor entering every layer
        plus the final output (calibration); ``capture_outputs``: also
        return every layer's output (goldens, eval/golden.py)."""
        conv_fn = _get_conv_fn("fp32", kernel)
        captured: List[torch.Tensor] = []
        outs: List[torch.Tensor] = []
        for li, layer in enumerate(self.layers):
            captured.append(x)
            p = params[li]
            if isinstance(layer, Conv):
                with layer_scope(li, layer):
                    x = conv_fn(x, p["w"], p["b"], act=layer.act,
                                stride=layer.stride, padding=layer.padding)
            elif isinstance(layer, Dense):
                x = apply_activation(dense_f32(x, p["w"]) + p["b"],
                                     layer.act)
            else:
                x = _graph_layer(layer, x, outs)
            outs.append(x)
        captured.append(x)
        result = self._select_outputs(outs, x)
        if capture_inputs:
            return result, tuple(captured)
        if capture_outputs:
            return result, tuple(outs)
        return result

    @torch.no_grad()
    def forward_w8(self, qparams, x, capture_outputs: bool = False,
                   kernel: str = "xla"):
        """INT8 weight-only forward: f32 activations, int8 weights with
        per-channel scales applied to each conv's output."""
        conv_fn = _get_conv_fn("w8", kernel)
        outs: List[torch.Tensor] = []
        for li, layer in enumerate(self.layers):
            p = qparams[li]
            if isinstance(layer, Conv):
                with layer_scope(li, layer):
                    x = conv_fn(x, p["wq"], p["s_w"], p["b"], act=layer.act,
                                stride=layer.stride, padding=layer.padding)
            elif isinstance(layer, Dense):
                x = apply_activation(dense_f32(x, dense_weights(p)) + p["b"],
                                     layer.act)
            else:
                x = _graph_layer(layer, x, outs)
            outs.append(x)
        result = self._select_outputs(outs, x)
        if capture_outputs:
            return result, tuple(outs)
        return result

    @torch.no_grad()
    def forward_w8a8(self, qparams, act_scales, x,
                     capture_outputs: bool = False, kernel: str = "xla"):
        """Layer-by-layer W8A8 forward: x enters f32, is quantized with
        the first conv's input scale and stays int8 across the chain;
        linear convs (the heads) emit f32. Returns the head, or the tuple
        of ``out_layers`` outputs; with ``capture_outputs`` also every
        layer's output in f32."""
        conv_fn = _get_conv_fn("w8a8", kernel)
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
                with layer_scope(li, layer):
                    x = conv_fn(x, cur_scale, p["wq"], p["s_w"], p["b"],
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
            elif isinstance(layer, Shortcut):
                x = _to_f32(x, cur_scale) + _to_f32(*outs[layer.frm])
                x = quantize_act(apply_activation(x, layer.act), s_next)
                cur_scale = s_next
            elif isinstance(layer, GlobalAvgPool):
                x = torch.mean(_to_f32(x, cur_scale), dim=(1, 2))
                cur_scale = None
            elif isinstance(layer, Dense):
                q = qparams[li]
                x = dense_f32(_to_f32(x, cur_scale), dense_weights(q))
                x = apply_activation(x + q["b"], layer.act)
                cur_scale = None
            else:
                raise TypeError(f"unknown layer {layer!r}")
            outs.append((x, cur_scale))
        if self.out_layers is not None:
            result = tuple(_to_f32(*outs[j]) for j in self.out_layers)
        else:
            result = _to_f32(x, cur_scale)
        if capture_outputs:
            return result, tuple(_to_f32(*o) for o in outs)
        return result

    def forward(self, params, x, mode: str = "fp32", act_scales=None,
                kernel: str = "xla", capture_outputs: bool = False):
        """The forward of ``mode`` (fp32 | w8 | w8a8) on ``kernel``'s tier;
        w8a8 needs the calibration scales. ``capture_outputs``: also
        every layer's output (f32)."""
        kw = dict(kernel=kernel, capture_outputs=capture_outputs)
        if mode == "fp32":
            return self.forward_fp32(params, x, **kw)
        if mode == "w8":
            return self.forward_w8(params, x, **kw)
        if mode == "w8a8":
            if act_scales is None:
                raise ValueError("w8a8 needs calibration scales")
            return self.forward_w8a8(params, act_scales, x, **kw)
        raise ValueError(f"unknown mode {mode!r}; have fp32, w8, w8a8")


_XLA_TIER = {"fp32": conv2d_fp32, "w8": conv2d_w8, "w8a8": conv2d_w8a8}
_DISPATCH = {"fp32": conv2d_fp32_dispatch, "w8": conv2d_w8_dispatch,
             "w8a8": conv2d_w8a8_dispatch}


def _get_conv_fn(mode: str, kernel: str):
    """The conv of ``mode`` on tier ``kernel``: ``xla`` the xla-tier conv,
    ``pallas`` the dispatch forced onto the gemm tier, ``auto`` the
    dispatch's own choice per layer."""
    if kernel == "xla":
        return _XLA_TIER[mode]
    if kernel in ("pallas", "auto"):
        return functools.partial(_DISPATCH[mode],
                                 force_pallas=kernel == "pallas")
    raise ValueError(f"unknown kernel tier {kernel!r}; have xla, pallas, "
                     "auto")
