"""Plain reference of a W8A8 layer-list network, from the published layer
equations and the engine's documented quantization, in plain PyTorch.

Nothing of the program is imported or taken: the reference gets the
benchmark's float32 weights, calibration images and uint8 batches, and
works out its own int8 weights, scales and outputs. It reads the layer
list from the configuration file:

- ``conv``: SAME padding split as XLA splits it (the smaller half first),
  weights HWIO, then ``act`` (leaky 0.1, relu, linear);
- ``maxpool``: VALID, ``SAME`` (XLA's pads), or ``RIGHT_BOTTOM`` (darknet's
  stride-1 pool: size - 1 rows and columns of padding at the bottom and
  right), the padding the dtype's lowest value;
- ``route``: the channel concatenation of earlier layers' outputs;
- ``shortcut``: the sum with an earlier layer's output, then ``act``;
- ``gap``: the mean over height and width;
- ``dense``: ``x @ w + b``, then ``act``.

Quantization (symmetric, clipped to +-qmax; qmax 127 is int8, 7 the int4
control): each conv and dense layer's weights per output channel, ``s_w =
max(max|w|, 1e-12) / qmax``, ``wq = clip(rint(w / s_w))``; one scale per
tensor entering a layer (and one for the output), the largest magnitude
over the float32 forward of the calibration images / qmax. The int8
forward keeps codes between layers: a conv's int32 accumulator, exact
(summed in float64, where every partial sum of these products is an
integer below 2^53), then ``y = act(acc * (s_in * s_w) + b)`` in float32,
and for a conv that is not linear the codes ``clip(rint(y / s_out))`` at
its output's scale; a linear conv hands on float32. Pools take the max of
the codes; a route or shortcut works in float32 (codes times scale) and
requantizes; the average pool and the dense layer are float32.

Departures from a float network, as the engine documents its own:
``entry = "u8_quantized"`` divides the uint8 batch by 255 in float32 and
quantizes it at the calibrated input scale (ResNet-18's stem);
``entry = "u8_exact"`` reads it exactly at scale s_in = float32(1/255)
(YOLOv2's fused stem: codes u - 128, the offset's 128 x the weights' sum
over the taps folded into the bias) and requantizes the entry conv in the
folded order that stem documents: ``clip(rint(act(acc * scale + bias)))``
with ``scale = s_in * s_w / s_out`` and ``bias = (b + 128 s_in s_w
sum(wq)) / s_out``. That order rounds a few codes a batch otherwise than
the conv order, and a random network carries one such code to some
percent of its head. Float32 throughout with TF32 off; the calibration's
convolutions are float32 cuDNN convolutions (or the CPU's), not an exact
sum.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

LEAKY = 0.1


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuDNN and matmul, restored afterwards."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def activation(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "leaky":
        return torch.where(x > 0, x, LEAKY * x)
    if act == "relu":
        return torch.clamp_min(x, 0.0)
    if act == "linear":
        return x
    raise ValueError(f"unknown activation {act!r}")


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one dimension: (lo, hi), the smaller half
    first."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pads(layer: Dict, h: int, w: int) -> Tuple[int, int, int, int]:
    k, s = layer["size"], layer["stride"]
    pad = layer.get("padding", "SAME")
    if pad == "SAME":
        return (*same_pads(h, k, s), *same_pads(w, k, s))
    if pad == "RIGHT_BOTTOM":
        return 0, k - 1, 0, k - 1
    if pad == "VALID":
        return 0, 0, 0, 0
    raise ValueError(f"unknown padding {pad!r}")


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, layer: Dict) -> torch.Tensor:
    """NHWC x HWIO in x's dtype; float64 runs outside cuDNN (PyTorch's
    im2col and GEMM), so integer operands sum exactly."""
    t, b, l, r = _pads(layer, x.shape[1], x.shape[2])
    xn = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b))
    with torch.backends.cudnn.flags(enabled=x.dtype != torch.float64,
                                    allow_tf32=False):
        y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=layer["stride"])
    return y.permute(0, 2, 3, 1)


def maxpool(x: torch.Tensor, layer: Dict) -> torch.Tensor:
    t, b, l, r = _pads(layer, x.shape[1], x.shape[2])
    low = (float("-inf") if x.dtype.is_floating_point
           else torch.iinfo(x.dtype).min)
    xp = F.pad(x.permute(0, 3, 1, 2).to(torch.float32), (l, r, t, b),
               value=low)
    y = F.max_pool2d(xp, layer["size"], layer["stride"])
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def quantize(x: torch.Tensor, s: float, qmax: float) -> torch.Tensor:
    """Codes of x at scale s: clip(rint(x / s)) in float32, as int8."""
    sf = torch.tensor(s, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / sf), -qmax, qmax).to(torch.int8)


def dequantize(q: torch.Tensor, s: Optional[float]) -> torch.Tensor:
    if s is None:
        return q
    return q.to(torch.float32) * torch.tensor(s, dtype=torch.float32,
                                              device=q.device)


class Reference:
    """The W8A8 network of a configuration (its ``layers``, ``entry``)
    on the benchmark's float32 weights ``params`` (per layer {"w", "b"}
    or {}), quantized at ``qmax``."""

    def __init__(self, cfg: Dict, params: Sequence[Dict],
                 qmax: float = 127.0):
        self.cfg, self.layers = cfg, cfg["layers"]
        self.params, self.qmax = list(params), float(qmax)
        self.qparams = [self._quantize_weights(p) for p in self.params]
        self.scales: Optional[List[float]] = None

    def _quantize_weights(self, p: Dict) -> Dict:
        if not p:
            return {}
        w = p["w"]
        amax = torch.amax(torch.abs(w), dim=tuple(range(w.ndim - 1)))
        s_w = torch.clamp_min(amax, 1e-12) / torch.tensor(
            self.qmax, dtype=torch.float32, device=w.device)
        wq = torch.clamp(torch.round(w / s_w), -self.qmax, self.qmax)
        return {"wq": wq.to(torch.int8), "s_w": s_w, "b": p["b"]}

    # -- float32 forward and calibration ------------------------------------

    @torch.no_grad()
    def forward_fp32(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The tensor entering every layer, and the output last."""
        seen, outs = [], []
        with full_float32():
            for li, layer in enumerate(self.layers):
                seen.append(x)
                p, kind = self.params[li], layer["type"]
                if kind == "conv":
                    x = activation(conv_nhwc(x, p["w"], layer) + p["b"],
                                   layer["act"])
                elif kind == "maxpool":
                    x = maxpool(x, layer)
                elif kind == "route":
                    x = torch.cat([outs[j] for j in layer["layers"]], -1)
                elif kind == "shortcut":
                    x = activation(x + outs[layer["from"]], layer["act"])
                elif kind == "gap":
                    x = torch.mean(x, dim=(1, 2))
                elif kind == "dense":
                    x = activation(x @ p["w"] + p["b"], layer["act"])
                else:
                    raise ValueError(f"layer {li}: unknown type {kind!r}")
                outs.append(x)
        seen.append(x)
        return seen

    def calibrate(self, images: torch.Tensor) -> List[float]:
        """Per-layer input scales (and the output's) from float32 images
        in [0, 1]: max|x| / qmax, the maximum taken in float32 and the
        division in float64."""
        seen = self.forward_fp32(images)
        amax = [float(torch.amax(torch.abs(t))) for t in seen]
        self.scales = [max(a, 1e-12) / self.qmax for a in amax]
        return self.scales

    # -- int8 forward ---------------------------------------------------------

    def _entry(self, u8: torch.Tensor):
        """(codes or f32 values, scale) of the uint8 batch entering layer 0."""
        if self.cfg["entry"] == "u8_exact":
            return u8, None
        if self.cfg["entry"] == "u8_quantized":
            x = u8.to(torch.float32) / torch.tensor(
                255.0, dtype=torch.float32, device=u8.device)
            return quantize(x, self.scales[0], self.qmax), self.scales[0]
        raise ValueError(f"unknown entry {self.cfg['entry']!r}")

    def _conv(self, li: int, layer: Dict, x: torch.Tensor, s_in: float):
        q = self.qparams[li]
        acc = conv_nhwc(x.to(torch.float64), q["wq"].to(torch.float64),
                        layer).to(torch.float32)
        scale = torch.tensor(s_in, dtype=torch.float32,
                             device=x.device) * q["s_w"]
        y = activation(acc * scale + q["b"], layer["act"])
        if layer["act"] == "linear":
            return y, None
        s_out = self.scales[li + 1]
        return quantize(y, s_out, self.qmax), s_out

    def _exact_u8_conv(self, li: int, layer: Dict, u8: torch.Tensor):
        """The entry conv on the uint8 batch read exactly (``u8_exact``),
        requantized in the folded order."""
        q, dev = self.qparams[li], u8.device
        wq = q["wq"].to(torch.float64)
        acc = conv_nhwc(u8.to(torch.float64), wq, layer)
        w1 = wq.reshape(-1, wq.shape[-1]).sum(0)
        acc = (acc - 128.0 * w1).to(torch.float32)       # codes u - 128
        f32 = dict(dtype=torch.float32, device=dev)
        s_in = torch.tensor(1.0 / 255.0, **f32)
        s_out = torch.tensor(self.scales[li + 1], **f32)
        scale = (s_in * q["s_w"]) / s_out
        bias = (q["b"] + 128.0 * s_in * q["s_w"] * w1.to(torch.float32)) \
            / s_out
        y = activation(acc * scale + bias, layer["act"])
        codes = torch.clamp(torch.round(y), -self.qmax, self.qmax)
        return codes.to(torch.int8), self.scales[li + 1]

    @torch.no_grad()
    def forward(self, u8: torch.Tensor, block: int = 16) -> torch.Tensor:
        """The float32 head of a uint8 (N, H, W, C) batch, ``block``
        images at a time."""
        return torch.cat([self._forward(u8[i:i + block])
                          for i in range(0, u8.shape[0], block)])

    def _forward(self, u8: torch.Tensor) -> torch.Tensor:
        if self.scales is None:
            raise RuntimeError("calibrate first")
        x, s = self._entry(u8)
        outs: List[Tuple[torch.Tensor, Optional[float]]] = []
        with full_float32():
            for li, layer in enumerate(self.layers):
                kind = layer["type"]
                s_next = self.scales[li + 1]
                if kind == "conv" and x.dtype == torch.uint8:
                    x, s = self._exact_u8_conv(li, layer, x)
                elif kind == "conv":
                    if s is None:
                        x, s = quantize(x, self.scales[li], self.qmax), \
                            self.scales[li]
                    x, s = self._conv(li, layer, x, s)
                elif kind == "maxpool":
                    x = maxpool(x, layer)
                elif kind == "route":
                    x = torch.cat([dequantize(*outs[j])
                                   for j in layer["layers"]], -1)
                    x, s = quantize(x, s_next, self.qmax), s_next
                elif kind == "shortcut":
                    y = dequantize(x, s) + dequantize(*outs[layer["from"]])
                    x = quantize(activation(y, layer["act"]), s_next,
                                 self.qmax)
                    s = s_next
                elif kind == "gap":
                    x, s = torch.mean(dequantize(x, s), dim=(1, 2)), None
                elif kind == "dense":
                    q = self.qparams[li]
                    w = q["wq"].to(torch.float32) * q["s_w"]
                    x = activation(dequantize(x, s) @ w + q["b"],
                                   layer["act"])
                    s = None
                else:
                    raise ValueError(f"layer {li}: unknown type {kind!r}")
                outs.append((x, s))
        return dequantize(x, s)
