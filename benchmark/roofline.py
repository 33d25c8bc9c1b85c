"""Operations and bytes of a configuration's layers, and the card's peaks
from NVIDIA's data sheets. A model's operations an image are its family's
count (``ops_per_image``); the rest here is a layer list's geometry, from
the list alone.

A conv layer, with the max pool that directly follows it where one does,
is one unit of work, whatever kernel (fused or not) runs it:

- operations: 2 per multiply-accumulate of the conv (the pool's compares
  are not counted);
- bytes: its input read once (one byte an element: int8 codes, or the
  uint8 batch at the entry), its int8 weights with a float32 scale and
  bias per output channel read once a batch, its output written once:
  the pool's where a pool follows, one byte an element (the codes the next
  layer reads), four where the output is the network's float32 head.

``unit_bound_s`` is the least time a unit can take on the card: the larger
of its operations over the int8 peak and its bytes over the bandwidth.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark import families

# (name substring, dense int8 ops/s, HBM bytes/s), NVIDIA's H100 data
# sheets; the first match wins, the SXM part where none does
PEAKS = (("PCIe", 1513e12, 2.0e12),
         ("NVL", 1671e12, 3.9e12),
         ("", 1979e12, 3.35e12))


def peaks(device_name: str) -> Tuple[float, float]:
    """(int8 ops/s, bytes/s) of the H100 variant ``device_name`` names."""
    return next((ops, bw) for key, ops, bw in PEAKS if key in device_name)


def layer_geometry(cfg: Dict) -> List[Dict]:
    """Per layer: input (h, w, c), output (h, w, c) and MACs per image."""
    h = w = cfg["input_size"]
    c = cfg["in_channels"]
    geo, outs = [], []
    for layer in cfg["layers"]:
        kind, inp, macs = layer["type"], (h, w, c), 0
        if kind == "conv":
            s, k = layer["stride"], layer["size"]
            h, w = -(-h // s), -(-w // s)
            macs = h * w * k * k * c * layer["filters"]
            c = layer["filters"]
        elif kind == "maxpool":
            s = layer["stride"]
            if layer["padding"] == "VALID":
                h = (h - layer["size"]) // s + 1
                w = (w - layer["size"]) // s + 1
            else:
                h, w = -(-h // s), -(-w // s)
        elif kind == "route":
            h, w = outs[layer["layers"][0]][:2]
            c = sum(outs[j][2] for j in layer["layers"])
        elif kind == "gap":
            h = w = 1
        elif kind == "dense":
            macs = c * layer["units"]
            c = layer["units"]
        geo.append({"type": kind, "in": inp, "out": (h, w, c),
                    "macs": macs})
        outs.append((h, w, c))
    return geo


def ops_per_image(cfg: Dict) -> float:
    """The model's useful operations an image (2 a multiply-accumulate),
    as the configuration's family counts them."""
    return families.of(cfg).ops_per_image(cfg)


def conv_units(cfg: Dict) -> List[Dict]:
    """Each conv (with its directly following max pool): ``layers``,
    ``ops`` per image, ``act_bytes`` per image, ``weight_bytes`` per
    batch."""
    geo, layers = layer_geometry(cfg), cfg["layers"]
    last = len(layers) - 1
    units = []
    for li, layer in enumerate(layers):
        if layer["type"] != "conv":
            continue
        g, end = geo[li], li
        if li < last and layers[li + 1]["type"] == "maxpool":
            end = li + 1
        h, w, c = geo[end]["out"]
        out_bytes = h * w * c * (4 if end == last else 1)
        k, cin = layer["size"], g["in"][2]
        units.append({
            "layers": (li, end),
            "ops": 2.0 * g["macs"],
            "act_bytes": g["in"][0] * g["in"][1] * cin + out_bytes,
            "weight_bytes": k * k * cin * c + 8 * c,
        })
    return units


def unit_bound_s(unit: Dict, batch: int, peak_ops: float,
                 bandwidth: float) -> float:
    return max(unit["ops"] * batch / peak_ops,
               (unit["act_bytes"] * batch + unit["weight_bytes"])
               / bandwidth)


def conv_bound_s(cfg: Dict, batch: int, peak_ops: float,
                 bandwidth: float) -> float:
    """The least time of every conv unit of one batch, summed."""
    return sum(unit_bound_s(u, batch, peak_ops, bandwidth)
               for u in conv_units(cfg))
