"""Everything a run feeds both sides, made from ``--seed`` on the device.

- the float32 weights, as the configuration's family makes them
  (``families/<family>.py`` ``weights``). A layer list's
  (``fp32_weights``) are He-normal (std sqrt(2 / fan_in)) with biases of
  0.01 x normal, as the engine's own seeded init draws them but in one
  ``randn`` over every layer, on the device, in the served dtype; where the
  configuration says ``"head": "standardized"``, the last layer's weights
  and bias are then scaled and shifted so that each of its output
  channels has mean 0 and standard deviation 1 over the float32 forward of
  the calibration images (``standardize_head``). A random network's head
  otherwise spreads by seed (YOLOv2-tiny's from 1.3 to 2.3), and with it
  how many boxes pass the score threshold, which is the NMS's work;
- the calibration images: uint8 noise divided by 255 in float32;
- the pool: ``pool_batches`` distinct uint8 batches of noise, standing for
  frames that a decoder on the card leaves in its memory.

Each is drawn from its own stream of the seed (``stream_seed``), so a seed
of any size (numpy's ``SeedSequence`` takes it whole) gives the same
inputs every time.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark import families

WEIGHTS, CALIB, POOL = 0, 1, 2
CALIB_IMAGES = 8


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of ``seed``."""
    state = np.random.SeedSequence([int(seed), stream]).generate_state(
        1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def layer_shapes(cfg: Dict) -> List[Dict]:
    """Each layer's weight and bias shapes ({} where it has none)."""
    shapes, chans = [], []
    prev = cfg["in_channels"]
    for layer in cfg["layers"]:
        kind = layer["type"]
        if kind == "conv":
            k, cout = layer["size"], layer["filters"]
            shapes.append({"w": (k, k, prev, cout), "b": (cout,)})
            prev = cout
        elif kind == "dense":
            shapes.append({"w": (prev, layer["units"]),
                           "b": (layer["units"],)})
            prev = layer["units"]
        else:
            shapes.append({})
            if kind == "route":
                prev = sum(chans[j] for j in layer["layers"])
        chans.append(prev)
    return shapes


def fp32_weights(cfg: Dict, seed: int, device) -> List[Dict]:
    """Per layer {"w", "b"} float32 tensors on ``device`` (or {})."""
    shapes = layer_shapes(cfg)
    total = sum(int(np.prod(s)) for p in shapes for s in p.values())
    flat = torch.randn(total, generator=generator(seed, WEIGHTS, device),
                       device=device, dtype=torch.float32)
    params, at = [], 0
    for p in shapes:
        if not p:
            params.append({})
            continue
        out = {}
        for key in ("w", "b"):
            n = int(np.prod(p[key]))
            out[key] = flat[at:at + n].view(p[key])
            at += n
        fan_in = int(np.prod(p["w"][:-1]))
        params.append({"w": out["w"] * (2.0 / fan_in) ** 0.5,
                       "b": 0.01 * out["b"]})
    return params


def standardize_head(cfg: Dict, params: List[Dict],
                     images: torch.Tensor) -> List[Dict]:
    """``params`` with the last layer's output channels at mean 0 and
    standard deviation 1 over ``images`` (the float32 forward of the plain
    reference, in float64 statistics)."""
    from benchmark.reference.int8_net import Reference
    head = Reference(cfg, params).forward_fp32(images)[-1].double()
    dims = tuple(range(head.ndim - 1))
    mean, std = head.mean(dims), head.std(dims).clamp_min(1e-12)
    last = params[-1]
    w = (last["w"].double() / std).to(torch.float32)
    b = ((last["b"].double() - mean) / std).to(torch.float32)
    return params[:-1] + [{"w": w, "b": b}]


def weights(cfg: Dict, seed: int, device, calib: torch.Tensor):
    """The weights both sides get, from the configuration's family."""
    return families.of(cfg).weights(cfg, seed, device, calib)


def uint8_images(n: int, size: int, channels: int, gen: torch.Generator,
                 device) -> torch.Tensor:
    return torch.randint(0, 256, (n, size, size, channels),
                         dtype=torch.uint8, generator=gen, device=device)


def calib_images(cfg: Dict, seed: int, device, size: int) -> torch.Tensor:
    """(8, size, size, C) float32 in [0, 1]: uint8 noise / 255."""
    u8 = uint8_images(CALIB_IMAGES, size, cfg["in_channels"],
                      generator(seed, CALIB, device), device)
    return u8.to(torch.float32) / torch.tensor(255.0, device=device)


def pool(cfg: Dict, seed: int, device, size: int, batch: int,
         batches: int) -> List[torch.Tensor]:
    """``batches`` distinct uint8 (batch, size, size, C) batches."""
    gen = generator(seed, POOL, device)
    return [uint8_images(batch, size, cfg["in_channels"], gen, device)
            for _ in range(batches)]


def _tree_map(fn, tree):
    """``fn`` on every leaf of a tree of lists, tuples and dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def to_numpy(params):
    """A tree of tensors (the weights) as numpy arrays on the host."""
    return _tree_map(lambda v: v.cpu().numpy(), params)


def to_torch(params, device):
    return _tree_map(lambda v: torch.as_tensor(v, device=device), params)
