"""A configuration whose ``layers`` list the model: convs, pools, routes,
shortcuts, the average pool and dense layers (YOLOv2-tiny, ResNet-18).
Its weights are ``inputs.fp32_weights``, standardized at the head where
the configuration says ``"head": "standardized"``; its reference is
``reference/int8_net.py``; its operations are counted from
``roofline.layer_geometry``."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from benchmark import inputs, roofline
from benchmark.reference.int8_net import Reference


def weights(cfg: Dict, seed: int, device, calib: torch.Tensor
            ) -> List[Dict]:
    """Per layer {"w", "b"} (or {}): He-normal from the seed, the head
    standardized on ``calib`` where the configuration says so."""
    params = inputs.fp32_weights(cfg, seed, device)
    if cfg.get("head") == "standardized":
        params = inputs.standardize_head(cfg, params, calib)
    return params


def reference(cfg: Dict, params: Sequence[Dict], qmax: float) -> Reference:
    return Reference(cfg, params, qmax)


def ops_per_image(cfg: Dict) -> float:
    """2 x the multiply-accumulates of every conv and dense layer."""
    return 2.0 * sum(g["macs"] for g in roofline.layer_geometry(cfg))


def program_codes(engine) -> Tuple[List[Dict], List[float]]:
    """``engine.params``' int8 weights and scales per layer ({} where a
    layer has none), and ``engine.act_scales``."""
    codes = [{k: p[k].cpu() for k in ("wq", "s_w")} if p else {}
             for p in engine.params]
    return codes, list(engine.act_scales)
