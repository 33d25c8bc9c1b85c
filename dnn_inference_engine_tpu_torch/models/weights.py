"""Carry parameters across from the JAX package.

Counterpart of ``dnn_inference_engine_tpu/models/weights.py``, for the
in-memory form only so far: the darknet, pickle and ``.npz`` loaders are
ROADMAP item A4. ``params_from_numpy`` takes the JAX package's parameter
list after ``jax.tree.map(np.asarray, params)`` — fp32 ``{"w", "b"}`` or
quantized ``{"wq", "s_w", "b"}`` per layer, ``{}`` for layers without
weights — and returns the port's, on ``device``. Both packages keep HWIO,
so this is a checked move, with no relayout.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_KINDS = {
    frozenset(): {},
    frozenset({"w", "b"}): {"w": np.float32, "b": np.float32},
    frozenset({"wq", "s_w", "b"}): {"wq": np.int8, "s_w": np.float32,
                                    "b": np.float32},
}


def _check_layer(li: int, p: Dict) -> None:
    kinds = _KINDS.get(frozenset(p))
    if kinds is None:
        raise ValueError(f"layer {li}: unknown parameter keys {sorted(p)}; "
                         "expected {} or {'w','b'} or {'wq','s_w','b'}")
    for key, dtype in kinds.items():
        if np.asarray(p[key]).dtype != dtype:
            raise TypeError(f"layer {li}: {key} must be {np.dtype(dtype)}, "
                            f"got {np.asarray(p[key]).dtype}")
    if kinds:
        w = np.asarray(p["w"] if "w" in p else p["wq"])
        cout = w.shape[-1]
        if w.ndim not in (2, 4):
            raise ValueError(f"layer {li}: weights must be HWIO or (Cin,Cout)"
                             f", got shape {w.shape}")
        for key in ("b", "s_w"):
            if key in p and np.asarray(p[key]).shape != (cout,):
                raise ValueError(f"layer {li}: {key} must be ({cout},), got "
                                 f"{np.asarray(p[key]).shape}")


def params_from_numpy(params: Sequence[Dict],
                      act_scales: Optional[Sequence[float]] = None,
                      device="cuda") -> Tuple[List[Dict],
                                              Optional[List[float]]]:
    """Numpy per-layer params (and calibration scales) -> the port's
    torch params on ``device`` and a list of Python-float scales."""
    out: List[Dict] = []
    for li, p in enumerate(params):
        _check_layer(li, p)
        out.append({k: torch.tensor(np.asarray(v), device=device)
                    for k, v in p.items()})
    scales = None if act_scales is None else [float(s) for s in act_scales]
    return out, scales
