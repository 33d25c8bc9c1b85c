"""Weight files and parameters carried across from the JAX package.

Counterpart of ``dnn_inference_engine_tpu/models/weights.py``, a numpy
copy (pinned by ``tests/test_torch_weights.py``):

- ``load_params`` / ``save_params``: a pickled per-layer list, raw BN
  layers ``{"w","b","gamma","mean","var"}`` folded at load
  (``fold_bn``) or pre-folded ``{"w","b"}``;
- ``load_darknet_weights``: darknet's ``.weights`` binary;
- ``load_checkpoint`` / ``save_checkpoint``: the engine's ``.npz``
  (``l{i}.{key}`` per layer, ``n_layers``, ``act_scales``).

Loaders return numpy, as the JAX ones do; the writers take torch tensors
or numpy arrays and write numpy, so each package reads what the other
writes. ``params_from_numpy`` takes such a list (or the JAX package's
params after ``jax.tree.map(np.asarray, params)``) — fp32 ``{"w", "b"}``
or quantized ``{"wq", "s_w", "b"}`` per layer, ``{}`` for layers without
weights — and returns the port's, on ``device``. Both packages keep HWIO,
so this is a checked move, with no relayout.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dnn_inference_engine_tpu_torch.models.layers import Conv, Dense

BN_EPS = 1e-6  # darknet's batch_norm epsilon, as the JAX package's


def fold_bn(w: np.ndarray, bias: np.ndarray, gamma: np.ndarray,
            mean: np.ndarray, var: np.ndarray, eps: float = BN_EPS):
    """Fold conv+BN into (w', b'); w is HWIO, the BN params (Cout,):
    w' = w * gamma / sqrt(var + eps), b' = bias - mean * that scale
    (darknet's conv bias with BN on is the BN beta)."""
    scale = gamma / np.sqrt(var + eps)
    return ((w * scale).astype(np.float32),
            (bias - mean * scale).astype(np.float32))


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def save_params(params: Sequence[Dict], path: str) -> None:
    """Pickle the per-layer params as numpy."""
    host = [{k: _host(v) for k, v in p.items()} for p in params]
    with open(path, "wb") as f:
        pickle.dump(host, f)


def load_params(path: str, fold: bool = True) -> List[Dict]:
    """A pickled per-layer list; raw BN layers are folded when ``fold``.
    A pickle runs code as it loads: load only files you trust."""
    with open(path, "rb") as f:
        raw = pickle.load(f)
    out: List[Dict] = []
    for p in raw:
        if fold and "gamma" in p:
            w, b = fold_bn(np.asarray(p["w"]), np.asarray(p["b"]),
                           np.asarray(p["gamma"]), np.asarray(p["mean"]),
                           np.asarray(p["var"]))
            out.append({"w": w, "b": b})
        else:
            out.append({k: np.asarray(v) for k, v in p.items()})
    return out


def load_darknet_weights(model, path: str) -> List[Dict]:
    """darknet's binary into folded numpy params.

    Layout: int32 major, minor, revision; an int64 ``seen`` when
    major*10+minor >= 2, else an int32; then per conv layer, in file
    order, ``beta, gamma, mean, var`` (with BN) or ``bias``, then the
    weights (Cout, Cin, kh, kw), moved to HWIO by (2, 3, 1, 0). Layers
    without weights get ``{}``."""
    with open(path, "rb") as f:
        major, minor, _rev = np.fromfile(f, np.int32, 3)
        np.fromfile(f, np.int64 if major * 10 + minor >= 2 else np.int32, 1)
        buf = np.fromfile(f, np.float32)
    pos = 0

    def take(n):
        nonlocal pos
        out = buf[pos:pos + n]
        if out.size != n:
            raise ValueError("weights file truncated")
        pos += n
        return out

    chans = model.out_channels()
    params: List[Dict] = []
    prev = model.in_ch
    for li, layer in enumerate(model.layers):
        if isinstance(layer, Conv):
            c, k = layer.out_ch, layer.ksize
            if layer.use_bn:
                beta, gamma, mean, var = take(c), take(c), take(c), take(c)
            else:
                bias = take(c)
            w = take(c * prev * k * k).reshape(c, prev, k, k).transpose(
                2, 3, 1, 0)
            if layer.use_bn:
                w, b = fold_bn(w, beta, gamma, mean, var)
            else:
                b = bias.astype(np.float32)
            params.append({"w": np.ascontiguousarray(w), "b": b})
        elif isinstance(layer, Dense):
            raise NotImplementedError("darknet format has no dense layers "
                                      "here")
        else:
            params.append({})
        prev = chans[li]
    if pos != buf.size:
        raise ValueError(f"weights file has {buf.size - pos} unread floats")
    return params


def save_checkpoint(path: str, params: Sequence[Dict],
                    act_scales: Optional[Sequence[float]] = None) -> None:
    """The engine's ``.npz``: ``l{i}.{key}`` per layer, ``n_layers`` and,
    when given, ``act_scales`` (float32)."""
    flat = {}
    for li, p in enumerate(params):
        for k, v in p.items():
            flat[f"l{li}.{k}"] = _host(v)
    flat["n_layers"] = np.int64(len(params))
    if act_scales is not None:
        flat["act_scales"] = np.asarray(act_scales, np.float32)
    np.savez(path, **flat)


def load_checkpoint(path: str):
    """(numpy params, act_scales as a list of floats or None)."""
    with np.load(path) as z:
        n = int(z["n_layers"])
        params: List[Dict] = [{} for _ in range(n)]
        for key in z.files:
            if key.startswith("l") and "." in key:
                li, name = key.split(".", 1)
                params[int(li[1:])][name] = z[key]
        scales = z["act_scales"].tolist() if "act_scales" in z.files \
            else None
    return params, scales

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
