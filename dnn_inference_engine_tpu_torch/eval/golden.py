"""Per-layer golden tensors.

Counterpart of ``dnn_inference_engine_tpu/eval/golden.py``: the fp32
forward dumps every layer's output, and another mode or tier is diffed
against the dump, exactly (``compare_goldens``) or by its relative RMS
error per layer (``quant_error_report``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def dump_goldens(model, params, x, path: str) -> Tuple:
    """Run the fp32 forward on ``x`` and write every layer's output
    (``layer{i}``) and the input (``input``) to the ``.npz`` ``path``.
    Returns (result, per-layer outputs)."""
    out, layer_outs = model.forward_fp32(params, x, capture_outputs=True)
    arrs = {f"layer{li}": _host(t) for li, t in enumerate(layer_outs)}
    arrs["input"] = _host(x)
    np.savez_compressed(path, **arrs)
    return out, layer_outs


def load_goldens(path: str) -> Dict[int, np.ndarray]:
    with np.load(path) as z:
        return {int(k[len("layer"):]): z[k] for k in z.files
                if k.startswith("layer")}


def compare_goldens(layer_outs: Sequence, goldens: Dict[int, np.ndarray],
                    rtol: float = 1e-5, atol: float = 1e-5):
    """Per-layer max abs diff; raises where a layer is off tolerance."""
    report = {}
    for li, t in enumerate(layer_outs):
        g = goldens[li]
        t = _host(t)
        report[li] = float(np.max(np.abs(t - g)))
        np.testing.assert_allclose(t, g, rtol=rtol, atol=atol,
                                   err_msg=f"layer {li} mismatch")
    return report


def quant_error_report(layer_outs: Sequence, goldens: Dict[int, np.ndarray]):
    """Per-layer relative RMS error against the fp32 goldens."""
    report = {}
    for li, t in enumerate(layer_outs):
        g = np.asarray(goldens[li], np.float64)
        t = _host(t).astype(np.float64)
        denom = np.sqrt(np.mean(g * g)) + 1e-12
        report[li] = float(np.sqrt(np.mean((t - g) ** 2)) / denom)
    return report
