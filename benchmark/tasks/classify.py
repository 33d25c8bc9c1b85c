"""Classification cells: ``Engine.forward_fn()`` on a pool batch, the
logits copied to the host; the logits are the head."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.trace import FORWARD, TO_HOST

COMBINE: Dict[str, str] = {}


def engine_config(cfg: Dict, traffic: Dict) -> Dict:
    return {}


def window_call(engine, span):
    forward = engine.forward_fn()

    def call(x):
        with span(FORWARD):
            logits = forward(x)
        with span(TO_HOST):
            out = logits.cpu().numpy()
        return out, None
    return call


def head_of(out) -> torch.Tensor:
    """The host logits are the head."""
    return torch.as_tensor(np.asarray(out))


def reference_outputs(head: torch.Tensor, cfg: Dict, traffic: Dict,
                      size: int, decode_dtype=None):
    return head


def compare(out, ref) -> Dict[str, float]:
    return {}
