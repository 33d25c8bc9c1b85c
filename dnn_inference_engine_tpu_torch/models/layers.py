"""Layer IR: the model-graph vocabulary.

Counterpart of ``dnn_inference_engine_tpu/models/layers.py``: a model is
a tuple of these frozen layer configs. Route/Shortcut indices are
absolute layer indices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Conv:
    out_ch: int
    ksize: int = 3
    stride: int = 1
    act: str = "leaky"       # leaky | relu | linear
    use_bn: bool = True      # BN folded into (w, b) at load time
    padding: str = "SAME"


@dataclasses.dataclass(frozen=True)
class MaxPool:
    size: int = 2
    stride: int = 2          # stride=1 => darknet 'same' pool
    padding: str = "VALID"   # 'SAME' for the ResNet stem pool


@dataclasses.dataclass(frozen=True)
class Route:
    """Concatenate outputs of earlier layers along channels."""
    layers: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Shortcut:
    """Residual add with an earlier layer's output."""
    frm: int
    act: str = "linear"


@dataclasses.dataclass(frozen=True)
class Upsample:
    stride: int = 2


@dataclasses.dataclass(frozen=True)
class GlobalAvgPool:
    pass


@dataclasses.dataclass(frozen=True)
class Dense:
    out: int
    act: str = "linear"
