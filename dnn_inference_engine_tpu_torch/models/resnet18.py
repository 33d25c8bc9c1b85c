"""ResNet-18: residual (Shortcut) adds, stride-2 convs, a 1x1/3x3 kernel
mix, global average pooling and a dense classifier head on the same
layer-list machinery as the YOLO detectors (224 px, 1000 classes).

Counterpart of ``dnn_inference_engine_tpu/models/resnet18.py``, with the
same 34 layers. A downsample block expresses the projection skip
sequentially:

    ... block input at index i-1 ...
    Conv 3x3 s2 C (relu)        # main branch
    Conv 3x3    C (linear)      # -> index j
    Route((i-1,))               # the block input again
    Conv 1x1 s2 C (linear)      # projection skip
    Shortcut(frm=j, act=relu)   # main + projection
"""

from __future__ import annotations

from typing import List

from dnn_inference_engine_tpu_torch.models.layers import (
    Conv, Dense, GlobalAvgPool, MaxPool, Route, Shortcut,
)
from dnn_inference_engine_tpu_torch.models.model import Model


def resnet18(num_classes: int = 1000, input_size: int = 224) -> Model:
    layers: List = [
        Conv(64, ksize=7, stride=2, act="relu"),     # 0: 224 -> 112
        MaxPool(size=3, stride=2, padding="SAME"),   # 1: 112 -> 56
    ]

    def identity_block(ch: int) -> None:
        inp = len(layers) - 1
        layers.append(Conv(ch, act="relu"))
        layers.append(Conv(ch, act="linear"))
        layers.append(Shortcut(frm=inp, act="relu"))

    def downsample_block(ch: int) -> None:
        inp = len(layers) - 1
        layers.append(Conv(ch, stride=2, act="relu"))
        layers.append(Conv(ch, act="linear"))
        j = len(layers) - 1
        layers.append(Route((inp,)))
        layers.append(Conv(ch, ksize=1, stride=2, act="linear"))
        layers.append(Shortcut(frm=j, act="relu"))

    identity_block(64)
    identity_block(64)
    downsample_block(128)
    identity_block(128)
    downsample_block(256)
    identity_block(256)
    downsample_block(512)
    identity_block(512)
    layers.append(GlobalAvgPool())
    layers.append(Dense(num_classes))
    return Model("resnet18", layers, in_ch=3, input_size=input_size)
