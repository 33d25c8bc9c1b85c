"""YOLOv3-tiny: route (channel concat), upsample and two detection heads
(13x13 and 26x26 at 416 px) on the same layer-list machinery as
YOLOv2-tiny. Structure follows the public darknet yolov3-tiny.cfg.

Counterpart of ``dnn_inference_engine_tpu/models/yolov3_tiny.py``.
"""

from __future__ import annotations

from dnn_inference_engine_tpu_torch.config import NUM_CLASSES
from dnn_inference_engine_tpu_torch.models.layers import (
    Conv, MaxPool, Route, Upsample,
)
from dnn_inference_engine_tpu_torch.models.model import Model


def yolov3_tiny(num_classes: int = NUM_CLASSES) -> Model:
    head_ch = 3 * (5 + num_classes)     # 3 anchors per head
    layers = [
        Conv(16), MaxPool(),             # 0,1:  416 -> 208
        Conv(32), MaxPool(),             # 2,3:  208 -> 104
        Conv(64), MaxPool(),             # 4,5:  104 -> 52
        Conv(128), MaxPool(),            # 6,7:  52 -> 26
        Conv(256),                       # 8: route target for head 2
        MaxPool(),                       # 9:   26 -> 13
        Conv(512), MaxPool(stride=1),    # 10,11: 13 -> 13
        Conv(1024),                      # 12
        Conv(256, ksize=1),              # 13: route target for upsample branch
        Conv(512),                       # 14
        Conv(head_ch, ksize=1, act="linear", use_bn=False),   # 15: head 1 (13x13)
        Route((13,)),                    # 16
        Conv(128, ksize=1),              # 17
        Upsample(),                      # 18: 13 -> 26
        Route((18, 8)),                  # 19: concat 128 + 256 = 384 ch
        Conv(256),                       # 20
        Conv(head_ch, ksize=1, act="linear", use_bn=False),   # 21: head 2 (26x26)
    ]
    return Model("yolov3-tiny", layers, in_ch=3, input_size=416,
                 out_layers=(15, 21))
