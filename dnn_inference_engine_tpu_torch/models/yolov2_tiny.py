"""YOLOv2-tiny: 9 convs + 6 maxpools (the 6th is darknet's stride-1
'same' pool), 416x416x3 input, 13x13x(5*(5+num_classes)) output head.

Counterpart of ``dnn_inference_engine_tpu/models/yolov2_tiny.py``.
"""

from __future__ import annotations

from dnn_inference_engine_tpu_torch.config import NUM_ANCHORS, NUM_CLASSES
from dnn_inference_engine_tpu_torch.models.layers import Conv, MaxPool
from dnn_inference_engine_tpu_torch.models.model import Model


def yolov2_tiny(num_classes: int = NUM_CLASSES,
                num_anchors: int = NUM_ANCHORS) -> Model:
    head_ch = num_anchors * (5 + num_classes)   # 125 for VOC
    layers = [
        Conv(16), MaxPool(),             # 0,1:  416 -> 208
        Conv(32), MaxPool(),             # 2,3:  208 -> 104
        Conv(64), MaxPool(),             # 4,5:  104 -> 52
        Conv(128), MaxPool(),            # 6,7:  52 -> 26
        Conv(256), MaxPool(),            # 8,9:  26 -> 13
        Conv(512), MaxPool(stride=1),    # 10,11: 13 -> 13 (darknet same-pool)
        Conv(1024),                      # 12
        Conv(1024),                      # 13
        Conv(head_ch, ksize=1, act="linear", use_bn=False),  # 14: head
    ]
    return Model("yolov2-tiny", layers, in_ch=3, input_size=416)
