from dnn_inference_engine_tpu_torch.models.layers import (  # noqa: F401
    Conv, MaxPool, Route, Shortcut, Upsample, GlobalAvgPool, Dense,
)
from dnn_inference_engine_tpu_torch.models.model import Model  # noqa: F401
from dnn_inference_engine_tpu_torch.models.resnet18 import resnet18  # noqa: F401
from dnn_inference_engine_tpu_torch.models.yolov2_tiny import yolov2_tiny  # noqa: F401
from dnn_inference_engine_tpu_torch.models.yolov3_tiny import yolov3_tiny  # noqa: F401

_MODELS = {"yolov2-tiny": yolov2_tiny, "yolov3-tiny": yolov3_tiny,
           "resnet18": resnet18}


def build_model(name: str, num_classes: int | None = None) -> Model:
    """Model registry: the two YOLO detectors and ResNet-18."""
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; have {sorted(_MODELS)}")
    if num_classes is None:
        return _MODELS[name]()
    return _MODELS[name](num_classes=num_classes)
