from dnn_inference_engine_tpu_torch.models.layers import (  # noqa: F401
    Conv, MaxPool, Route, Shortcut, Upsample, GlobalAvgPool, Dense,
)
from dnn_inference_engine_tpu_torch.models.model import Model  # noqa: F401
from dnn_inference_engine_tpu_torch.models.yolov2_tiny import yolov2_tiny  # noqa: F401

_LATER = {"yolov3-tiny": "A10", "resnet18": "A10"}


def build_model(name: str, num_classes: int | None = None) -> Model:
    """Model registry. Only YOLOv2-tiny is ported so far."""
    if name in _LATER:
        raise NotImplementedError(
            f"{name} is ported with the stretch models "
            f"(ROADMAP item {_LATER[name]})")
    if name != "yolov2-tiny":
        raise ValueError(f"unknown model {name!r}; have ['yolov2-tiny']")
    if num_classes is None:
        return yolov2_tiny()
    return yolov2_tiny(num_classes=num_classes)
