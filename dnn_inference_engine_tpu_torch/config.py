"""Engine configuration and workload constants.

Counterpart of ``dnn_inference_engine_tpu/config.py``. The constants are
copies, pinned equal to the JAX package's by ``tests/test_torch_ops.py``;
the port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

# Standard darknet yolov2-tiny-voc anchors, in grid-cell units.
YOLOV2_TINY_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (1.08, 1.19),
    (3.42, 4.41),
    (6.63, 11.38),
    (9.42, 5.11),
    (16.62, 10.52),
)

# darknet yolov3-tiny COCO anchors in pixels.
YOLOV3_TINY_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (10, 14), (23, 27), (37, 58), (81, 82), (135, 169), (344, 319),
)

VOC_CLASSES: Tuple[str, ...] = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

INPUT_SIZE = 416
GRID_SIZE = 13
NUM_ANCHORS = 5
NUM_CLASSES = 20

SCORE_THRESH_VIS = 0.3
SCORE_THRESH_EVAL = 0.005
NMS_IOU_THRESH = 0.45
MAX_DETECTIONS = 128
# Candidate pool of the fixpoint NMS at serving thresholds; uncapped below
# NMS_TRUNCATION_MIN_THRESH, where a cap costs recall (see the JAX config).
NMS_TOPK = 256
NMS_TRUNCATION_MIN_THRESH = 0.25

# Symmetric int8, clipped to [-127, 127]; leaky-ReLU after dequant, in f32.
QMAX = 127.0
LEAKY_SLOPE = 0.1


@dataclasses.dataclass
class EngineConfig:
    """Engine configuration, field for field the JAX package's: a JSON
    file written by either package loads in the other to an equal
    config."""

    model: str = "yolov2-tiny"          # yolov2-tiny | yolov3-tiny | resnet18
    mode: str = "fp32"                  # fp32 | w8 | w8a8
    # auto: the fused stage plan (w8 and w8a8) or the per-layer tier
    # choice (fp32, and where no plan applies); xla | pallas: every conv
    # on that tier, layer by layer
    kernel: str = "auto"
    batch: int = 1
    input_size: int = INPUT_SIZE
    num_classes: int = NUM_CLASSES

    # (data, model) mesh of ranks, one device each (parallel/): the batch
    # split over data; channel (w8a8) splits the heaviest conv pair over
    # model, replicated keeps the weights whole
    mesh_shape: Tuple[int, int] = (1, 1)
    sharding: str = "replicated"        # replicated | channel

    score_thresh: float = SCORE_THRESH_VIS
    nms_iou_thresh: float = NMS_IOU_THRESH
    max_detections: int = MAX_DETECTIONS
    # None = adaptive (capped at serving thresholds, uncapped at eval
    # thresholds); an int caps the NMS candidate pool explicitly.
    nms_topk: Optional[int] = None

    # serving (runtime/serve.py): device batch and assembly window
    serve_max_batch: int = 32
    serve_timeout_ms: float = 5.0

    # weight file (.npz checkpoint, pickle, darknet .weights) and
    # calibration images (a directory, .npy or .npz) for w8a8
    weights: Optional[str] = None
    calib: Optional[str] = None
    # Plan strategy: path to a `cli plan-sweep` artifact (or a bare
    # {layer: [kind, fold, opts?]} JSON object); Engine.prepare then uses
    # it instead of the pinned table.
    strategy: Optional[str] = None

    def resolved_nms_topk(self) -> int:
        """Candidate-pool size of the detect path: explicit nms_topk wins;
        otherwise NMS_TOPK at serving thresholds and unbounded (clamped
        to the candidate count by the NMS) at eval thresholds."""
        if self.nms_topk is not None:
            return self.nms_topk
        if self.score_thresh >= NMS_TRUNCATION_MIN_THRESH:
            return NMS_TOPK
        return 1 << 30

    @classmethod
    def from_json(cls, path: str) -> "EngineConfig":
        with open(path) as f:
            d = json.load(f)
        if "mesh_shape" in d:
            d["mesh_shape"] = tuple(d["mesh_shape"])
        return cls(**d)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
