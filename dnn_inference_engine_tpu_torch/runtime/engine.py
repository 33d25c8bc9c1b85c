"""Engine: the inference runtime for one model/mode/batch configuration.

Counterpart of ``dnn_inference_engine_tpu/runtime/engine.py``. The
forward is the fused stage plan (runtime/plan.py) for w8 and w8a8 with
``kernel="auto"``, else the generic layer-by-layer forward on the
``kernel`` tier (``Model.forward``): always for fp32, and where the plan
is illegal or, in w8, holds an int8-only kind. The columnar decode and
the fixpoint NMS (postprocess.py) follow, all on the engine's device.
The engine runs on the card unless ``device="cpu"`` is passed; without a
card and without that, it raises rather than run on the CPU. Weights come
from a file (``load_weights(path)`` or ``config.weights``: an ``.npz``
checkpoint, a darknet ``.weights`` file or a pickle) or from a seed;
``save`` writes the checkpoint. One device only: a mesh is ROADMAP A14.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dnn_inference_engine_tpu_torch.config import (
    EngineConfig, YOLOV2_TINY_ANCHORS, YOLOV3_TINY_ANCHORS,
)
from dnn_inference_engine_tpu_torch.models import build_model
from dnn_inference_engine_tpu_torch.models.weights import (
    load_checkpoint, load_darknet_weights, load_params, params_from_numpy,
    save_checkpoint,
)
from dnn_inference_engine_tpu_torch.postprocess import (
    decode_yolov2_cols, decode_yolov3_cols, device_nms_cols,
)
from dnn_inference_engine_tpu_torch.quant.quantize import (
    calibrate, f32_scalar, quantize_model_params,
)
from dnn_inference_engine_tpu_torch.runtime.plan import (
    plan_forward_w8, plan_forward_w8a8, plan_input_uint8_ok, plan_or_reason,
    prepare_plan_params,
)
from dnn_inference_engine_tpu_torch.runtime.plan_sweep import load_strategy


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the plain PyTorch versions on the CPU")
        device = "cuda"
    return torch.device(device)


class Engine:
    """Inference engine for one model/mode/batch configuration."""

    def __init__(self, config: EngineConfig, device=None):
        if config.mode not in ("fp32", "w8", "w8a8"):
            raise ValueError(f"unknown mode {config.mode!r}; have fp32, w8, "
                             "w8a8")
        if config.kernel not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown kernel tier {config.kernel!r}; have "
                             "auto, xla, pallas")
        if tuple(config.mesh_shape) != (1, 1) or config.sharding != \
                "replicated":
            raise NotImplementedError(
                f"mesh_shape={tuple(config.mesh_shape)}, sharding="
                f"{config.sharding!r}: the port runs on one device; "
                "multi-device is ROADMAP item A14")
        self.config = config
        self.device = resolve_device(device)
        self.model = build_model(config.model, num_classes=config.num_classes)
        self.params: Optional[List[Dict]] = None       # quantized params
        self.fp32_params: Optional[List[Dict]] = None  # kept for calibration
        self.act_scales: Optional[List[float]] = None
        self._plan = None
        self._plan_params = None
        self._prepared = False
        self._weights_from_file = False

    # ------------------------------------------------------------------
    # Weights
    # ------------------------------------------------------------------

    def load_weights(self, path: Optional[str] = None, seed: int = 0,
                     params: Optional[Sequence[Dict]] = None,
                     act_scales: Optional[Sequence[float]] = None
                     ) -> "Engine":
        """Weights from the file ``path``: ``.npz`` a checkpoint
        (quantized params and calibration scales kept as they are),
        ``.weights`` darknet's binary, anything else a pickle. Else the
        numpy ``params`` (and ``act_scales``) carried across, fp32 or
        already quantized. With neither, the file ``config.weights``
        where one is set, else a random He init from
        ``torch.Generator().manual_seed(seed)`` (a file takes the place
        of the seed, as in the JAX engine). A file together with
        ``params`` or ``act_scales`` raises."""
        if path is not None and (params is not None
                                 or act_scales is not None):
            raise ValueError("load_weights: give a weight file or params "
                             "and act_scales, not both")
        if path is None and params is None and act_scales is None:
            path = self.config.weights
        self._weights_from_file = path is not None
        if path is not None:
            params, act_scales = self._weights_from_path(path)
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            self.fp32_params = self.model.init_params(gen, self.device)
            return self
        ps, scales = params_from_numpy(params, act_scales, self.device)
        if scales is not None:
            self.act_scales = scales
        if any("wq" in p for p in ps):
            self.params = ps
        else:
            self.fp32_params = ps
        return self

    def _weights_from_path(self, path: str):
        """(numpy params, act_scales or None) of a weight file."""
        if path.endswith(".npz"):
            return load_checkpoint(path)
        if path.endswith(".weights"):
            return load_darknet_weights(self.model, path), None
        return load_params(path), None

    def save(self, path: str) -> None:
        """The engine's params (quantized once prepared) and calibration
        scales as an ``.npz`` checkpoint, in numpy."""
        save_checkpoint(path, self.params, self.act_scales)

    def prepare(self, calib_images: Optional[np.ndarray] = None) -> "Engine":
        """Quantize and calibrate as the mode needs, and build the fused
        plan for w8 and w8a8 with ``kernel="auto"``: from the strategy file
        ``config.strategy`` when one is set, else from the pinned table.
        Where that plan is illegal (or, in w8, holds an int8-only kind)
        the engine warns, naming the file and the layer, and falls back
        to the generic forward, as the JAX engine does."""
        mode = self.config.mode
        self._plan = self._plan_params = None
        if mode == "fp32":
            if self.fp32_params is None:
                raise RuntimeError("load_weights first (fp32 params)")
            self.params = self.fp32_params
            self._prepared = True
            return self
        if self.params is None:
            if self.fp32_params is None:
                raise RuntimeError("load_weights first")
            self.params = quantize_model_params(self.fp32_params,
                                                self.model.layers)
        if self.config.kernel == "auto":
            self._build_plan()
        if mode == "w8a8" and self.act_scales is None:
            if calib_images is None and self.config.calib:
                from dnn_inference_engine_tpu_torch.preprocess import (
                    load_calib_images)
                calib_images = load_calib_images(self.config.calib,
                                                 self.config.input_size)
            if calib_images is None:
                if self._weights_from_file:
                    raise ValueError(
                        "w8a8 with file-loaded weights needs real "
                        "calibration images: pass calib_images to "
                        "prepare(), load a checkpoint with saved scales, "
                        "or set config.calib. (Uniform-noise fallback is "
                        "only allowed for randomly initialized weights.)")
                # uniform-noise calibration, the same batch the JAX engine
                # draws: fine for synthetic weights only
                warnings.warn(
                    "w8a8 calibration falling back to uniform noise "
                    "(synthetic-weights mode); activation scales will not "
                    "match natural images", stacklevel=2)
                calib_images = np.random.default_rng(0).uniform(
                    0, 1, (8, self.config.input_size,
                           self.config.input_size, 3)).astype(np.float32)
            if self.fp32_params is None:
                raise RuntimeError("w8a8 calibration needs fp32 params")
            self.act_scales = calibrate(self.model, self.fp32_params,
                                        calib_images, device=self.device)
        self._prepared = True
        return self

    def _build_plan(self) -> None:
        """The fused plan of ``config.mode``, or None and a warning."""
        mode, path = self.config.mode, self.config.strategy
        strategy = load_strategy(path) if path else None
        plan, why = plan_or_reason(self.model, strategy,
                                   batch=self.config.batch, mode=mode)
        if plan is not None and mode == "w8":
            int8_only = [st for st in plan if st.kind in ("rs", "s0")]
            if int8_only:
                plan, why = None, (f"layer {int8_only[0].conv_li}: "
                                   f"{int8_only[0].kind} is an int8 kernel "
                                   "with no w8 form")
        if plan is None:
            warnings.warn(
                f"no fused {mode} plan for {self.model.name} under "
                f"{path or 'the pinned strategy'}: {why}; running the "
                "generic layer-by-layer forward (kernel='auto' tiers)",
                stacklevel=3)
            return
        self._plan = plan
        self._plan_params = prepare_plan_params(self.model, self.params,
                                                plan)

    # ------------------------------------------------------------------
    # Forward, decode, NMS
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _fwd(self, x: torch.Tensor):
        """The f32 head, or the tuple of heads (YOLOv3-tiny). A uint8
        batch is divided by 255 here, on the device, unless a w8a8 plan's
        entry stage ingests it (ResNet-18's entry is an ``xla`` stage,
        which does not)."""
        mode = self.config.mode
        if x.dtype == torch.uint8 and not (
                self._plan is not None and mode == "w8a8"
                and plan_input_uint8_ok(self._plan)):
            x = x.to(torch.float32) / f32_scalar(255.0, x.device)
        if self._plan is None:
            return self.model.forward(self.params, x, mode=mode,
                                      act_scales=self.act_scales,
                                      kernel=self.config.kernel)
        if mode == "w8":
            return plan_forward_w8(self.model, self._plan, self._plan_params,
                                   x)
        return plan_forward_w8a8(self.model, self._plan, self._plan_params,
                                 self.act_scales, x)

    @torch.no_grad()
    def postprocess(self, heads):
        """heads -> (boxes xyxy (B,D,4), scores (B,D), classes (B,D)).
        YOLOv3-tiny's two heads decode with their anchor halves and
        concatenate along the candidate axis, 13x13 head first (the
        order sets the NMS tie-breaks). A classifier (ResNet-18) is not a
        detector and raises ``ValueError``, as in the JAX engine."""
        c = self.config
        if self.model.name == "yolov2-tiny":
            boxes, scores = decode_yolov2_cols(
                heads, YOLOV2_TINY_ANCHORS, c.num_classes, c.input_size)
        elif self.model.name == "yolov3-tiny":
            h1, h2 = heads
            b1, s1 = decode_yolov3_cols(h1, YOLOV3_TINY_ANCHORS[3:],
                                        c.num_classes, c.input_size)
            b2, s2 = decode_yolov3_cols(h2, YOLOV3_TINY_ANCHORS[:3],
                                        c.num_classes, c.input_size)
            boxes = torch.cat([b1, b2], dim=-1)
            scores = torch.cat([s1, s2], dim=-1)
        else:
            raise ValueError(f"{self.model.name} is not a detector")
        return device_nms_cols(boxes, scores,
                               iou_thresh=c.nms_iou_thresh,
                               score_thresh=c.score_thresh,
                               topk=c.resolved_nms_topk(),
                               max_det=c.max_detections)

    def detect_fn(self):
        """The device detect function: image batch tensor -> (boxes,
        scores, classes) tensors on the engine's device."""
        if not self._prepared:
            raise RuntimeError("prepare first")

        def run(x):
            return self.postprocess(self._fwd(x))
        return run

    def _device_batch(self, images) -> torch.Tensor:
        return torch.as_tensor(np.asarray(images)).to(self.device)

    def detect_device(self, images):
        """Dispatch detection without waiting for the device: returns
        device tensors (boxes, scores, classes). The NMS fixpoint syncs
        with the host once per sweep."""
        return self.detect_fn()(self._device_batch(images))

    def detect(self, images):
        """Image batch (N,S,S,3), uint8 or f32 in [0,1] -> numpy results."""
        b, s, cl = self.detect_device(images)
        return b.cpu().numpy(), s.cpu().numpy(), cl.cpu().numpy()

    def classify(self, images):
        """Image batch -> the f32 head as numpy (ResNet-18: the (N,
        num_classes) logits), or a tuple of them (YOLOv3-tiny)."""
        if not self._prepared:
            raise RuntimeError("prepare first")
        heads = self._fwd(self._device_batch(images))
        if isinstance(heads, tuple):
            return tuple(h.cpu().numpy() for h in heads)
        return heads.cpu().numpy()
