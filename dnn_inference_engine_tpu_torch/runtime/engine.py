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
``save`` writes the checkpoint.

On a mesh (``config.mesh_shape`` of more than one rank, parallel/): every
rank builds the same engine in a process of its own, on
``cuda:{local rank % cards}`` unless ``device`` is given, with the
process group up first (``parallel.mesh.init_distributed`` or torchrun),
and calls ``detect``/``classify`` with the same global batch. Each rank
computes its data index's rows (with ``sharding="channel"``, W8A8 only,
the channel pair split over the model group, its row-parallel conv
summing int32 accumulators), and the rows are gathered over the data
group, so every rank returns the whole batch, equal bit for bit to a
single-device engine's. ``detect_fn``/``forward_fn`` take this rank's
rows (``_device_batch``) and return theirs. Profiling and the sweep are
single-device (ROADMAP A15).

Timing (the JAX engine's, on the engine's device): ``stage_times``
times each stage of the W8A8 plan on its own input state with its
roofline, ``stage_times_traced`` adds each stage's in-context device time
from a trace (runtime/profiling.py), ``layer_times`` times each conv of
the generic forward.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

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
from dnn_inference_engine_tpu_torch.parallel.mesh import (
    Mesh, broadcast_floats, gather_rows, make_mesh)
from dnn_inference_engine_tpu_torch.parallel.sharded_engine import (
    _validated_pair, make_sharded_detect_fn, make_sharded_forward_fn,
    shard_engine_params)
from dnn_inference_engine_tpu_torch.parallel.sharding import input_sharding
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
        self.config = config
        # the mesh first: its groups are made in every rank, in one order
        self.mesh: Optional[Mesh] = None
        if tuple(config.mesh_shape) != (1, 1):
            self.mesh = make_mesh(tuple(config.mesh_shape))
            if device is None and torch.cuda.is_available():
                local = int(os.environ.get("LOCAL_RANK", self.mesh.rank))
                device = f"cuda:{local % torch.cuda.device_count()}"
        self.device = resolve_device(device)
        if self.mesh is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.model = build_model(config.model, num_classes=config.num_classes)
        self.params: Optional[List[Dict]] = None       # quantized params
        self.fp32_params: Optional[List[Dict]] = None  # kept for calibration
        self.act_scales: Optional[List[float]] = None
        self._local_params = None     # this rank's params (parallel/)
        self._plan = None
        self._plan_params = None
        self._prepared = False
        self._weights_from_file = False
        self._detect_fn = self._forward_fn = None

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
        to the generic forward, as the JAX engine does.

        On a mesh the rank's params are its shard of these
        (``parallel.sharded_engine.shard_engine_params``), and scales
        calibrated here are rank 0's on every rank."""
        mode = self.config.mode
        self._plan = self._plan_params = None
        self._detect_fn = self._forward_fn = None
        if self.mesh is not None:
            _validated_pair(self)        # the policy's errors, up front
        if mode == "fp32":
            if self.fp32_params is None:
                raise RuntimeError("load_weights first (fp32 params)")
            self.params = self.fp32_params
        else:
            if self.params is None:
                if self.fp32_params is None:
                    raise RuntimeError("load_weights first")
                self.params = quantize_model_params(self.fp32_params,
                                                    self.model.layers)
            if self.config.kernel == "auto":
                self._build_plan()
        self._local_params = self.params
        if self.mesh is not None:
            shard_engine_params(self, self.mesh)
        if mode == "fp32":
            self._prepared = True
            return self
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
            if self.mesh is not None:
                self.act_scales = broadcast_floats(self.act_scales,
                                                   self.device)
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
        if self.mesh is not None:
            return                # built from the shard: prepare() does it
        self._plan_params = prepare_plan_params(self.model, self.params,
                                                plan)

    # ------------------------------------------------------------------
    # Forward, decode, NMS
    # ------------------------------------------------------------------

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        """A uint8 batch divided by 255, on the device, unless a w8a8
        plan's entry stage ingests it (ResNet-18's entry is an ``xla``
        stage, which does not)."""
        if x.dtype == torch.uint8 and not (
                self._plan is not None and self.config.mode == "w8a8"
                and plan_input_uint8_ok(self._plan)):
            x = x.to(torch.float32) / f32_scalar(255.0, x.device)
        return x

    @torch.no_grad()
    def _fwd(self, x: torch.Tensor):
        """The f32 head, or the tuple of heads (YOLOv3-tiny), of a batch
        on one device."""
        self._single_device("the single-device forward")
        mode = self.config.mode
        x = self._input(x)
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

    def _single_device(self, what: str) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                f"{what} runs on one device; on a mesh "
                f"{tuple(self.config.mesh_shape)} use detect, classify, "
                "detect_fn or forward_fn (profiling and the sweep on a mesh "
                "are ROADMAP item A15)")

    def forward_fn(self):
        """The device forward: image batch tensor -> the f32 head(s) on
        the engine's device. On a mesh: this rank's rows -> theirs."""
        if not self._prepared:
            raise RuntimeError("prepare first")
        if self._forward_fn is None:
            self._forward_fn = (self._fwd if self.mesh is None else
                                make_sharded_forward_fn(self, self.mesh))
        return self._forward_fn

    def detect_fn(self):
        """The device detect function: image batch tensor -> (boxes,
        scores, classes) tensors on the engine's device. On a mesh: this
        rank's rows (``_device_batch``) -> theirs, the whole pipeline
        sharded (parallel/sharded_engine.py)."""
        if not self._prepared:
            raise RuntimeError("prepare first")
        if self._detect_fn is None:
            if self.mesh is None:
                def run(x):
                    return self.postprocess(self._fwd(x))
                self._detect_fn = run
            else:
                self._detect_fn = make_sharded_detect_fn(self, self.mesh)
        return self._detect_fn

    def _device_batch(self, images) -> torch.Tensor:
        """The batch on the engine's device; on a mesh only this rank's
        rows of it (a batch the data axis does not divide raises)."""
        x = np.asarray(images)
        if self.mesh is not None:
            x = x[input_sharding(self.mesh, x.shape[0])]
        return torch.as_tensor(x).to(self.device)

    def detect_device(self, images):
        """Dispatch detection without waiting for the device: returns
        device tensors (boxes, scores, classes), on a mesh the whole
        batch's (gathered over the data group). The NMS fixpoint syncs
        with the host once a group of ``SWEEPS_PER_SYNC`` sweeps
        (postprocess.py)."""
        out = self.detect_fn()(self._device_batch(images))
        return gather_rows(out, self.mesh)

    def detect(self, images):
        """Image batch (N,S,S,3), uint8 or f32 in [0,1] -> numpy results."""
        b, s, cl = self.detect_device(images)
        return b.cpu().numpy(), s.cpu().numpy(), cl.cpu().numpy()

    def classify(self, images):
        """Image batch -> the f32 head as numpy (ResNet-18: the (N,
        num_classes) logits), or a tuple of them (YOLOv3-tiny)."""
        heads = gather_rows(self.forward_fn()(self._device_batch(images)),
                            self.mesh)
        if isinstance(heads, tuple):
            return tuple(h.cpu().numpy() for h in heads)
        return heads.cpu().numpy()

    # ------------------------------------------------------------------
    # Timing (the JAX engine's per-stage and per-layer reports)
    # ------------------------------------------------------------------

    def _bench_input(self, batch: int) -> torch.Tensor:
        """A seeded batch in the format the forward executes: uint8 (the
        serving wire format) where the W8A8 plan's entry ingests it, f32
        in [0, 1] otherwise; the JAX engine's numbers."""
        size = self.config.input_size
        x = np.random.default_rng(0).uniform(
            0, 1, (batch, size, size, 3)).astype(np.float32)
        if (self._plan is not None and self.config.mode == "w8a8"
                and plan_input_uint8_ok(self._plan)):
            x = np.clip(np.round(x * 255), 0, 255).astype(np.uint8)
        return torch.as_tensor(x, device=self.device)

    def stage_times(self, batch: Optional[int] = None,
                    iters: Optional[Tuple[int, int]] = None) -> List[Dict]:
        """Per-stage times and roofline of the W8A8 plan as it executes:
        each stage timed by loop difference (``per_iter_time_stats``, min
        of 3 reps) on its own input state from one forward. Per stage:
        ``name``, ``kind``, ``ms``, ``gop`` (useful work, 2 ops a MAC),
        ``gop_exec`` (the work the stage's formulation executes),
        ``mfu_pct`` and ``hw_util_pct`` (those over the int8 tensor-core
        peak), ``hbm_mb`` (the least traffic of the stage's contract:
        input, output and the plan's parameters, not the port's derived
        copies of them), ``binding`` ("tc" | "hbm": the floor that binds,
        from the data sheet's peaks, ``benchlib.device_peaks``),
        ``bound_ms`` (that floor), ``pct_of_binding`` (the floor over the
        time), ``noise_pct`` (the reps' spread), ``iters``,
        ``sub_resolution`` (under 20 ms of work resolved: the percentages
        are None) and ``suspect`` (sub-resolution, or a utilization above
        the peak: the timing is wrong, not the kernel fast). On the CPU
        the percentages are None: a CPU time is no measure of the card.

        Without ``iters`` the loop counts scale so that each stage's loop
        difference is about 120 ms of work; ``iters=(hi, lo)`` fixes them
        (quick, noisy)."""
        from dnn_inference_engine_tpu_torch.runtime.benchlib import (
            binding_bound_s, device_peaks, per_iter_time_stats,
            roofline_pct)
        from dnn_inference_engine_tpu_torch.runtime.plan import (
            _run_stage, stage_flops)
        self._single_device("stage_times")
        if self._plan is None or self.config.mode != "w8a8":
            raise ValueError("stage_times needs the fused w8a8 plan "
                             "(mode=w8a8, kernel=auto); use layer_times "
                             "for other configs")
        batch = batch or self.config.batch
        x = self._bench_input(batch)
        states: List = []
        plan_forward_w8a8(self.model, self._plan, self._plan_params,
                          self.act_scales, x, record_states=states)
        flops = stage_flops(self.model, self._plan,
                            input_size=self.config.input_size)
        peak_ops, hbm_bps = device_peaks(self.device)
        on_card = self.device.type == "cuda"
        layers = self.model.layers
        report: List[Dict] = []
        for si, st in enumerate(self._plan):
            x0, cs0, cf0, saved0 = states[si]
            pp = self._plan_params[si]

            @torch.no_grad()
            def f(xx, _st=st, _pp=pp, _cs=cs0, _cf=cf0, _sv=saved0):
                return _run_stage(layers, _st, _pp, xx, _cs, _cf,
                                  self.act_scales, _sv)[0]
            x_out = states[si + 1][0] if si + 1 < len(states) else f(x0)
            hbm_bytes = (_nbytes(x0) + _nbytes(x_out)
                         + sum(_nbytes(pp[k]) for k in _CONTRACT_PARAMS
                               if k in pp))
            s = per_iter_time_stats(f, (x0,), *(iters or ()))
            t = max(s["min"], 1e-9)
            useful, executed = flops[si]
            gop = 2 * useful * batch / 1e9
            gop_exec = 2 * executed * batch / 1e9
            sub_res = s["delta_work_s"] < 0.02
            mfu = roofline_pct(gop * 1e9, t, peak_ops)
            hw = roofline_pct(gop_exec * 1e9, t, peak_ops)
            bound_s, binding = binding_bound_s(gop_exec * 1e9, hbm_bytes,
                                               peak_ops, hbm_bps)
            shown = on_card and not sub_res
            report.append({
                "stage": si,
                "name": f"L{st.conv_li}_{st.kind}"
                        + (f"_f{st.fold}" if st.fold > 1 else ""),
                "kind": st.kind,
                "ms": round(t * 1e3, 4),
                "gop": round(gop, 3),
                "gop_exec": round(gop_exec, 3),
                "mfu_pct": round(mfu, 2) if shown else None,
                "hw_util_pct": round(hw, 2) if shown else None,
                "hbm_mb": round(hbm_bytes / 1e6, 2),
                "binding": binding,
                "bound_ms": round(bound_s * 1e3, 6),
                "pct_of_binding": (round(100.0 * bound_s / t, 2) if shown
                                   else None),
                "noise_pct": round(min(s["spread_pct"], 999.9), 1),
                "iters": list(s["iters"]),
                "sub_resolution": sub_res,
                "suspect": bool(sub_res or (on_card and (
                    mfu > 100.0 or hw > 105.0))),
            })
        return report

    def stage_times_traced(self, batch: Optional[int] = None,
                           runs: int = 30) -> Dict:
        """``stage_times`` rows with each stage's in-context device time
        from a trace of the whole forward (``trace_attribution``):
        ``trace_ms``, the stage scope's device time per forward (the
        isolated ``ms`` leaves out what only exists in context), plus
        ``unattributed/*`` rows (time outside every stage scope) with
        only ``trace_ms``, so that the ``trace_ms`` column sums to the
        forward's device busy time ``module_ms``; that is checked to 2%.
        ``trace_pct_of_binding``: the stage's binding floor over its
        ``trace_ms``, how close it runs to the roofline in context (the
        isolated loop of a short stage times the host's launches).
        ``in_context_overhead_ms``: ``module_ms`` less the isolated
        stages' sum. Needs the card."""
        from dnn_inference_engine_tpu_torch.runtime.profiling import (
            trace_attribution)
        batch = batch or self.config.batch
        rep = self.stage_times(batch=batch)
        art = trace_attribution(self._fwd, self._bench_input(batch),
                                runs=runs)
        scopes = dict(art["by_scope_us"])
        used = set()
        for row in rep:
            keys = [k for k in scopes if k.startswith(f"stage{row['stage']}_")]
            used.update(keys)
            row["trace_ms"] = round(sum(scopes[k] for k in keys) / 1e3, 4)
            row["trace_pct_of_binding"] = (
                round(100.0 * row["bound_ms"] / row["trace_ms"], 2)
                if row["trace_ms"] > 0 else None)
        extra = [{"stage": None, "name": k, "kind": "unattributed",
                  "ms": None, "trace_ms": round(v / 1e3, 4)}
                 for k, v in scopes.items() if k not in used]
        module_ms = art["module_device_us_per_run"] / 1e3
        trace_total = sum(r["trace_ms"] for r in rep + extra)
        if abs(trace_total - module_ms) >= 0.02 * max(module_ms, 1e-9):
            raise AssertionError(
                f"trace rows ({trace_total:.4f} ms) do not sum to the "
                f"forward's device time ({module_ms:.4f} ms)")
        iso_total = sum(r["ms"] for r in rep)
        return {
            "batch": batch,
            "module_ms": round(module_ms, 4),
            "total_stage_ms": round(iso_total, 4),
            "trace_total_ms": round(trace_total, 4),
            "in_context_overhead_ms": round(module_ms - iso_total, 4),
            "runs_traced": art["runs_traced"],
            "stages": rep + extra,
        }

    def layer_times(self, batch: Optional[int] = None,
                    iters: Tuple[int, int] = (60, 10)
                    ) -> List[Tuple[str, float]]:
        """Steady-state seconds of each conv of the generic forward (the
        mode's conv on ``config.kernel``'s tier), each on its input from
        an fp32 forward of a seeded batch: [("layer{li}
        conv{k}x{k}->{Cout}", s), ...]. In w8a8 the input is quantized
        with the layer's scale and the conv emits f32."""
        from dnn_inference_engine_tpu_torch.models.layers import Conv
        from dnn_inference_engine_tpu_torch.models.model import _get_conv_fn
        from dnn_inference_engine_tpu_torch.quant.quantize import (
            quantize_act)
        from dnn_inference_engine_tpu_torch.runtime.benchlib import (
            per_iter_time)
        self._single_device("layer_times")
        if self.fp32_params is None:
            raise RuntimeError("layer_times needs the fp32 params (load "
                               "weights that are not quantized)")
        batch = batch or self.config.batch
        mode = self.config.mode
        size = self.config.input_size
        x = torch.as_tensor(np.random.default_rng(0).uniform(
            0, 1, (batch, size, size, 3)).astype(np.float32),
            device=self.device)
        _, inputs = self.model.forward_fp32(self.fp32_params, x,
                                            capture_inputs=True)
        conv_fn = _get_conv_fn(mode, self.config.kernel)
        report = []
        for li, layer in enumerate(self.model.layers):
            if not isinstance(layer, Conv):
                continue
            p, xin = self.params[li], inputs[li]
            kw = dict(act=layer.act, stride=layer.stride,
                      padding=layer.padding)
            if mode == "fp32":
                args = (p["w"], p["b"])
            elif mode == "w8":
                args = (p["wq"], p["s_w"], p["b"])
            else:
                s_in = self.act_scales[li]
                xin = quantize_act(xin, s_in)
                args = (s_in, p["wq"], p["s_w"], p["b"])

            @torch.no_grad()
            def f(xx, _args=args, _kw=kw):
                return conv_fn(xx, *_args, **_kw)
            t = per_iter_time(f, (xin,), iters_hi=iters[0],
                              iters_lo=iters[1])
            report.append((f"layer{li} conv{layer.ksize}x{layer.ksize}"
                           f"->{layer.out_ch}", t))
        return report


# the plan parameters of the stage contract, as the JAX plan holds them;
# the port's derived copies of the same weights (the K-major ``wt``, a
# dense stage's f32 ``w``, the kernels' cached tiles) are not traffic of
# the contract
_CONTRACT_PARAMS = ("wq", "s_w", "b", "wv")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()
