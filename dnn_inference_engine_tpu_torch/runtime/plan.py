"""Execution plans: the fused W8A8 and w8 stage pipelines.

Counterpart of ``dnn_inference_engine_tpu/runtime/plan.py``. A plan
rewrites the layer list into stages; folded stages absorb the following
2x2/s2 maxpool into a channel group-max, exactly in int8. Activation
scales follow ``Model.forward_w8a8``: each conv requantizes to the
calibrated scale of its own output; pools preserve scale.

The w8 plan (``plan_forward_w8``) runs the same stages on bf16 tensors
with ops/conv.py's bf16 conv (cuDNN on the card); its kinds are listed
there. Stage kinds of the W8A8 plan, with what runs them on the card:

  stem_rs      ops/fused_conv.stem_fused_k2 (kernel)
  stem_dg      ops/fused_conv.stem_fused_dg (kernel)
  fold_xla     ops/conv.conv2d_w8a8 (the conv_w8a8 kernel) with its
               group-max; as the entry stage (f=4, k=3) the input goes
               through ops/fused_conv.quant_space_to_depth4 (kernel)
  fold_xla_k2  the shifted k=2 fold: its input from shift_s2d2 (kernel)
               when int8, from quant_space_to_depth4 (kernel) as the f=4
               entry, or read as a fold_xla_s2 emitted it; then
               conv2d_w8a8 over the trimmed output with its group-max
  fold_xla_s2  conv2d_w8a8, then ops/fused_conv.gmax_shift_s2d2
               (kernel): the shifted fold-2 layout for a fold_xla_k2 f=2
               consumer (cur_fold holds the sentinel -(H/2))
  rs, rs2      ops/fused_conv.conv3x3_rs (kernel): implicit-im2col k=3
               (rs) or shifted k=2 (rs2) folded conv with the group-max on
               the int32 accumulator; scale and bias fold 1/s_out
  xla          ops/conv.conv2d_w8a8: the conv_w8a8 kernel (a 1x1 conv:
               gemm_fused on a view), conv order; as the entry stage on
               the uint8 wire, where the small-Cin kernel takes the conv
               (plan_entry_u8_rows), ops/conv.conv2d_w8a8_u8: one
               conv_w8a8_rows launch that reads each byte as its code
  gemm         im2col + gemm_fused in the folded order
               (ops/conv_lowering.conv2d_w8a8_gemm)
  auto         xla or gemm per layer shape (ops/dispatch.py)
  s0           ops/attic/stage0.stage0_fused_v2 (kernel): quantize (f32
               input) + conv1 + 2x2/s2 pool on the int32 accumulator +
               epilogue/requant, emitting the fold-2 tensor (cur_fold 2);
               layer 0 of the 416 px model only, elsewhere it degrades to
               fold_xla, as in the JAX plan
  pool         ops/pool.maxpool
  route        dequantize the saved pieces, concat, requantize
  upsample     nearest repeat of the int8 tensor (keeps its scale)
  shortcut     dequantize both sides (an f32 side as it is), add in f32,
               the activation, requantize
  gap          the global average pool, in f32 (scale None)
  dense        f32 x (wq * s_w) + b, the activation (full float32)

A stride-2 conv and a linear conv's f32 output (ResNet-18's projection
skips and the second conv of each block) run as ``xla`` stages on
``conv2d_w8a8``: the conv_w8a8 kernel's stride-2 and f32-output forms.

Layer outputs consumed out of sequence (route sources, the heads of a
multi-head model) are saved de-folded with their scale.

Each stage runs in a profiler scope (runtime/profiling.py), opened only
while a profiler runs: ``stage{si}_{kind}_L{li}`` (``_fold{f}`` when
folded) in the W8A8 plan, ``w8stage{si}_{kind}_L{li}`` in the w8 plan,
the JAX plan's named scopes. ``stage_flops`` gives each stage's work.

The strategy tables are the JAX package's pins, measured there on a TPU;
the port uses them as its parity contract. A strategy file measured by
the port's sweep (runtime/plan_sweep.py) replaces them through
``EngineConfig.strategy``; the port's own pins await adoption (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from dnn_inference_engine_tpu_torch.models.layers import (
    Conv, Dense, GlobalAvgPool, MaxPool, Route, Shortcut, Upsample,
)
from dnn_inference_engine_tpu_torch.models.model import (
    _to_f32, _upsample_nearest, dense_f32, dense_weights,
)
from dnn_inference_engine_tpu_torch.ops.activations import apply_activation
from dnn_inference_engine_tpu_torch.ops.attic.stage0 import (
    build_stage0_weights_v2, dense_k_from_v2, stage0_fused_v2,
    stage0_tile_matrix)
from dnn_inference_engine_tpu_torch.ops.conv import (
    conv2d_w8_bf16, conv2d_w8a8, conv2d_w8a8_u8, entry_codes, rows_takes)
from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
    conv2d_w8a8_gemm, gemm_weights)
from dnn_inference_engine_tpu_torch.ops.dispatch import conv2d_w8a8_dispatch
from dnn_inference_engine_tpu_torch.ops.fused_conv import (
    _pad_channels, _pad_hw, _round_up, conv3x3_rs, depth_to_space,
    fold_conv3x3_k2_weights, fold_conv3x3_weights, gmax_shift_s2d2,
    group_max4, quant_space_to_depth4, rs_tile_matrix, rs_weight_matrix,
    shift_s2d2,
    shift_space_to_depth, space_to_depth, stem_dg_weight_slabs,
    stem_fused_dg, stem_fused_k2,
)
from dnn_inference_engine_tpu_torch.ops.pool import maxpool
from dnn_inference_engine_tpu_torch.quant.quantize import (
    PlanScale, f32_scalar, quantize_act,
)
from dnn_inference_engine_tpu_torch.runtime.profiling import scope


@dataclasses.dataclass
class Stage:
    kind: str                     # conv kinds: stem_rs | stem_dg | s0
                                  # | fold_xla | fold_xla_k2 | fold_xla_s2
                                  # | rs | xla | gemm | auto; pool | route
                                  # | upsample | shortcut | gap | dense
    conv_li: int                  # layer index this stage implements
    pool_li: Optional[int]        # fused following MaxPool layer (or None)
    fold: int = 1                 # 1 (unfolded) or fold factor (+ gmax)
    k: int = 3                    # folded kernel size (3 = SAME, 2 = shifted VALID)
    s2d_out: bool = False         # the rs kernel emits the s2d(2) layout
    cin_pad: int = 0              # lane-pad folded input channels to this
    act: str = "leaky"
    stride: int = 1
    padding: str = "SAME"
    s_out_is_final: bool = False


_CONV_KINDS = {"fold_xla": "fold_xla", "fold_xla_k2": "fold_xla_k2",
               "fold_xla_s2": "fold_xla_s2",
               "rs": "rs", "rs2": "rs", "stem_rs": "stem_rs",
               "stem_dg": "stem_dg",
               "xla": "xla", "gemm": "gemm", "auto": "auto", "s0": "s0"}

# The JAX package's YOLOv2-tiny pin for batch 32 (and the default for
# batches without a pin of their own).
_YOLOV2_STRATEGY = {
    0: ("stem_rs", 4, {"cin_pad": 64}),
    2: ("fold_xla", 2),     # conv2 folded f2 (chained in, no relayout)
    4: ("fold_xla_k2", 2),  # conv3 shifted-k2 f2 (absorbs the pool)
    6: ("xla", 1),
    8: ("xla", 1),
    10: ("xla", 1),
    12: ("xla", 1),
    13: ("xla", 1),
    14: ("xla", 1),
}

# The JAX package's YOLOv3-tiny pin, measured there at batch 16; the
# default for every batch (it has no per-batch pins).
_YOLOV3_STRATEGY = {
    0: ("stem_dg", 4),
    2: ("fold_xla", 2),
    4: ("fold_xla_k2", 2),                    # absorbs the C=64 pool

    6: ("xla", 1),
    8: ("xla", 1),
    10: ("xla", 1),
    12: ("xla", 1),
    13: ("xla", 1),
    14: ("xla", 1),
    15: ("xla", 1),
    17: ("xla", 1),
    20: ("xla", 1),
    21: ("xla", 1),
}

_DEFAULT_STRATEGIES = {
    "yolov2-tiny": _YOLOV2_STRATEGY,
    "yolov3-tiny": _YOLOV3_STRATEGY,
}

# Per-(model, batch) pins; an exact batch match wins over the default.
_BATCH_STRATEGIES: Dict[Tuple[str, int], Dict] = {
    ("yolov2-tiny", 1): {
        0: ("stem_rs", 4, {"cin_pad": 64}),
        2: ("fold_xla", 2),
        4: ("fold_xla", 2),
        6: ("xla", 1), 8: ("xla", 1), 10: ("xla", 1),
        12: ("xla", 1), 13: ("xla", 1), 14: ("xla", 1),
    },
    ("yolov2-tiny", 8): {
        0: ("stem_rs", 4, {"cin_pad": 64}),
        2: ("fold_xla", 2),
        4: ("fold_xla", 2),
        6: ("xla", 1),
        8: ("fold_xla_k2", 2),
        10: ("xla", 1),
        12: ("xla", 1), 13: ("xla", 1), 14: ("xla", 1),
    },
}


# The JAX package's w8 (weight-only, bf16) pins, keyed (model, batch).
_W8_BATCH_STRATEGIES: Dict[Tuple[str, int], Dict] = {
    ("yolov2-tiny", 1): {
        0: ("fold_xla_k2", 4, {"cin_pad": 64}),
        2: ("fold_xla", 2),
        4: ("xla", 1),
        6: ("gemm", 1),
        8: ("xla", 1), 10: ("xla", 1),
        12: ("xla", 1), 13: ("xla", 1), 14: ("xla", 1),
    },
    ("yolov3-tiny", 16): {
        0: ("fold_xla", 4, {"cin_pad": 64}),
        2: ("fold_xla", 2),
        4: ("xla", 1),
        6: ("xla", 1), 8: ("xla", 1), 10: ("xla", 1),
        12: ("xla", 1), 13: ("xla", 1), 14: ("xla", 1),
        15: ("xla", 1), 17: ("xla", 1), 20: ("xla", 1), 21: ("xla", 1),
    },
}


def default_strategy(model_name: str, batch: Optional[int] = None,
                     mode: str = "w8a8") -> Dict:
    """The pinned strategy for (model, mode, batch): the w8 pin of the
    batch in w8 when one exists, else the per-batch w8a8 pin, else the
    model's default table."""
    if mode == "w8" and batch is not None:
        s = _W8_BATCH_STRATEGIES.get((model_name, batch))
        if s is not None:
            return s
    if batch is not None:
        s = _BATCH_STRATEGIES.get((model_name, batch))
        if s is not None:
            return s
    return _DEFAULT_STRATEGIES.get(model_name, {})


def _referenced_layers(model) -> Set[int]:
    """Layer indices whose outputs are consumed out of sequence."""
    refs: Set[int] = set()
    for layer in model.layers:
        if isinstance(layer, Route):
            refs.update(layer.layers)
        elif isinstance(layer, Shortcut):
            refs.add(layer.frm)
    if model.out_layers is not None:
        refs.update(model.out_layers)
    return refs


def build_plan(model, strategy: Optional[Dict] = None,
               batch: Optional[int] = None,
               mode: str = "w8a8") -> Optional[List[Stage]]:
    """Layer-list model -> list of stages; None where the JAX plan gives
    None (a fold without its pool, a fold of a referenced output, a chain
    the fold states cannot follow)."""
    return plan_or_reason(model, strategy, batch, mode)[0]


def plan_or_reason(model, strategy: Optional[Dict] = None,
                   batch: Optional[int] = None, mode: str = "w8a8"
                   ) -> Tuple[Optional[List[Stage]], str]:
    """``build_plan`` with the reason for a None: (stages, "") or
    (None, what makes which layer illegal)."""
    if strategy is None:
        strategy = default_strategy(model.name, batch, mode)
    refs = _referenced_layers(model)
    stages: List[Stage] = []
    layers = model.layers
    li = 0
    while li < len(layers):
        layer = layers[li]
        if isinstance(layer, Conv):
            entry = strategy.get(li, ("xla", 1))
            kind, fold = entry[0], entry[1]
            opts = entry[2] if len(entry) > 2 else {}
            if kind not in _CONV_KINDS:
                raise ValueError(
                    f"unknown plan strategy kind {kind!r} for layer {li}; "
                    f"valid kinds: {sorted(_CONV_KINDS)}")
            if kind == "s0" and not (
                    li == 0 and model.in_ch == 3 and model.input_size == 416
                    and layer.ksize == 3 and layer.out_ch == 16
                    and layer.stride == 1):
                kind = "fold_xla"   # shape-specialized kernel; degrade
            pool_li = None
            nxt = li + 1
            if (fold > 1 and nxt < len(layers)
                    and isinstance(layers[nxt], MaxPool)
                    and layers[nxt].stride == 2 and layers[nxt].size == 2):
                pool_li = nxt
            if fold > 1 and pool_li is None:
                return None, (f"layer {li}: {kind}:{fold} folds a 2x2/s2 "
                              "maxpool and none follows")
            if fold > 1 and li in refs:
                # a fold erases the conv's pre-pool output
                return None, (f"layer {li}: {kind}:{fold} would fold away "
                              "an output that a later layer reads")
            stages.append(Stage(
                kind=_CONV_KINDS[kind], conv_li=li, pool_li=pool_li,
                fold=fold,
                k=2 if kind in ("rs2", "fold_xla_k2", "stem_rs", "stem_dg")
                else 3,
                s2d_out=opts.get("s2d_out", False),
                cin_pad=opts.get("cin_pad", 0), act=layer.act,
                stride=layer.stride, padding=layer.padding,
                s_out_is_final=(layer.act == "linear")))
            li = (pool_li + 1) if pool_li is not None else li + 1
        elif isinstance(layer, MaxPool):
            stages.append(Stage(kind="pool", conv_li=li, pool_li=None))
            li += 1
        elif isinstance(layer, Route):
            stages.append(Stage(kind="route", conv_li=li, pool_li=None))
            li += 1
        elif isinstance(layer, Shortcut):
            stages.append(Stage(kind="shortcut", conv_li=li, pool_li=None,
                                act=layer.act))
            li += 1
        elif isinstance(layer, Upsample):
            stages.append(Stage(kind="upsample", conv_li=li, pool_li=None))
            li += 1
        elif isinstance(layer, GlobalAvgPool):
            stages.append(Stage(kind="gap", conv_li=li, pool_li=None))
            li += 1
        elif isinstance(layer, Dense):
            stages.append(Stage(kind="dense", conv_li=li, pool_li=None,
                                act=layer.act))
            li += 1
        else:
            return None, f"layer {li}: no plan stage for {layer!r}"
    # fold_xla_s2 emits the SHIFTED fold-2 layout; only a fold_xla_k2 f=2
    # stage right after it can read that
    for i, st in enumerate(stages):
        if st.kind == "fold_xla_s2":
            nxt = stages[i + 1] if i + 1 < len(stages) else None
            if (st.fold != 2 or st.pool_li in refs or nxt is None
                    or nxt.kind != "fold_xla_k2" or nxt.fold != 2):
                return None, (f"layer {st.conv_li}: fold_xla_s2 must be "
                              "fold 2 and feed a fold_xla_k2:2 stage")
    # follow the fold state _run_stage tracks (-2: the shifted layout)
    cur = 1
    for st in stages:
        if cur == -2 and st.kind != "fold_xla_k2":
            return None, (f"layer {st.conv_li}: only fold_xla_k2 reads the "
                          "shifted fold-2 layout of a fold_xla_s2")
        if st.kind in ("stem_rs", "stem_dg", "fold_xla_k2", "fold_xla"):
            cur = st.fold // 2
        elif st.kind == "s0":
            cur = 2
        elif st.kind == "fold_xla_s2":
            cur = -2
        elif st.kind == "rs":
            cur = ((st.fold // 2) * (2 if st.s2d_out else 1)
                   if st.fold > 1 else 1)
        else:
            cur = 1
    if cur == -2:
        return None, "the plan ends in the shifted fold-2 layout"
    return stages, ""


class StageScales(NamedTuple):
    """What a W8A8 stage makes of host values, by the float32 ops and in
    the order the stage uses them: made once a plan by
    ``prepare_plan_params`` (a plan prepared without act_scales makes them
    each call). ``s_in``: the input scale they were made for (an entry
    stage's own ``act_scales[li]``); ``s_out``: the scale the stage emits
    (None: an f32 output); ``scale`` and ``bias``: its conv's epilogue
    operands, f32(s_in) * s_w, or in the folded order of the rs, s0 and
    stem kernels both over f32(s_out); ``u8``: a stem's (f32(1/255),
    scale, bias) for the uint8 wire, 128 times the weight row sums folded
    into the bias."""
    s_in: Optional[PlanScale] = None
    s_out: Optional[PlanScale] = None
    scale: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    u8: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


def stage_scales(st: Stage, pp: Dict, s_in: Optional[float],
                 s_out: Optional[float], dev) -> StageScales:
    """``StageScales`` of stage ``st`` (its params ``pp``) for input scale
    ``s_in`` and output scale ``s_out``, on ``dev``."""
    si = None if s_in is None else PlanScale(s_in, dev)
    so = None if s_out is None else PlanScale(s_out, dev)
    if st.kind in ("stem_rs", "stem_dg"):
        s_w = pp["s_w"]
        s255 = f32_scalar(1.0 / 255.0, dev)
        w1 = pp["wq"].reshape(-1, s_w.shape[0]).to(torch.float32).sum(0)
        u8 = (s255, (s255 * s_w) / so.t,
              (pp["b"] + 128.0 * s255 * s_w * w1) / so.t)
        return StageScales(si, so, (si.t * s_w) / so.t, pp["b"] / so.t, u8)
    if st.kind == "s0":
        # the JAX s0 branch's op order (the f32 s_in/s_next first)
        return StageScales(si, so, pp["s_w"].repeat(4) * (si.t / so.t),
                           pp["b"].repeat(4) / so.t)
    if st.kind == "rs":
        return StageScales(si, so, (si.t * pp["s_w"]) / so.t,
                           pp["b"] / so.t)
    if st.kind in ("xla", "fold_xla", "fold_xla_s2", "fold_xla_k2"):
        return StageScales(si, so, si.t * pp["s_w"])
    return StageScales(si, so)


def _scale_keys(stages: Sequence[Stage], act_scales
                ) -> List[Optional[Tuple[Optional[float], Optional[float]]]]:
    """Each stage's (s_in, s_out) as ``_run_stage`` reads them, following
    the scale a forward carries from stage to stage; None for a stage
    that reads no scale of its own (pool, upsample, gap, dense)."""
    keys: List = []
    cur = None
    for st in stages:
        li = st.conv_li
        s_next = act_scales[li + 1]
        if st.kind in ("pool", "upsample"):
            keys.append(None)
            continue
        if st.kind in ("gap", "dense"):
            keys.append(None)
            cur = None
            continue
        if st.kind in ("route", "shortcut"):
            key = (None, s_next)
        elif st.kind in ("stem_rs", "stem_dg", "s0"):
            key = (act_scales[li], s_next)
        else:
            s_in = act_scales[li] if cur is None else cur
            key = (s_in, None if (st.s_out_is_final
                                  and st.kind != "fold_xla_k2") else s_next)
        keys.append(key)
        cur = key[1]
    return keys


def _stage_scales_of(st: Stage, pp: Dict, s_in: Optional[float],
                     s_out: Optional[float], dev) -> StageScales:
    """The plan's ``StageScales`` of the stage, checked against the scales
    this forward reads (a plan prepared for other act_scales raises), or
    made now for a plan prepared without them."""
    sc = pp.get("scales")
    if sc is None:
        return stage_scales(st, pp, s_in, s_out, dev)
    made = tuple(None if s is None else s.v for s in (sc.s_in, sc.s_out))
    if made != (s_in, s_out):
        raise ValueError(
            f"layer {st.conv_li}: the plan's {st.kind} scales were made for "
            f"(s_in, s_out) {made}, this forward reads {(s_in, s_out)}: "
            "prepare_plan_params with the act_scales the forward runs")
    return sc


def _v(s) -> Optional[float]:
    """A scale's float (None stays None)."""
    return None if s is None else float(s)


def prepare_plan_params(model, qparams: Sequence[Dict],
                        stages: Sequence[Stage],
                        act_scales: Optional[Sequence[float]] = None
                        ) -> List[Dict]:
    """Pre-fold weights for folded stages (host-side, once), store each
    conv stage's K-major weight matrix ``wt`` (gemm_weights: the GEMM's,
    and the conv_w8a8 kernel's without a group-max), and lay out the
    stem_dg kernel's weight slabs, the rs kernel's K-major matrix, the
    conv_w8a8 kernel's pool-major matrix of a fold stage and the s0
    kernel's dense-K matrix and tile (each cached on its weights); a
    dense stage keeps its params and gains its f32 weights ``w``. Given
    the W8A8 ``act_scales``, an entry stage that reads the uint8 wire on
    the small-Cin kernel (``plan_entry_u8_rows``) gains its
    ``entry_codes``: the byte-to-code table and s_in * s_w, and every stage
    that reads a scale its ``scales`` (``StageScales``, on the weights'
    device): so the forward copies no host value to the card."""
    out: List[Dict] = []
    for st in stages:
        p = qparams[st.conv_li]
        if st.kind == "s0":
            # v2's operand at unit scale; the stage folds the scales in at
            # run time. Taken before the fold branch: s0's weights are not
            # folded, whatever the strategy's fold says
            wv, _, _ = build_stage0_weights_v2(
                p["wq"].cpu().numpy(), np.ones(16, np.float32),
                np.zeros(16, np.float32), 1.0, 1.0)
            wv = torch.as_tensor(wv, device=p["wq"].device)
            stage0_tile_matrix(dense_k_from_v2(wv))
            out.append({"wv": wv, "s_w": p["s_w"], "b": p["b"]})
            continue
        if st.fold > 1:
            f = st.fold
            folder = (fold_conv3x3_k2_weights if st.k == 2
                      else fold_conv3x3_weights)
            wq = p["wq"]
            # pool-major group order: the fused group-max is 3 maxes over
            # contiguous channel quarters
            wf = folder(wq.cpu().numpy(), f, pool_major=True)
            if st.cin_pad and wf.shape[2] < st.cin_pad:
                # zero Cin rows match the lane-padded input's zero channels
                wf = np.concatenate(
                    [wf, np.zeros(wf.shape[:2]
                                  + (st.cin_pad - wf.shape[2], wf.shape[3]),
                                  wf.dtype)], axis=2)
            q = {"wq": torch.as_tensor(wf, device=wq.device),
                 "s_w": p["s_w"].repeat(f * f),
                 "b": p["b"].repeat(f * f)}
        else:
            q = dict(p)
        if st.kind == "dense":
            q["w"] = dense_weights(q)
        elif st.kind == "stem_dg":
            stem_dg_weight_slabs(q["wq"])
        elif st.kind == "rs":
            rs_weight_matrix(q["wq"])
        elif st.kind != "stem_rs" and "wq" in q:
            q["wt"] = gemm_weights(q["wq"])
            if st.kind in ("fold_xla", "fold_xla_k2"):
                # the conv_w8a8 kernel's pool-major matrix for the
                # group-max, cached on the folded weights
                rs_tile_matrix(q["wq"], q["wq"].shape[3] // 4)
        out.append(q)
    if act_scales is not None:
        if plan_entry_u8_rows(model, stages):
            out[0]["entry_codes"] = entry_codes(
                act_scales[stages[0].conv_li], out[0]["s_w"])
        dev = next(p["wq"].device for p in qparams if p and "wq" in p)
        for st, q, key in zip(stages, out, _scale_keys(stages, act_scales)):
            if key is not None:
                q["scales"] = stage_scales(st, q, *key, dev)
    return out


@torch.no_grad()
def plan_forward_w8a8(model, stages: Sequence[Stage],
                      plan_params: Sequence[Dict], act_scales, x,
                      pair: Optional[Tuple[int, int]] = None, group=None,
                      record_states: Optional[list] = None):
    """Run the fused stage pipeline. x: (N,H,W,3) f32, or uint8 when the
    entry stage ingests the wire format (plan_input_uint8_ok); returns
    the f32 head, or the tuple of heads of a multi-head model.

    ``pair``: on one rank of a channel-sharded mesh
    (parallel/sharded_engine.py), the (Cout-shard, Cin-shard) layers. The
    first needs nothing of its own (its params are the rank's Cout
    slice); the second sums its int32 accumulator over ``group`` before
    the epilogue (``row_parallel_conv_w8a8``), so the sharded plan equals
    the single-device one bit for bit.

    ``record_states``: when a list, each stage's entry state
    ``(x, cur_scale, cur_fold, saved)`` is appended to it.
    """
    refs = _referenced_layers(model)
    cur_scale = None
    cur_fold = 1                  # s2d fold factor of the tensor in ``x``
    # saved[li] = (tensor, scale) for out-of-sequence consumers, always
    # de-folded; scale None: the tensor is f32
    saved: Dict[int, Tuple[torch.Tensor, Optional[float]]] = {}
    for si, st in enumerate(stages):
        if record_states is not None:
            record_states.append((x, cur_scale, cur_fold, dict(saved)))
        with scope(f"stage{si}_{st.kind}_L{st.conv_li}"
                   + (f"_fold{st.fold}" if st.fold > 1 else "")):
            x, cur_scale, cur_fold = _run_stage(
                model.layers, st, plan_params[si], x, cur_scale, cur_fold,
                act_scales, saved, pair, group)
        out_li = st.pool_li if st.pool_li is not None else st.conv_li
        if out_li in refs:
            t = depth_to_space(x, cur_fold) if cur_fold > 1 else x
            saved[out_li] = (t, cur_scale)
    if model.out_layers is not None:
        return tuple(_to_f32(*saved[j]) for j in model.out_layers)
    if cur_fold > 1:
        x = depth_to_space(x, cur_fold)
    return _to_f32(x, cur_scale)


def plan_input_uint8_ok(stages: Sequence[Stage]) -> bool:
    """True when the plan's entry stage consumes the uint8 wire format
    directly (no separate /255 normalize of the batch)."""
    st = stages[0]
    return (st.kind in ("fold_xla", "fold_xla_k2", "stem_rs", "stem_dg")
            and st.fold == 4)


def plan_entry_u8_rows(model, stages: Sequence[Stage]) -> bool:
    """True when the W8A8 plan's entry stage is an unfolded ``xla`` conv
    that the small-Cin kernel takes (``rows_takes``: ResNet-18's stem, the
    YOLO models' entry conv): it reads the uint8 wire batch itself
    (``conv2d_w8a8_u8``), so the batch skips the /255 pass. The port's own
    check: ``plan_input_uint8_ok`` mirrors the JAX plan's, whose ``xla``
    entry divides by 255 first."""
    st = stages[0]
    lay = model.layers[st.conv_li]
    return isinstance(lay, Conv) and _rows_entry(
        st, model.in_ch, (lay.ksize, lay.ksize, model.in_ch, lay.out_ch))


def _rows_entry(st: Stage, cin: int, wshape) -> bool:
    """An unfolded ``xla`` stage whose conv (HWIO ``wshape`` on a ``cin``
    input) the small-Cin kernel takes."""
    kh, kw, _, cout = (int(d) for d in wshape)
    return (st.kind == "xla" and st.fold == 1
            and rows_takes(cin, cout, kh, kw, st.stride, st.padding))


def _conv_flops(model, input_size: Optional[int] = None) -> Dict[int, float]:
    """Useful MACs per image of each conv layer, its spatial size tracked
    through strided convs and pools, upsamples and routes (the JAX
    package's ``parallel/sharding._conv_flops``)."""
    flops = {}
    h = w = input_size or model.input_size
    prev_c = model.in_ch
    chans = model.out_channels()
    sizes = []
    for li, layer in enumerate(model.layers):
        if isinstance(layer, Conv):
            ho, wo = -(-h // layer.stride), -(-w // layer.stride)
            flops[li] = (ho * wo * layer.ksize * layer.ksize
                         * prev_c * layer.out_ch)
            h, w = ho, wo
        elif isinstance(layer, MaxPool) and layer.stride > 1:
            h, w = -(-h // layer.stride), -(-w // layer.stride)
        elif isinstance(layer, Upsample):
            h, w = h * layer.stride, w * layer.stride
        elif isinstance(layer, Route):
            h, w = sizes[layer.layers[0]]
        sizes.append((h, w))
        prev_c = chans[li]
    return flops


def stage_flops(model, stages: Sequence[Stage],
                input_size: Optional[int] = None
                ) -> List[Tuple[float, float]]:
    """Per-stage (useful MACs, executed MACs) per image.

    ``useful``: the layer's own MAC count, the work any implementation
    must do. ``executed``: the MACs the stage's formulation performs (a
    k=3 fold f executes f^2 times the useful MACs, the shifted k=2 fold
    4f^2/9 times, the s0 kernel 3 products of K=128 per 27-MAC output).
    The graph stages (pool, route, shortcut, upsample, gap) move bytes
    only: (0, 0)."""
    per_layer = _conv_flops(model, input_size)
    out: List[Tuple[float, float]] = []
    for st in stages:
        if st.kind in ("pool", "route", "shortcut", "upsample", "gap"):
            out.append((0.0, 0.0))
            continue
        if st.kind == "dense":
            chans = model.out_channels()
            cin = chans[st.conv_li - 1] if st.conv_li else model.in_ch
            out.append((float(cin * model.layers[st.conv_li].out),) * 2)
            continue
        useful = float(per_layer[st.conv_li])
        if st.kind == "s0":
            factor = 3 * 128 / 27.0
        elif st.fold > 1 and st.k == 2:
            factor = 4.0 * st.fold ** 2 / 9.0
        elif st.fold > 1:
            factor = float(st.fold ** 2)
        else:
            factor = 1.0
        out.append((useful, useful * factor))
    return out


@torch.no_grad()
def plan_forward_w8(model, stages: Sequence[Stage],
                    plan_params: Sequence[Dict], x):
    """Run the weight-only (w8) plan: the same stages on bf16 tensors.
    x: (N,H,W,3) uint8 (divided by 255) or f32; returns the f32 head, or
    the tuple of heads.

    As in the JAX plan: the input and every inter-stage tensor is bf16;
    each conv is ``conv2d_w8_bf16`` (f32 sums and epilogue); a fold stage
    rounds its conv output to bf16 before the group-max; the head stays
    f32.
    ``fold_xla_k2`` and the stem kinds run the shifted k=2 fold on the
    padded s2d(f) input, ``fold_xla`` and ``fold_xla_s2`` the k=3 fold
    (no shifted emission: the next k2 stage shifts for itself), ``xla``,
    ``gemm`` and ``auto`` the plain conv. ``rs`` and ``s0`` are int8
    kernels with no w8 form and raise (the engine drops such plans)."""
    refs = _referenced_layers(model)
    layers = model.layers
    cur_fold = 1
    saved: Dict[int, torch.Tensor] = {}
    x = _entry_u8_to_f32(x).to(torch.bfloat16)

    def conv(xb, pp, act, stride=1, padding="SAME"):
        return conv2d_w8_bf16(xb, pp["wq"], pp["s_w"], pp["b"], act=act,
                              stride=stride, padding=padding)

    def gmax_bf16(y):
        return group_max4(y.to(torch.bfloat16))

    for si, st in enumerate(stages):
        pp = plan_params[si]
        li = st.conv_li
        with scope(f"w8stage{si}_{st.kind}_L{li}"):
            if st.kind == "pool":
                x, cur_fold = _defold(x, cur_fold)
                lay = layers[li]
                x = maxpool(x, lay.size, lay.stride, lay.padding)
            elif st.kind == "route":
                x = torch.cat([saved[j] for j in layers[li].layers], dim=-1)
            elif st.kind == "upsample":
                x, cur_fold = _defold(x, cur_fold)
                x = _upsample_nearest(x, layers[li].stride)
            elif st.kind == "shortcut":
                x, cur_fold = _defold(x, cur_fold)
                x = (x.to(torch.float32)
                     + saved[layers[li].frm].to(torch.float32))
                x = apply_activation(x, st.act).to(torch.bfloat16)
            elif st.kind == "gap":
                x, cur_fold = _defold(x, cur_fold)
                x = torch.mean(x.to(torch.float32), dim=(1, 2))
            elif st.kind == "dense":
                x = apply_activation(
                    dense_f32(x.to(torch.float32), pp["w"]) + pp["b"],
                    st.act)
            elif st.kind in ("fold_xla_k2", "stem_rs", "stem_dg"):
                f = st.fold
                if cur_fold != 1:
                    raise ValueError(
                        f"{st.kind} reads the plain tensor: {st}")
                x = space_to_depth(
                    _pad_hw(x, 1, 2 * f - 1, 1, 2 * f - 1), f)
                if st.cin_pad:
                    x = _pad_channels(x, st.cin_pad)
                ho, wo = x.shape[1] - 2, x.shape[2] - 2
                y = conv(x, pp, st.act, padding="VALID")[:, :ho, :wo]
                x, cur_fold = gmax_bf16(y), f // 2
            elif st.kind in ("fold_xla", "fold_xla_s2"):
                f = st.fold
                if cur_fold != f:
                    x, cur_fold = _defold(x, cur_fold)
                    x, cur_fold = space_to_depth(x, f), f
                if st.cin_pad:
                    x = _pad_channels(x, st.cin_pad)
                x, cur_fold = gmax_bf16(conv(x, pp, st.act)), f // 2
            elif st.kind in ("xla", "gemm", "auto"):
                x, cur_fold = _defold(x, cur_fold)
                y = conv(x, pp, st.act, stride=st.stride,
                         padding=st.padding)
                x = y if st.s_out_is_final else y.to(torch.bfloat16)
            else:
                raise ValueError(
                    f"stage kind {st.kind!r} has no w8 implementation; use "
                    "a strategy without rs/s0 kinds for w8 plans")
        out_li = st.pool_li if st.pool_li is not None else st.conv_li
        if out_li in refs:
            saved[out_li] = (depth_to_space(x, cur_fold) if cur_fold > 1
                             else x)
    if model.out_layers is not None:
        return tuple(saved[j].to(torch.float32) for j in model.out_layers)
    if cur_fold > 1:
        x = depth_to_space(x, cur_fold)
    return x.to(torch.float32)


def _defold(x, cur_fold):
    """The plain (de-folded) tensor and fold 1."""
    if cur_fold < 1:
        raise ValueError("the shifted fold-2 state (negative sentinel) must "
                         "feed a fold_xla_k2 f=2 stage")
    return (depth_to_space(x, cur_fold), 1) if cur_fold > 1 else (x, 1)


def _entry_u8_to_f32(x):
    """The /255 normalize of a uint8 batch that no fused entry takes."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / f32_scalar(255.0, x.device)
    return x


def _fold_k2_stage(st, pp, x, cur_scale, cur_fold, act_scales):
    """The shifted-fold k2 stage: a 2x2 VALID conv over the shifted s2d(f)
    of the input (padded 1 top/left, 2f-1 bottom/right), trimmed to the
    conv's real rows and columns (out_hw), then the pool-major
    group-max."""
    li, f = st.conv_li, st.fold
    if st.s_out_is_final:
        raise ValueError(f"fold_xla_k2 cannot emit the head: {st}")
    sc = _stage_scales_of(st, pp, act_scales[li] if cur_scale is None
                          else _v(cur_scale), act_scales[li + 1], x.device)
    if cur_fold > 1:
        x, cur_fold = _defold(x, cur_fold)
    out_hw = None
    pad = (1, 2 * f - 1, 1, 2 * f - 1)
    if cur_fold < 0:
        # a fold_xla_s2 producer emitted the shifted fold-2 layout; the
        # sentinel's magnitude is its true output row count H/2
        ho = -cur_fold
        if f != 2 or x.shape[1] != _round_up(ho + 1, 8):
            raise ValueError(f"shifted fold-2 payload {tuple(x.shape)} does "
                             f"not match the producer's {ho} rows: {st}")
        out_hw = (ho, x.shape[2] - 1)
    elif cur_scale is None:
        # the entry stage: quantize the network input
        cur_scale = act_scales[li]
        fused_ok = (f == 4 and x.shape[-1] == 3
                    and (x.shape[1] + 2 * f) % 8 == 0
                    and (x.shape[2] + 2 * f) % 8 == 0)
        if fused_ok:
            # uint8 wire or f32; reads the zero border from the bounds
            x = quant_space_to_depth4(x, cur_scale, pad_to=st.cin_pad,
                                      pad_hw=pad)
        else:
            x = quantize_act(_entry_u8_to_f32(x), sc.s_in)
            x = space_to_depth(_pad_hw(x, *pad), f)
    elif (f == 2 and x.dtype == torch.int8 and x.shape[1] % 2 == 0
          and x.shape[2] % 2 == 0):
        out_hw = (x.shape[1] // 2, x.shape[2] // 2)
        x = shift_s2d2(x)
    else:
        x = space_to_depth(_pad_hw(x, *pad), f)
    if st.cin_pad:
        x = _pad_channels(x, st.cin_pad)
    y = conv2d_w8a8(x, cur_scale, pp["wq"], pp["s_w"], pp["b"], act=st.act,
                    padding="VALID", s_out=sc.s_out, wt=pp["wt"],
                    out_hw=out_hw or (x.shape[1] - 2, x.shape[2] - 2),
                    gmax=True, scale=sc.scale)
    return y, sc.s_out, f // 2


def _run_stage(layers, st, pp, x, cur_scale, cur_fold, act_scales,
               saved=None, pair=None, group=None):
    """One plan stage; returns (x, cur_scale, cur_fold). ``act_scales``
    are Python floats (f32-rounded where used), as the JAX plan's
    ``jnp.float32(act_scales[i])``; the scale a stage emits is its
    ``StageScales.s_out`` (a ``PlanScale``), and ``cur_scale`` may be one
    or a float. ``saved``: the de-folded outputs a route or shortcut stage
    reads; ``pair`` and ``group``: the channel pair's row-parallel conv
    (plan_forward_w8a8)."""
    li = st.conv_li
    s_next = act_scales[li + 1]
    dev = x.device
    if st.kind == "pool":
        x, cur_fold = _defold(x, cur_fold)
        lay = layers[li]
        x = maxpool(x, lay.size, lay.stride, lay.padding)  # scale-preserving
        return x, cur_scale, cur_fold
    if st.kind == "route":
        sc = _stage_scales_of(st, pp, None, s_next, dev)
        x = torch.cat([_to_f32(*saved[j]) for j in layers[li].layers],
                      dim=-1)
        return quantize_act(x, sc.s_out), sc.s_out, 1
    if st.kind == "upsample":
        x, cur_fold = _defold(x, cur_fold)
        x = _upsample_nearest(x, layers[li].stride)        # scale-preserving
        return x, cur_scale, cur_fold
    if st.kind == "shortcut":
        sc = _stage_scales_of(st, pp, None, s_next, dev)
        x, cur_fold = _defold(x, cur_fold)
        x = _to_f32(x, cur_scale) + _to_f32(*saved[layers[li].frm])
        x = apply_activation(x, st.act)
        return quantize_act(x, sc.s_out), sc.s_out, 1
    if st.kind == "gap":
        x, cur_fold = _defold(x, cur_fold)
        return torch.mean(_to_f32(x, cur_scale), dim=(1, 2)), None, cur_fold
    if st.kind == "dense":
        x = dense_f32(_to_f32(x, cur_scale), pp["w"]) + pp["b"]
        return apply_activation(x, st.act), None, cur_fold

    if st.kind in ("stem_rs", "stem_dg"):
        # the whole stage 0 in one kernel: quantize (uint8 wire or f32) +
        # shifted s2d(4) + 2x2 folded conv + epilogue/requant + pool-major
        # group-max; stem_dg is the same function in the per-tap
        # formulation
        stem = stem_fused_dg if st.kind == "stem_dg" else stem_fused_k2
        if not (cur_fold == 1 and cur_scale is None and st.fold == 4
                and not st.s_out_is_final):
            raise ValueError(f"{st.kind} must be the entry stage: {st}")
        sc = _stage_scales_of(st, pp, act_scales[li], s_next, dev)
        if x.dtype == torch.uint8:
            # exact uint8 ingestion: layer-0 input scale 1/255, codes
            # v = u - 128; the offset contributes 128 * (per-channel
            # weight row-sums), folded into the bias (same op order as
            # the JAX plan)
            s_in, scale, bias = sc.u8
            x = stem(x, pp["wq"], scale, bias, s_in, act=st.act,
                     exact_u8=True)
        else:
            x = stem(x, pp["wq"], sc.scale, sc.bias, act_scales[li],
                     act=st.act)
        return x, sc.s_out, st.fold // 2

    if st.kind == "s0":
        # quantize + conv1 + pool + fold-2 emit in one kernel; the JAX s0
        # branch's op order (the f32 s_in/s_next first), not the stems'
        if not (cur_scale is None and cur_fold == 1):
            raise ValueError(f"s0 must be the entry stage: {st}")
        sc = _stage_scales_of(st, pp, act_scales[li], s_next, dev)
        x = stage0_fused_v2(x, pp["wv"], sc.scale, sc.bias, act_scales[li],
                            act=st.act)
        return x, sc.s_out, 2

    if st.kind == "fold_xla_k2":
        return _fold_k2_stage(st, pp, x, cur_scale, cur_fold, act_scales)

    sc = _stage_scales_of(st, pp, act_scales[li] if cur_scale is None
                          else _v(cur_scale),
                          None if st.s_out_is_final else s_next, dev)
    s_out = sc.s_out
    if cur_scale is None:
        # the entry stage quantizes the network input
        cur_scale = act_scales[li]
        if (st.fold == 4 and st.k == 3 and cur_fold == 1
                and x.shape[-1] == 3 and x.shape[1] % 8 == 0
                and x.shape[2] % 8 == 0):
            # fused quantize + s2d(4), uint8 wire or f32, lane-padded
            x = quant_space_to_depth4(x, cur_scale, pad_to=st.cin_pad)
            cur_fold = 4
        elif (x.dtype == torch.uint8 and not (pair and li == pair[1])
              and _rows_entry(st, x.shape[-1], pp["wq"].shape)):
            # the uint8 wire straight into the small-Cin kernel: each byte
            # read as its code (the table and s_in * s_w made once a plan)
            e = pp.get("entry_codes")
            if e is None or e.s_in != cur_scale:
                raise ValueError(
                    f"layer {li}: a uint8 entry needs the plan's entry_codes "
                    f"at scale {cur_scale} (prepare_plan_params with the "
                    f"act_scales); it has {e and e.s_in}")
            x = conv2d_w8a8_u8(x, e, pp["wq"], pp["s_w"], pp["b"],
                               act=st.act, stride=st.stride,
                               padding=st.padding, s_out=s_out)
            return x, s_out, cur_fold
        else:
            x = quantize_act(_entry_u8_to_f32(x), sc.s_in)
    # layout: folded stages consume s2d(fold) of the plain tensor; the k=2
    # formulation consumes the SHIFTED fold (never chained)
    if st.fold > 1 and st.k == 2:
        x, cur_fold = _defold(x, cur_fold)
        x, cur_fold = shift_space_to_depth(x, st.fold), st.fold
    elif cur_fold != st.fold:
        x, cur_fold = _defold(x, cur_fold)
        if st.fold > 1:
            x, cur_fold = space_to_depth(x, st.fold), st.fold
    if st.fold > 1 and st.cin_pad:
        x = _pad_channels(x, st.cin_pad)

    if st.kind in ("xla", "gemm", "auto") and pair and li == pair[1]:
        if st.fold != 1 or cur_fold != 1:
            raise ValueError(f"the row-parallel conv is unfolded: {st}")
        from dnn_inference_engine_tpu_torch.parallel.shard_map_forward \
            import row_parallel_conv_w8a8
        x = row_parallel_conv_w8a8(
            x, pp, st, cur_scale, s_out, group,
            use_pallas_tier=st.kind in ("gemm", "auto"),
            force_pallas=st.kind == "gemm", wt=pp["wt"])
        return x, s_out, cur_fold
    if st.kind == "xla":
        x = conv2d_w8a8(x, cur_scale, pp["wq"], pp["s_w"], pp["b"],
                        act=st.act, stride=st.stride, padding=st.padding,
                        s_out=s_out, wt=pp["wt"], scale=sc.scale)
        return x, s_out, cur_fold
    if st.kind in ("gemm", "auto"):
        # the gemm tier takes its scales as floats (conv_lowering)
        conv = {"gemm": conv2d_w8a8_gemm,
                "auto": conv2d_w8a8_dispatch}[st.kind]
        x = conv(x, _v(cur_scale), pp["wq"], pp["s_w"], pp["b"], act=st.act,
                 stride=st.stride, padding=st.padding, s_out=_v(s_out),
                 wt=pp["wt"])
        return x, s_out, cur_fold
    if st.kind not in ("fold_xla", "fold_xla_s2", "rs"):
        raise ValueError(st.kind)
    if s_out is None:
        raise ValueError(f"{st.kind} cannot emit the head: {st}")
    f = st.fold
    cout = pp["s_w"].shape[0] // (f * f)
    if st.kind == "rs":
        # the kernel's folded order: 1/s_out is folded into scale and bias
        x = conv3x3_rs(x, pp["wq"], sc.scale, sc.bias, act=st.act,
                       quantize_out=True, pool=("gmaxm", f, cout),
                       ksize=st.k, s2d_out=st.s2d_out)
        return x, s_out, f // 2 * (2 if st.s2d_out else 1)
    if st.kind == "fold_xla_s2":
        if f != 2:
            raise ValueError(f"fold_xla_s2 is a fold-2 stage: {st}")
        y = conv2d_w8a8(x, cur_scale, pp["wq"], pp["s_w"], pp["b"],
                        act=st.act, s_out=s_out, wt=pp["wt"],
                        scale=sc.scale)
        # group-max + shifted s2d(2) in one kernel, for the fold_xla_k2
        # consumer; the sentinel carries the true row count H/2
        return gmax_shift_s2d2(y, go=cout), s_out, -(y.shape[1] // 2)
    # the conv with the pool-major group-max of its requantized codes; the
    # surviving group order IS the fold-(f/2) layout
    x = conv2d_w8a8(x, cur_scale, pp["wq"], pp["s_w"], pp["b"], act=st.act,
                    s_out=s_out, wt=pp["wt"], gmax=True, scale=sc.scale)
    return x, s_out, f // 2
