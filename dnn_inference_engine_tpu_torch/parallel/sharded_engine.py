"""The Engine's sharded detect and forward.

Counterpart of ``dnn_inference_engine_tpu/parallel/sharded_engine.py``:
what the engine needs to honour ``EngineConfig.mesh_shape`` and
``sharding``:

- ``plan_param_specs``: the split axes of the fused plan's params, stage
  by stage (the channel pair's stages shard as its layers do; folded
  stages are early layers and replicated);
- ``shard_engine_params``: this rank's params, and the plan's params
  built from them, so that the layouts the plan caches from the weights
  (``wt``, the kernels' tiles) are the shard's, not cut out of the
  whole's;
- ``make_sharded_detect_fn`` / ``make_sharded_forward_fn``: this rank's
  part of the pipeline, the quantized forward (the fused plan where the
  engine has one) with the pair's row-parallel conv summing its int32
  accumulator over the model group, then (detect) the decode and the
  NMS.

Each rank computes its own rows; decode and NMS are per image, so they
run on those rows with no collective. ``runtime/engine.py`` gathers the
rows over the data group, so every rank returns the whole batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from dnn_inference_engine_tpu_torch.parallel.mesh import Mesh
from dnn_inference_engine_tpu_torch.parallel.shard_map_forward import (
    make_local_w8a8_forward)
from dnn_inference_engine_tpu_torch.parallel.sharding import (
    channel_shard_pair, param_specs, shard_params)


def plan_param_specs(model, stages, policy: str = "replicated"
                     ) -> List[Dict[str, int]]:
    """Per plan stage, {param name: the axis split over ``model``}, in
    the order of ``runtime.plan.prepare_plan_params``' output. Folded and
    s0 stages are replicated; an unfolded conv stage takes its layer's
    ``param_specs``."""
    layer_specs = param_specs(model, policy)
    return [{} if st.fold > 1 or st.kind == "s0"
            else dict(layer_specs[st.conv_li]) for st in stages]


def shard_engine_params(engine, mesh: Mesh) -> None:
    """This rank's per-layer params (``engine._local_params``) and, where
    the engine runs a fused plan, the plan's params built from them. The
    pair's stages must be unfolded conv stages (``xla``, ``gemm`` or
    ``auto``); a strategy that folds one raises."""
    from dnn_inference_engine_tpu_torch.runtime.plan import (
        prepare_plan_params)
    engine._local_params = shard_params(engine.params, mesh, engine.model,
                                        engine.config.sharding)
    if engine._plan is None:
        return
    pair = _validated_pair(engine)
    for st in engine._plan:
        if pair and st.conv_li in pair and (
                st.kind not in ("xla", "gemm", "auto") or st.fold > 1):
            raise ValueError(
                f"layer {st.conv_li} of the channel pair {pair} runs as "
                f"{st.kind}:{st.fold}; a sharded stage must be an unfolded "
                "xla, gemm or auto stage")
    engine._plan_params = prepare_plan_params(
        engine.model, engine._local_params, engine._plan)


def _make_local_forward(engine, pair: Optional[Tuple[int, int]],
                        mesh: Mesh):
    """This rank's forward for the engine's mode and plan: x (its rows,
    already divided by 255 where the plan does not ingest uint8) -> its
    heads."""
    from dnn_inference_engine_tpu_torch.runtime.plan import (
        plan_forward_w8, plan_forward_w8a8)
    model, cfg = engine.model, engine.config
    group = mesh.model_group
    if engine._plan is not None:
        if cfg.mode == "w8":
            return lambda x: plan_forward_w8(model, engine._plan,
                                             engine._plan_params, x)
        return lambda x: plan_forward_w8a8(
            model, engine._plan, engine._plan_params, engine.act_scales, x,
            pair=pair, group=group)
    if cfg.mode == "w8a8":
        fwd = make_local_w8a8_forward(model, engine.act_scales, pair,
                                      cfg.kernel, group)
        return lambda x: fwd(engine._local_params, x)
    # fp32 and w8: replicated weights only (_validated_pair), the generic
    # forward on this rank's rows
    return lambda x: model.forward(engine._local_params, x, mode=cfg.mode,
                                   act_scales=engine.act_scales,
                                   kernel=cfg.kernel)


def _validated_pair(engine) -> Optional[Tuple[int, int]]:
    """The channel pair of the engine's policy (None: replicated)."""
    policy = engine.config.sharding
    if policy == "replicated":
        return None
    if policy != "channel":
        raise ValueError(f"unknown sharding policy {policy!r}; have "
                         "replicated, channel")
    if engine.config.mode != "w8a8":
        raise ValueError(
            "sharding='channel' requires mode='w8a8' (the int32-sum "
            "row-parallel conv); use sharding='replicated' for "
            f"mode={engine.config.mode!r}")
    pair = channel_shard_pair(engine.model)
    if pair is None:
        raise ValueError(f"{engine.model.name} has no shardable conv pair; "
                         "use sharding='replicated'")
    return pair


def make_sharded_forward_fn(engine, mesh: Mesh):
    """This rank's rows (uint8 or f32, on its device) -> their heads, the
    pair's conv summed over ``mesh``'s model group."""
    local_fwd = _make_local_forward(engine, _validated_pair(engine), mesh)
    return lambda x: local_fwd(engine._input(x))


def make_sharded_detect_fn(engine, mesh: Mesh):
    """This rank's rows -> their (boxes, scores, classes): the sharded
    forward, then the decode and the NMS on these rows."""
    fwd = make_sharded_forward_fn(engine, mesh)
    return lambda x: engine.postprocess(fwd(x))
