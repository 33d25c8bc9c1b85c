"""The channel-sharded W8A8 forward with its collectives placed by hand.

Counterpart of ``dnn_inference_engine_tpu/parallel/shard_map_forward.py``
(whose ``shard_map`` body each rank of the port runs as its own
forward). The heaviest conv pair runs column-parallel, then
row-parallel:

- the first conv has Cout-sharded weights; its output channel slice
  stays local, and it is exactly the second conv's Cin shard, so nothing
  crosses ranks between the two;
- the second conv contracts its Cin shard into an int32 accumulator
  (``conv2d_w8a8_acc``, the conv_w8a8 kernel's raw store, or on the gemm
  tier ``conv2d_int8_acc``), which is summed over the model group
  (``all_reduce`` on int32: integer addition is exact in any order), and
  the epilogue runs once on the sum (``ops/conv.conv_epilogue``, the
  function the unsharded conv's plain version ends in). So the sharded
  forward equals the single-device one bit for bit.

Activations are batch-sharded over ``data``: each rank runs its rows.
The local forward is ``Model.forward_w8a8`` with the row-parallel conv in
the pair's second layer, so it covers the whole layer vocabulary (Conv,
MaxPool, Route, Shortcut, Upsample, GlobalAvgPool, Dense) and shards
YOLOv3-tiny and ResNet-18 too: graph layers read only replicated
outputs (``channel_shard_pair`` keeps the pair out of every
out-of-sequence read), so their concatenations and sums stay local.

JAX's ``async_collective_flags`` (libtpu's XLA flags for overlapping the
psum with compute) has no CUDA meaning and is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dnn_inference_engine_tpu_torch.ops.conv import (
    conv2d_w8a8_acc, conv_epilogue)
from dnn_inference_engine_tpu_torch.ops.conv_lowering import conv2d_int8_acc
from dnn_inference_engine_tpu_torch.ops.dispatch import use_pallas
from dnn_inference_engine_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_sum, gather_rows)
from dnn_inference_engine_tpu_torch.parallel.sharding import (
    channel_shard_pair)


def row_parallel_conv_w8a8(x, p, layer_or_stage, cur_scale, s_out,
                           group=None, use_pallas_tier: bool = False,
                           force_pallas: bool = False,
                           wt: Optional[torch.Tensor] = None):
    """The Cin-sharded W8A8 conv: this rank's int32 accumulator, summed
    over ``group``, then the epilogue ``acc*(s_in*s_w) + b``, the
    activation and (with ``s_out``) the requantization, rounded in the
    order of the conv it stands for: the gemm tier's folded order where
    that tier takes the conv (``use_pallas_tier``: ``force_pallas``, or
    ``use_pallas`` on the unsharded conv's shape), else the conv order.
    ``wt``: the shard's precomputed ``gemm_weights``."""
    stride, padding = layer_or_stage.stride, layer_or_stage.padding
    kh, kw, cin, cout = p["wq"].shape
    parts = dist.get_world_size(group) if group is not None else 1
    gemm = use_pallas_tier and (force_pallas or use_pallas(
        x.shape, (kh, kw, cin * parts, cout), stride))
    acc_fn = conv2d_int8_acc if gemm else conv2d_w8a8_acc
    acc = all_reduce_sum(acc_fn(x, p["wq"], stride, padding, wt), group)
    return conv_epilogue(acc, cur_scale, p["s_w"], p["b"], layer_or_stage.act,
                         s_out, folded=gemm)


def make_local_w8a8_forward(model, act_scales: Sequence[float],
                            pair: Optional[Tuple[int, int]] = None,
                            kernel: str = "xla", group=None):
    """The per-rank W8A8 forward: ``Model.forward_w8a8`` on this rank's
    rows and params, with the pair's row-parallel conv summing its int32
    accumulator over ``group``. Returns ``local_fwd(params, x)``."""
    convs = {}
    if pair is not None:
        layer = model.layers[pair[1]]

        def rowpar(x, s_in, wq, s_w, b, act, stride, padding, s_out):
            return row_parallel_conv_w8a8(
                x, {"wq": wq, "s_w": s_w, "b": b}, layer, s_in, s_out, group,
                use_pallas_tier=kernel in ("auto", "pallas"),
                force_pallas=kernel == "pallas")
        convs[pair[1]] = rowpar

    def local_fwd(params, x):
        return model.forward_w8a8(params, act_scales, x, kernel=kernel,
                                  convs=convs)
    return local_fwd


def make_shardmap_forward(model, mesh: Mesh, act_scales: Sequence[float],
                          policy: str = "channel", kernel: str = "xla"):
    """The W8A8 forward over ``mesh`` for any layer-graph model:
    ``fwd(params, x)`` takes this rank's params (``shard_params(...,
    policy)``) and rows (``input_sharding``) and returns the whole batch's
    head, or tuple of heads, on every rank (gathered over the data
    group). Also right for ``policy="replicated"`` (nothing summed).
    ``kernel``: the conv tier, "xla", "pallas" or "auto"."""
    pair = channel_shard_pair(model) if policy == "channel" else None
    local_fwd = make_local_w8a8_forward(model, act_scales, pair, kernel,
                                        mesh.model_group)

    @torch.no_grad()
    def fwd(params, x):
        return gather_rows(local_fwd(params, x), mesh)
    return fwd
