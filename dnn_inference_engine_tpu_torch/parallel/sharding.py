"""Sharding policies: replicated or channel-sharded weights, batch-sharded
activations.

Counterpart of ``dnn_inference_engine_tpu/parallel/sharding.py``. Policy
``channel`` splits the heaviest consecutive conv pair over the mesh's
``model`` axis (YOLOv2-tiny's layers 12 and 13):

- the first conv of the pair is Cout-sharded (column-parallel: HWIO
  weight axis 3, per-channel ``s_w`` and ``b`` axis 0); its output slice
  stays local, and it is exactly the second conv's Cin shard;
- the second is Cin-sharded (row-parallel: weight axis 2), and its
  partial int32 sums are added over the model group before the epilogue
  (parallel/shard_map_forward.py).

Activations are batch-sharded over ``data`` in every policy: each rank
computes its data index's rows (``input_sharding``). Where JAX's specs
place every leaf with a ``NamedSharding``, the port's ``param_specs``
name the axis split over ``model`` and ``shard_params`` slices out this
rank's piece.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dnn_inference_engine_tpu_torch.models.layers import (
    MaxPool, Upsample)
from dnn_inference_engine_tpu_torch.parallel.mesh import (
    Mesh, gather_rows, input_rows)
# the JAX module's _conv_flops and _out_of_sequence_refs, kept once, in
# the plan
from dnn_inference_engine_tpu_torch.runtime.plan import (  # noqa: F401
    _conv_flops, _referenced_layers as _out_of_sequence_refs)


def channel_shard_pair(model) -> Optional[Tuple[int, int]]:
    """The (Cout-shard, Cin-shard) conv pair: consecutive convs (only
    pools and upsamples between them, so the channels pass unchanged)
    with the most MACs together, where nothing reads the first conv's
    output (or an in-between layer's) out of sequence: that tensor is a
    channel slice on each rank. The second conv's output is summed, whole
    on every rank, and safe to read."""
    flops = _conv_flops(model)
    refs = _out_of_sequence_refs(model)
    conv_ids = sorted(flops)
    best, best_val = None, 0.0
    for a, b in zip(conv_ids, conv_ids[1:]):
        between = model.layers[a + 1:b]
        if any(not isinstance(l, (MaxPool, Upsample)) for l in between):
            continue
        if any(li in refs for li in range(a, b)):
            continue
        val = flops[a] + flops[b]
        if val > best_val:
            best, best_val = (a, b), val
    return best


# the param leaves a conv layer holds, by form (fp32 "w", quantized "wq")
_COLUMN = {"w": 3, "wq": 3, "s_w": 0, "b": 0}
_ROW = {"w": 2, "wq": 2}


def param_specs(model, policy: str = "replicated") -> List[Dict[str, int]]:
    """Per layer, {param name: the axis split over ``model``}; a name that
    is absent is replicated (the row-parallel conv's ``s_w`` and ``b``
    too: the epilogue runs once on the summed accumulator)."""
    pair = channel_shard_pair(model) if policy == "channel" else None
    specs: List[Dict[str, int]] = []
    for li in range(len(model.layers)):
        if pair and li == pair[0]:
            specs.append(dict(_COLUMN))
        elif pair and li == pair[1]:
            specs.append(dict(_ROW))
        else:
            specs.append({})
    return specs


def _piece(v: torch.Tensor, axis: int, index: int, parts: int):
    n = v.shape[axis]
    if n % parts:
        raise ValueError(f"axis {axis} of {tuple(v.shape)} does not split "
                         f"into {parts} equal parts")
    step = n // parts
    # a copy of its own: the kernels' weight layouts cached on it (the
    # K-major matrix, the pool-major tiles) are then the shard's
    return v.narrow(axis, index * step, step).contiguous().clone()


def shard_params(params: Sequence[Dict], mesh: Mesh, model,
                 policy: str = "replicated") -> List[Dict]:
    """This rank's params: each leaf that ``param_specs`` splits, the
    ``mesh.model_index``-th of ``mesh.mp`` equal slices along its axis;
    the rest as they are (the same tensors)."""
    specs = param_specs(model, policy)
    out = []
    for p, spec in zip(params, specs):
        out.append({k: (_piece(v, spec[k], mesh.model_index, mesh.mp)
                        if k in spec and mesh.mp > 1 else v)
                    for k, v in p.items()})
    return out


def input_sharding(mesh: Mesh, batch: int) -> slice:
    """The rows of a ``batch``-row NHWC batch that this rank computes (its
    data index's share; a batch ``dp`` does not divide raises)."""
    return slice(*input_rows(mesh, batch))


def make_sharded_forward(model, mesh: Mesh, mode: str = "w8a8",
                         act_scales=None):
    """The pure data-parallel tier: ``fwd(params, x)`` runs the generic
    forward (the xla tier) on this rank's rows ``x`` with replicated
    params and returns the whole batch's output on every rank (gathered
    over the data group). Exact: nothing is summed across ranks. Channel
    sharding is ``shard_map_forward.make_shardmap_forward``'s."""
    def fwd(params, x):
        with torch.no_grad():
            y = model.forward(params, x, mode=mode, act_scales=act_scales,
                              kernel="xla")
        return gather_rows(y, mesh)
    return fwd
