"""The (data, model) mesh of ranks, on ``torch.distributed``.

Counterpart of ``dnn_inference_engine_tpu/parallel/mesh.py``. JAX drives
a ``Mesh(('data', 'model'))`` of devices from one controller; PyTorch has
no single-controller SPMD, so the port runs one rank (process) per
device, and the mesh is a layout of ranks:

- the mesh ``(dp, mp)`` spans ``dp * mp`` ranks in row-major order, as
  JAX's device grid: rank ``r`` holds data index ``r // mp`` and model
  index ``r % mp``;
- a *model group* is the ranks that share a data index: the channel
  pair's row-parallel conv sums its int32 accumulator over it
  (``all_reduce_sum``);
- a *data group* is the ranks that share a model index: each rank
  computes its own rows of the batch, and the outputs are gathered over
  it (``gather_rows``), so that every rank holds the whole batch, as
  JAX's replicated output gives its caller.

``init_distributed`` brings up the process group. gloo's collectives run
on host memory, so a CUDA tensor crosses a gloo group through a host copy
(``_wire``); NCCL reads the card's memory.

The JAX module's ``apply_overlap_flags`` (with
``shard_map_forward.async_collective_flags``) appends libtpu's XLA flags
for overlapping collectives with compute. They have no meaning on CUDA
and are not ported.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """This rank's place in a ``(dp, mp)`` mesh: ``rank`` and the process
    groups of its model and data groups (None where the group is this
    rank alone)."""
    shape: Tuple[int, int]
    rank: int = 0
    model_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def dp(self) -> int:
        return self.shape[0]

    @property
    def mp(self) -> int:
        return self.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.mp

    @property
    def model_index(self) -> int:
        return self.rank % self.mp


def make_mesh(shape: Tuple[int, int] = (1, 1)) -> Mesh:
    """This rank's mesh over the default process group, which must hold
    exactly ``dp * mp`` ranks. ``new_group`` is collective over every
    rank, so every rank creates every model group and every data group,
    in one order, the groups it is not in too: a rank that skipped one
    would hang the others. A (1, 1) mesh needs no process group."""
    dp, mp = (int(v) for v in shape)
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh {tuple(shape)}: both axes must be >= 1")
    n = dp * mp
    if n == 1:
        return Mesh((1, 1))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"mesh {(dp, mp)} spans {n} ranks and no process group is "
            "initialized: call dnn_inference_engine_tpu_torch.parallel."
            "mesh.init_distributed(...) in every rank first, or start the "
            "ranks with torchrun")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {(dp, mp)} needs {n} ranks; the process "
                         f"group has {world}")
    rank = dist.get_rank()
    mesh = Mesh((dp, mp), rank)
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)]) if mp > 1 \
            else None
        if d == mesh.data_index:
            mesh.model_group = g
    for m in range(mp):
        g = dist.new_group([d * mp + m for d in range(dp)]) if dp > 1 \
            else None
        if m == mesh.model_index:
            mesh.data_group = g
    return mesh


def input_rows(mesh: Mesh, batch: int) -> Tuple[int, int]:
    """[lo, hi): the rows of a ``batch``-row global batch that this rank
    computes, its data index's contiguous share."""
    if batch % mesh.dp:
        raise ValueError(f"batch {batch} is not divisible by the data-axis "
                         f"size {mesh.dp}")
    per = batch // mesh.dp
    return mesh.data_index * per, (mesh.data_index + 1) * per


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor the group's backend reads: gloo's collectives run on
    host memory, so a CUDA tensor goes through a host copy there."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t.contiguous()


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (``t`` itself where the group is
    None: this rank alone), on ``t``'s device. Integer sums are exact in
    any order."""
    if group is None:
        return t
    w = _wire(t, group)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return w.to(t.device)


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    w = _wire(t, group)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts).to(t.device)


def gather_rows(out, mesh: Optional[Mesh]):
    """Each rank's rows (a tensor, or a tuple of them) concatenated along
    the batch axis over the data group, in data-index order: the whole
    batch, on every rank."""
    if mesh is None or mesh.data_group is None:
        return out
    if isinstance(out, tuple):
        return tuple(_gather(t, mesh.data_group) for t in out)
    return _gather(out, mesh.data_group)


def broadcast_floats(values: Sequence[float], device) -> list:
    """Rank 0's ``values`` on every rank of the default group, bit for
    bit (float64 carries a float32 or a Python float exactly)."""
    dev = torch.device(device)
    on_host = dist.get_backend() == "gloo"
    t = torch.tensor(list(values), dtype=torch.float64,
                     device="cpu" if on_host else dev)
    dist.broadcast(t, src=0)
    return t.cpu().tolist()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def default_backend(ranks_here: int) -> str:
    """The backend of the stated rule: NCCL when every rank on this host
    has a card of its own, gloo (for CPU tensors) when there is no card.
    More ranks than cards raise: gloo, which runs CUDA tensors through
    host copies, must then be asked for by name."""
    if not torch.cuda.is_available():
        return "gloo"
    cards = torch.cuda.device_count()
    if ranks_here <= cards:
        return "nccl"
    raise ValueError(
        f"{ranks_here} ranks on this host share {cards} card(s): NCCL "
        "refuses two ranks on one device; pass backend='gloo' (the CLI's "
        "--backend gloo) to run them over gloo")


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = 1800.0) -> bool:
    """Bring up the default process group, with JAX's arguments:
    ``coordinator`` "host:port" (rank 0 serves the group's TCPStore
    there), ``num_processes`` and ``process_id``. Where they are absent,
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). A coordinator with a scheme
    ("file:///path", "tcp://host:port") is the init method itself.
    ``backend``: "nccl" or "gloo", else ``default_backend`` for the ranks
    on this host (``LOCAL_WORLD_SIZE``,
    else all of them). Returns True when a group of more than one rank is
    up (or already was), False for a single process, where there is
    nothing to do."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    n = num_processes if num_processes is not None \
        else _env_int("WORLD_SIZE")
    if n is None or n <= 1:
        return False
    rank = process_id if process_id is not None else _env_int("RANK")
    if rank is None:
        raise ValueError("init_distributed: give process_id (or RANK)")
    if coordinator is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if not (addr and port):
            raise ValueError("init_distributed: give coordinator "
                             "'host:port' (or MASTER_ADDR and MASTER_PORT)")
        coordinator = f"{addr}:{port}"
    if backend is None:
        backend = default_backend(_env_int("LOCAL_WORLD_SIZE") or n)
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(
        backend=backend, init_method=coordinator,
        world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True
