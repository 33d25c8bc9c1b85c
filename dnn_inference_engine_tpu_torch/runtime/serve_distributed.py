"""Continuous batching across the ranks of a mesh, in lockstep.

Counterpart of ``dnn_inference_engine_tpu/runtime/serve_distributed.py``
(BASELINE config 5: channel-sharded continuous-batching serving across
hosts), on ``torch.distributed``: one server process a rank. Every rank
joins every collective of the sharded detect, so the batching loop is
lockstep:

- rank 0 (the LEADER) owns the request queue and the HTTP surface
  (``ContinuousBatcher``'s). Ingestion is leader-only by design: one
  process orders the requests and assembles the batches, and the
  followers are compute mirrors;
- each step the leader sends every follower only that follower's rows of
  the batch (its data index's, ``_proc_rows``), plus a small header a
  follower a step, over the process group's key-value store (the
  ``TCPStore`` that rank 0 serves): O(batch / dp) bytes a follower a
  step;
- every rank puts its rows on its device (``_place_local``) and runs the
  sharded detect (``Engine.detect_fn``); ``_replicator`` gathers the rows
  over the data group, so the leader answers for every row;
- FOLLOWERS run ``follower_loop``: wait for the next header, mirror the
  step, loop. If no header comes within ``leader_timeout_s``, or the
  store fails (it lives in the leader's process), the loop returns
  instead of waiting forever on a dead leader. The leader sends keepalive
  headers while idle, so a quiet service is told from a dead one.

Store hygiene and failure contract:

- every key lives under ``sdb/r{run}/``; ``run`` is allocated atomically
  (the store's ``add``) a ``DistributedBatcher``, so a restarted batcher
  on the same process group never meets its predecessor's keys. The
  leader publishes the id at ``sdb/current_run``; followers attach to
  it;
- every key of a step has one reader, which deletes it: a payload's
  chunks and their count by its follower, and the headers are written a
  follower each (``h/p{p}/{step}``), so each follower deletes its own. A
  long-running service holds O(1) live keys; the only residue is one
  ``done`` tombstone a run;
- a follower that exits abnormally (header timeout, missing payload,
  compute failure) writes ``dead/p{p}`` where it still can; the leader
  checks these (``check``, no wait) before every data step and refuses
  to start a collective that would wait forever for a missing rank. Any
  leader-side failure after the headers of a step are out is FATAL: the
  loop fails the batch's futures, sends the shutdown headers and stops,
  since going on after a desync could pair collectives of different
  steps and return wrong rows. (A rank dying inside a collective is the
  one case this protocol cannot catch: the process group's timeout ends
  the others' wait.)

A blocking read with a timeout is the store's ``wait`` then ``get``;
deletion is ``delete_key``.
"""

from __future__ import annotations

import datetime
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dnn_inference_engine_tpu_torch.parallel.mesh import (
    Mesh, gather_rows, input_rows)
from dnn_inference_engine_tpu_torch.runtime.serve import ContinuousBatcher

_CHUNK = 2 << 20        # bytes a store value

#: step-header flags
_H_DATA, _H_KEEPALIVE, _H_SHUTDOWN = 1, 2, 0


def _kv_store():
    """The default process group's key-value store."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.mesh.init_distributed first")
    from torch.distributed import distributed_c10d
    return distributed_c10d._get_default_store()


def _ms(timeout_ms: int) -> datetime.timedelta:
    return datetime.timedelta(milliseconds=timeout_ms)


class _KVWire:
    """Chunked bytes and the lockstep's control keys over the process
    group's store, under the run's namespace."""

    def __init__(self, run: int = 0):
        self._s = _kv_store()
        self.run = run

    # -- run handshake -------------------------------------------------

    @classmethod
    def alloc_run(cls) -> "_KVWire":
        """Leader: a fresh run id, published for the followers."""
        s = _kv_store()
        run = int(s.add("sdb/runid", 1))
        s.set("sdb/current_run", str(run))
        return cls(run)

    @classmethod
    def attach_run(cls, timeout_ms: int) -> Optional["_KVWire"]:
        """Follower: the published run; None when no leader publishes
        one within the timeout, or its run already ended."""
        s = _kv_store()
        try:
            s.wait(["sdb/current_run"], _ms(timeout_ms))
            run = int(s.get("sdb/current_run"))
        except Exception:   # noqa: BLE001 — timeout or the store is gone
            return None
        wire = cls(run)
        return None if wire.is_done() else wire

    def _k(self, suffix: str) -> str:
        return f"sdb/r{self.run}/{suffix}"

    def _get(self, key: str, timeout_ms: int) -> bytes:
        self._s.wait([key], _ms(timeout_ms))
        return self._s.get(key)

    def _delete(self, key: str) -> None:
        try:
            self._s.delete_key(key)
        except Exception:  # noqa: BLE001 — the store may be gone
            pass

    # -- payloads (their reader deletes every key) ---------------------

    def send(self, key: str, payload: bytes) -> None:
        n = max(1, -(-len(payload) // _CHUNK))
        for i in range(n):
            self._s.set(f"{key}/c{i}", payload[i * _CHUNK:(i + 1) * _CHUNK])
        self._s.set(f"{key}/n", str(n))

    def recv(self, key: str, timeout_ms: int) -> Optional[bytes]:
        """The payload, or None on a timeout or a dead store."""
        try:
            n = int(self._get(f"{key}/n", timeout_ms))
            parts = [self._get(f"{key}/c{i}", timeout_ms) for i in range(n)]
        except Exception:     # noqa: BLE001 — timeout or the store is gone
            return None
        for k in [f"{key}/c{i}" for i in range(n)] + [f"{key}/n"]:
            self._delete(k)
        return b"".join(parts)

    def rows_key(self, step: int, p: int) -> str:
        return self._k(f"d/{step}/p{p}")

    # -- a header a follower a step ------------------------------------

    def set_header(self, step: int, p: int, flag: int) -> None:
        self._s.set(self._k(f"h/p{p}/{step}"), str(flag))

    def get_header(self, step: int, p: int,
                   timeout_ms: int) -> Optional[int]:
        """Read and delete this follower's header of ``step`` (its own
        key: deleting it races no other rank); None on a timeout or a
        dead store."""
        key = self._k(f"h/p{p}/{step}")
        try:
            flag = int(self._get(key, timeout_ms))
        except Exception:     # noqa: BLE001 — timeout or the store is gone
            return None
        self._delete(key)
        return flag

    # -- failures ------------------------------------------------------

    def mark_dead(self, p: int, reason: str) -> None:
        """Follower: record an abnormal exit, so that the leader starts no
        collective this rank will not join. Where the store still
        answers."""
        try:
            self._s.set(self._k(f"dead/p{p}"), reason)
        except Exception:     # noqa: BLE001
            pass

    def dead_followers(self, n_procs: int) -> Dict[int, str]:
        out: Dict[int, str] = {}
        for p in range(1, n_procs):
            key = self._k(f"dead/p{p}")
            if self._s.check([key]):
                out[p] = self._s.get(key).decode()
        return out

    # -- the run's tombstone -------------------------------------------

    def mark_done(self) -> None:
        try:
            self._s.set(self._k("done"), "1")
        except Exception:     # noqa: BLE001
            pass

    def is_done(self) -> bool:
        try:
            return bool(self._s.check([self._k("done")]))
        except Exception:     # noqa: BLE001
            return False


def _proc_rows(mesh, batch: int) -> Dict[int, Tuple[int, int]]:
    """rank -> the [lo, hi) rows of a ``batch``-row batch it computes:
    its data index's share (the ranks of one model group share rows)."""
    return {r: input_rows(Mesh(mesh.shape, r), batch)
            for r in range(mesh.dp * mesh.mp)}


def _replicator(engine):
    """The detect outputs of this rank's rows -> the whole batch's, on
    every rank: an all_gather over the data group (identity without a
    mesh). The leader must answer for rows other ranks computed."""
    return lambda out: gather_rows(out, engine.mesh)


def _place_local(engine, x_local: np.ndarray, batch: int) -> torch.Tensor:
    """This rank's rows of the ``batch``-row step, on its device."""
    rows = _proc_rows(engine.mesh, batch)[engine.mesh.rank]
    size = engine.config.input_size
    want = (rows[1] - rows[0], size, size, 3)
    if x_local.shape != want:
        raise ValueError(f"rank {engine.mesh.rank}: rows "
                         f"{x_local.shape} where the step gives {want}")
    return torch.as_tensor(x_local).to(engine.device)


class _FollowerDead(RuntimeError):
    """A follower recorded an abnormal exit; the sharded detect would wait
    forever in its collectives."""


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DistributedBatcher(ContinuousBatcher):
    """The leader's batcher: a ContinuousBatcher whose device step runs in
    lockstep with the follower ranks (scatter, then the mirrored sharded
    detect). One process degrades to the plain batcher's step."""

    #: seconds of queue silence between keepalive headers
    keepalive_s = 5.0

    def __init__(self, engine, max_batch: Optional[int] = None,
                 timeout_ms: Optional[float] = None):
        super().__init__(engine, max_batch=max_batch, timeout_ms=timeout_ms)
        rank, self._nproc = _world()
        if rank != 0:
            raise RuntimeError("DistributedBatcher runs on the leader (rank "
                               "0); the other ranks run follower_loop()")
        self._rep = _replicator(engine)
        self._step_no = 0
        self._fatal: Optional[BaseException] = None
        self._wire_closed = False
        if self._nproc > 1:
            if engine.mesh is None:
                raise ValueError("several ranks need the engine's mesh "
                                 "(EngineConfig.mesh_shape)")
            self._wire = _KVWire.alloc_run()
            self._rows = _proc_rows(engine.mesh, self.max_batch)

    def submit(self, image: np.ndarray):
        """As ``ContinuousBatcher.submit``; raises once the loop has stopped
        on a lockstep failure. A request that passes that check while the
        loop goes fatal may be queued after the loop's last drain
        (``_fail_queued``), with no loop left to take it: so the queue is
        drained again after the put whenever the loop has gone fatal by
        then, and every future handed out resolves."""
        if self._fatal is not None:
            raise RuntimeError(
                "distributed serving loop stopped after a lockstep "
                f"failure: {self._fatal!r}")
        fut = super().submit(image)
        if self._fatal is not None:
            self._fail_queued(self._fatal)
        return fut

    def _step(self, x: np.ndarray):
        """Send the followers their rows, run the sharded detect on this
        rank's, gather: (boxes, scores, classes) of every row, tensors.

        All fallible local work (placing the rows, the dead-follower
        check) comes before the step's headers. With several ranks the
        caller treats every failure of a step as fatal, before the
        headers or after them: a failure after them desyncs the lockstep,
        and one before them (a follower recorded dead) ends the run."""
        if self._nproc == 1:
            return self._rep(self.engine.detect_device(x))
        s = self._step_no
        lo, hi = self._rows[0]
        xl = _place_local(self.engine, x[lo:hi], self.max_batch)
        dead = self._wire.dead_followers(self._nproc)
        if dead:
            raise _FollowerDead(f"follower(s) recorded abnormal exit: {dead}")
        for p, (plo, phi) in self._rows.items():
            if p != 0:
                self._wire.send(self._wire.rows_key(s, p),
                                x[plo:phi].tobytes())
        for p in range(1, self._nproc):
            self._wire.set_header(s, p, _H_DATA)
        self._step_no += 1
        return self._rep(self.engine.detect_fn()(xl))

    # lockstep steps cannot overlap (the scatter is a sync point), so the
    # loop resolves each step before the next; while the queue is idle it
    # sends keepalive headers, so followers tell a quiet leader from a
    # dead one
    def _loop(self):
        last_activity = time.perf_counter()
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                now = time.perf_counter()
                if (self._nproc > 1
                        and now - last_activity >= self.keepalive_s):
                    for p in range(1, self._nproc):
                        self._wire.set_header(self._step_no, p, _H_KEEPALIVE)
                    self._step_no += 1
                    last_activity = now
                continue
            last_activity = time.perf_counter()
            try:
                res = self._step(self._wire_batch(batch))
            except Exception as e:             # noqa: BLE001 — to futures
                for _img, fut, _t in batch:
                    fut.set_exception(e)
                if self._nproc > 1:
                    # a dead follower, or a failure after the headers: the
                    # lockstep is (or would be) out of step, and going on
                    # could pair collectives of different steps; stop and
                    # tell the followers to exit
                    self._fatal = e
                    self._fail_queued(e)
                    self._close_wire()
                    return
                continue
            self._resolve((batch, res))

    def _fail_queued(self, exc: BaseException) -> None:
        """Fail every request still queued, so that no caller waits."""
        import queue as _q
        while True:
            try:
                _img, fut, _t = self.q.get_nowait()
            except _q.Empty:
                return
            fut.set_exception(exc)

    def _close_wire(self) -> None:
        """The shutdown header for every follower and the run's tombstone
        (once)."""
        if self._nproc <= 1 or self._wire_closed:
            return
        self._wire_closed = True
        for p in range(1, self._nproc):
            self._wire.set_header(self._step_no, p, _H_SHUTDOWN)
        self._step_no += 1
        self._wire.mark_done()

    def stop(self):
        """Stop the loop, then send the shutdown headers, so that the
        followers' waits end and their loops return. The loop is joined
        without a timeout: a shutdown header written while a step is under
        way would race its step numbers, and every wait in the loop has a
        timeout of its own."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._close_wire()


def follower_loop(engine, max_batch: Optional[int] = None,
                  leader_timeout_s: float = 60.0) -> int:
    """A follower rank's serving loop: mirror every step of the leader
    until its shutdown header. Returns the number of batches served.

    Returns (cleanly) when no header comes within ``leader_timeout_s`` or
    the store fails: both mean the leader is gone. The leader's idle
    keepalives come every ``keepalive_s`` (5 s), so a timeout well above
    that trips on no quiet leader. On every abnormal exit the follower
    records itself dead where it can (``mark_dead``), so that a leader
    still alive starts no collective this rank will not join."""
    rank, _ = _world()
    if rank == 0:
        raise RuntimeError("rank 0 (the leader) runs DistributedBatcher")
    max_batch = max_batch or engine.config.serve_max_batch
    size = engine.config.input_size
    timeout_ms = int(leader_timeout_s * 1e3)
    wire = _KVWire.attach_run(timeout_ms)
    if wire is None:
        return 0                     # no leader published a live run
    lo, hi = _proc_rows(engine.mesh, max_batch)[rank]
    rep = _replicator(engine)
    served = 0
    step = 0
    while True:
        flag = wire.get_header(step, rank, timeout_ms)
        if flag is None:             # the leader is gone, or silent
            wire.mark_dead(rank, f"header-timeout@step{step}")
            return served
        if flag == _H_SHUTDOWN:
            return served
        if flag == _H_KEEPALIVE:
            step += 1
            continue
        payload = wire.recv(wire.rows_key(step, rank), timeout_ms)
        step += 1
        if payload is None:
            wire.mark_dead(rank, f"payload-timeout@step{step - 1}")
            return served
        x_local = np.frombuffer(bytearray(payload), np.uint8).reshape(
            hi - lo, size, size, 3)
        try:
            xl = _place_local(engine, x_local, max_batch)
            rep(engine.detect_fn()(xl))
            if engine.device.type == "cuda":
                torch.cuda.synchronize(engine.device)
        except Exception:
            # the leader is in (or about to enter) this step's
            # collectives; the mark stops it from starting another
            wire.mark_dead(rank, f"compute-failure@step{step - 1}")
            raise
        served += 1
