"""The port's lockstep serving across ranks (runtime/serve_distributed.py)
on the CPU: gloo ranks of ``_torch_dist_worker.py`` at 64 px, YOLOv2-tiny
W8A8 under its pin, channel-sharded.

- one process: ``DistributedBatcher`` is the plain batcher's step, and
  the store's key hygiene (run ids, reader-owned keys deleted, the done
  tombstone, dead markers) holds on a one-rank group;
- 2 ranks ((1, 2)) and 4 ranks ((2, 2)): every served row (10 submits
  and one ``POST /detect``) equals a single-device detect, each follower
  receives only its own rows, and after ``stop`` every rank exits 0;
- a follower that times out marks itself dead: the leader's next step
  fails fast, and later submits raise;
- a leader that stops without the shutdown headers: every follower
  returns on its header timeout (2 and 4 ranks);
- a submit that passes the fatal check before the loop's step fails and
  puts its request after the loop's last drain still gets a future that
  resolves with the step's exception (ROADMAP C8).
Every spawn has a timeout of its own. The module runs on one thread
(ROADMAP C5); each rank does too.
"""

import socket

import numpy as np
import pytest
import threadpoolctl
import torch

import _torch_dist as td

pytestmark = pytest.mark.subproc


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(torch_threads)


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_distributed")
    td.write_inputs(str(d), models=("yolov2-tiny",))
    return str(d)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_single_process_degenerates_to_the_plain_batcher(d):
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    from dnn_inference_engine_tpu_torch.runtime.serve_distributed import (
        DistributedBatcher)
    kw = dict(model="yolov2-tiny", mode="w8a8", batch=4, input_size=64,
              score_thresh=0.02, serve_max_batch=4)
    eng = Engine(EngineConfig(**kw), device="cpu").load_weights(
        f"{d}/yolov2-tiny.npz").prepare()
    imgs = np.load(f"{d}/images.npy")
    b = DistributedBatcher(eng, timeout_ms=50).start()
    try:
        got = [f.result(timeout=120) for f in [b.submit(i) for i in imgs]]
    finally:
        b.stop()
    want = eng.detect(imgs)
    for i, row in enumerate(got):
        for g, w in zip(row, want):
            np.testing.assert_array_equal(g, w[i])
    assert b.stats()["images"] == len(imgs)


def test_store_key_hygiene_on_one_rank(tmp_path):
    """On a one-rank gloo group: run ids count up, a payload's chunks and
    its count are deleted by the read, a header too, a missing key times
    out as None, dead markers and the tombstone are seen."""
    import torch.distributed as dist
    from dnn_inference_engine_tpu_torch.runtime import serve_distributed as sd
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        w1, w2 = sd._KVWire.alloc_run(), sd._KVWire.alloc_run()
        assert w2.run == w1.run + 1
        assert sd._KVWire.attach_run(1000).run == w2.run
        payload = bytes(range(256)) * 40000          # past one chunk
        w2.send(w2.rows_key(0, 1), payload)
        assert w2.recv(w2.rows_key(0, 1), 1000) == payload
        store = sd._kv_store()
        assert not store.check([w2.rows_key(0, 1) + "/n",
                                w2.rows_key(0, 1) + "/c0"])
        w2.set_header(3, 1, sd._H_DATA)
        assert w2.get_header(3, 1, 1000) == sd._H_DATA
        assert w2.get_header(3, 1, 200) is None        # deleted, times out
        assert w2.recv(w2.rows_key(9, 1), 200) is None
        assert w2.dead_followers(3) == {}
        w2.mark_dead(2, "header-timeout@step0")
        assert w2.dead_followers(3) == {2: "header-timeout@step0"}
        assert not w2.is_done()
        w2.mark_done()
        assert w2.is_done() and sd._KVWire.attach_run(1000) is None
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_lockstep_serving_equals_single_device(d, world):
    outs = td.spawn("serve", world, d, timeout=240,
                    init=f"127.0.0.1:{_free_port()}")
    td.check_ranks(outs, "serve")


def test_follower_death_fails_the_leader_fast(d):
    outs = td.spawn("fdead", 2, d, timeout=180)
    td.check_ranks(outs, "fdead")


@pytest.mark.parametrize("world", [2, 4])
def test_leader_crash_every_follower_exits_cleanly(d, world):
    outs = td.spawn("crash", world, d, timeout=180)
    td.check_ranks(outs, "crash", rcs=[42] + [0] * (world - 1))


def test_submit_racing_the_fatal_step_resolves(d):
    """The order submit's fatal check, the loop's fatal step and its drain,
    then submit's put (forced on two ranks by a put that waits for the
    drain): the late request's future resolves with the step's exception
    within seconds instead of waiting for ever."""
    outs = td.spawn("race", 2, d, timeout=180)
    td.check_ranks(outs, "race")
