"""One rank of the port's multi-rank CPU tests (gloo, 64 px).

    python _torch_dist_worker.py <mode> <rank> <world> <init> <dir> [mesh]

``init`` is the process group's init method (``file://...`` in the
test's tmp_path, or ``host:port``), ``dir`` the test's directory, which
holds the weight checkpoints (``{model}.npz``) and ``images.npy``.

Modes:
  engine  every ENGINE_CASES case on ``mesh`` (DP,MP): the Engine's
          detect and classify of the global batch, saved by each rank to
          ``{dir}/engine_{DP}x{MP}_{case}_r{rank}.npz``; then a batch
          that DP does not divide must raise
  forward make_shardmap_forward of the FORWARD_CASES on ``mesh``, from
          the checkpoints' params, saved as ``forward_..._r{rank}.npz``
  serve   DistributedBatcher on rank 0, follower_loop on the others, a
          (world/2, 2) channel mesh ((1, 2) for two ranks): the leader
          holds every result to a single-device detect; each follower
          only ever receives its own rows
  crash   the leader stops its loop without the shutdown headers after
          serving and goes quiet; every follower must return on its
          header timeout
  fdead   a follower times out (no keepalives) and marks itself dead;
          the leader's next submit must fail fast, and later submits
          raise
  timing  profiling on ``mesh`` (ROADMAP A15): ``stage_times`` and
          ``layer_times`` at fixed counts (4, 2) beside a single-device
          engine's rows; on a mesh with MP > 1 also the auto-scaled
          ``stage_times`` with rank 1's clock made slower, a trace lost on
          rank 1 alone (``_retaking``), and ``cli layer-times --mesh``
          last (the CLI takes the process group down); the rank's results
          in ``{dir}/timing_{DP}x{MP}_r{rank}.json``
  sweep   ``cli plan-sweep --mesh 1,2``, each rank with its own ``--out``
          (``{dir}/sweep_r{rank}.json``): only rank 0 may write
Prints ``RANK_OK <mode> <rank>`` on success.
"""

import os
import sys
import time

import numpy as np
import torch

# (case, model, kernel, sharding on a mesh with MP > 1)
ENGINE_CASES = [("v2_pin", "yolov2-tiny", "auto", "channel"),
                ("v2_xla", "yolov2-tiny", "xla", "channel"),
                ("v2_pallas", "yolov2-tiny", "pallas", "channel"),
                ("v3_pin", "yolov3-tiny", "auto", "channel"),
                ("r18_pin", "resnet18", "auto", "channel")]
FORWARD_CASES = [("v2_xla", "yolov2-tiny", "xla"),
                 ("v3_auto", "yolov3-tiny", "auto"),
                 ("r18_xla", "resnet18", "xla")]
SIZE, BATCH = 64, 4


def config(model, kernel, **kw):
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    return EngineConfig(model=model, mode="w8a8", kernel=kernel,
                        batch=BATCH, input_size=SIZE, score_thresh=0.02,
                        num_classes=10 if model == "resnet18" else 20, **kw)


def engine(d, model, kernel, **kw):
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    return Engine(config(model, kernel, **kw), device="cpu").load_weights(
        os.path.join(d, f"{model}.npz")).prepare()


def run_engine(rank, d, mesh):
    imgs = np.load(os.path.join(d, "images.npy"))
    tag = f"{mesh[0]}x{mesh[1]}"
    for case, model, kernel, sharding in ENGINE_CASES:
        eng = engine(d, model, kernel, mesh_shape=mesh, sharding=sharding)
        heads = eng.classify(imgs)
        heads = heads if isinstance(heads, tuple) else (heads,)
        out = {f"head{i}": h for i, h in enumerate(heads)}
        if model != "resnet18":
            out.update(zip(("boxes", "scores", "classes"), eng.detect(imgs)))
        np.savez(os.path.join(d, f"engine_{tag}_{case}_r{rank}.npz"), **out)
        if mesh[0] > 1:
            try:
                eng.classify(imgs[:BATCH - 1])
            except ValueError as e:
                assert "divisible" in str(e), e
            else:
                raise AssertionError("a batch dp does not divide ran")


def run_forward(rank, d, mesh):
    from dnn_inference_engine_tpu_torch.models import build_model
    from dnn_inference_engine_tpu_torch.models.weights import (
        load_checkpoint, params_from_numpy)
    from dnn_inference_engine_tpu_torch.parallel.mesh import make_mesh
    from dnn_inference_engine_tpu_torch.parallel.shard_map_forward import (
        make_shardmap_forward)
    from dnn_inference_engine_tpu_torch.parallel.sharding import (
        input_sharding, shard_params)
    imgs = torch.as_tensor(np.load(os.path.join(d, "images.npy"))).float()
    x = imgs / 255.0
    m = make_mesh(mesh)
    for case, name, kernel in FORWARD_CASES:
        model = build_model(name, 10 if name == "resnet18" else None)
        params, scales = params_from_numpy(
            *load_checkpoint(os.path.join(d, f"{name}.npz")), device="cpu")
        fwd = make_shardmap_forward(model, m, scales, "channel", kernel)
        heads = fwd(shard_params(params, m, model, "channel"),
                    x[input_sharding(m, BATCH)])
        heads = heads if isinstance(heads, tuple) else (heads,)
        np.savez(os.path.join(d, f"forward_{mesh[0]}x{mesh[1]}_{case}"
                              f"_r{rank}.npz"),
                 **{f"head{i}": h.numpy() for i, h in enumerate(heads)})


def http_detect(batcher, img):
    """One ``POST /detect`` of ``img`` as .npy through the leader's HTTP
    surface: the reply's (boxes, scores, classes) of the survivors. The
    image is 64 px, so the image frame is the network's."""
    import io
    import json
    import urllib.request
    srv = batcher.serve_http(port=0, host="127.0.0.1")
    try:
        buf = io.BytesIO()
        np.save(buf, img)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/detect",
            data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
    return (np.asarray(out["boxes"], np.float32).reshape(-1, 4),
            np.asarray(out["scores"], np.float32),
            np.asarray(out["classes"], np.int32))


def run_serve(mode, rank, world, d):
    from dnn_inference_engine_tpu_torch.runtime import serve_distributed as sd
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    mesh = (max(1, world // 2), 2 if world > 1 else 1)
    kw = dict(serve_max_batch=BATCH, mesh_shape=mesh, sharding="channel")
    eng = engine(d, "yolov2-tiny", "auto", **kw)
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
            for _ in range(10 if mode == "serve" else 6)]
    if rank != 0:
        # every payload this follower receives must be its rows only
        sizes = []
        recv = sd._KVWire.recv

        def spy(self, key, timeout_ms):
            p = recv(self, key, timeout_ms)
            if p is not None:
                sizes.append(len(p))
            return p
        sd._KVWire.recv = spy
        if mode == "fdead":
            served = sd.follower_loop(eng, leader_timeout_s=4.0)
            assert served == 0, served
            print(f"RANK_OK {mode} {rank}", flush=True)
            os._exit(0)          # the leader is still up: no teardown
        served = sd.follower_loop(
            eng, leader_timeout_s=8.0 if mode == "crash" else 120.0)
        rows = BATCH // mesh[0] * SIZE * SIZE * 3
        assert sizes and all(s == rows for s in sizes), (sizes, rows)
        assert served >= (1 if mode == "crash" else 3), served
        if mode == "crash":
            print(f"RANK_OK {mode} {rank} served={served}", flush=True)
            os._exit(0)          # the wedged leader never tears down
        return
    ref = Engine(config("yolov2-tiny", "auto"), device="cpu").load_weights(
        os.path.join(d, "yolov2-tiny.npz")).prepare()
    if mode == "fdead":
        b = sd.DistributedBatcher(eng)
        b.keepalive_s = 3600.0
        b.start()
        time.sleep(7.0)          # past the follower's header timeout
        err = None
        try:
            b.submit(imgs[0]).result(timeout=120)
        except Exception as e:   # noqa: BLE001
            err = e
        assert err is not None and "abnormal exit" in str(err), err
        try:
            b.submit(imgs[1])
            raise AssertionError("a submit after the fatal step ran")
        except RuntimeError as e:
            assert "lockstep failure" in str(e), e
        b.stop()
        print(f"RANK_OK {mode} {rank}", flush=True)
        os._exit(0)
    b = sd.DistributedBatcher(eng).start()
    try:
        results = [f.result(timeout=300)
                   for f in [b.submit(img) for img in imgs]]
        if mode == "serve":
            http = http_detect(b, imgs[0])
    finally:
        if mode != "crash":
            b.stop()
    for i, (img, got) in enumerate(zip(imgs, results)):
        pad = np.zeros((BATCH, SIZE, SIZE, 3), np.uint8)
        pad[0] = img
        want = ref.detect(pad)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w[0], err_msg=f"image {i}")
    if mode == "serve":
        keep = results[0][1] > 0
        assert keep.any()
        for g, w in zip(http, results[0]):
            np.testing.assert_array_equal(g, w[keep], err_msg="http")
    if mode == "crash":
        # wedge: the loop stops without the shutdown headers, the store
        # stays up, nothing more is sent
        from dnn_inference_engine_tpu_torch.runtime.serve import (
            ContinuousBatcher)
        ContinuousBatcher.stop(b)
        time.sleep(14.0)         # past the followers' header timeout
        print(f"RANK_OK {mode} {rank}", flush=True)
        os._exit(42)
    assert b.stats()["images"] == len(imgs) + (mode == "serve")


def run_timing(rank, d, mesh):
    """Returns True where the CLI took the process group down."""
    import contextlib
    import io
    import json
    from dnn_inference_engine_tpu_torch import cli
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime import benchlib, profiling
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    calib = np.random.default_rng(11).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    sharding = "channel" if mesh[1] > 1 else "replicated"
    engines = {
        tag: Engine(config("yolov2-tiny", "auto", **kw),
                    device="cpu").load_weights(seed=0).prepare(calib)
        for tag, kw in (("mesh", dict(mesh_shape=mesh, sharding=sharding)),
                        ("single", {}))}
    out = {}
    for tag, eng in engines.items():
        rows = eng.stage_times(iters=(4, 2))
        out[tag] = {"stage_names": [r["name"] for r in rows],
                    "stage_iters": [r["iters"] for r in rows],
                    "gop": [r["gop"] for r in rows],
                    "layer_names": [n for n, _ in
                                    eng.layer_times(iters=(4, 2))]}
    done = False
    if mesh[1] > 1:
        eng = engines["mesh"]
        real_loop = benchlib._loop_s
        if rank == 1:                 # a slower clock: its own counts differ
            benchlib._loop_s = lambda *a: 1000.0 * real_loop(*a)
        try:
            out["auto_iters"] = [r["iters"] for r in eng.stage_times()]
        finally:
            benchlib._loop_s = real_loop
        real_lost = profiling._lost_events
        for agree in (True, False):
            calls = []

            def lost(traced, launched):
                return ({"conv_w8a8": (0, 1)} if rank == 1 and len(calls) == 1
                        else {})

            def take():
                calls.append(1)
                return "art", {}, {}
            profiling._lost_events = lost
            try:
                profiling._retaking(take, "one run", agree_ranks=agree)
            finally:
                profiling._lost_events = real_lost
            out[f"takes_agree_{agree}"] = len(calls)
        cfg = os.path.join(d, f"config_r{rank}.json")
        EngineConfig(input_size=SIZE).to_json(cfg)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out["cli_rc"] = cli.main([
                "layer-times", "--mesh", "1,2", "--sharding", "channel",
                "--backend", "gloo", "--device", "cpu", "--mode", "w8a8",
                "--batch", "2", "--iters", "4,2", "--config", cfg,
                "--weights", os.path.join(d, "yolov2-tiny.npz")])
        out["cli_stdout"] = buf.getvalue()
        done = True
    with open(os.path.join(d, f"timing_{mesh[0]}x{mesh[1]}_r{rank}.json"),
              "w") as f:
        json.dump(out, f)
    return done


def run_sweep(rank, d):
    from dnn_inference_engine_tpu_torch import cli
    rc = cli.main(["plan-sweep", "--mesh", "1,2", "--backend", "gloo",
                   "--device", "cpu", "--mode", "w8a8", "--batch", "2",
                   "--input-size", str(SIZE), "--quick", "--iters", "2,1",
                   "--reps", "1", "--out",
                   os.path.join(d, f"sweep_r{rank}.json")])
    assert rc == 0, rc
    return True                  # the CLI took the process group down


def main():
    mode, rank, world, init, d = sys.argv[1:6]
    rank, world = int(rank), int(world)
    mesh = tuple(int(v) for v in sys.argv[6].split(",")) \
        if len(sys.argv) > 6 else None
    torch.set_num_threads(1)
    import warnings
    warnings.simplefilter("ignore")
    from dnn_inference_engine_tpu_torch.parallel.mesh import (
        init_distributed)
    init_distributed(init, world, rank, backend="gloo", timeout_s=300)
    group_down = False
    if mode == "engine":
        run_engine(rank, d, mesh)
    elif mode == "forward":
        run_forward(rank, d, mesh)
    elif mode == "timing":
        group_down = run_timing(rank, d, mesh)
    elif mode == "sweep":
        group_down = run_sweep(rank, d)
    else:
        run_serve(mode, rank, world, d)
    import torch.distributed as dist
    if not group_down:
        dist.barrier()
        dist.destroy_process_group()
    print(f"RANK_OK {mode} {rank}", flush=True)


if __name__ == "__main__":
    main()
