"""Helpers of the port's multi-rank CPU tests: seeded W8A8 checkpoints at
64 px, and ranks of ``_torch_dist_worker.py`` spawned over gloo, each
with a hard timeout of its own."""

import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_dist_worker.py")
MODELS = ("yolov2-tiny", "yolov3-tiny", "resnet18")
SIZE, BATCH = 64, 4


def write_inputs(d, models=MODELS) -> None:
    """``{model}.npz``: the port's W8A8 checkpoint of seed-0 weights
    calibrated on seeded images (both packages load it), and
    ``images.npy``: the global uint8 batch."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    calib = np.random.default_rng(11).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    for m in models:
        Engine(EngineConfig(model=m, mode="w8a8", kernel="xla",
                            input_size=SIZE,
                            num_classes=10 if m == "resnet18" else 20),
               device="cpu").load_weights(seed=0).prepare(calib).save(
            os.path.join(d, f"{m}.npz"))
    np.save(os.path.join(d, "images.npy"), np.random.default_rng(12).integers(
        0, 256, (BATCH, SIZE, SIZE, 3)).astype(np.uint8))


def spawn(mode, world, d, mesh=None, timeout=240, init=None):
    """Run ``world`` ranks of the worker; [(rc, stdout, stderr)] by rank.
    The ranks are killed ``timeout`` seconds after the start and then
    show rc None.
    ``init``: the process group's init method (default: a file in
    ``d``)."""
    tag = f"{mode}_{world}" + (f"_{mesh[0]}x{mesh[1]}" if mesh else "")
    init = init or "file://" + os.path.join(d, f"pg_{tag}")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    args = [mode, None, str(world), init, str(d)]
    if mesh:
        args.append(",".join(str(v) for v in mesh))
    procs = []
    for r in range(world):
        args[1] = str(r)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER] + args, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=REPO, env=env))
    outs = []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            so, se = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, so, se))
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
            outs.append((None, so, se))
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return outs


def check_ranks(outs, mode, rcs=None) -> None:
    """Every rank ended with its rc (default 0) and said ``RANK_OK``."""
    for r, (rc, so, se) in enumerate(outs):
        want = 0 if rcs is None else rcs[r]
        assert rc == want and f"RANK_OK {mode} {r}" in so, (
            f"rank {r} rc={rc} (want {want})\nstdout:\n{so[-2000:]}\n"
            f"stderr:\n{se[-4000:]}")


def rank_file(d, kind, mesh, case, rank):
    return os.path.join(d, f"{kind}_{mesh[0]}x{mesh[1]}_{case}_r{rank}.npz")


def load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
