"""The port's continuous batcher and HTTP front against the JAX package's.

JAX's ``tests/test_serve.py`` cases run on a fake engine whose device
results are torch tensors. A real YOLOv2-tiny W8A8 engine at 64 px (the
JAX engine's weights and scales carried across) serves requests from
several threads: every future must equal, bit for bit, its image's row of
``Engine.detect`` on the same padded batch. One ``.npy`` POST must give
the JSON of JAX's ``serve_http`` on the same weights and image: classes
and names exact, boxes within 1e-3 px, scores within 1e-5 (the JAX
engine's jit rounds the f32 head once, an FMA).
"""

import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu_torch.config import EngineConfig
from dnn_inference_engine_tpu_torch.runtime.engine import Engine
from dnn_inference_engine_tpu_torch.runtime.serve import ContinuousBatcher

SIZE = 64


class FakeEngine:
    """Deterministic stand-in: the per-image mean as every 'score'."""

    def __init__(self, max_batch=4, delay=0.0):
        self.config = EngineConfig(serve_max_batch=max_batch,
                                   serve_timeout_ms=20.0, input_size=8)
        self.delay = delay
        self.batch_sizes = []

    def detect_device(self, x):
        self.batch_sizes.append(x.shape[0])
        assert x.dtype == np.uint8          # the batcher ships uint8
        if self.delay:
            time.sleep(self.delay)
        n = x.shape[0]
        xf = torch.from_numpy(x).float() / 255.0
        boxes = torch.zeros((n, 4, 4))
        scores = xf.reshape(n, -1).mean(dim=1, keepdim=True).repeat(1, 4)
        return boxes, scores, torch.zeros((n, 4), dtype=torch.int32)


def test_single_request_roundtrip():
    b = ContinuousBatcher(FakeEngine()).start()
    try:
        img = np.full((8, 8, 3), 0.5, np.float32)
        boxes, scores, classes = b.infer(img, timeout=5)
        np.testing.assert_allclose(scores, 0.5, atol=1.0 / 255.0)
        assert isinstance(scores, np.ndarray)
    finally:
        b.stop()


def test_batch_assembly_and_routing():
    """Concurrent requests share batches, padded to max_batch; each future
    resolves to its own image's result."""
    eng = FakeEngine(max_batch=4, delay=0.01)
    b = ContinuousBatcher(eng).start()
    try:
        vals = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]
        futs = [b.submit(np.full((8, 8, 3), v, np.float32)) for v in vals]
        results = [f.result(timeout=10) for f in futs]
        for v, (_bx, sc, _cl) in zip(vals, results):
            np.testing.assert_allclose(sc, v, atol=1.0 / 255.0)
        assert all(s == 4 for s in eng.batch_sizes)
        st = b.stats()
        assert st["images"] == len(vals)
        assert st["batches"] >= 2
        assert st["avg_batch_fill"] == len(vals) / st["batches"]
    finally:
        b.stop()


def test_stats_and_error_propagation():
    eng = FakeEngine()
    b = ContinuousBatcher(eng).start()
    try:
        b.infer(np.zeros((8, 8, 3), np.float32), timeout=5)
        st = b.stats()
        assert st["images"] == 1
        assert st["p50_ms"] is not None and st["p50_ms"] >= 0

        def boom(x):
            raise RuntimeError("device fell over")
        eng.detect_device = boom
        fut = b.submit(np.zeros((8, 8, 3), np.float32))
        with pytest.raises(RuntimeError, match="device fell over"):
            fut.result(timeout=5)

        class Bad:
            def cpu(self):
                raise RuntimeError("copy back failed")
        eng.detect_device = lambda x: (Bad(), Bad(), Bad())
        with pytest.raises(RuntimeError, match="copy back failed"):
            b.infer(np.zeros((8, 8, 3), np.uint8), timeout=5)
    finally:
        b.stop()
    with pytest.raises(RuntimeError, match="already running"):
        b2 = ContinuousBatcher(eng).start()
        try:
            b2.start()
        finally:
            b2.stop()


def test_uint8_roundtrip_tolerance():
    """f32 [0,1] images survive the uint8 wire format within 1/255."""
    rng = np.random.default_rng(5)
    b = ContinuousBatcher(FakeEngine()).start()
    try:
        img = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
        _bx, sc, _cl = b.infer(img, timeout=5)
        np.testing.assert_allclose(sc, img.mean(), atol=1.0 / 255.0)
    finally:
        b.stop()


def test_many_threads_lose_no_request():
    """More client threads than cores with a short switch interval: every
    request is resolved once, to its own value, and counted once."""
    eng = FakeEngine(max_batch=8)
    b = ContinuousBatcher(eng, timeout_ms=1.0).start()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    out, errors = {}, []

    def client(t):
        try:
            for j in range(8):
                v = (t * 8 + j) % 200 + 20
                sc = b.infer(np.full((8, 8, 3), v, np.uint8), timeout=20)[1]
                out[(t, j)] = (v, float(sc[0]))
        except Exception as e:             # noqa: BLE001 — reported below
            errors.append(e)
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        b.stop()
    assert not errors and len(out) == 24 * 8
    for v, sc in out.values():
        assert abs(sc - v / 255.0) < 1e-6
    assert b.stats()["images"] == 24 * 8


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def test_http_stats_healthz_and_errors():
    b = ContinuousBatcher(FakeEngine()).start()
    srv = b.serve_http(port=0, host="127.0.0.1")
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, st = _get(base + "/stats")
        assert code == 200 and "images_per_s" in st
        assert _get(base + "/healthz") == (200, {"ok": True})
        code, err = _post(base + "/detect", b"not an image")
        assert code == 400 and "error" in err
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/nowhere")
        assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        b.stop()


@pytest.fixture(scope="module")
def engines():
    """JAX and port YOLOv2-tiny W8A8 engines at 64 px with the same
    weights and scales, serving batches of 4."""
    from dnn_inference_engine_tpu.config import EngineConfig as JConfig
    from dnn_inference_engine_tpu.runtime.engine import Engine as JEngine
    kw = dict(mode="w8a8", batch=4, input_size=SIZE, serve_max_batch=4,
              score_thresh=0.02)
    calib = np.random.default_rng(11).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    jeng = JEngine(JConfig(**kw)).load_weights(
        key=jax.random.PRNGKey(0)).prepare(calib)
    teng = Engine(EngineConfig(**kw), device="cpu").load_weights(
        params=jax.tree.map(np.asarray, jeng.params),
        act_scales=jeng.act_scales).prepare()
    return jeng, teng


def test_real_engine_rows_equal_detect(engines):
    """Requests from 3 threads; each result equals its row of detect on
    the padded batch the batcher shipped, and of a detect of all images
    (rows do not depend on their batchmates)."""
    _, eng = engines
    shipped = []
    detect_device = eng.detect_device

    def record(x):
        shipped.append(x.copy())
        return detect_device(x)
    eng.detect_device = record
    imgs = np.random.default_rng(13).integers(
        0, 256, (10, SIZE, SIZE, 3)).astype(np.uint8)
    b = ContinuousBatcher(eng).start()
    results = {}
    try:
        def client(idx):
            for i in idx:
                results[i] = b.submit(imgs[i]).result(timeout=120)
        threads = [threading.Thread(target=client, args=(range(t, 10, 3),))
                   for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        b.stop()
        del eng.detect_device
    assert len(results) == 10 and all(x.shape[0] == 4 for x in shipped)
    assert b.stats()["avg_batch_fill"] > 0
    seen = 0
    for x in shipped:
        ref = eng.detect(x)
        for row in range(4):
            hits = [i for i in range(10) if np.array_equal(imgs[i], x[row])]
            for i in hits:
                for got, want in zip(results[i], ref):
                    np.testing.assert_array_equal(got, want[row])
                seen += 1
    assert seen >= 10
    for i0 in range(0, 10, 4):
        chunk = np.zeros((4, SIZE, SIZE, 3), np.uint8)
        chunk[:len(imgs[i0:i0 + 4])] = imgs[i0:i0 + 4]
        ref = eng.detect(chunk)
        for r, i in enumerate(range(i0, min(i0 + 4, 10))):
            for got, want in zip(results[i], ref):
                np.testing.assert_array_equal(got, want[r])
    assert any((results[i][1] > 0).any() for i in range(10))


def test_http_detect_matches_jax_serve_http(engines):
    from dnn_inference_engine_tpu.runtime.serve import (
        ContinuousBatcher as JBatcher)
    jeng, teng = engines
    img = np.random.default_rng(14).integers(
        0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
    buf = io.BytesIO()
    np.save(buf, img)
    body = buf.getvalue()
    replies = []
    for batcher in (ContinuousBatcher(teng), JBatcher(jeng)):
        batcher.start()
        kw = {"host": "127.0.0.1"} if isinstance(
            batcher, ContinuousBatcher) else {}
        srv = batcher.serve_http(port=0, **kw)
        try:
            replies.append(_post(
                f"http://127.0.0.1:{srv.server_address[1]}/detect", body))
        finally:
            srv.shutdown()
            srv.server_close()
            batcher.stop()
    (tc, got), (jc, want) = replies
    assert tc == jc == 200
    assert got["classes"] == want["classes"] and got["names"] == \
        want["names"]
    assert len(got["scores"]) > 0
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5,
                               rtol=0)
