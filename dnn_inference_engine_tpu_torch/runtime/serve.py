"""Continuous-batching serving loop.

Counterpart of ``dnn_inference_engine_tpu/runtime/serve.py``: a host-side
queue of single-image requests feeding device batches of a fixed size
(``max_batch``, padded with zeros), one future per request. A worker
thread runs a depth-1 pipeline: it dispatches batch n to the engine,
then resolves batch n-1's device tensors into numpy. ``stats()`` gives
images/s, queue depth, average batch fill and p50/p99 latency;
``serve_http`` puts ``POST /detect``, ``GET /stats`` and ``GET /healthz``
in front of it.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np

from dnn_inference_engine_tpu_torch.config import VOC_CLASSES


class ContinuousBatcher:
    """Assembles incoming single-image requests into device batches."""

    def __init__(self, engine, max_batch: Optional[int] = None,
                 timeout_ms: Optional[float] = None):
        self.engine = engine
        self.max_batch = max_batch or engine.config.serve_max_batch
        self.timeout_s = (timeout_ms if timeout_ms is not None
                          else engine.config.serve_timeout_ms) / 1e3
        self.q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lat_ms: List[float] = []
        self._lat_lock = threading.Lock()
        self._n_images = 0
        self._n_batches = 0
        self._t_start = None

    # -- client API ----------------------------------------------------

    def submit(self, image: np.ndarray) -> Future:
        """image: (S, S, 3) uint8, or f32 in [0, 1]. The future resolves
        to this image's (boxes, scores, classes) as numpy."""
        fut: Future = Future()
        self.q.put((image, fut, time.perf_counter()))
        return fut

    def infer(self, image: np.ndarray, timeout: float = 30.0):
        return self.submit(image).result(timeout=timeout)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "ContinuousBatcher":
        if self._thread is not None:
            raise RuntimeError("the batcher is already running")
        self._t_start = time.perf_counter()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    # -- batching loop -------------------------------------------------

    def _collect(self):
        """Wait up to 0.1 s for one request, then fill the batch until it
        is full or the assembly window closes."""
        try:
            first = self.q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.timeout_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self.q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _resolve(self, pending) -> None:
        """Copy a dispatched batch's results to the host and fulfil its
        futures; an exception goes into every future of the batch."""
        batch, res = pending
        try:
            boxes, scores, classes = (t.cpu().numpy() for t in res)
        except Exception as e:                 # noqa: BLE001 — to futures
            for _img, fut, _t in batch:
                fut.set_exception(e)
            return
        now = time.perf_counter()
        with self._lat_lock:
            self._n_images += len(batch)
            self._n_batches += 1
            for i, (_img, fut, t0) in enumerate(batch):
                self._lat_ms.append((now - t0) * 1e3)
                fut.set_result((boxes[i], scores[i], classes[i]))
            if len(self._lat_ms) > 10000:
                self._lat_ms = self._lat_ms[-5000:]

    def _wire_batch(self, batch) -> np.ndarray:
        """The uint8 device batch, zero-padded to ``max_batch``: uint8
        images pass through, f32 ones in [0, 1] are rounded to codes."""
        size = self.engine.config.input_size
        x = np.zeros((self.max_batch, size, size, 3), np.uint8)
        for i, (img, _f, _t) in enumerate(batch):
            if img.dtype == np.uint8:
                x[i] = img
            else:
                x[i] = np.clip(np.round(img * 255.0), 0, 255).astype(
                    np.uint8)
        return x

    def _loop(self) -> None:
        # depth-1 pipeline: batch n is dispatched before batch n-1 is
        # resolved, so assembling n and its copy to the card overlap the
        # copy of n-1's results back
        pending = None
        while not self._stop.is_set():
            # with nothing queued behind it, a dispatched batch resolves
            # now rather than after the next 0.1 s wait in _collect
            if pending is not None and self.q.empty():
                self._resolve(pending)
                pending = None
            batch = self._collect()
            if not batch:
                continue
            try:
                res = self.engine.detect_device(self._wire_batch(batch))
            except Exception as e:             # noqa: BLE001 — to futures
                for _img, fut, _t in batch:
                    fut.set_exception(e)
                continue
            if pending is not None:
                self._resolve(pending)
            pending = (batch, res)
        if pending is not None:
            self._resolve(pending)

    # -- observability -------------------------------------------------

    def stats(self) -> dict:
        with self._lat_lock:
            lat = np.asarray(self._lat_ms[-2000:], np.float64)
            elapsed = (time.perf_counter() - self._t_start
                       if self._t_start else 0.0)
            return {
                "images": self._n_images,
                "batches": self._n_batches,
                "queue_depth": self.q.qsize(),
                "images_per_s": self._n_images / elapsed if elapsed else 0.0,
                "avg_batch_fill": (self._n_images / self._n_batches
                                   if self._n_batches else 0.0),
                "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
                "p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
            }

    def serve_http(self, port: int = 8000, host: str = "0.0.0.0"):
        """Start an HTTP server on a thread of its own and return it
        (``shutdown()`` stops it; port 0 takes a free port, see
        ``server_address``):

        - ``POST /detect``: the body is an encoded image (anything PIL
          decodes) or a raw ``.npy`` (H, W, 3) uint8 array; the reply is
          the detections as JSON in the image's own coordinates, 400 with
          the error for a body that fails;
        - ``GET /stats``: ``stats()``;
        - ``GET /healthz``: liveness.
        """
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from dnn_inference_engine_tpu_torch.preprocess import (
            boxes_to_original, preprocess_image)
        batcher = self

        def decode_image(data: bytes) -> np.ndarray:
            if data[:6] == b"\x93NUMPY":
                return np.asarray(np.load(io.BytesIO(data),
                                          allow_pickle=False))
            from PIL import Image
            with Image.open(io.BytesIO(data)) as im:
                return np.asarray(im.convert("RGB"))

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path not in ("/stats", "/healthz"):
                    self.send_response(404)
                    self.end_headers()
                    return
                self._reply(200, batcher.stats() if self.path == "/stats"
                            else {"ok": True})

            def do_POST(self):
                if self.path != "/detect":
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    img = decode_image(self.rfile.read(n))
                    x, meta = preprocess_image(
                        img, batcher.engine.config.input_size)
                    boxes, scores, classes = batcher.infer(x)
                    keep = scores > 0
                    orig = boxes_to_original(boxes[keep], meta)
                    self._reply(200, {
                        "boxes": orig.tolist(),
                        "scores": scores[keep].tolist(),
                        "classes": classes[keep].tolist(),
                        "names": [VOC_CLASSES[c] if c < len(VOC_CLASSES)
                                  else str(c) for c in classes[keep]],
                    })
                except Exception as e:         # noqa: BLE001 — reply 400
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})

            def _reply(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        srv = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv
