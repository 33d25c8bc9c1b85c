"""ctypes bridge to the native host library (``native/host_ops.cpp``).

Counterpart of ``dnn_inference_engine_tpu/runtime/native_bridge.py``:
bilinear resize, the fused uint8 resize + normalise, and the greedy host
NMS, all on the host in numpy buffers. At first use the port compiles
``native/host_ops.cpp`` with the flags of ``native/Makefile`` into
``build/native/`` at the root of the checkout, so both packages run the
same machine code for the same source on one host; it never writes into
``native/``. Where the library cannot be built (no C++ compiler) each
function returns None and the callers use numpy; ``native_available()``
says which one is in use.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "native" / "host_ops.cpp"
SO_PATH = _ROOT / "build" / "native" / "libhost_ops.so"
# native/Makefile's CXXFLAGS
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
            "-Wall"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int)


def _build() -> bool:
    """Compile the library unless it is newer than its source. The
    compiler writes a file of this process's own, renamed into place, so
    processes that build at once do not read half a library."""
    if SO_PATH.exists() and SO_PATH.stat().st_mtime >= SRC.stat().st_mtime:
        return True
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not SRC.exists():
        return False
    SO_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = SO_PATH.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SRC)],
                           capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, SO_PATH)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(str(SO_PATH))
        except OSError:
            return None
        lib.resize_bilinear_f32.argtypes = [
            _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32P,
            ctypes.c_int, ctypes.c_int]
        lib.resize_bilinear_f32.restype = None
        lib.preprocess_u8.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32P,
            ctypes.c_int, ctypes.c_int]
        lib.preprocess_u8.restype = None
        lib.nms_greedy.argtypes = [
            _F32P,                             # boxes xyxy (M,4)
            _F32P,                             # scores (M,)
            ctypes.c_int,                      # M
            ctypes.c_float, ctypes.c_float,    # iou_thresh, score_thresh
            _I32P,                             # out: kept indices
            ctypes.c_int]                      # max_det
        lib.nms_greedy.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the native library is in use, False when numpy is."""
    return _load() is not None


def native_resize(img: np.ndarray, out_h: int,
                  out_w: int) -> Optional[np.ndarray]:
    """Bilinear resize, half-pixel centres: (H, W[, C]) -> f32."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(img, np.float32)
    h, w = src.shape[:2]
    c = src.shape[2] if src.ndim == 3 else 1
    dst = np.empty((out_h, out_w, c), np.float32)
    lib.resize_bilinear_f32(src.ctypes.data_as(_F32P), h, w, c,
                            dst.ctypes.data_as(_F32P), out_h, out_w)
    return dst[..., 0] if img.ndim == 2 else dst


def native_preprocess_u8(img: np.ndarray, out_h: int,
                         out_w: int) -> Optional[np.ndarray]:
    """uint8 (H, W, C) -> resized f32 in [0, 1], fused in C++."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(img, np.uint8)
    if src.ndim != 3:
        raise ValueError(f"expected (H, W, C) uint8, got {src.shape}")
    h, w, c = src.shape
    dst = np.empty((out_h, out_w, c), np.float32)
    lib.preprocess_u8(src.ctypes.data_as(_U8P), h, w, c,
                      dst.ctypes.data_as(_F32P), out_h, out_w)
    return dst


def native_nms(boxes_xyxy: np.ndarray, scores: np.ndarray,
               iou_thresh: float, score_thresh: float,
               max_det: int) -> Optional[np.ndarray]:
    """Greedy NMS over candidates sorted by score: the kept indices."""
    lib = _load()
    if lib is None:
        return None
    b = np.ascontiguousarray(boxes_xyxy, np.float32).reshape(-1, 4)
    s = np.ascontiguousarray(scores, np.float32)
    if len(b) != len(s):
        raise ValueError(f"{len(b)} boxes for {len(s)} scores")
    keep = np.empty((max(max_det, 0),), np.int32)
    n = lib.nms_greedy(b.ctypes.data_as(_F32P), s.ctypes.data_as(_F32P),
                       len(s), ctypes.c_float(iou_thresh),
                       ctypes.c_float(score_thresh),
                       keep.ctypes.data_as(_I32P), max_det)
    return keep[:n]
