"""Host-side image preprocessing: load, resize, normalise to [0, 1] NHWC.

Counterpart of ``dnn_inference_engine_tpu/preprocess.py``, a numpy copy
(pinned by ``tests/test_torch_preprocess.py``). It stays on the host; the
device sees a batch only when ``Engine`` moves it. The bilinear resize
and the fused uint8 resize + normalise run in the native host library
(runtime/native_bridge.py) where it builds, in numpy otherwise. PIL is
imported inside the functions that decode or draw images only.
"""

from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np

from dnn_inference_engine_tpu_torch.runtime.native_bridge import (
    native_preprocess_u8, native_resize)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize with half-pixel centres (cv2.INTER_LINEAR):
    (H, W, C) uint8 or float -> f32 (out_h, out_w, C)."""
    out = native_resize(img, out_h, out_w)
    if out is not None:
        return out
    return _resize_bilinear_numpy(img, out_h, out_w)


def _resize_bilinear_numpy(img: np.ndarray, out_h: int,
                           out_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    img = img.astype(np.float32)
    ys = (np.arange(out_h, dtype=np.float32) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float32) + 0.5) * (w / out_w) - 0.5
    ys = np.clip(ys, 0, h - 1)
    xs = np.clip(xs, 0, w - 1)
    y0 = np.floor(ys).astype(np.int32)
    x0 = np.floor(xs).astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx).astype(np.float32)


def preprocess_image(img: np.ndarray, input_size: int = 416,
                     letterbox: bool = False) -> Tuple[np.ndarray, dict]:
    """(H, W, 3) uint8 or float RGB -> ((S, S, 3) f32 in [0, 1], meta);
    meta holds the scales and offsets that map boxes back to the image
    (``boxes_to_original``)."""
    h, w = img.shape[:2]
    if not letterbox:
        meta = {"scale_x": w / input_size, "scale_y": h / input_size,
                "pad_x": 0.0, "pad_y": 0.0}
        if img.dtype == np.uint8 and img.ndim == 3:
            out = native_preprocess_u8(img, input_size, input_size)
            if out is not None:
                return out, meta
        out = resize_bilinear(img, input_size, input_size) / 255.0
        return out.astype(np.float32), meta
    scale = min(input_size / w, input_size / h)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    resized = resize_bilinear(img, nh, nw) / 255.0
    out = np.full((input_size, input_size, 3), 0.5, np.float32)
    px, py = (input_size - nw) // 2, (input_size - nh) // 2
    out[py:py + nh, px:px + nw] = resized
    meta = {"scale_x": 1.0 / scale, "scale_y": 1.0 / scale,
            "pad_x": float(px), "pad_y": float(py)}
    return out, meta


def load_image(path: str) -> np.ndarray:
    """An image file as RGB uint8 (H, W, 3)."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_calib_images(source: str, input_size: int = 416,
                      limit: int = 64) -> np.ndarray:
    """Calibration images as an (N, S, S, 3) f32 batch in [0, 1].

    ``source`` is a directory of image files (each through
    ``preprocess_image``) or a ``.npy``/``.npz`` file holding an
    (N, H, W, 3) array, f32 in [0, 1] or uint8 (its first array for an
    ``.npz``), resized where H, W differ from S. The CLI's
    ``--calib-images`` and ``EngineConfig.calib`` both load through here.
    """
    if source.endswith((".npy", ".npz")):
        if source.endswith(".npz"):
            with np.load(source, allow_pickle=False) as z:
                arr = z[z.files[0]]
        else:
            arr = np.load(source, allow_pickle=False)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        if arr.ndim != 4 or arr.shape[-1] != 3:
            raise ValueError(
                f"calibration array must be (N, H, W, 3), got {arr.shape}")
        if arr.shape[1] != input_size or arr.shape[2] != input_size:
            arr = np.stack([resize_bilinear(a, input_size, input_size)
                            for a in arr[:limit]])
            arr = np.clip(arr, 0.0, 1.0)
        return arr[:limit].astype(np.float32)
    files = sorted(f for f in glob.glob(os.path.join(source, "*"))
                   if os.path.isfile(f))[:limit]
    if not files:
        raise ValueError(f"no calibration images found in {source!r}")
    return np.stack([preprocess_image(load_image(f), input_size)[0]
                     for f in files])


def boxes_to_original(boxes_xyxy: np.ndarray, meta: dict) -> np.ndarray:
    """Network-space xyxy boxes -> original image coordinates."""
    b = np.asarray(boxes_xyxy, np.float32).copy()
    b[..., [0, 2]] = (b[..., [0, 2]] - meta["pad_x"]) * meta["scale_x"]
    b[..., [1, 3]] = (b[..., [1, 3]] - meta["pad_y"]) * meta["scale_y"]
    return b


def draw_boxes(img: np.ndarray, boxes_xyxy: np.ndarray, scores: np.ndarray,
               classes: np.ndarray, class_names=None) -> np.ndarray:
    """Rectangles and "name:score" labels for the boxes with a score
    above 0 (PIL)."""
    from PIL import Image, ImageDraw
    im = Image.fromarray(np.asarray(img, np.uint8))
    dr = ImageDraw.Draw(im)
    for box, s, c in zip(boxes_xyxy, scores, classes):
        if s <= 0:
            continue
        dr.rectangle([float(box[0]), float(box[1]),
                      float(box[2]), float(box[3])], outline=(255, 0, 0),
                     width=2)
        label = f"{class_names[int(c)] if class_names else int(c)}:{s:.2f}"
        dr.text((float(box[0]) + 2, float(box[1]) + 2), label,
                fill=(255, 0, 0))
    return np.asarray(im)
