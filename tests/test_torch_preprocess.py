"""The port's host preprocessing and native bridge against the JAX
package's.

Both packages compile the same ``native/host_ops.cpp`` with
``native/Makefile``'s flags on this host, so their native resize and
fused uint8 path must agree bit for bit; their numpy paths too. Native
against numpy: JAX's own ``tests/test_native.py`` tolerance (``-O3
-march=native`` contracts ``a*b+c`` into FMAs). Calibration batches,
boxes and drawn images: bit for bit. Every image is written here from a
seed.
"""

import os
import time

import numpy as np
import pytest

from dnn_inference_engine_tpu import preprocess as jpre
from dnn_inference_engine_tpu.runtime import native_bridge as jnb

from dnn_inference_engine_tpu_torch import preprocess as tpre
from dnn_inference_engine_tpu_torch.runtime import native_bridge as tnb

SHAPES = [((37, 53, 3), 16, 24), ((100, 120, 3), 64, 64),
          ((375, 500, 3), 416, 416), ((20, 30, 1), 45, 7)]


def _img(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.uniform(0, 255, shape).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def jax_native_loaded():
    """JAX's bridge runs ``make -C native`` at first use and gives up for
    the process if the library it finds cannot be opened, as when another
    test process is still writing it: wait for that build and load
    again."""
    for _ in range(10):
        if jnb.native_available():
            return
        time.sleep(1.0)
        jnb._load_attempted, jnb._lib = False, None


@pytest.fixture
def numpy_only(monkeypatch):
    """Both packages on their numpy paths."""
    for mod in (jnb, tpre):
        monkeypatch.setattr(mod, "native_resize", lambda *a: None)
        monkeypatch.setattr(mod, "native_preprocess_u8", lambda *a: None)


def test_native_library_builds_here_in_build():
    """The port's library comes from build/, never native/."""
    assert tnb.native_available() == jnb.native_available()
    assert tnb.native_available()
    assert tnb.SO_PATH.parent.name == "native" and \
        tnb.SO_PATH.parents[1].name == "build"
    assert os.path.samefile(tnb.SRC, os.path.join(
        os.path.dirname(jnb._SO_PATH), "host_ops.cpp"))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape,oh,ow", SHAPES)
def test_native_resize_matches_jax_native(shape, oh, ow, dtype):
    img = _img(shape, dtype)
    got = tnb.native_resize(img, oh, ow)
    np.testing.assert_array_equal(got, jnb.native_resize(img, oh, ow))
    np.testing.assert_array_equal(tpre.resize_bilinear(img, oh, ow), got)


def test_native_resize_near_numpy():
    """JAX's tests/test_native.py case and tolerance: the two paths place
    the samples with different roundings."""
    img = _img((37, 53, 3), np.float32)
    np.testing.assert_allclose(tnb.native_resize(img, 16, 24),
                               tpre._resize_bilinear_numpy(img, 16, 24),
                               rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape,oh,ow", SHAPES)
def test_numpy_resize_matches_jax_numpy(shape, oh, ow, dtype):
    img = _img(shape, dtype, seed=1)
    np.testing.assert_array_equal(tpre._resize_bilinear_numpy(img, oh, ow),
                                  jpre._resize_bilinear_numpy(img, oh, ow))


@pytest.mark.parametrize("shape", [(100, 120, 3), (375, 500, 3)])
def test_native_preprocess_u8_matches_jax(shape):
    img = _img(shape, np.uint8, seed=2)
    got = tnb.native_preprocess_u8(img, 64, 64)
    np.testing.assert_array_equal(got, jnb.native_preprocess_u8(img, 64,
                                                                64))
    ref = tpre._resize_bilinear_numpy(img.astype(np.float32) / 255.0, 64, 64)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("letterbox", [False, True])
@pytest.mark.parametrize("dtype,shape", [(np.uint8, (375, 500, 3)),
                                         (np.uint8, (90, 60, 3)),
                                         (np.float32, (100, 120, 3))])
def test_preprocess_image_matches_jax(request, native, letterbox, dtype,
                                      shape):
    if not native:
        request.getfixturevalue("numpy_only")
    img = _img(shape, dtype, seed=3)
    if dtype == np.float32:
        img = img.round()
    got, gmeta = tpre.preprocess_image(img, 64, letterbox=letterbox)
    want, wmeta = jpre.preprocess_image(img, 64, letterbox=letterbox)
    assert got.dtype == np.float32 and got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, want)
    assert gmeta == wmeta


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp("calib")
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate([(70, 90), (64, 64), (120, 50)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
                        ).save(d / f"{i}.png")
    (d / "sub").mkdir()            # a directory is not an image
    return d


def test_load_image_matches_jax(pngs):
    for f in sorted(pngs.glob("*.png")):
        got = tpre.load_image(str(f))
        assert got.dtype == np.uint8 and got.ndim == 3
        np.testing.assert_array_equal(got, jpre.load_image(str(f)))


@pytest.mark.parametrize("kind", ["dir", "npy-u8", "npy-f32", "npz",
                                  "npy-64"])
def test_load_calib_images_matches_jax(pngs, tmp_path, kind):
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (5, 48, 40, 3)).astype(np.uint8)
    if kind == "dir":
        src = str(pngs)
    elif kind == "npz":
        src = str(tmp_path / "c.npz")
        np.savez(src, images=u8, other=u8[:1])
    else:
        src = str(tmp_path / "c.npy")
        arr = {"npy-u8": u8, "npy-f32": u8.astype(np.float32) / 255.0,
               "npy-64": rng.uniform(0, 1, (3, 64, 64, 3)).astype(
                   np.float32)}[kind]
        np.save(src, arr)
    got = tpre.load_calib_images(src, 64, limit=4)
    want = jpre.load_calib_images(src, 64, limit=4)
    assert got.dtype == np.float32 and got.shape[1:] == (64, 64, 3)
    assert got.shape[0] == (3 if kind in ("dir", "npy-64") else 4)
    np.testing.assert_array_equal(got, want)


def test_load_calib_images_refusals(tmp_path):
    np.save(tmp_path / "bad.npy", np.zeros((4, 8, 8), np.uint8))
    with pytest.raises(ValueError, match=r"\(N, H, W, 3\)"):
        tpre.load_calib_images(str(tmp_path / "bad.npy"), 64)
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no calibration images"):
        tpre.load_calib_images(str(tmp_path / "empty"), 64)


@pytest.mark.parametrize("letterbox", [False, True])
def test_boxes_to_original_matches_jax(letterbox):
    img = _img((375, 500, 3), np.uint8, seed=6)
    _, meta = tpre.preprocess_image(img, 416, letterbox=letterbox)
    boxes = np.random.default_rng(7).uniform(0, 416, (2, 9, 4)).astype(
        np.float32)
    got = tpre.boxes_to_original(boxes, meta)
    np.testing.assert_array_equal(got, jpre.boxes_to_original(boxes, meta))
    assert got.dtype == np.float32


def test_draw_boxes_matches_jax():
    from dnn_inference_engine_tpu_torch.config import VOC_CLASSES
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    xy = rng.uniform(0, 100, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 50, (6, 2))], 1)
    scores = np.array([0.9, 0.5, 0.0, 0.3, 0.7, 0.0], np.float32)
    classes = rng.integers(0, 20, 6)
    for names in (VOC_CLASSES, None):
        got = tpre.draw_boxes(img, boxes, scores, classes, names)
        want = jpre.draw_boxes(img, boxes, scores, classes, names)
        np.testing.assert_array_equal(got, want)
        assert (got != img).any()
