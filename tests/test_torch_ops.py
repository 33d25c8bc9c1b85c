"""The PyTorch port's ops against the JAX package, on the CPU.

Same inputs, made with numpy from a seed, go through the JAX function
(Pallas kernels in interpret mode, as the JAX package's own tests run
them) and the port's counterpart, whose wrappers take their plain
PyTorch versions for CPU tensors. int8 codes, int32 accumulators and the
fold transforms must be identical; the f32 epilogue outputs too, since
both sides round the same float32 operations in the same order.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu import config as jcfg
from dnn_inference_engine_tpu.ops import conv as jconv
from dnn_inference_engine_tpu.ops import pallas_conv as jpc
from dnn_inference_engine_tpu.ops import pallas_gemm as jgemm
from dnn_inference_engine_tpu.ops.pool import maxpool as jmaxpool
from dnn_inference_engine_tpu.quant import quantize as jq

from dnn_inference_engine_tpu_torch import config as tcfg
from dnn_inference_engine_tpu_torch.ops import fused_conv as tfc
from dnn_inference_engine_tpu_torch.ops import gemm as tgemm
from dnn_inference_engine_tpu_torch.ops import dispatch as tdispatch
from dnn_inference_engine_tpu_torch.ops.conv import conv2d_w8a8
from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
    conv2d_w8a8_gemm, extract_patches, gemm_weights)
from dnn_inference_engine_tpu_torch.ops.pool import maxpool as tmaxpool
from dnn_inference_engine_tpu_torch.quant import quantize as tq


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def N(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def eq(got, ref):
    got, ref = N(got), N(ref)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture
def r():
    return np.random.default_rng(1234)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_constants_match_jax():
    for name in ("YOLOV2_TINY_ANCHORS", "YOLOV3_TINY_ANCHORS", "VOC_CLASSES",
                 "INPUT_SIZE", "GRID_SIZE", "NUM_ANCHORS", "NUM_CLASSES",
                 "SCORE_THRESH_VIS", "SCORE_THRESH_EVAL", "NMS_IOU_THRESH",
                 "MAX_DETECTIONS", "NMS_TOPK", "NMS_TRUNCATION_MIN_THRESH",
                 "QMAX", "LEAKY_SLOPE"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    jdef = {f.name: f.default for f in dataclasses.fields(jcfg.EngineConfig)}
    for f in dataclasses.fields(tcfg.EngineConfig):
        assert f.default == jdef[f.name], f.name
    for thresh in (0.005, 0.04, 0.25, 0.3):
        for topk in (None, 16):
            kw = dict(score_thresh=thresh, nms_topk=topk)
            assert (tcfg.EngineConfig(**kw).resolved_nms_topk()
                    == jcfg.EngineConfig(**kw).resolved_nms_topk())


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (1, 1, 64, 125), (40, 7)])
def test_quantize_weights_identical(r, shape):
    w = (r.standard_normal(shape) * 0.3).astype(np.float32)
    w[..., 0] = 0.0                      # an all-zero channel: the 1e-12 floor
    jwq, js = jq.quantize_weights_per_channel(jnp.asarray(w))
    twq, ts = tq.quantize_weights_per_channel(T(w))
    eq(twq, jwq)
    eq(ts, js)


@pytest.mark.parametrize("scale", [0.00787, 0.05, 1 / 255.0, 0.0123456])
def test_quantize_act_and_dequantize_identical(r, scale):
    x = r.uniform(-20, 20, (4, 9, 9, 8)).astype(np.float32)
    x[0, 0, 0, :4] = np.array([0.5, 1.5, -2.5, 300.0]) * scale  # ties, clip
    jx = jq.quantize_act(jnp.asarray(x), jnp.float32(scale))
    tx = tq.quantize_act(T(x), scale)
    eq(tx, jx)
    eq(tq.dequantize(tx, scale), jq.dequantize(jx, jnp.float32(scale)))


# ---------------------------------------------------------------------------
# fold transforms and layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("pool_major", [False, True])
def test_weight_folds_identical(r, f, pool_major):
    w = r.integers(-127, 128, (3, 3, 5, 6)).astype(np.int8)
    eq(tfc.fold_conv3x3_weights(w, f, pool_major),
       jpc.fold_conv3x3_weights(w, f, pool_major))
    eq(tfc.fold_conv3x3_k2_weights(w, f, pool_major),
       jpc.fold_conv3x3_k2_weights(w, f, pool_major))


@pytest.mark.parametrize("f", [2, 4])
def test_layout_transforms_identical(r, f):
    x = r.integers(-127, 128, (2, 16, 24, 3)).astype(np.int8)
    s = tfc.space_to_depth(T(x), f)
    eq(s, jpc.space_to_depth(jnp.asarray(x), f))
    eq(tfc.depth_to_space(s, f), x)
    eq(tfc.shift_space_to_depth(T(x), f),
       jpc.shift_space_to_depth(jnp.asarray(x), f))


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
@pytest.mark.parametrize("stride", [1, 2])
def test_maxpool_identical(r, dtype, stride):
    x = (r.integers(-128, 128, (2, 6, 8, 5)) if dtype == np.int8
         else r.standard_normal((2, 6, 8, 5))).astype(dtype)
    eq(tmaxpool(T(x), 2, stride), jmaxpool(jnp.asarray(x), 2, stride))


def test_extract_patches_identical(r):
    from dnn_inference_engine_tpu.ops.conv_lowering import (
        extract_patches as jextract)
    x = r.integers(-127, 128, (2, 7, 9, 4)).astype(np.int8)
    for k, s, pad in ((3, 1, "SAME"), (3, 2, "SAME"), (2, 1, "VALID"),
                      (1, 1, "SAME")):
        eq(extract_patches(T(x), k, k, s, pad),
           jextract(jnp.asarray(x), k, k, s, pad))


# ---------------------------------------------------------------------------
# gemm_fused (kernel 1's plain version)
# ---------------------------------------------------------------------------

def _gemm_inputs(r, m=300, k=576, n=125):
    a = r.integers(-127, 128, (m, k)).astype(np.int8)
    b = r.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (r.uniform(0.5, 2.0, n) * 1e-4).astype(np.float32)
    bias = r.standard_normal(n).astype(np.float32)
    return a, b, scale, bias


def _assert_f32_vs_jax_gemm(got, ref, a, b, scale, bias, act):
    """The JAX gemm_fused, run in interpret mode on the CPU, computes
    acc*scale + bias as ONE fused multiply-add (one rounding); the port
    rounds the multiply and the add separately, as conv2d_w8a8 — the
    order of the slice's conv stages — does. Pin both exactly: JAX
    against the single-rounded expression, the port against the
    double-rounded one; the two differ by at most the product's
    rounding plus one rounding of the result."""
    acc = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.float64)

    def act_fn(y):
        if act == "leaky":
            return np.where(y > 0, y, np.float32(0.1) * y)
        if act == "relu":
            return np.maximum(y, np.float32(0))
        return y
    fused = (acc * scale.astype(np.float64) + bias.astype(np.float64)
             ).astype(np.float32)
    prod = acc.astype(np.float32) * scale
    eq(ref, act_fn(fused))
    eq(got, act_fn(prod + bias))
    gap = np.abs(N(got) - N(ref))
    assert (gap <= np.spacing(np.abs(prod)) + np.spacing(np.abs(fused))).all()


@pytest.mark.parametrize("act", ["leaky", "linear", "relu"])
@pytest.mark.parametrize("mode", ["f32", "quantize_out", "raw_acc"])
def test_gemm_fused_plain_matches_jax(r, act, mode):
    a, b, scale, bias = _gemm_inputs(r)
    kw = {"quantize_out": mode == "quantize_out",
          "raw_acc": mode == "raw_acc"}
    ref = jgemm.gemm_fused(jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale),
                           jnp.asarray(bias), act=act, **kw)
    got = tgemm.gemm_fused(T(a), T(b.T), T(scale), T(bias), act=act, **kw)
    if mode == "f32":
        _assert_f32_vs_jax_gemm(got, ref, a, b, scale, bias, act)
    else:
        eq(got, ref)


@pytest.mark.parametrize("s_out", [None, 0.05])
def test_int8_gemm_fused_matches_jax(r, s_out):
    a, b, scale, bias = _gemm_inputs(r, m=200, k=512, n=256)
    ref = jgemm.int8_gemm_fused(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(scale), jnp.asarray(bias),
                                s_out=s_out)
    got = tgemm.int8_gemm_fused(T(a), T(b.T), T(scale), T(bias), s_out=s_out)
    if s_out is None:
        _assert_f32_vs_jax_gemm(got, ref, a, b, scale, bias, "leaky")
    else:
        eq(got, ref)


def test_gemm_conv_order_matches_jax_epilogue(r):
    """The conv-order epilogue (s_out): conv2d_w8a8's op order on the
    exact int32 accumulator."""
    a, b, scale, bias = _gemm_inputs(r)
    s_out = 0.0173
    acc = jnp.asarray(a.astype(np.int32) @ b.astype(np.int32))
    y = acc.astype(jnp.float32) * jnp.asarray(scale) + jnp.asarray(bias)
    ref = jq.quantize_act(jnp.where(y > 0, y, 0.1 * y), jnp.float32(s_out))
    got = tgemm.gemm_fused(T(a), T(b.T), T(scale), T(bias), act="leaky",
                           s_out=s_out)
    eq(got, ref)


@pytest.mark.parametrize("s_out", [None, 0.031])
@pytest.mark.parametrize("shape,k,cout,stride", [
    ((2, 13, 13, 64), 3, 128, 1), ((2, 8, 8, 256), 1, 125, 1),
    ((2, 9, 10, 16), 3, 32, 2)])
def test_conv2d_w8a8_matches_jax(r, shape, k, cout, stride, s_out):
    x = r.integers(-127, 128, shape).astype(np.int8)
    wq = r.integers(-127, 128, (k, k, shape[-1], cout)).astype(np.int8)
    s_w = (r.uniform(0.5, 2, cout) * 1e-3).astype(np.float32)
    b = (r.standard_normal(cout) * 0.1).astype(np.float32)
    s_in = 0.0421
    act = "leaky" if s_out else "linear"
    ref = jconv.conv2d_w8a8(jnp.asarray(x), jnp.float32(s_in),
                            jnp.asarray(wq), jnp.asarray(s_w), jnp.asarray(b),
                            act=act, stride=stride,
                            s_out=None if s_out is None
                            else jnp.float32(s_out))
    got = conv2d_w8a8(T(x), s_in, T(wq), T(s_w), T(b), act=act,
                      stride=stride, s_out=s_out, wt=gemm_weights(T(wq)))
    eq(got, ref)


# ---------------------------------------------------------------------------
# stem_fused_k2 (kernel 2), shift_s2d2 (kernel 3) and stem_fused_dg
# (kernel 4) plain versions
# ---------------------------------------------------------------------------

def _stem_args(r, cin_pad, exact_u8):
    w = (r.standard_normal((3, 3, 3, 16)) * 0.2).astype(np.float32)
    wq, s_w = jq.quantize_weights_per_channel(jnp.asarray(w))
    b = jnp.asarray(r.standard_normal(16) * 0.1, jnp.float32)
    s_in = jnp.float32(1 / 255.0 if exact_u8 else 0.00787)
    s_out = jnp.float32(0.05)
    wf = jpc.fold_conv3x3_k2_weights(np.asarray(wq), 4, pool_major=True)
    wf = np.concatenate([wf, np.zeros((2, 2, cin_pad - 48, 256), np.int8)],
                        axis=2)
    s_wt, bt = jnp.tile(s_w, 16), jnp.tile(b, 16)
    scale = (s_in * s_wt) / s_out
    if exact_u8:
        w1 = jnp.asarray(wf.reshape(-1, 256).astype(np.float32).sum(axis=0))
        bias = (bt + 128.0 * s_in * s_wt * w1) / s_out
    else:
        bias = bt / s_out
    return wf, scale, bias, s_in


@pytest.mark.parametrize("cin_pad", [48, 64])
@pytest.mark.parametrize("ingest", ["f32", "exact_u8"])
def test_stem_fused_k2_plain_matches_jax(r, ingest, cin_pad):
    exact = ingest == "exact_u8"
    xu = r.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    x = xu.astype(np.float32) / 255.0 if ingest == "f32" else xu
    wf, scale, bias, s_in = _stem_args(r, cin_pad, exact)
    ref = jpc.stem_fused_k2(jnp.asarray(x), jnp.asarray(wf), scale, bias,
                            s_in, exact_u8=exact)
    got = tfc.stem_fused_k2(T(x), T(wf), T(scale), T(bias), float(s_in),
                            exact_u8=exact)
    assert got.shape == (2, 16, 16, 64)
    eq(got, ref)


@pytest.mark.parametrize("cin_pad", [48, 64])
@pytest.mark.parametrize("ingest", ["f32", "exact_u8"])
def test_stem_fused_dg_plain_matches_jax(r, ingest, cin_pad):
    """The per-tap formulation against the JAX stem_fused_dg (Pallas, in
    interpret mode), bit for bit; and against the port's own k2 stem."""
    exact = ingest == "exact_u8"
    xu = r.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    x = xu.astype(np.float32) / 255.0 if ingest == "f32" else xu
    wf, scale, bias, s_in = _stem_args(r, cin_pad, exact)
    ref = jpc.stem_fused_dg(jnp.asarray(x), jnp.asarray(wf), scale, bias,
                            s_in, exact_u8=exact)
    args = (T(x), T(wf), T(scale), T(bias), float(s_in))
    got = tfc.stem_fused_dg(*args, exact_u8=exact)
    assert got.shape == (2, 16, 16, 64)
    eq(got, ref)
    eq(got, tfc.stem_fused_k2(*args, exact_u8=exact))


def test_stem_dg_weight_slabs_layout_and_cache(r):
    """slabs[2*dh+dw, o, l] == w[dh, dw, l, o] for the 48 real lanes; the
    cin_pad rows are dropped; the cache follows in-place writes."""
    w = T(r.integers(-127, 128, (2, 2, 64, 256)).astype(np.int8))
    s = tfc.stem_dg_weight_slabs(w)
    assert tuple(s.shape) == (4, 256, 48) and s.is_contiguous()
    want = w.numpy()[:, :, :48, :].reshape(4, 48, 256).transpose(0, 2, 1)
    eq(s, want)
    assert tfc.stem_dg_weight_slabs(w) is s
    w[1, 0, 5, 7] = 0 if int(w[1, 0, 5, 7]) else 1
    s2 = tfc.stem_dg_weight_slabs(w)
    assert s2 is not s and int(s2[2, 7, 5]) == int(w[1, 0, 5, 7])


@pytest.mark.parametrize("shape", [(2, 16, 16, 32), (1, 10, 14, 5),
                                   (2, 26, 26, 128)])
def test_shift_s2d2_plain_matches_jax(r, shape):
    x = r.integers(-127, 128, shape).astype(np.int8)
    ref = jpc.shift_s2d2_pallas(jnp.asarray(x))
    got = tfc.shift_s2d2(T(x))
    eq(got, ref)
    h, w = shape[1], shape[2]
    eq(got[:, :h // 2 + 1], tfc.shift_space_to_depth(T(x), 2))


# ---------------------------------------------------------------------------
# quant_space_to_depth4 (kernel 5), gmax_shift_s2d2 (kernel 6) and
# conv3x3_rs (kernel 7) plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["k3", "k3-pad64", "k2-pad64",
                                     "k3-pad56", "k2-pad72"])
@pytest.mark.parametrize("ingest", ["f32", "uint8"])
@pytest.mark.parametrize("n,h,w,s_in", [(1, 64, 64, 0.0123),
                                        (2, 64, 64, 1 / 127.0),
                                        (1, 32, 96, 0.007919)])
def test_quant_space_to_depth4_plain_matches_jax(r, n, h, w, s_in, ingest,
                                                 variant):
    """Bit for bit, for scales whose reciprocal is inexact. The k3 entry
    reads the input as it is; the k2 entry's (1, 7) border, which the JAX
    plan pads before its kernel, is the port's ``pad_hw``. Any ``pad_to``:
    56 and 72 are not multiples of 16."""
    x = (r.uniform(-1, 1, (n, h, w, 3)).astype(np.float32) if ingest == "f32"
         else r.integers(0, 256, (n, h, w, 3)).astype(np.uint8))
    entry, _, pad = variant.partition("-pad")
    pad_to = int(pad or 0)
    pad_hw = (1, 7, 1, 7) if entry == "k2" else (0, 0, 0, 0)
    xj = jnp.asarray(x)
    if entry == "k2":
        xj = jnp.pad(xj, ((0, 0), (1, 7), (1, 7), (0, 0)))
    ref = jpc.quant_space_to_depth4(xj, jnp.float32(s_in), pad_to=pad_to)
    got = tfc.quant_space_to_depth4(T(x), s_in, pad_to=pad_to, pad_hw=pad_hw)
    assert got.shape[-1] == max(48, pad_to)
    eq(got, ref)


@pytest.mark.parametrize("n,h,w,go", [(2, 16, 16, 8), (1, 26, 26, 32),
                                      (2, 24, 16, 4), (1, 10, 14, 16)])
def test_gmax_shift_s2d2_plain_matches_jax(r, n, h, w, go):
    """Bit for bit, the zero junk rows included."""
    y = r.integers(-127, 128, (n, h, w, 4 * go)).astype(np.int8)
    ref = jpc.gmax_shift_s2d2(jnp.asarray(y), go)
    got = tfc.gmax_shift_s2d2(T(y), go)
    eq(got, ref)
    eq(got[:, :h // 2 + 1],
       tfc.shift_space_to_depth(tfc.group_max4(T(y)), 2))


def _rs_y_f32(x, w, scale, bias, ksize, act, fused):
    """The pre-pool f32 epilogue of conv3x3_rs in numpy, from the exact
    int32 accumulator: ``fused`` rounds acc*scale + bias once (an FMA, as
    XLA compiles the JAX kernel under jit), else the product and the sum
    separately (the port)."""
    n, h, wd, cin = x.shape
    ho, wo = (h, wd) if ksize == 3 else (h - 1, wd - 1)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0))) if ksize == 3 else x
    a = np.concatenate([xp[:, i:i + ho, j:j + wo] for i in range(ksize)
                        for j in range(ksize)], axis=-1).astype(np.int64)
    acc = a @ w.reshape(-1, w.shape[-1]).astype(np.int64)
    if fused:
        y = (acc.astype(np.float64) * scale.astype(np.float64)
             + bias.astype(np.float64)).astype(np.float32)
    else:
        y = acc.astype(np.float32) * scale + bias
    if act == "leaky":
        y = np.where(y > 0, y, np.float32(0.1) * y)
    return y


RS_CASES = [
    # (h, w, cin, cout, ksize, pool, quantize_out, s2d_out)
    (9, 11, 16, 24, 3, None, True, False),
    (8, 10, 32, 32, 3, ("gmaxm", 2, 8), True, False),
    (9, 9, 64, 64, 2, ("gmaxm", 2, 16), True, False),
    (8, 8, 48, 64, 3, ("gmaxm", 4, 4), True, False),
    (8, 8, 16, 32, 3, ("gmax", 2, 8), True, False),
    (9, 9, 48, 64, 2, ("gmax", 4, 4), True, False),
    (8, 13, 16, 16, 3, "pool2", True, False),
    (8, 12, 16, 32, 3, ("gmaxm", 2, 8), True, True),
    (9, 10, 32, 16, 2, None, True, True),
    (7, 7, 16, 16, 3, None, False, False),
    (8, 8, 16, 32, 3, ("gmaxm", 2, 8), False, False),
    (9, 9, 16, 32, 2, None, False, False),
]


@pytest.mark.parametrize("case", RS_CASES)
def test_conv3x3_rs_plain_matches_jax(r, case):
    """Every pool form, k 2 and 3, quantize_out both ways, s2d_out.

    The JAX kernel runs under jax.jit, and XLA contracts its
    acc*scale + bias into one FMA; the port rounds twice. int8 codes are
    identical at these inputs; the f32 outputs are pinned exactly, JAX to
    the single rounding and the port to the double one, both computed
    here in numpy."""
    h, w, cin, cout, k, pool, qo, s2d = case
    x = r.integers(-127, 128, (2, h, w, cin)).astype(np.int8)
    wq = r.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    scale = (r.uniform(0.5, 2, cout) * 1e-4).astype(np.float32)
    bias = r.standard_normal(cout).astype(np.float32)
    kw = dict(quantize_out=qo, pool=pool, ksize=k, s2d_out=s2d)
    ref = jpc.conv3x3_rs(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale),
                         jnp.asarray(bias), **kw)
    got = tfc.conv3x3_rs(T(x), T(wq), T(scale), T(bias), **kw)
    assert got.shape == ref.shape
    if qo:
        eq(got, ref)
        return
    want = [_rs_y_f32(x, wq, scale, bias, k, "leaky", fused)
            for fused in (True, False)]
    if pool is not None:                     # ("gmaxm", 2, co)
        want = [np.max(y.reshape(y.shape[:-1] + (4, -1)), axis=-2)
                for y in want]
    eq(ref, want[0])
    eq(got, want[1])


@pytest.mark.parametrize("s_out", [None, 0.06])
@pytest.mark.parametrize("pool", [None, "pool2"])
def test_conv2d_w8a8_rs_matches_jax(r, s_out, pool):
    x = r.integers(-127, 128, (2, 8, 10, 16)).astype(np.int8)
    wq = r.integers(-127, 128, (3, 3, 16, 32)).astype(np.int8)
    s_w = r.uniform(1e-3, 1e-2, 32).astype(np.float32)
    b = r.standard_normal(32).astype(np.float32)
    ref = jpc.conv2d_w8a8_rs(
        jnp.asarray(x), jnp.float32(0.02), jnp.asarray(wq), jnp.asarray(s_w),
        jnp.asarray(b), s_out=None if s_out is None else jnp.float32(s_out),
        pool=pool)
    got = tfc.conv2d_w8a8_rs(T(x), 0.02, T(wq), T(s_w), T(b), s_out=s_out,
                             pool=pool)
    if s_out is not None:
        eq(got, ref)
    else:                      # f32: one FMA rounding apart at most
        np.testing.assert_allclose(N(got), N(ref), rtol=0,
                                   atol=2 * np.spacing(np.abs(N(ref)).max()))


def test_fold_helpers_match_jax(r):
    y = r.standard_normal((2, 3, 5, 4 * 4 * 6)).astype(np.float32)
    eq(tfc.fold_group_pool_channels(T(y), 4, 6),
       jpc.fold_group_pool_channels(jnp.asarray(y), 4, 6))
    wq = r.integers(-127, 128, (3, 3, 5, 6)).astype(np.int8)
    s_w, b = r.uniform(size=6).astype(np.float32), r.standard_normal(6)
    for got, want in zip(tfc.folded_stage_params(wq, s_w, b, 2),
                         jpc.folded_stage_params(wq, s_w, b, 2)):
        eq(got, want)


def test_rs_weight_matrix_layout_and_cache(r):
    w = T(r.integers(-127, 128, (2, 2, 32, 64)).astype(np.int8))
    m = tfc.rs_weight_matrix(w)
    eq(m, gemm_weights(w))
    assert tfc.rs_weight_matrix(w) is m
    w[0, 1, 3, 5] = 0 if int(w[0, 1, 3, 5]) else 1
    assert tfc.rs_weight_matrix(w) is not m


# ---------------------------------------------------------------------------
# the gemm and auto conv tiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s_out", [None, 0.031])
@pytest.mark.parametrize("shape,k,cout,stride", [
    ((2, 13, 13, 64), 3, 128, 1), ((2, 8, 8, 256), 1, 125, 1),
    ((2, 9, 10, 16), 3, 32, 2)])
def test_conv2d_w8a8_gemm_matches_jax(r, shape, k, cout, stride, s_out):
    """The gemm tier's folded order, against the JAX Pallas tier
    (conv2d_w8a8_pallas): codes exact; the f32 output pinned as the GEMM's
    (one FMA rounding in JAX, two in the port)."""
    from dnn_inference_engine_tpu.ops.conv_lowering import conv2d_w8a8_pallas
    x = r.integers(-127, 128, shape).astype(np.int8)
    wq = r.integers(-127, 128, (k, k, shape[-1], cout)).astype(np.int8)
    s_w = (r.uniform(0.5, 2, cout) * 1e-3).astype(np.float32)
    b = (r.standard_normal(cout) * 0.1).astype(np.float32)
    s_in = 0.0421
    act = "leaky" if s_out else "linear"
    ref = conv2d_w8a8_pallas(jnp.asarray(x), jnp.float32(s_in),
                             jnp.asarray(wq), jnp.asarray(s_w),
                             jnp.asarray(b), act=act, stride=stride,
                             s_out=None if s_out is None
                             else jnp.float32(s_out))
    got = conv2d_w8a8_gemm(T(x), s_in, T(wq), T(s_w), T(b), act=act,
                           stride=stride, s_out=s_out)
    if s_out is not None:
        eq(got, ref)
        return
    a = N(extract_patches(T(x), k, k, stride))
    _assert_f32_vs_jax_gemm(
        N(got).reshape(-1, cout), N(ref).reshape(-1, cout),
        a.reshape(-1, a.shape[-1]), wq.reshape(-1, cout),
        np.float32(s_in) * s_w, b, act)


@pytest.mark.parametrize("x_shape,w_shape,stride", [
    ((1, 13, 13, 512), (3, 3, 512, 1024), 1),
    ((1, 26, 26, 128), (3, 3, 128, 256), 1),
    ((1, 52, 52, 64), (3, 3, 64, 128), 1),
    ((1, 13, 13, 1024), (1, 1, 1024, 125), 1),
    ((1, 13, 13, 1000), (1, 1, 1000, 125), 1),
    ((1, 64, 64, 128), (3, 3, 128, 128), 2)])
def test_auto_tier_choice_matches_jax(r, x_shape, w_shape, stride):
    """The auto tier takes the gemm tier exactly where JAX takes its
    Pallas tier, and then computes that tier's codes."""
    from dnn_inference_engine_tpu.ops import dispatch as jdispatch
    want = jdispatch.use_pallas(x_shape, w_shape, stride)
    assert tdispatch.use_pallas(x_shape, w_shape, stride) == want
    if x_shape[1] > 26:
        return
    x = r.integers(-127, 128, (1,) + x_shape[1:]).astype(np.int8)
    wq = r.integers(-127, 128, w_shape).astype(np.int8)
    s_w = (r.uniform(0.5, 2, w_shape[-1]) * 1e-4).astype(np.float32)
    b = r.standard_normal(w_shape[-1]).astype(np.float32)
    ref = jdispatch.conv2d_w8a8_dispatch(
        jnp.asarray(x), jnp.float32(0.03), jnp.asarray(wq), jnp.asarray(s_w),
        jnp.asarray(b), stride=stride, s_out=jnp.float32(0.07))
    got = tdispatch.conv2d_w8a8_dispatch(T(x), 0.03, T(wq), T(s_w), T(b),
                                         stride=stride, s_out=0.07)
    eq(got, ref)


def test_kernel_wrappers_refuse_bad_inputs(r):
    a = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        tgemm.gemm_fused(a.float(), a, torch.zeros(4), torch.zeros(4))
    with pytest.raises(ValueError):
        tgemm.gemm_fused(a, a, torch.zeros(4), torch.zeros(4),
                         quantize_out=True, s_out=0.1)
    w = torch.zeros((2, 2, 64, 256), dtype=torch.int8)
    for x, exact in ((torch.zeros((1, 8, 8, 3)), True),
                     (torch.zeros((1, 8, 8, 3), dtype=torch.uint8), False)):
        for stem in (tfc.stem_fused_k2, tfc.stem_fused_dg):
            with pytest.raises(TypeError):
                stem(x, w, torch.zeros(256), torch.zeros(256), 0.1,
                     exact_u8=exact)
    with pytest.raises(ValueError):
        tfc.shift_s2d2(torch.zeros((1, 5, 4, 3), dtype=torch.int8))
    with pytest.raises(ValueError):       # padded H not a multiple of 8
        tfc.quant_space_to_depth4(torch.zeros((1, 8, 8, 3)), 0.1,
                                  pad_hw=(1, 1, 0, 0))
    with pytest.raises(TypeError):
        tfc.quant_space_to_depth4(torch.zeros((1, 8, 8, 3),
                                              dtype=torch.int8), 0.1)
    with pytest.raises(ValueError):       # channels != 4 * go
        tfc.gmax_shift_s2d2(torch.zeros((1, 4, 4, 12), dtype=torch.int8), 4)
    with pytest.raises(ValueError):       # odd H
        tfc.gmax_shift_s2d2(torch.zeros((1, 5, 4, 16), dtype=torch.int8), 4)
    x = torch.zeros((1, 7, 8, 16), dtype=torch.int8)
    w = torch.zeros((3, 3, 16, 32), dtype=torch.int8)
    sb = torch.zeros(32)
    with pytest.raises(TypeError):
        tfc.conv3x3_rs(x.float(), w, sb, sb)
    with pytest.raises(ValueError):       # w does not match x
        tfc.conv3x3_rs(x, w[:2, :2], sb, sb)
    with pytest.raises(ValueError):       # f*f*co != Cout
        tfc.conv3x3_rs(x, w, sb, sb, pool=("gmaxm", 2, 4))
    with pytest.raises(ValueError):       # odd output height
        tfc.conv3x3_rs(x, w, sb, sb, pool=("gmaxm", 2, 8), s2d_out=True)
    with pytest.raises(ValueError):
        tfc.conv3x3_rs(x, w, sb, sb, pool="pool2")


# ---------------------------------------------------------------------------
# the no-JAX rule
# ---------------------------------------------------------------------------

def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py) loads
    neither jax nor the JAX package, nor PIL (an installation may lack
    it: the port imports it where it decodes or draws an image)."""
    code = (
        "import importlib, pkgutil, sys, runpy\n"
        "import dnn_inference_engine_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "new = ['parallel.mesh', 'parallel.sharding',\n"
        "       'parallel.shard_map_forward', 'parallel.sharded_engine',\n"
        "       'runtime.serve_distributed', 'bench', 'bench_all',\n"
        "       'runtime.benchlib']\n"
        "assert all(p.__name__ + '.' + m in sys.modules for m in new)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k.startswith('dnn_inference_engine_tpu.')\n"
        "       or k == 'dnn_inference_engine_tpu'\n"
        "       or k == 'PIL' or k.startswith('PIL.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", (
        out.stdout, out.stderr)
