"""The port's attic kernels against the JAX package's, on the CPU.

``ops/attic/stage0.py`` (stage0_fused, stage0_fused_v2 and their operand
builders) and ``ops/attic/tail.py`` (conv3x3_bt, conv2d_w8a8_bt). Inputs
are made with numpy from a seed; the JAX Pallas kernels run in interpret
mode, the port's wrappers take their plain versions for CPU tensors.

Stage-0 codes are identical. The JAX tail kernel runs under ``jax.jit``,
and XLA on the CPU contracts its acc*scale + bias into one FMA, where the
port rounds the product and the sum apart: both results are pinned
exactly, JAX's to the single rounding and the port's to the double one,
each computed here in numpy from the exact int32 accumulator.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu.ops.attic import pallas_stage0 as jst0
from dnn_inference_engine_tpu.ops.attic import pallas_tail as jtail
from dnn_inference_engine_tpu.quant.quantize import (
    quantize_weights_per_channel as jquantize_w)

from dnn_inference_engine_tpu_torch.ops.attic import stage0 as st0
from dnn_inference_engine_tpu_torch.ops.attic import tail
from dnn_inference_engine_tpu_torch.ops.fused_conv import conv3x3_rs_plain


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def eq(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture
def r():
    return np.random.default_rng(4321)


def _conv1(r):
    """Quantized conv1 params (3,3,3,16) as the JAX package makes them,
    and scales whose reciprocals are inexact."""
    w = (r.standard_normal((3, 3, 3, 16)) * 0.2).astype(np.float32)
    wq, s_w = jquantize_w(jnp.asarray(w))
    b = (r.standard_normal(16) * 0.1).astype(np.float32)
    return np.asarray(wq), np.asarray(s_w), b, 0.00789, 0.0511


# ---------------------------------------------------------------------------
# stage 0: operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ht", [4, 8])
def test_stage0_v1_operands_match_jax(r, ht):
    wq, s_w, b, s_in, s_out = _conv1(r)
    for got, want in zip(st0.build_stage0_weights(wq, s_w, b, s_in, s_out),
                         jst0.build_stage0_weights(wq, s_w, b, s_in, s_out)):
        eq(got, want)
    wk = jst0.build_stage0_weights(wq, s_w, b, s_in, s_out)[0]
    eq(st0.expand_stage0_weights(wk, ht), jst0.expand_stage0_weights(wk, ht))
    for got, want in zip(st0.stage0_params(T(wq), T(s_w), T(b), s_in, s_out,
                                           ht=ht),
                         jst0.stage0_params(wq, s_w, b, s_in, s_out, ht=ht)):
        eq(got, want)


def test_stage0_v2_operands_match_jax(r):
    wq, s_w, b, s_in, s_out = _conv1(r)
    for got, want in zip(
            st0.build_stage0_weights_v2(wq, s_w, b, s_in, s_out),
            jst0.build_stage0_weights_v2(wq, s_w, b, s_in, s_out)):
        eq(got, want)
    for got, want in zip(st0.stage0_params_v2(wq, s_w, b, s_in, s_out),
                         jst0.stage0_params_v2(wq, s_w, b, s_in, s_out)):
        eq(got, want)


def _dense_k_reference(wq):
    """B (128, 256) from its definition: row k = r6*18 + c6*3 + ch is
    patch pixel (raw row 4i-1+r6, column 4j-1+c6, channel ch); column
    g*16 + co of pool-major group g = (u*2+v)*4 + (a*2+b) is the conv
    output at (4i + 2a+u, 4j + 2b+v), whose tap is (dh, dw) = (r6-1 -
    (2a+u), c6-1 - (2b+v))."""
    b = np.zeros((128, 256), np.int8)
    for r6 in range(6):
        for c6 in range(6):
            for ch in range(3):
                for r in range(4):
                    for q in range(4):
                        dh, dw = r6 - 1 - r, c6 - 1 - q
                        if abs(dh) > 1 or abs(dw) > 1:
                            continue
                        g = ((r % 2) * 2 + q % 2) * 4 + (r // 2) * 2 + q // 2
                        b[r6 * 18 + c6 * 3 + ch, g * 16:(g + 1) * 16] = \
                            wq[dh + 1, dw + 1, ch]
    return b


@pytest.mark.parametrize("ht", [4, 8])
def test_dense_k_from_v1_equals_from_v2(r, ht):
    """Both index gathers give the same B from the JAX package's own
    operands for one conv1, and that B is the definition's."""
    wq, s_w, b, s_in, s_out = _conv1(r)
    wb, _, _ = jst0.stage0_params(wq, s_w, b, s_in, s_out, ht=ht)
    wv, _, _ = jst0.stage0_params_v2(wq, s_w, b, s_in, s_out)
    b1 = st0.dense_k_from_v1(T(wb), ht)
    b2 = st0.dense_k_from_v2(T(wv))
    assert tuple(b1.shape) == (128, 256) and b1.dtype == torch.int8
    eq(b1, b2)
    eq(b1, _dense_k_reference(wq))


def test_dense_k_is_cached_on_the_operand(r):
    wq, s_w, b, s_in, s_out = _conv1(r)
    wv = T(st0.build_stage0_weights_v2(wq, s_w, b, s_in, s_out)[0])
    m = st0.dense_k_from_v2(wv)
    assert st0.dense_k_from_v2(wv).t().data_ptr() == m.t().data_ptr()
    assert m.t().is_contiguous()                 # the kernel's K-major copy
    wv[1, 12, 0] += 1                            # written in place
    assert not torch.equal(st0.dense_k_from_v2(wv), m)


# ---------------------------------------------------------------------------
# stage 0: the function
# ---------------------------------------------------------------------------

def _stage0_epilogue(s_w, b, s_in, s_out):
    """The JAX s0 plan stage's scale and bias (f32 s_in/s_out first)."""
    s_in, s_out = np.float32(s_in), np.float32(s_out)
    return np.tile(s_w, 4) * (s_in / s_out), np.tile(b, 4) / s_out


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 416, 416, 3),
                                   (1, 40, 56, 3)])
def test_stage0_fused_v2_matches_jax(r, shape):
    wq, s_w, b, s_in, s_out = _conv1(r)
    wv, _, _ = jst0.build_stage0_weights_v2(
        wq, np.ones(16, np.float32), np.zeros(16, np.float32), 1.0, 1.0)
    scale, bias = _stage0_epilogue(s_w, b, s_in, s_out)
    x = r.uniform(-0.1, 1.1, shape).astype(np.float32)
    ref = jst0.stage0_fused_v2(jnp.asarray(x), jnp.asarray(wv),
                               jnp.asarray(scale), jnp.asarray(bias),
                               jnp.float32(s_in))
    got = st0.stage0_fused_v2(T(x), T(wv), T(scale), T(bias), s_in)
    assert tuple(got.shape) == (shape[0], shape[1] // 4, shape[2] // 4, 64)
    eq(got, ref)


@pytest.mark.parametrize("ht", [4, 8])
def test_stage0_fused_v1_matches_jax(r, ht):
    wq, s_w, b, s_in, s_out = _conv1(r)
    wb, scale, bias = jst0.stage0_params(wq, s_w, b, s_in, s_out, ht=ht)
    x = r.uniform(0, 1, (1, 416, 416, 3)).astype(np.float32)
    ref = jst0.stage0_fused(jnp.asarray(x), wb, scale, bias, s_in, ht=ht)
    got = st0.stage0_fused(T(x), T(wb), T(scale), T(bias), s_in, ht=ht)
    eq(got, ref)
    wv, _, _ = st0.stage0_params_v2(wq, s_w, b, s_in, s_out)
    eq(st0.stage0_fused_v2(T(x), wv, T(scale), T(bias), s_in), ref)


def test_stage0_wrappers_refuse_bad_inputs(r):
    wq, s_w, b, s_in, s_out = _conv1(r)
    wv, scale, bias = st0.stage0_params_v2(wq, s_w, b, s_in, s_out)
    wb, _, _ = st0.stage0_params(wq, s_w, b, s_in, s_out)
    with pytest.raises(ValueError):             # H not a multiple of 8
        st0.stage0_fused_v2(torch.zeros((1, 12, 16, 3)), wv, scale, bias, 0.1)
    with pytest.raises(TypeError):              # the wire format, not f32
        st0.stage0_fused_v2(torch.zeros((1, 16, 16, 3), dtype=torch.uint8),
                            wv, scale, bias, 0.1)
    with pytest.raises(ValueError):             # v1 is 416 px only
        st0.stage0_fused(torch.zeros((1, 64, 64, 3)), wb, scale, bias, 0.1)
    with pytest.raises(ValueError):             # wb of another ht
        st0.stage0_fused(torch.zeros((1, 416, 416, 3)), wb, scale, bias,
                         0.1, ht=8)
    with pytest.raises(ValueError):             # scale not (64,)
        st0.stage0_fused_v2(torch.zeros((1, 16, 16, 3)), wv,
                            torch.zeros(256), bias, 0.1)


# ---------------------------------------------------------------------------
# the tail conv
# ---------------------------------------------------------------------------

def _bt_y(x, wq, scale, bias, act, fused):
    """conv3x3_bt's epilogue in numpy from the exact int32 accumulator:
    ``fused`` rounds acc*scale + bias once (an FMA), else twice."""
    n, h, wd, _ = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0))).astype(np.int64)
    a = np.concatenate([xp[:, i:i + h, j:j + wd] for i in range(3)
                        for j in range(3)], axis=-1)
    acc = a @ wq.reshape(-1, wq.shape[-1]).astype(np.int64)
    if fused:
        y = (acc.astype(np.float64) * scale.astype(np.float64)
             + bias.astype(np.float64)).astype(np.float32)
    else:
        y = acc.astype(np.float32) * scale + bias
    if act == "leaky":
        y = np.where(y > 0, y, np.float32(0.1) * y)
    return y


@pytest.mark.parametrize("s_out", [0.0613, None])
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (2, 13, 13, 128, 256), (3, 13, 13, 256, 128), (2, 26, 26, 128, 128),
    (1, 8, 8, 128, 128), (1, 13, 13, 128, 512)])
def test_conv2d_w8a8_bt_matches_jax(r, n, h, w, cin, cout, s_out):
    """The shapes of tests/test_pallas_tail.py and Cout 512; int8 and f32
    out, each side pinned to its own rounding."""
    xq = r.integers(-127, 128, (n, h, w, cin)).astype(np.int8)
    wq = r.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    s_w = r.uniform(1e-3, 1e-2, cout).astype(np.float32)
    b = r.standard_normal(cout).astype(np.float32)
    s_in = np.float32(0.0217)
    ref = jtail.conv2d_w8a8_bt(
        jnp.asarray(xq), s_in, jnp.asarray(wq), jnp.asarray(s_w),
        jnp.asarray(b), s_out=None if s_out is None else jnp.float32(s_out))
    got = tail.conv2d_w8a8_bt(T(xq), 0.0217, T(wq), T(s_w), T(b),
                              s_out=s_out)
    assert tuple(got.shape) == (n, h, w, cout)
    scale, bias = s_in * s_w, b
    if s_out is not None:
        scale, bias = scale / np.float32(s_out), bias / np.float32(s_out)
    want = [_bt_y(xq, wq, scale, bias, "leaky", fused)
            for fused in (True, False)]
    if s_out is not None:
        want = [np.clip(np.round(y), -127, 127).astype(np.int8)
                for y in want]
        eq(got, ref)                    # no code lies on a rounding edge here
    eq(ref, want[0])
    eq(got, want[1])


@pytest.mark.parametrize("act", ["leaky", "linear", "relu"])
@pytest.mark.parametrize("quantize_out", [True, False])
def test_conv3x3_bt_plain_equals_conv3x3_rs_plain(r, act, quantize_out):
    """The tap-shift formulation computes conv3x3_rs's pool-None function,
    the card kernel's cross-check."""
    x = T(r.integers(-127, 128, (3, 7, 9, 128)).astype(np.int8))
    w = T(r.integers(-127, 128, (3, 3, 128, 64)).astype(np.int8))
    scale = T((r.uniform(0.5, 2, 64) * 1e-4).astype(np.float32))
    bias = T(r.standard_normal(64).astype(np.float32))
    got = tail.conv3x3_bt(x, w, scale, bias, act=act,
                          quantize_out=quantize_out)
    eq(got, conv3x3_rs_plain(x, w, scale, bias, act=act,
                             quantize_out=quantize_out))


def test_conv3x3_bt_refuses_what_jax_asserts():
    sb = torch.zeros(128)
    w = torch.zeros((3, 3, 128, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="Cin"):
        tail.conv3x3_bt(torch.zeros((1, 8, 8, 64), dtype=torch.int8),
                        w[:, :, :64], sb, sb)
    with pytest.raises(ValueError, match="W <= 31"):
        tail.conv3x3_bt(torch.zeros((1, 8, 32, 128), dtype=torch.int8), w,
                        sb, sb)
    with pytest.raises(ValueError):             # not 3x3
        tail.conv3x3_bt(torch.zeros((1, 8, 8, 128), dtype=torch.int8),
                        w[:1, :1], sb, sb)
    with pytest.raises(TypeError):
        tail.conv3x3_bt(torch.zeros((1, 8, 8, 128)), w, sb, sb)
    with pytest.raises(ValueError, match="stride"):
        tail.conv2d_w8a8_bt(torch.zeros((1, 8, 8, 128), dtype=torch.int8),
                            0.1, w, sb, sb, stride=2)
