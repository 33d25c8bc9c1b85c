"""The host-side plan and arithmetic of the Hopper float GEMM and the
persistent k2 stem, on the CPU.

``gemm_f32``'s wgmma form (``csrc/gemm_f32.cu``) computes a float32
product as three TF32 tensor-core products of the operands' halves
(``ops/gemm.tf32_split``; two for int8 codes), with K split across blocks
where the tiles leave SMs idle; ``ops/gemm.gemm_f32_form`` picks the form,
the split and the grid from the shape alone. These tests hold the split
to its definition, emulate the kernel's products and split-K sum in
float32 at the detect paths' (K, N) against the plain version and the JAX
package's ``gemm_fused`` (interpret mode), and hold the form to every
detect shape.

``stem_fused_k2`` (``csrc/stem_fused_k2.cu``) walks (image, band) units
on a persistent grid and runs wgmma m64n256k32 with A built in registers
from the staged rows and B from a swizzled copy of the weights
(``ops/fused_conv.stem_tile_matrix``). The tests replay the schedule and
the kernel's addressing and column map in numpy against the JAX package's
``stem_fused_k2``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu.ops import pallas_conv as jpc
from dnn_inference_engine_tpu.ops import pallas_gemm as jgemm
from dnn_inference_engine_tpu.quant import quantize as jq

from dnn_inference_engine_tpu_torch.ops import conv_lowering as tcl
from dnn_inference_engine_tpu_torch.ops import dispatch as tdispatch
from dnn_inference_engine_tpu_torch.ops import fused_conv as tfc
from dnn_inference_engine_tpu_torch.ops import gemm as tgemm

SMS = 132                            # an H100 SXM
U32 = 2.0 ** -24

# (M, K, N) of the gemm_f32 launches of the fp32 auto forward at 416 px
# (the layers where use_pallas takes the gemm tier): YOLOv2-tiny b32 and
# b1, YOLOv3-tiny b16 and b1
F32_V2_B32 = [(21632, 1152, 256), (5408, 2304, 512), (5408, 4608, 1024),
              (5408, 9216, 1024), (5408, 1024, 125)]
F32_V2_B1 = [(676, 1152, 256), (169, 2304, 512), (169, 4608, 1024),
             (169, 9216, 1024), (169, 1024, 125)]
F32_V3_B16 = [(10816, 1152, 256), (2704, 2304, 512), (2704, 4608, 1024),
              (2704, 1024, 256), (2704, 2304, 512), (10816, 3456, 256)]
F32_V3_B1 = [(676, 1152, 256), (169, 2304, 512), (169, 4608, 1024),
             (169, 1024, 256), (169, 2304, 512), (676, 3456, 256)]
F32_B1 = F32_V2_B1 + F32_V3_B1
# ... and of the w8 gemm tier (kernel="pallas", every conv) of
# YOLOv2-tiny per image at 416 px; layer 0's K = 27 takes the ragged form
W8_V2 = [(173056, 27, 16), (43264, 144, 32), (10816, 288, 64),
         (2704, 576, 128), (676, 1152, 256), (169, 2304, 512),
         (169, 4608, 1024), (169, 9216, 1024), (169, 1024, 125)]
W8_DETECT = [(b * m, k, n) for b in (1, 32) for m, k, n in W8_V2 if k != 27]
DETECT = F32_V2_B32 + F32_V2_B1 + F32_V3_B16 + F32_V3_B1 + W8_DETECT


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def bits(t):
    return t.contiguous().view(torch.int32).numpy().astype(np.int64) \
        & 0xFFFFFFFF


def sum_tol(abs_sum_max, k):
    """The card test's tolerance: 8 sqrt(K) + 4 float32 half-ulps of the
    largest sum |a||b||scale|."""
    return (8 * k ** 0.5 + 4) * U32 * abs_sum_max


@pytest.fixture
def r():
    return np.random.default_rng(808)


# ---------------------------------------------------------------------------
# tf32_split
# ---------------------------------------------------------------------------

def _normals(r, n=20000):
    e = r.integers(-100, 100, n).astype(np.float64)
    x = r.uniform(1, 2, n) * 2.0 ** e * r.choice([-1, 1], n)
    return x.astype(np.float32)


def test_tf32_split_halves_have_their_low_13_bits_zero(r):
    x = T(_normals(r))
    hi, lo = tgemm.tf32_split(x)
    assert (bits(hi) & 0x1FFF == 0).all()
    assert (bits(lo) & 0x1FFF == 0).all()


def test_tf32_round_is_round_to_nearest_even(r):
    """Against an independent rounding: the significand scaled to 11
    bits and rounded half to even in float64."""
    x = _normals(r)
    m, e = np.frexp(x.astype(np.float64))
    want = np.ldexp(np.rint(m * 2.0 ** 11) / 2.0 ** 11, e).astype(np.float32)
    np.testing.assert_array_equal(tgemm.tf32_round(T(x)).numpy(), want)


def test_tf32_split_recovers_x(r):
    x = _normals(r)
    hi, lo = tgemm.tf32_split(T(x))
    rec = hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64)
    assert (np.abs(rec - x) <= 2.0 ** -22 * np.abs(x)).all()


@pytest.mark.parametrize("x,want", [
    (1 + 2 ** -11, 1.0),                      # tie, even below
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),          # tie, even above
    (1 + 2 ** -11 + 2 ** -20, 1 + 2 ** -10),  # past the tie
    (-(1 + 2 ** -11), -1.0),
    (-(1 + 3 * 2 ** -11), -(1 + 2 ** -9)),
    (2 - 2 ** -12, 2.0),                      # carries into the exponent
])
def test_tf32_round_ties_to_even(x, want):
    assert tgemm.tf32_round(torch.tensor([x], dtype=torch.float32)).item() \
        == want


def test_tf32_split_special_values():
    big = np.finfo(np.float32).max
    tiny = np.float32(1e-40)                  # subnormal
    x = torch.tensor([0.0, -0.0, np.inf, -np.inf, np.nan, tiny, -tiny, big,
                      -big], dtype=torch.float32)
    hi, lo = tgemm.tf32_split(x)
    h, lw = hi.numpy(), lo.numpy()
    assert h[0] == 0 and not np.signbit(h[0]) and lw[0] == 0
    assert h[1] == 0 and np.signbit(h[1]) and lw[1] == 0
    assert h[2] == np.inf and h[3] == -np.inf and (lw[2:5] == 0).all()
    assert np.isnan(h[4])
    # a subnormal rounds on the same grid: within half its 2**13 spacing
    for i in (5, 6):
        assert bits(hi[i:i + 1])[0] & 0x1FFF == 0
        assert abs(float(h[i]) + float(lw[i]) - float(x[i])) <= 2.0 ** -137
    # the largest floats would round to inf: truncated, lo finite
    for i in (7, 8):
        assert np.isfinite(h[i]) and np.isfinite(lw[i])
        rec = float(h[i]) + float(lw[i])
        assert abs(rec - float(x[i])) <= 2.0 ** -22 * big


def test_tf32_split_a_is_the_truncation_and_its_rounded_rest(r):
    """The kernel's split of A: hi is x with its low 13 bits dropped (as
    the tensor cores read it), lo the rest rounded to TF32; hi + lo within
    2**-21 |x|; inf and NaN give lo = 0."""
    x = _normals(r)
    hi, lo = tgemm.tf32_split_a(T(x))
    assert (bits(hi) == (bits(T(x)) & ~0x1FFF & 0xFFFFFFFF)).all()
    assert (bits(lo) & 0x1FFF == 0).all()
    np.testing.assert_array_equal(
        lo.numpy(), tgemm.tf32_round(T(x) - hi).numpy())
    rec = hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64)
    assert (np.abs(rec - x) <= 2.0 ** -21 * np.abs(x)).all()
    _, lo = tgemm.tf32_split_a(torch.tensor([np.inf, -np.inf, np.nan]))
    assert (lo == 0).all()


# ---------------------------------------------------------------------------
# The 3xTF32 product, emulated
# ---------------------------------------------------------------------------

def emulate_wgmma_f32(a, bt, splits):
    """The kernel's float32 sum of ``a @ bt.T``: A split by
    ``tf32_split_a``, B by ``tf32_split`` (an int8 B is its codes), per
    8-wide k slice the products hi*lo, lo*hi, hi*hi (lo*b, hi*b) added to
    a float32 accumulator, each split over its stages of 16, and the
    splits' sums added in split order."""
    ah, al = tgemm.tf32_split_a(a)
    if bt.dtype == torch.int8:
        terms = [(al, bt.float()), (ah, bt.float())]
    else:
        bh, bl = tgemm.tf32_split(bt)
        terms = [(ah, bl), (al, bh), (ah, bh)]
    k = a.shape[1]
    total = None
    for k0, k1 in tgemm.f32_split_ranges(k, splits):
        acc = torch.zeros((a.shape[0], bt.shape[0]), dtype=torch.float32)
        for s in range(k0, k1, 8):
            for x, y in terms:
                acc = acc + x[:, s:s + 8] @ y[:, s:s + 8].T
        total = acc if total is None else total + acc
    return total


@pytest.mark.parametrize("b_dtype", ["f32", "int8"])
@pytest.mark.parametrize("k,n", sorted({(k, n) for _, k, n in F32_V2_B32}))
def test_3xtf32_product_within_tolerance_of_plain_and_jax(b_dtype, k, n):
    """At each (K, N) of the fp32 forward (b32 and b1 share them), M = 8,
    with the split of the b1 shape: the emulated kernel sum and the
    plain version within the card test's tolerance of each other, and
    both within it of JAX's gemm_fused at Precision.HIGHEST (interpret
    mode)."""
    r = np.random.default_rng(k + n)
    m = 8
    a = (r.random((m, k)) - 0.25).astype(np.float32)
    if b_dtype == "int8":
        b = r.integers(-127, 128, (k, n)).astype(np.int8)
        scale = (r.random(n) * 1e-3).astype(np.float32)
    else:
        b = r.standard_normal((k, n)).astype(np.float32)
        scale = (r.random(n) + 0.5).astype(np.float32)
    bias = r.standard_normal(n).astype(np.float32)
    b1_m = 676 if k == 1152 else 169
    splits = tgemm.gemm_f32_form(b1_m, n, k, True, SMS).splits
    assert splits > 1
    acc = emulate_wgmma_f32(T(a), T(b.T), splits)
    emu = (acc * T(scale) + T(bias))
    emu = torch.where(emu > 0, emu, 0.1 * emu)
    plain = tgemm.gemm_f32_plain(T(a), T(b.T), T(scale), T(bias))
    want = np.asarray(jgemm.gemm_fused(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(scale), jnp.asarray(bias),
                                       act="leaky"))
    bound = float((np.abs(a).astype(np.float64) @ np.abs(b).astype(
        np.float64) * np.abs(scale)).max())
    tol = sum_tol(bound, k)
    for x, y in ((emu.numpy(), plain.numpy()), (emu.numpy(), want),
                 (plain.numpy(), want)):
        np.testing.assert_allclose(x, y, rtol=0, atol=tol)


def test_3xtf32_is_closer_than_one_tf32_product(r):
    """The point of three products: one TF32 product errs by ~2**-11 of
    each |a||b|; three by a few 2**-22, within the tolerance and two
    orders of magnitude below one product's error."""
    k, n = 4608, 64
    a = T(r.random((4, k)).astype(np.float32))
    bt = T(r.standard_normal((n, k)).astype(np.float32))
    exact = a.double() @ bt.double().T
    bound = float((a.double().abs() @ bt.double().abs().T).max())
    one = tgemm.tf32_round(a).double() @ tgemm.tf32_round(bt).double().T
    three = emulate_wgmma_f32(a, bt, 1).double()
    err1 = float((one - exact).abs().max())
    err3 = float((three - exact).abs().max())
    assert err3 <= sum_tol(bound, k) and 100 * err3 < err1


# ---------------------------------------------------------------------------
# gemm_f32_form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", DETECT)
def test_detect_shapes_take_the_wgmma_form(m, k, n):
    f = tgemm.gemm_f32_form(m, n, k, True, SMS)
    assert f.form == "wgmma"
    assert f.tiles == -(-m // 128) * -(-n // 128)
    assert 1 <= f.splits <= -(-k // 16)
    assert f.grid == min(f.tiles * f.splits, SMS)
    assert f.splits == tgemm.f32_k_splits(f.tiles, -(-k // 16), SMS)


@pytest.mark.parametrize("tiles,kt,want", [
    (338, 72, 1), (344, 576, 1), (344, 288, 1),   # b32: nearly full waves
    (172, 144, 3), (170, 72, 3), (88, 144, 3),    # a wave and a bit
    (16, 576, 8), (16, 288, 8), (8, 144, 8), (12, 72, 6), (2, 64, 6),
    (132, 2, 1), (1, 2, 1)])
def test_f32_k_splits_even_out_the_waves(tiles, kt, want):
    assert tgemm.f32_k_splits(tiles, kt, SMS) == want


@pytest.mark.parametrize("m,k,n", F32_B1)
def test_batch1_shapes_split_k(m, k, n):
    f = tgemm.gemm_f32_form(m, n, k, True, SMS)
    assert f.splits > 1
    # each split walks at least two stages, and the splits fit the card
    assert k // 16 // f.splits >= 2 or f.splits == 1
    assert f.tiles * f.splits <= SMS


@pytest.mark.parametrize("k,splits", [
    (k, s) for k in (32, 100, 1024, 1028, 1152, 3456, 9216)
    for s in (1, 2, 3, 6, 8, 16) if s <= -(-k // 16)])
def test_f32_split_ranges_cover_k_exactly(k, splits):
    ranges = tgemm.f32_split_ranges(k, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(k0 < k1 and k0 % 16 == 0 for k0, k1 in ranges)


@pytest.mark.parametrize("m,k,n,aligned", [(37, 27, 16, True),
                                           (130, 1030, 70, True),
                                           (173056, 27, 16, True),
                                           (169, 9216, 1024, False),
                                           (5408, 1024, 125, False)])
def test_ragged_shapes_take_the_ragged_form(m, k, n, aligned):
    f = tgemm.gemm_f32_form(m, n, k, aligned, SMS)
    assert f.form == "ragged" and f.splits == 1
    assert f.grid == f.tiles == -(-m // 128) * -(-n // 128)


def test_forward_weights_and_scales_are_made_once(r):
    """The gemm tiers get the cached K-major weights (``kmajor_weights``,
    also the split's cache key) and one unit column scale, and the same
    outputs as with weights transposed on the call."""
    w = T((r.standard_normal((3, 3, 128, 64)) * 0.05).astype(np.float32))
    b = T(r.standard_normal(64).astype(np.float32))
    x = T(r.random((1, 6, 6, 128)).astype(np.float32))
    wt = tgemm.kmajor_weights(w)
    assert tgemm.kmajor_weights(w) is wt
    torch.testing.assert_close(wt, tcl.gemm_weights(w), rtol=0, atol=0)
    assert tcl.unit_scale(64, "cpu") is tcl.unit_scale(64, "cpu")
    got = tdispatch.conv2d_fp32_dispatch(x, w, b, force_pallas=True)
    assert tgemm.kmajor_weights(w) is wt
    torch.testing.assert_close(got, tcl.conv2d_fp32_pallas(x, w, b),
                               rtol=0, atol=0)
    hi, lo = tgemm.tf32_operands(wt)
    assert tgemm.tf32_operands(wt)[0] is hi
    assert torch.equal(hi, tgemm.tf32_split(wt)[0])
    assert torch.equal(lo, tgemm.tf32_split(wt)[1])
    wq = T(r.integers(-127, 128, (3, 3, 128, 64)).astype(np.int8))
    codes, none = tgemm.tf32_operands(tgemm.kmajor_weights(wq))
    assert none is None and torch.equal(codes, tcl.gemm_weights(wq).float())


# ---------------------------------------------------------------------------
# stem_fused_k2: weight layout, schedule, column map
# ---------------------------------------------------------------------------

def test_stem_tile_matrix_is_a_bijection_and_cached(r):
    w = T(r.integers(-127, 128, (2, 2, 64, 256)).astype(np.int8))
    m = tfc.stem_tile_matrix(w)
    assert m.shape == (tfc.STEM_K2_TILE_BYTES,) and m.dtype == torch.int8
    idx = tfc.stem_k2_tile_index()
    assert idx.unique().numel() == idx.numel() == 256 * 192
    # every real byte at its place; everything else zero
    ref = w[:, :, :48, :].reshape(192, 256).T
    assert torch.equal(m[idx], ref)
    rest = torch.ones(tfc.STEM_K2_TILE_BYTES, dtype=torch.bool)
    rest[idx.reshape(-1)] = False
    assert (m[rest] == 0).all()
    # each output's bytes stay in its own 128-byte row (stem_k2_row, a
    # permutation of the 256 rows)
    row = tfc.stem_k2_row(torch.arange(256))
    assert (row.sort().values == torch.arange(256)).all()
    assert ((idx % (256 * 128)) // 128 == row.view(-1, 1)).all()
    assert tfc.stem_tile_matrix(w) is m
    w.add_(1)
    assert tfc.stem_tile_matrix(w) is not m


@pytest.mark.parametrize("n,max_rows,rows", [
    (1, 8, 1), (8, 8, 8), (16, 8, 8), (32, 8, 4),
    (1, 4, 1), (8, 4, 4), (32, 4, 4)])
def test_stem_k2_rows_at_416(n, max_rows, rows):
    assert tfc._stem_k2_rows(n, 104, 104, SMS, max_rows) == rows


@pytest.mark.parametrize("n,h", [(1, 416), (8, 416), (32, 416), (2, 56),
                                 (3, 64)])
def test_stem_schedule_covers_every_pixel_once(n, h):
    """The persistent schedule's replay: every (image, band) is one unit
    of one block, and the two consumers' 64-pixel tiles cover each
    output pixel of it exactly once."""
    hout = wout = h // 4
    rows = tfc._stem_k2_rows(n, hout, wout, SMS)
    bands = -(-hout // rows)
    grid = min(n * bands, SMS)
    seen = np.zeros((n, hout, wout), np.int64)
    units = set()
    for tiles in tfc.stem_k2_schedule(n, hout, wout, rows, grid):
        for img, y0, c, m0 in tiles:
            units.add((img, y0))
            band_px = min(rows, hout - y0) * wout
            assert m0 % 128 == 64 * c
            px = np.arange(m0, min(m0 + 64, band_px))
            np.add.at(seen[img], (y0 + px // wout, px % wout), 1)
    assert len(units) == n * bands
    assert (seen == 1).all()


def _stem_args(r, exact_u8):
    w = (r.standard_normal((3, 3, 3, 16)) * 0.2).astype(np.float32)
    wq, s_w = jq.quantize_weights_per_channel(jnp.asarray(w))
    b = jnp.asarray(r.standard_normal(16) * 0.1, jnp.float32)
    s_in = jnp.float32(1 / 255.0 if exact_u8 else 0.00787)
    s_out = jnp.float32(0.05)
    wf = jpc.fold_conv3x3_k2_weights(np.asarray(wq), 4, pool_major=True)
    wf = np.concatenate([wf, np.zeros((2, 2, 16, 256), np.int8)], axis=2)
    s_wt, bt = jnp.tile(s_w, 16), jnp.tile(b, 16)
    scale = (s_in * s_wt) / s_out
    if exact_u8:
        w1 = jnp.asarray(wf.reshape(-1, 256).astype(np.float32).sum(axis=0))
        bias = (bt + 128.0 * s_in * s_wt * w1) / s_out
    else:
        bias = bt / s_out
    return wf, np.asarray(scale), np.asarray(bias), np.float32(s_in)


def _staged_rows(x, img, y0, rows, s_in, exact_u8):
    """The band's staged rows as the kernel stages them: input rows 4*y0-1
    .. 4*y0+4*rows+2, element e = 3*col + c of a row at byte e + 3,
    padding u = 0 (code -128) or x = 0."""
    h, w = x.shape[1:3]
    rb = -(-3 * (w + 4) // 16) * 16
    pad = -128 if exact_u8 else 0
    st = np.full((4 * rows + 4, rb), pad, np.int64)
    for r_ in range(4 * rows + 4):
        row = 4 * y0 - 1 + r_
        if 0 <= row < h:
            v = x[img, row].reshape(-1)
            if exact_u8:
                codes = v.astype(np.int64) - 128
            else:
                q = np.rint(v.astype(np.float32) / np.float32(s_in))
                codes = np.clip(q, -127, 127).astype(np.int64)
            st[r_, 3:3 + 3 * w] = codes
    return st.reshape(-1), rb


def _group_offset(j, rb):
    tap, p = j // 12, (j % 12) // 3
    return (4 * (tap >> 1) + p) * rb + 12 * (tap & 1) + 4 * (j % 3)


@pytest.mark.parametrize("ingest", ["exact_u8", "f32"])
def test_stem_k2_column_map_replay_matches_jax(r, ingest):
    """The kernel's data flow in numpy at 64 px, b2, under its own
    schedule: A fragments read from the staged rows by the 4-byte
    shifted-s2d addressing (rows g and g + 8 of each warp, bytes 4t and
    16 + 4t of each k32 slice), B read back from ``stem_tile_matrix``
    through the swizzle by physical row, the int32 products of the two
    m64n128 halves, the
    group-max over each thread's columns 8j + 2t + e (j, j + 4, j + 8,
    j + 12) of each n128 half, the epilogue: equal to JAX's stem_fused_k2
    (interpret mode)."""
    exact = ingest == "exact_u8"
    xu = r.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    x = xu.astype(np.float32) / 255.0 if not exact else xu
    wf, scale, bias, s_in = _stem_args(r, exact)
    ref = np.asarray(jpc.stem_fused_k2(jnp.asarray(x), jnp.asarray(wf),
                                       scale, bias, s_in, exact_u8=exact))
    n, hout, wout = 2, 16, 16
    # B as the kernel sees it: physical row R of shared memory, byte k of
    # K atom k // 128 at chunk (k % 128) // 16 XOR R % 8
    tiles = tfc.stem_tile_matrix(T(wf)).numpy().astype(np.int64)
    rows_ = np.arange(256).reshape(-1, 1)
    k = np.arange(192).reshape(1, -1)
    bphys = tiles[(k // 128) * 256 * 128 + rows_ * 128
                  + (((k % 128) // 16) ^ (rows_ % 8)) * 16 + k % 16]
    rows = tfc._stem_k2_rows(n, hout, wout, SMS)
    grid = min(n * -(-hout // rows), SMS)
    out = np.zeros((n, hout, wout, 64), np.int8)
    for block in tfc.stem_k2_schedule(n, hout, wout, rows, grid):
        for img, y0, c, m0 in block:
            staged, rb = _staged_rows(x, img, y0, rows, s_in, exact)
            band_px = min(rows, hout - y0) * wout
            a = np.zeros((64, 192), np.int64)
            for wq_ in range(4):                        # consumer warps
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    for hh in (0, 1):
                        m = m0 + 16 * wq_ + g + 8 * hh
                        mm = m if m < band_px else 0
                        base = 4 * (mm // wout) * rb + 12 * (mm % wout)
                        for kc in range(6):
                            for half in (0, 1):
                                j = kc * 8 + half * 4 + t
                                o = base + _group_offset(j, rb)
                                a[16 * wq_ + g + 8 * hh,
                                  32 * kc + 16 * half + 4 * t:
                                  32 * kc + 16 * half + 4 * t + 4] = \
                                    staged[o:o + 4]
            for hf in (0, 1):                           # the two n128 tiles
                acc = a @ bphys[128 * hf:128 * hf + 128].T
                assert np.abs(acc).max() < 2 ** 31
                for t in range(4):
                    for jj in range(4):
                        for e in (0, 1):
                            ch = 32 * hf + 8 * jj + 2 * t + e
                            # thread t's columns 8 j + 2 t + e, j = jj + 4 gi
                            cols = [8 * (jj + 4 * gi) + 2 * t + e
                                    for gi in range(4)]
                            v = acc[:, cols].max(axis=1).astype(np.float32)
                            y = (v * scale[ch]).astype(np.float32) + bias[ch]
                            y = np.where(y > 0, y, np.float32(0.1) * y)
                            q = np.clip(np.rint(y), -127, 127).astype(np.int8)
                            for i in range(64):
                                m = m0 + i
                                if m < band_px:
                                    out[img, y0 + m // wout, m % wout,
                                        ch] = q[i]
    np.testing.assert_array_equal(out, ref)
