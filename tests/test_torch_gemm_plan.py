"""The host-side plan of the Hopper int8 mainloop, on the CPU.

``gemm_fused`` and ``conv3x3_rs`` launch one shared mainloop
(``csrc/wgmma_s8.cuh``) whose form, block tile, K-split and grid the
wrappers choose from the shape alone (``ops/gemm.gemm_form``,
``ops/fused_conv.rs_form``). These tests hold those choices to the
main-path shapes, show that a split of K cannot move a code (int32 sums
over the splits equal the whole sum), and replay the conv kernel's
pool-major tile mapping in numpy against the JAX package's
``conv3x3_rs``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu.ops import pallas_conv as jpc
from dnn_inference_engine_tpu.ops import pallas_gemm as jgemm

from dnn_inference_engine_tpu_torch.ops import fused_conv as tfc
from dnn_inference_engine_tpu_torch.ops import gemm as tgemm

SMS = 132                            # an H100 SXM

# (M, K, N) of every gemm_fused launch of one forward at 416 px under the
# W8A8 pins: YOLOv2-tiny b32 and b1 (its own folds: L4 is a fold-2 3x3,
# not the b32 pin's k2 fold), YOLOv3-tiny b16 and b1; N = 125 and 75 are
# the f32 heads
V2_B32 = [(346112, 576, 128), (86528, 512, 256), (86528, 576, 128),
          (21632, 1152, 256), (5408, 2304, 512), (5408, 4608, 1024),
          (5408, 9216, 1024), (5408, 1024, 125)]
V2_B1 = [(10816, 576, 128), (2704, 1152, 256), (2704, 576, 128),
         (676, 1152, 256), (169, 2304, 512), (169, 4608, 1024),
         (169, 9216, 1024), (169, 1024, 125)]
V3_B16 = [(173056, 576, 128), (43264, 512, 256), (43264, 576, 128),
          (10816, 1152, 256), (2704, 2304, 512), (2704, 4608, 1024),
          (2704, 1024, 256), (2704, 2304, 512), (2704, 512, 75),
          (2704, 256, 128), (10816, 3456, 256), (10816, 256, 75)]
V3_B1 = [(10816, 576, 128), (2704, 512, 256), (2704, 576, 128),
         (676, 1152, 256), (169, 2304, 512), (169, 4608, 1024),
         (169, 1024, 256), (169, 2304, 512), (169, 512, 75),
         (169, 256, 128), (676, 3456, 256), (676, 256, 75)]
MAIN = V2_B32 + V2_B1 + V3_B16 + V3_B1


@pytest.fixture
def r():
    return np.random.default_rng(77)


@pytest.mark.parametrize("m,k,n", MAIN)
def test_main_path_shapes_take_the_wgmma_form(m, k, n):
    f = tgemm.gemm_form(m, n, k, True, SMS)
    assert f.form == "wgmma"
    assert f.tiles == -(-m // 128) * -(-n // 128)
    assert 1 <= f.splits <= -(-k // 128)
    assert f.grid == min(f.tiles * f.splits, SMS)
    # K is split exactly where the tiles alone leave SMs idle
    assert (f.splits > 1) == (2 * f.tiles <= SMS and k > 384)


@pytest.mark.parametrize("m,k,n", [(169, 1152, 256), (169, 9216, 1024),
                                   (169, 1024, 125), (5408, 1024, 125),
                                   (2704, 512, 75), (169, 512, 75)])
def test_batch1_layers_and_heads_split_k(m, k, n):
    """b1's L8-L14 (M 169 here), b32's L14 and the YOLOv3 heads."""
    assert tgemm.gemm_form(m, n, k, True, SMS).splits > 1


@pytest.mark.parametrize("m,k,n,aligned", [(169, 27, 16, True),
                                           (130, 100, 64, True),
                                           (5408, 1024, 125, False),
                                           (300, 576, 125, False)])
def test_ragged_shapes_take_the_ragged_form(m, k, n, aligned):
    """K % 16 != 0 (the generic tier's first conv, K = 27) or an operand
    off 16-byte alignment: the mma.sync form, unsplit."""
    f = tgemm.gemm_form(m, n, k, aligned, SMS)
    assert f.form == "ragged" and f.splits == 1
    assert f.grid == f.tiles == -(-m // 128) * -(-n // 128)


@pytest.mark.parametrize("k", [16, 32, 128, 200, 576, 1024, 4608, 9216])
def test_split_ranges_cover_k_exactly(k):
    for splits in range(1, -(-k // 128) + 1):
        ranges = tgemm.split_ranges(k, splits)
        assert len(ranges) == splits
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0
        for k0, k1 in ranges:
            assert k0 < k1 and k0 % 128 == 0


@pytest.mark.parametrize("tiles,kt,want", [(2704, 5, 1), (132, 72, 1),
                                           (16, 72, 6), (16, 36, 4),
                                           (8, 18, 3), (2, 8, 2), (43, 8, 2),
                                           (22, 4, 2), (85, 5, 1), (1, 1, 1),
                                           (1, 2, 1), (1, 800, 16)])
def test_k_splits(tiles, kt, want):
    assert tgemm.k_splits(tiles, kt, SMS) == want


@pytest.mark.parametrize("m,k,n,splits", [(169, 9216, 1024, 8),
                                          (300, 576, 125, 2),
                                          (64, 4608, 32, 5)])
def test_split_k_sum_equals_the_whole_sum(r, m, k, n, splits):
    """int32 partial sums over the split ranges add up to the whole
    product, and to the JAX package's int32 accumulator: the order of an
    int32 sum cannot move a code."""
    a = r.integers(-127, 128, (m, k)).astype(np.int8)
    b = r.integers(-127, 128, (n, k)).astype(np.int8)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    whole = tgemm.int32_acc_plain(at, bt)
    parts = [tgemm.int32_acc_plain(at[:, k0:k1], bt[:, k0:k1])
             for k0, k1 in tgemm.split_ranges(k, splits)]
    assert torch.equal(torch.stack(parts).sum(0, dtype=torch.int32), whole)
    ref = jgemm.gemm_fused(jnp.asarray(a), jnp.asarray(b.T),
                           jnp.ones(n, jnp.float32),
                           jnp.zeros(n, jnp.float32), act="linear",
                           raw_acc=True)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(ref))


@pytest.mark.parametrize("m,cout,go,k,splits", [
    (21632, 512, 128, 1024, 1), (5408, 1024, 256, 4608, 1),
    (346112, 128, 32, 576, 1), (86528, 256, 64, 512, 1),
    (676, 512, 128, 1024, 2), (169, 1024, 256, 4608, 4),
    (169, 1024, 0, 4608, 4)])
def test_rs_form_splits_the_batch1_stages(m, cout, go, k, splits):
    """S1 and S2's b32 stages fill the card unsplit; S1's b1 stages (and
    pool None at b1) split K."""
    f = tfc.rs_form(m, cout, go, k, SMS)
    n_tiles = -(-go // 32) if go else -(-cout // 128)
    assert f.form == "wgmma"
    assert f.tiles == -(-m // 128) * n_tiles and f.splits == splits


def _wgmma_columns(t: int, bn: int = 128):
    """The accumulator columns a thread of quad position t holds under
    wgmma m64nNk32's layout: 8i + 2t + e, register 4i + 2h + e."""
    return {4 * i + e: 8 * i + 2 * t + e for i in range(bn // 8)
            for e in (0, 1)}


@pytest.mark.parametrize("h,w,cin,go,k", [(9, 11, 32, 16, 3),
                                          (13, 13, 64, 32, 3),
                                          (9, 9, 64, 48, 2),
                                          (6, 7, 16, 80, 3)])
def test_conv_rs_pool_major_tile_mapping_matches_jax(r, h, w, cin, go, k):
    """The kernel's 'gmaxm' mapping, replayed in numpy: tile j reads rows
    128j..128j+127 of ``rs_tile_matrix`` (channels 32j..32j+31 of each pool
    group k in rows 32k.., zeros past go), and each thread takes the max
    over its own registers r, r+16, r+32, r+48. The codes equal the JAX
    package's conv3x3_rs (and the port's plain version)."""
    n, cout = 2, 4 * go
    x = r.integers(-127, 128, (n, h, w, cin)).astype(np.int8)
    wq = r.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    scale = (r.uniform(0.5, 2, cout) * 1e-4).astype(np.float32)
    bias = r.standard_normal(cout).astype(np.float32)
    kw = dict(quantize_out=True, pool=("gmaxm", 2, go), ksize=k)
    ref = np.asarray(jpc.conv3x3_rs(jnp.asarray(x), jnp.asarray(wq),
                                    jnp.asarray(scale), jnp.asarray(bias),
                                    **kw))
    plain = tfc.conv3x3_rs_plain(torch.from_numpy(x), torch.from_numpy(wq),
                                 torch.from_numpy(scale),
                                 torch.from_numpy(bias), **kw).numpy()
    np.testing.assert_array_equal(plain, ref)

    tiles = tfc.rs_tile_matrix(torch.from_numpy(wq), go).numpy()
    tiles = tiles.astype(np.int64)
    assert tiles.shape == (-(-go // 32) * 128, k * k * cin)
    pad = (k == 3)
    ho, wo = (h, w) if k == 3 else (h - 1, w - 1)
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    a = np.concatenate([xp[:, dh:dh + ho, dw:dw + wo] for dh in range(k)
                        for dw in range(k)], axis=-1)
    a = a.reshape(n * ho * wo, -1).astype(np.int64)
    out = np.zeros((n * ho * wo, go), np.int64)
    for j in range(-(-go // 32)):
        acc = a @ tiles[128 * j:128 * (j + 1)].T     # (M, 128) of the tile
        for t in range(4):
            cols = _wgmma_columns(t)
            for reg in range(16):                    # group 0's registers
                if reg % 4 >= 2:                     # rows g + 8: same cols
                    continue
                ch_cols = [cols[reg + 16 * g] for g in range(4)]
                # one channel of all four groups in one thread
                assert len({c % 32 for c in ch_cols}) == 1
                assert [c // 32 for c in ch_cols] == [0, 1, 2, 3]
                ch = 32 * j + ch_cols[0]
                if ch < go:
                    out[:, ch] = acc[:, ch_cols].max(axis=1)
    y = out.astype(np.float32) * scale[:go] + bias[:go]
    y = np.where(y > 0, y, np.float32(0.1) * y)
    q = np.clip(np.round(y), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(q.reshape(n, ho, wo, go), ref)


@pytest.mark.parametrize("go", [16, 32, 48, 256])
def test_rs_tile_matrix_layout_and_cache(r, go):
    """Row 128j + 32k + i of the pool-major matrix is output column
    k*go + 32j + i of ``rs_weight_matrix`` (zeros past go); cached per go
    until the weights are written in place."""
    w = torch.from_numpy(r.integers(-127, 128, (3, 3, 16, 4 * go)).astype(
        np.int8))
    base = tfc.rs_weight_matrix(w)
    m = tfc.rs_tile_matrix(w, go)
    assert tfc.rs_tile_matrix(w, 0) is base
    for j in range(-(-go // 32)):
        for k in range(4):
            for i in range(32):
                row = m[128 * j + 32 * k + i]
                if 32 * j + i < go:
                    assert torch.equal(row, base[k * go + 32 * j + i])
                else:
                    assert not row.any()
    assert tfc.rs_tile_matrix(w, go) is m
    w[0, 0, 0, 0] = 0 if int(w[0, 0, 0, 0]) else 1
    assert tfc.rs_tile_matrix(w, go) is not m


# the 1x1 convs of those forwards, which stay GEMMs (the 3x3 convs are the
# conv_w8a8 kernel's, ops/conv.conv_w8a8_form)
V2_B1_1X1 = [(169, 1024, 125)]
V3_B1_1X1 = [(169, 1024, 256), (169, 512, 75), (169, 256, 128),
             (676, 256, 75)]


def test_batch1_pins_launch_the_table_shapes():
    """The W8A8 b1 pins of both models at 416 px, on the CPU: the (M, K,
    N) of their int8 convs are exactly the b1 tables above, the 1x1 convs
    as gemm_fused calls and every other one on the conv_w8a8 kernel's
    route (the card's chip_smoke.py checks its b32 and b16 tables the
    same way)."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.ops import conv as tconv
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    fn, seen = tgemm.gemm_fused, []
    kernel_fn, convs = tconv.conv2d_w8a8_plain, []

    def record(a, bt, *args, **kw):
        seen.append((int(a.shape[0]), int(a.shape[1]), int(bt.shape[0])))
        return fn(a, bt, *args, **kw)

    def record_conv(xq, s_in, wq, *args, **kw):
        y = kernel_fn(xq, s_in, wq, *args, **kw)
        kh, kw_, cin, cout = wq.shape
        convs.append((int(y.shape[0] * y.shape[1] * y.shape[2]),
                      int(kh * kw_ * cin), int(cout)))
        return y
    for model, table, gemms in (("yolov2-tiny", V2_B1, V2_B1_1X1),
                                ("yolov3-tiny", V3_B1, V3_B1_1X1)):
        eng = Engine(EngineConfig(model=model, mode="w8a8", batch=1),
                     device="cpu").load_weights(seed=0).prepare()
        img = np.zeros((1, 416, 416, 3), np.uint8)
        seen.clear()
        convs.clear()
        try:
            tgemm.gemm_fused = tconv.gemm_fused = record
            tconv.conv2d_w8a8_plain = record_conv
            eng.detect(img)
        finally:
            tgemm.gemm_fused = tconv.gemm_fused = fn
            tconv.conv2d_w8a8_plain = kernel_fn
        assert sorted(seen) == sorted(gemms), model
        assert sorted(seen + convs) == sorted(table), model
