"""The host-side plan and data flow of the persistent stem mainloop's
``stage0_fused`` and ``stem_fused_dg``, on the CPU.

Both kernels (``csrc/stage0_fused.cu``, ``csrc/stem_fused_dg.cu``) run
``csrc/stem_common.cuh``'s persistent ``wgmma`` mainloop, as the k2 stem
does: units (image, band) on a persistent grid (``fused_conv.stem_grid``,
``stem_k2_schedule``), A read into registers straight from the staged
input rows, B from a swizzled tile in shared memory, the group-max in
registers. ``stage0_fused`` lays each 18-byte patch row as a 20-byte run
of K (``attic/stage0.stage0_tile_matrix``), so that each 4-byte group of
A is one aligned word of one staged row; ``stem_fused_dg`` lays the JAX
package's per-tap slabs into the k2 stem's tile inside the kernel. These
tests replay the schedule, both B layouts and the kernels' addressing,
products, group-max and epilogue in numpy, against the JAX package's
kernels (interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu.ops import pallas_conv as jpc
from dnn_inference_engine_tpu.ops.attic import pallas_stage0 as jst0
from dnn_inference_engine_tpu.quant import quantize as jq

from dnn_inference_engine_tpu_torch.ops import fused_conv as tfc
from dnn_inference_engine_tpu_torch.ops.attic import stage0 as st0

SMS = 132                            # an H100 SXM
SMEM = 232448                        # shared memory a block may opt into
UNSET = 1000                         # a tile byte the kernel never writes


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def eq(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture
def r():
    return np.random.default_rng(909)


# ---------------------------------------------------------------------------
# the kernels' rules, written out as the CUDA source states them
# ---------------------------------------------------------------------------

def _k2_offset(j, rb):
    """K2Addr::offset: 4-lane group j of the 4 taps x 48 lanes."""
    tap, p = j // 12, (j % 12) // 3
    return (4 * (tap >> 1) + p) * rb + 12 * (tap & 1) + 4 * (j % 3)


def _s0_offset(j, rb):
    """Stage0Addr::offset: group j of patch row j // 5's 20-byte run."""
    return (j // 5) * rb + 4 * (j % 5) if j < 30 else 0


# (offset, k32 steps, staged rows beyond 4 a band row, K atoms of B)
K2 = (_k2_offset, 6, 4, 2)
S0 = (_s0_offset, 4, 2, 1)


def _rb(w):
    return -(-3 * (w + 4) // 16) * 16


def _smem(w, rows, halo, atoms, esize):
    """stem::smem_bytes with the raw rows of ``esize``-byte elements."""
    nr = 4 * rows + halo
    return (1024 + atoms * 256 * 128 + 2 * nr * _rb(w)
            + -(-nr * 3 * w * esize // 16) * 16 + 2 * 64 * 4 + 6 * 8)


def _stem_row(o):
    return (o % 64) // 32 * 128 + (o // 64) * 32 + o % 32


def _bphys(tile, atoms):
    """B as wgmma reads it: physical row R, K byte k of atom k // 128 at
    chunk (k % 128) // 16 XOR R % 8."""
    rows = np.arange(256).reshape(-1, 1)
    k = np.arange(128 * atoms).reshape(1, -1)
    return tile[(k // 128) * 256 * 128 + rows * 128
                + (((k % 128) // 16) ^ (rows % 8)) * 16 + k % 16]


def _staged(x, img, y0, nr, s_in, exact):
    """A band's staged rows as the producer converts them: input rows
    4*y0-1 .. 4*y0-2+nr, element e = 3*col + c of a row at byte e + 3,
    padding u = 0 (code -128) or x = 0."""
    h, w = x.shape[1:3]
    st = np.full((nr, _rb(w)), -128 if exact else 0, np.int64)
    for r_ in range(nr):
        row = 4 * y0 - 1 + r_
        if 0 <= row < h:
            v = x[img, row].reshape(-1)
            if exact:
                codes = v.astype(np.int64) - 128
            else:
                q = np.rint(v.astype(np.float32) / np.float32(s_in))
                codes = np.clip(q, -127, 127).astype(np.int64)
            st[r_, 3:3 + 3 * w] = codes
    return st.reshape(-1)


def _replay(x, tile, policy, max_rows, scale, bias, s_in, exact):
    """The mainloop in numpy under its own schedule: each thread's A
    fragment (rows 16 w + g + 8 h of a 64-pixel tile, 4-byte groups 8 kc
    + 4 half + t of k32 step kc) read from the staged rows at the policy's
    offsets, the int32 products of the two n128 halves of B, the group-max
    over a thread's columns 8 (jj + 4 gi) + 2t + e, the epilogue with its
    float32 roundings, the store of the valid pixels."""
    offset, ksteps, halo, atoms = policy
    n, h, w = x.shape[:3]
    hout, wout = h // 4, w // 4
    rows, grid = tfc.stem_grid(n, hout, wout, SMS, max_rows)
    nr, rb = 4 * rows + halo, _rb(w)
    bphys = _bphys(tile, atoms)[:, :32 * ksteps]
    assert (bphys != UNSET).all()
    wq, g, t, hh, kc, half = (a.ravel() for a in np.meshgrid(
        range(4), range(8), range(4), range(2), range(ksteps), range(2),
        indexing="ij"))
    arow, grp = 16 * wq + g + 8 * hh, 8 * kc + 4 * half + t
    koff = np.array([offset(j, rb) for j in range(8 * ksteps)])
    # thread t's accumulator columns and the channel each pair gives
    t_, jj, e, gi = np.meshgrid(range(4), range(4), range(2), range(4),
                                indexing="ij")
    cols = (8 * (jj + 4 * gi) + 2 * t_ + e).reshape(-1, 4)
    chs = (8 * jj + 2 * t_ + e).reshape(-1, 4)[:, 0]
    out = np.full((n, hout, wout, 64), UNSET, np.int64)
    staged = {}
    for block in tfc.stem_k2_schedule(n, hout, wout, rows, grid):
        for img, y0, c, m0 in block:
            if (img, y0) not in staged:
                staged = {(img, y0): _staged(x, img, y0, nr, s_in, exact)}
            st = staged[(img, y0)]
            band_px = min(rows, hout - y0) * wout
            m = m0 + arow
            mm = np.where(m < band_px, m, 0)
            base = 4 * (mm // wout) * rb + 12 * (mm % wout)
            a = np.zeros((64, 32 * ksteps), np.int64)
            a[arow[:, None], 4 * grp[:, None] + np.arange(4)] = \
                st[(base + koff[grp])[:, None] + np.arange(4)]
            pix = m0 + np.arange(64)
            ok = pix < band_px
            for hf in (0, 1):
                acc = a @ bphys[128 * hf:128 * hf + 128].T
                assert np.abs(acc).max() < 2 ** 31
                ch = 32 * hf + chs
                v = acc[:, cols].max(axis=2).astype(np.float32)
                y = (v * scale[ch]).astype(np.float32) + bias[ch]
                y = np.where(y > 0, y, np.float32(0.1) * y)
                q = np.clip(np.rint(y), -127, 127)
                out[img, y0 + pix[ok] // wout, pix[ok] % wout, ch[:, None]] \
                    = q[ok].T
    assert (out != UNSET).all()
    return out.astype(np.int8)


def _conv1(r):
    w = (r.standard_normal((3, 3, 3, 16)) * 0.2).astype(np.float32)
    wq, s_w = jq.quantize_weights_per_channel(jnp.asarray(w))
    b = (r.standard_normal(16) * 0.1).astype(np.float32)
    return np.asarray(wq), np.asarray(s_w), b, 0.00789, 0.0511


# ---------------------------------------------------------------------------
# stage0_fused: the B tile and the data flow
# ---------------------------------------------------------------------------

def test_stage0_tile_is_a_bijection_and_cached(r):
    """The 108 true K rows of B land on distinct bytes of their output's
    row, at K lane 20 r6 + c6*3 + ch through the swizzle; every other byte
    is zero; the tile is made once and follows in-place writes of the
    operand and of B."""
    wq, s_w, b, s_in, s_out = _conv1(r)
    wv = T(st0.build_stage0_weights_v2(wq, s_w, b, s_in, s_out)[0])
    bm = st0.dense_k_from_v2(wv)
    m = st0.stage0_tile_matrix(bm)
    assert m.dtype == torch.int8 and m.numel() == st0.STAGE0_TILE_BYTES
    idx = st0.stage0_tile_index()
    assert idx.unique().numel() == idx.numel() == 256 * 108
    assert torch.equal(m[idx], bm[:108].t())
    rest = torch.ones(st0.STAGE0_TILE_BYTES, dtype=torch.bool)
    rest[idx.reshape(-1)] = False
    assert (m[rest] == 0).all()
    row = tfc.stem_k2_row(torch.arange(256)).view(-1, 1)
    assert (idx // 128 == row).all()
    lane = (((idx % 128) // 16) ^ (row % 8)) * 16 + idx % 16
    k = torch.arange(108)
    assert (lane == 20 * (k // 18) + k % 18).all()
    assert (lane % 20 < 18).all() and (lane < 120).all()
    # cached beside B; a new B after the operand is written in place
    assert st0.stage0_tile_matrix(st0.dense_k_from_v2(wv)) is m
    wv[1, 12, 0] += 1
    m2 = st0.stage0_tile_matrix(st0.dense_k_from_v2(wv))
    assert m2 is not m
    assert torch.equal(m2[idx], st0.dense_k_from_v2(wv)[:108].t())
    # ... and after B itself is
    b2 = st0.dense_k_from_v2(wv)
    b2[3, 7] += 1
    assert torch.equal(st0.stage0_tile_matrix(b2)[idx], b2[:108].t())


@pytest.mark.parametrize("form", ["v2", "v1-ht4", "v1-ht8"])
def test_stage0_mainloop_replay_matches_jax(r, form):
    """The kernel's data flow from either wrapper's operand (v2 at 64 px,
    b2; v1 at 416 px, b1, whose only size it is) equals JAX's
    stage0_fused_v2 or stage0_fused (interpret mode)."""
    wq, s_w, b, s_in, s_out = _conv1(r)
    if form == "v2":
        x = r.uniform(-0.1, 1.1, (2, 64, 64, 3)).astype(np.float32)
        wv, scale, bias = jst0.stage0_params_v2(wq, s_w, b, s_in, s_out)
        ref = jst0.stage0_fused_v2(jnp.asarray(x), wv, scale, bias,
                                   jnp.float32(s_in))
        bm = st0.dense_k_from_v2(T(wv))
    else:
        ht = int(form[-1])
        x = r.uniform(0, 1, (1, 416, 416, 3)).astype(np.float32)
        wb, scale, bias = jst0.stage0_params(wq, s_w, b, s_in, s_out, ht=ht)
        ref = jst0.stage0_fused(jnp.asarray(x), wb, scale, bias, s_in, ht=ht)
        bm = st0.dense_k_from_v1(T(wb), ht)
    tile = st0.stage0_tile_matrix(bm).numpy().astype(np.int64)
    got = _replay(x, tile, S0, 4, np.asarray(scale), np.asarray(bias),
                  s_in, False)
    eq(got, ref)


# ---------------------------------------------------------------------------
# stem_fused_dg: the slab relayout and the data flow
# ---------------------------------------------------------------------------

def _stem_args(r, exact_u8):
    """Folded conv1 weights (2, 2, 64, 256) with random cin_pad rows (the
    kernels drop them), and the stem's scale and bias."""
    w = (r.standard_normal((3, 3, 3, 16)) * 0.2).astype(np.float32)
    wq, s_w = jq.quantize_weights_per_channel(jnp.asarray(w))
    b = jnp.asarray(r.standard_normal(16) * 0.1, jnp.float32)
    s_in = jnp.float32(1 / 255.0 if exact_u8 else 0.00787)
    s_out = jnp.float32(0.05)
    wf = jpc.fold_conv3x3_k2_weights(np.asarray(wq), 4, pool_major=True)
    wf = np.concatenate(
        [wf, r.integers(-127, 128, (2, 2, 16, 256)).astype(np.int8)], axis=2)
    s_wt, bt = jnp.tile(s_w, 16), jnp.tile(b, 16)
    scale = (s_in * s_wt) / s_out
    if exact_u8:
        w1 = jnp.asarray(wf[:, :, :48].reshape(-1, 256).astype(np.float32)
                         .sum(axis=0))
        bias = (bt + 128.0 * s_in * s_wt * w1) / s_out
    else:
        bias = bt / s_out
    return wf, np.asarray(scale), np.asarray(bias), np.float32(s_in)


def _lay_slabs(slabs):
    """stem::lay_slabs in numpy: 16-byte chunk i of the (4, 256, 48) slabs
    (tap i // 768, output (i // 3) % 256, chunk i % 3) to K byte 48 tap +
    16 (i % 3) of row stem_row(o) of the swizzled tile; returns the tile
    (UNSET where nothing is written) and the chunks' destinations."""
    flat = slabs.reshape(-1, 16).astype(np.int64)
    tile = np.full(2 * 256 * 128, UNSET, np.int64)
    dsts = []
    for i in range(4 * 256 * 3):
        tap, o, c = i // 768, (i // 3) % 256, i % 3
        k, row = 48 * tap + 16 * c, _stem_row(o)
        dst = ((k // 128) * 256 * 128 + row * 128
               + (((k % 128) // 16) ^ (row % 8)) * 16)
        tile[dst:dst + 16] = flat[i]
        dsts.append(dst)
    return tile, np.array(dsts)


@pytest.mark.parametrize("ingest", ["exact_u8", "f32"])
def test_stem_dg_slab_relayout_replay_matches_jax(r, ingest):
    """The slabs laid into the tile chunk by chunk fill K 0..191 of every
    row exactly once and equal stem_tile_matrix there; the mainloop's data
    flow on that tile (the k2 addressing, 6 k32 steps) at 64 px, b2,
    equals JAX's stem_fused_dg (interpret mode)."""
    exact = ingest == "exact_u8"
    xu = r.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    x = xu.astype(np.float32) / 255.0 if not exact else xu
    wf, scale, bias, s_in = _stem_args(r, exact)
    ref = np.asarray(jpc.stem_fused_dg(jnp.asarray(x), jnp.asarray(wf),
                                       scale, bias, s_in, exact_u8=exact))
    slabs = tfc.stem_dg_weight_slabs(T(wf)).numpy()
    tile, dsts = _lay_slabs(slabs)
    assert len(set(dsts.tolist())) == dsts.size == 3072
    k2 = tfc.stem_tile_matrix(T(wf)).numpy().astype(np.int64)
    written = tile != UNSET
    assert written.sum() == 256 * 192
    assert (tile[written] == k2[written]).all()
    assert (_bphys(tile, 2)[:, :192] == _bphys(k2, 2)[:, :192]).all()
    got = _replay(x, tile, K2, 8 if exact else 4, scale, bias, s_in, exact)
    eq(got, ref)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,h,w", [(1, 416, 416), (16, 416, 416),
                                   (32, 416, 416), (2, 56, 72)])
@pytest.mark.parametrize("kernel", ["stage0", "dg"])
def test_stem_mainloop_schedule_covers_every_pixel_once(kernel, n, h, w):
    """Under the band height and grid each wrapper takes (stage0: f32, at
    most 4 rows; dg: exact u8, at most 8), every (image, band) is one unit
    of one block, the two consumers' 64-pixel tiles cover each output
    pixel exactly once (72 px: the last tile of a band ragged), the staged
    rows hold every input row the band's pixels read, and the raw rows fit
    beside the rest in shared memory."""
    _, ksteps, halo, atoms = {"stage0": S0, "dg": K2}[kernel]
    max_rows, esize = {"stage0": (4, 4), "dg": (8, 1)}[kernel]
    hout, wout = h // 4, w // 4
    rows, grid = tfc.stem_grid(n, hout, wout, SMS, max_rows)
    if h == 416:
        # the fewest tiles on the busiest SM, the most rows on a tie
        assert rows == {"stage0": {1: 1, 16: 1, 32: 4},
                        "dg": {1: 1, 16: 8, 32: 4}}[kernel][n]
        assert grid == min(n * -(-hout // rows), SMS)
    assert _smem(w, rows, halo, atoms, esize) <= SMEM
    bands = -(-hout // rows)
    seen = np.zeros((n, hout, wout), np.int64)
    units = set()
    for tiles in tfc.stem_k2_schedule(n, hout, wout, rows, grid):
        for img, y0, c, m0 in tiles:
            units.add((img, y0))
            band_px = min(rows, hout - y0) * wout
            assert m0 % 128 == 64 * c
            px = np.arange(m0, min(m0 + 64, band_px))
            np.add.at(seen[img], (y0 + px // wout, px % wout), 1)
            # the band's last output row y reads input rows up to
            # 4 (y + 1) + 3 - 1 (k2: tap dh = 1, p = 3) or 4 y + 4 (stage 0)
            y_last = y0 + (band_px - 1) // wout
            need = 4 * y_last + (6 if kernel == "dg" else 4)
            assert need <= 4 * y0 - 2 + 4 * rows + halo
    assert len(units) == n * bands
    assert (seen == 1).all()
