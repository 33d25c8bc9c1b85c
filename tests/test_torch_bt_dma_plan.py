"""The data flows of the tail conv's resident tap window
(``csrc/conv3x3_bt.cu``) and the copy-engine conv's TMA tap tiles
(``csrc/conv_dma.cu``), replayed in numpy on the CPU against the JAX
package, and their persistent schedules.

conv3x3_bt: the window of flat rows as the TMA box lands it (zeros
outside [0, M)) in the 128-byte swizzle, the row each lane addresses for
ldmatrix with the edge redirect and the A fragments it hands out, the
int32 products with B's (chunk, tap) boxes, split-K sums and the
epilogue.
conv_dma: each patch box of a tile (its rows by its columns and the halo
columns) with its out-of-bounds zeros, each tap's A read from it as the
descriptor reads it, B's boxes of the pool-major tile matrix, the
register group-max and the epilogue; and the resident B's handover
between column blocks (its barriers under random interleavings). Inputs
are made with numpy from a seed; the JAX Pallas kernels run in interpret
mode.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch
from jax.experimental.pallas import tpu as pltpu

from dnn_inference_engine_tpu.ops.attic import pallas_tail as jtail

from dnn_inference_engine_tpu_torch.ops.attic import tail
from dnn_inference_engine_tpu_torch.ops.fused_conv import (
    conv3x3_rs_plain, rs_tile_matrix, rs_weight_matrix)
from dnn_inference_engine_tpu_torch.ops.gemm import H100_SMS
from dnn_inference_engine_tpu_torch.tools import probe_dma_rules as pr
from dnn_inference_engine_tpu_torch.tools import proto_conv_dma as pc

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The replays make many small products: on a pool of spinning BLAS
    or OpenMP threads, with other test processes on the same cores, each
    costs hundreds of times its work (six processes of 1,500 float64
    128 x 128 products: 105 s each with 8 OpenBLAS threads, 0.13-0.17 s
    with one, on an 8-core host). So the module runs on one thread."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(torch_threads)

# conv3x3_bt at YOLOv2-tiny's 3x3 tail convs, 416 px (chip_smoke.py's
# BT_SHAPES): (x shape, Cout)
BT_SHAPES = [((32, 26, 26, 128), 256), ((32, 13, 13, 256), 512),
             ((32, 13, 13, 512), 1024), ((32, 13, 13, 1024), 1024),
             ((1, 13, 13, 512), 1024), ((1, 13, 13, 1024), 1024)]


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def unit(u, splits, n_tiles, kt):
    """wg::unit (csrc/wgmma_s8.cuh): (tile, split, mt, nt, kb, ke)."""
    tile, s = divmod(u, splits)
    mt, nt = divmod(tile, n_tiles)
    return tile, s, mt, nt, s * kt // splits, (s + 1) * kt // splits


def walk(units, grid):
    """The persistent walk: block b takes units b, b + grid, ..., its
    consumers alternately (consumer i % 2 of the block's i-th unit)."""
    return [(b, i % 2, u) for b in range(grid)
            for i, u in enumerate(range(b, units, grid))]


# ---------------------------------------------------------------------------
# conv3x3_bt: the resident tap window
# ---------------------------------------------------------------------------

LANE = np.arange(32)
# the row of its warp's 16 that a lane addresses for ldmatrix x4 (matrix
# lane // 8, row lane % 8: rows g, g + 8, g, g + 8) and its 16-byte chunk of
# a k32 step (0, 0, 1, 1)
LROW = (LANE & 7) + 8 * ((LANE >> 3) & 1)
LCHUNK = LANE >> 4


def swizzle128(win):
    """A (rows, 128) int8 box as the 128-byte swizzle lands it: byte b of
    row r at r*128 + ((b // 16) ^ (r % 8))*16 + b % 16."""
    rows = win.shape[0]
    r = np.arange(rows)[:, None]
    b = np.arange(128)[None, :]
    buf = np.zeros(rows * 128, np.int8)
    buf[r * 128 + ((b // 16) ^ (r % 8)) * 16 + b % 16] = win
    return buf


def bt_replay(x, w, sms=H100_SMS):
    """The int32 (M, Cout) accumulator of conv3x3_bt as the kernel forms
    it: each unit's windows as the TMA box lands them, each lane's
    ldmatrix row address for every (m64 half, warp, tap, k32 step) with
    the edge redirect, the four matrices' rows handed out as wgmma's A
    fragments, the products with B's (chunk, tap) boxes, and the split-K
    sum."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    m, halo = n * h * wd, wd + 1
    win_rows = 128 + 2 * halo
    xf = x.reshape(m, cin)
    wt = rs_weight_matrix(T(w)).numpy()
    f = tail.bt_form(m, cout, cin, sms)
    chunks, n_tiles = cin // 128, -(-cout // 128)
    acc = np.zeros((-(-m // 128) * 128, n_tiles * 128), np.int64)
    zero = np.zeros(128, np.int8)
    # [half q][warp w][lane]: the tile row a lane addresses
    rows = (64 * np.arange(2)[:, None, None] + 16 * np.arange(4)[None, :, None]
            + LROW[None, None, :])
    L = np.arange(32)
    for u in range(f.tiles * f.splits):
        _, _, mt, nt, kb, ke = unit(u, f.splits, n_tiles, chunks)
        mm = mt * 128 + rows
        xc, yc = mm % wd, (mm // wd) % h
        part = np.zeros((128, 128), np.int64)
        for ch in range(kb, ke):
            src = mt * 128 - halo + np.arange(win_rows)
            box = np.zeros((win_rows, 128), np.int8)
            ok = (src >= 0) & (src < m)
            box[ok] = xf[src[ok], ch * 128:(ch + 1) * 128]
            buf = np.concatenate([swizzle128(box), zero])   # + a zero row
            zrow = win_rows
            for tap in range(9):
                dh, dw = tap // 3 - 1, tap % 3 - 1
                v = ((mm < m) & (yc + dh >= 0) & (yc + dh < h)
                     & (xc + dw >= 0) & (xc + dw < wd))
                ra = np.where(v, rows + halo + dh * wd + dw, zrow)
                sw = np.where(v, ra & 7, 0)
                a = np.zeros((128, 128), np.int8)   # the tile's A, k bytes
                for kk in range(4):
                    addr = ra * 128 + (((2 * kk + LCHUNK) ^ sw) << 4)
                    # mats[q, w, i, r]: row r of matrix i = lane 8i + r's row
                    mats = buf[addr[..., None] + np.arange(16)].reshape(
                        2, 4, 4, 8, 16)
                    for q in range(2):
                        for wi in range(4):
                            for i in range(4):
                                # lane 4g + t receives bytes 4t..4t+3 of row
                                # g: its fragment register i, A row 16w + g
                                # + 8 (i % 2), bytes 32kk + 16 (i // 2) + 4t
                                reg = mats[q, wi, i][L // 4, 4 * (L % 4)
                                                     + np.arange(4)[:, None]]
                                a[64 * q + 16 * wi + L // 4 + 8 * (i % 2),
                                  32 * kk + 16 * (i // 2) + 4 * (L % 4)
                                  + np.arange(4)[:, None]] = reg
                bbox = np.zeros((128, 128), np.int8)
                brows = nt * 128 + np.arange(128)
                okb = brows < cout
                k0 = tap * cin + ch * 128
                bbox[okb] = wt[brows[okb], k0:k0 + 128]
                part += a.astype(np.int64) @ bbox.T.astype(np.int64)
        acc[mt * 128:(mt + 1) * 128, nt * 128:(nt + 1) * 128] += part
    return acc[:m, :cout]


def bt_epilogue(acc, scale, bias, act, quantize_out):
    """The kernel's epilogue: acc*scale then + bias, each rounded to
    float32, the activation, then clip(rint(y), +-127)."""
    y = (acc.astype(np.float32) * scale).astype(np.float32) + bias
    if act == "leaky":
        y = np.where(y > 0, y, np.float32(0.1) * y)
    elif act == "relu":
        y = np.maximum(y, 0)
    if quantize_out:
        return np.clip(np.rint(y), -127, 127).astype(np.int8)
    return y.astype(np.float32)


def exact_acc(x, w):
    n, h, wd, cin = x.shape
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    a = np.concatenate([xp[:, i:i + h, j:j + wd] for i in range(3)
                        for j in range(3)], axis=-1)
    return a.reshape(-1, 9 * cin) @ w.reshape(9 * cin, -1).astype(np.int64)


@pytest.mark.parametrize("quantize_out", [True, False])
@pytest.mark.parametrize("shape,cout", [((2, 13, 13, 128), 256),
                                        ((1, 13, 13, 256), 200),
                                        ((3, 5, 31, 128), 64)])
def test_bt_window_replay_matches_jax_conv3x3_bt(shape, cout, quantize_out):
    """At b2, at a ragged M (169: split-K over Cin 256's two chunks) and
    at W = 31 (the widest window): the replayed accumulator is the exact
    conv, and its epilogue gives JAX's conv3x3_bt (scale a power of two
    and bias in quarters, so that JAX's fused acc*scale + bias and the
    port's two roundings agree) and the port's plain version."""
    r = np.random.default_rng(sum(shape) + cout)
    x = r.integers(-127, 128, shape).astype(np.int8)
    w = r.integers(-20, 21, (3, 3, shape[3], cout)).astype(np.int8)
    scale = np.full(cout, 2.0 ** -9, np.float32)
    bias = (r.integers(-40, 41, cout) / 4).astype(np.float32)
    acc = bt_replay(x, w)
    np.testing.assert_array_equal(acc, exact_acc(x, w))
    got = bt_epilogue(acc, scale, bias, "leaky", quantize_out)
    ref = np.asarray(jtail.conv3x3_bt(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias), act="leaky", quantize_out=quantize_out,
        interpret=True)).reshape(got.shape)
    np.testing.assert_array_equal(got, ref)
    plain = tail.conv3x3_bt_plain(T(x), T(w), T(scale), T(bias),
                                  quantize_out=quantize_out)
    np.testing.assert_array_equal(got, plain.numpy().reshape(got.shape))
    if quantize_out:
        assert len(np.unique(got)) > 100


@pytest.mark.parametrize("act", ["leaky", "linear", "relu"])
def test_bt_window_replay_matches_jax_conv2d_w8a8_bt(act):
    """The W8A8 entry at b2, int8 out, scales as the JAX package makes
    them: the replay's codes are JAX's conv2d_w8a8_bt's."""
    r = np.random.default_rng(4321)
    xq = r.integers(-127, 128, (2, 13, 13, 128)).astype(np.int8)
    wq = r.integers(-127, 128, (3, 3, 128, 256)).astype(np.int8)
    s_w = r.uniform(1e-3, 1e-2, 256).astype(np.float32)
    b = r.standard_normal(256).astype(np.float32)
    s_in, s_out = np.float32(0.0217), np.float32(0.0613)
    ref = np.asarray(jtail.conv2d_w8a8_bt(
        jnp.asarray(xq), s_in, jnp.asarray(wq), jnp.asarray(s_w),
        jnp.asarray(b), act=act, s_out=jnp.float32(s_out)))
    scale = (s_in * s_w) / s_out
    bias = b / s_out
    got = bt_epilogue(bt_replay(xq, wq), scale, bias, act, True)
    np.testing.assert_array_equal(got, ref.reshape(got.shape))


def test_bt_window_ldmatrix_is_conflict_free():
    """The 8 rows one ldmatrix phase reads (a matrix: 8 consecutive rows
    of the window, one tap, no redirect) sit in 8 distinct 16-byte bank
    groups of the swizzled window, for every chunk: the 128-byte swizzle's
    point."""
    for row0 in range(0, 184):
        ra = row0 + np.arange(8)
        for j in range(8):
            groups = ((ra * 128 + ((j ^ (ra & 7)) << 4)) // 16) % 8
            assert len(set(groups.tolist())) == 8


@pytest.mark.parametrize("shape,cout", BT_SHAPES)
def test_bt_schedule_covers_every_output_once(shape, cout):
    """The b32 and b1 tail shapes: each (tile, split) unit is taken by
    one consumer of one block, a tile's splits cover its Cin chunks once,
    and the tiles cover every (flat row, channel) once; b32 takes no
    split, b1 splits K to fill the card."""
    n, h, wd, cin = shape
    m = n * h * wd
    f = tail.bt_form(m, cout, cin)
    chunks, n_tiles = cin // 128, -(-cout // 128)
    units = f.tiles * f.splits
    assert f.grid == min(units, H100_SMS)
    taken = [u for _, _, u in walk(units, f.grid)]
    assert sorted(taken) == list(range(units))
    cover = np.zeros((f.tiles, chunks), np.int64)
    out = np.zeros((-(-m // 128) * 128, n_tiles * 128), np.int64)
    for u in range(units):
        tile, s, mt, nt, kb, ke = unit(u, f.splits, n_tiles, chunks)
        assert ke > kb
        cover[tile, kb:ke] += 1
        if s == f.splits - 1:
            out[mt * 128:(mt + 1) * 128, nt * 128:(nt + 1) * 128] += 1
    assert (cover == 1).all()
    assert (out == 1).all()
    assert f.splits == (1 if n == 32 else {512: 4, 1024: 6}[cin])


def test_bt_form_takes_whole_chunks():
    assert tail.bt_form(169, 1024, 128).splits == 1
    assert tail.bt_form(507, 128, 256) == (
        "wgmma", 2, 4, 8)                   # 3 x 13 x 13: split over 2
    assert tail.bt_form(64, 125, 128) == ("wgmma", 1, 1, 1)


# ---------------------------------------------------------------------------
# conv_dma: TMA-built tap tiles
# ---------------------------------------------------------------------------

def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def numpy_box(src, start, box):
    """A TMA box of ``src`` at ``start`` (outermost first), zeros outside
    the source on every side."""
    pads = [(max(0, -s), max(0, s + b - d))
            for s, b, d in zip(start, box, src.shape)]
    padded = np.pad(src, pads)
    return padded[tuple(slice(s + lo, s + lo + b)
                        for s, b, (lo, _) in zip(start, box, pads))]


def dma_replay(x, w, scale, bias):
    """conv_dma's output as the kernel forms it: for each unit (pixel
    tile, column block) and step (tap row dh, Cin chunk) the patch box of
    x (the tile's 16 rows by its 8 columns and both halo columns; the
    SAME halo and the K padding past Cin as the box's zero fill), each
    tap column dw's A read from it as the descriptor reads it (core
    matrix j = patch row j from column dw), B's boxes of the pool-major
    tile matrix, the int32 sum, the register group-max and the epilogue;
    each output written once."""
    n, h, wd, cin = x.shape
    go = scale.shape[0]
    f = pc.conv_dma_form(n, h, wd, cin, go)
    tr, tc = pc.TR, pc.TC
    bt = rs_tile_matrix(T(w), go).numpy()
    kc = f.steps // 3
    rt, ct = -(-h // tr), -(-wd // tc)
    ptiles = n * rt * ct
    sc, bi = np.zeros((2, -(-go // 32) * 32), np.float32)
    sc[:go], bi[:go] = scale, bias
    # row j*8 + i of the tile's A for tap column dw: patch row j*10 + dw + i
    rows = (10 * np.arange(16)[:, None] + np.arange(8)[None, :]).reshape(-1)
    out = np.zeros((n, h, wd, go), np.int8)
    written = np.zeros((n, h, wd, go), np.int64)
    for u in range(f.units):
        nt, pt = divmod(u, ptiles)
        img, rest = divmod(pt, rt * ct)
        y0, x0 = rest // ct * tr, rest % ct * tc
        acc = np.zeros((128, 128), np.int64)
        for s in range(f.steps):
            dh, c0 = s // kc, (s % kc) * f.kb
            patch = numpy_box(x[img], (y0 + dh - 1, x0 - 1, c0),
                              (16, 10, f.kb)).reshape(160, f.kb)
            for dw in range(3):
                a = patch[rows + dw]
                b = numpy_box(bt, (nt * 128, (3 * dh + dw) * cin + c0),
                              (128, f.kb))
                acc += a.astype(np.int64) @ b.T.astype(np.int64)
        g = acc.reshape(128, 4, 32).max(axis=1)
        y = bt_epilogue(g, sc[nt * 32:(nt + 1) * 32],
                        bi[nt * 32:(nt + 1) * 32], "leaky", True)
        for p in range(128):
            oy, ox = y0 + p // tc, x0 + p % tc
            if oy < h and ox < wd:
                chs = np.arange(nt * 32, min(nt * 32 + 32, go))
                out[img, oy, ox, chs] = y[p, :len(chs)]
                written[img, oy, ox, chs] += 1
    assert (written == 1).all()
    return out


def _dma_inputs(seed, n, h, w, cin, go):
    r = np.random.default_rng(seed)
    x = r.integers(-127, 128, (n, h, w, cin), dtype=np.int8)
    wq = r.integers(-20, 21, (3, 3, cin, 4 * go), dtype=np.int8)
    scale = r.uniform(1e-3, 3e-3, go).astype(np.float32)
    b = (r.standard_normal(go) * 3).astype(np.float32)
    return x, wq, scale, b


@pytest.mark.parametrize("ht", [13, 26])
def test_dma_tile_replay_matches_jax_conv_dma(ht):
    """The JAX prototype at (2,26,104,64) -> 128, go 32 (the inputs of
    test_torch_dma's JAX test) for each of its bands ht: the replay's
    codes (whose tiles do not depend on ht) are identical."""
    x, w, scale, bias = _dma_inputs(7, 2, 26, 104, 64, 32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_jax_tool("proto_conv_dma").conv_dma(
            x, w, scale, bias, ht=ht))
    np.testing.assert_array_equal(dma_replay(x, w, scale, bias), want)


@pytest.mark.parametrize("shape", [
    (2, 11, 17, 16, 32),                # Cin 16: 48 bytes of K padding
    (1, 7, 24, 48, 32),                 # Cin 48, ragged tiles
    (2, 8, 8, 64, 64),                  # two column blocks of B
    (1, 6, 13, 80, 32),                 # 128-byte steps, Cin 80
    (1, 5, 9, 144, 32),                 # two steps a tap row, B streamed
    (1, 9, 20, 32, 80),                 # three column blocks, the last
                                        # half full
])
def test_dma_tile_replay_is_conv3x3_rs_gmaxm(shape):
    n, h, w, cin, go = shape
    x, wq, scale, bias = _dma_inputs(sum(shape), n, h, w, cin, go)
    want = conv3x3_rs_plain(T(x), T(wq), T(scale).repeat(4),
                            T(bias).repeat(4), pool=("gmaxm", 2, go))
    got = dma_replay(x, wq, scale, bias)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("shape", [(32, 104, 104), (2, 11, 17),
                                   (1, 7, 256)])
def test_dma_schedule_covers_every_pixel_once(shape):
    """The prototype shape and ragged ones: the units' 16 x 8 tiles cover
    every output pixel once, each unit on one consumer of one block; tile
    rows and columns past the image (at 104 rows the last row of tiles is
    half outside) are masked at the store."""
    n, h, w = shape
    f = pc.conv_dma_form(n, h, w, 64, 32)
    rt, ct = -(-h // pc.TR), -(-w // pc.TC)
    assert f.units == n * rt * ct and f.grid == min(f.units, H100_SMS)
    assert sorted(u for _, _, u in walk(f.units, f.grid)) == \
        list(range(f.units))
    cover = np.zeros((n, rt * pc.TR, ct * pc.TC), np.int64)
    for u in range(f.units):
        img, rest = divmod(u, rt * ct)
        y0, x0 = rest // ct * pc.TR, rest % ct * pc.TC
        cover[img, y0:y0 + pc.TR, x0:x0 + pc.TC] += 1
    assert (cover == 1).all()


class _Bar:
    """An mbarrier: a phase completes after ``count`` arrivals; a wait
    with parity P passes while the completed phases' parity differs from
    P (so a wait two phases behind passes at once)."""

    def __init__(self, count):
        self.count, self.arrived, self.phases = count, 0, 0

    def arrive(self):
        self.arrived += 1
        if self.arrived == self.count:
            self.arrived, self.phases = 0, self.phases + 1

    def passes(self, parity):
        return (self.phases & 1) != parity


def dma_handover_faults(units, ptiles, grid, block, turn_first, seed):
    """One block's walk of conv_dma's resident-B handover (the kernel's
    producer and two consumers, their bfull / bempty / turn barriers, each
    copy and each unit's A landing at any later time) under a seeded
    random interleaving. Returns the units whose wgmma could read B while
    a copy was in flight or holding another column block. ``turn_first``:
    the kernel's order (take the turn, then wait for B); False waits for
    B first."""
    r = np.random.default_rng(seed)
    us = list(range(block, units, grid))
    bfull, bempty = _Bar(1), _Bar(2)
    turn = [_Bar(1), _Bar(1)]
    b = {"holds": None, "flight": 0}
    landed, faults, agents = set(), [], []

    def land_b(nt):
        yield lambda: True
        b["holds"], b["flight"] = nt, b["flight"] - 1
        bfull.arrive()

    def land_a(u):
        yield lambda: True
        landed.add(u)

    def producer():
        cur, gen = -1, 0
        for u in us:
            nt = u // ptiles
            if nt != cur:
                if gen > 0:
                    yield lambda g=gen: bempty.passes((g - 1) & 1)
                b["flight"] += 1
                agents.append(land_b(nt))
                cur, gen = nt, gen + 1
            agents.append(land_a(u))

    def consumer(c):
        cur, gen, have_b, k = -1, 0, False, 0
        for i, u in enumerate(us):
            nt = u // ptiles
            if nt != cur:
                if gen > 0:
                    if gen > 1:
                        yield lambda g=gen: bempty.passes((g - 2) & 1)
                    bempty.arrive()
                cur, gen, have_b = nt, gen + 1, False
            if i % 2 != c:
                continue
            for step in ("turn", "b") if turn_first else ("b", "turn"):
                if step == "turn" and c == 1:
                    yield lambda k=k: turn[1].passes(k & 1)
                elif step == "turn" and k > 0:
                    yield lambda k=k: turn[0].passes((k - 1) & 1)
                elif step == "b" and not have_b:
                    yield lambda g=gen: bfull.passes((g - 1) & 1)
                    have_b = True
            k += 1
            yield lambda u=u: u in landed
            # the wgmma reads B from its issue until it retires, after the
            # turn's arrival; other agents run in between
            for arrive in (False, True, False):
                if b["flight"] or b["holds"] != nt:
                    faults.append(u)
                if arrive:
                    turn[1 - c].arrive()
                yield lambda: True

    agents += [producer(), consumer(0), consumer(1)]
    waits = [None] * len(agents)
    while True:
        while len(waits) < len(agents):
            waits.append(None)
        ready = [j for j, a in enumerate(agents)
                 if a is not None and (waits[j] is None or waits[j]())]
        if not ready:
            assert all(a is None for a in agents), "the handover deadlocks"
            return sorted(set(faults))
        j = ready[r.integers(len(ready))]
        try:
            waits[j] = next(agents[j])
        except StopIteration:
            agents[j] = None


@pytest.mark.parametrize("shape", [(1, 104, 104, 64, 64),
                                   (4, 104, 104, 64, 64),
                                   (2, 52, 104, 32, 128),
                                   (32, 104, 104, 64, 32)])
def test_dma_resident_b_handover_is_exact(shape):
    """Every block's walk where B is resident, under seeded random
    interleavings of the producer, both consumers and the copies' landing:
    no wgmma reads B in flight or another column block's, and nothing
    deadlocks. Waiting for B before the turn is not exact: a consumer
    whose last unit was a column block ago passes its bfull wait two
    phases behind (at 182 units on 132 blocks, block 0's consumer 1)."""
    n, h, w, cin, go = shape
    f = pc.conv_dma_form(n, h, w, cin, go)
    assert f.resident
    ptiles = f.units // -(-go // 32)
    for block in range(f.grid):
        for seed in range(4):
            assert dma_handover_faults(f.units, ptiles, f.grid, block, True,
                                       seed) == []
    if shape[0] == 1:
        assert any(dma_handover_faults(f.units, ptiles, f.grid, 0, False,
                                       seed) for seed in range(8))


@pytest.mark.parametrize("go", [32, 64, 128])
def test_dma_form_at_the_prototype_shape(go):
    """(32,104,104,64) -> 4 go: 64-byte steps, one patch box a tap row, B
    resident (72 KB a column block) beside 12 stages of 10 KB, 197,856
    bytes of shared memory, a column block's units each; both maps obey
    the TMA rules with the 64-byte swizzle (B's rows a column block
    each)."""
    f = pc.conv_dma_form(32, 104, 104, 64, go)
    assert f == pc.DmaForm(64, 3, True, 12, 197_856, 2912 * (go // 32),
                           132)
    x = torch.zeros(32, 104, 104, 64, dtype=torch.int8)
    maps = pc.conv_dma_maps(x.shape, x.stride(), go, f)
    assert maps[1][0] == (go // 32 * 128, 576)
    for shape, strides, box in maps:
        assert pr.tma_box_legal(shape, strides, box, 0, swizzle=64) == \
            (True, "")
