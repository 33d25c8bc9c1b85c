"""The work division and code table of ``quant_space_to_depth4``'s Hopper
kernel (``csrc/quant_space_to_depth4.cu``), on the CPU.

The kernel runs one block a unit, ``run`` output pixels of one output row
(``fused_conv.qs2d4_grid``). Four threads bulk-copy the 16-byte granules
holding the run's valid elements of its four input rows into shared row
buffers (``qs2d4_row_bytes``) that keep each row's global alignment; the
block builds a 256-entry uint8 code table (``qs2d4_code_table`` mirrors
it); its threads turn the staged rows into code rows (``qs2d4_code_bytes``)
a word of four elements at a time, masking the border's elements; then
consecutive threads store consecutive 16-byte chunks of the unit's
contiguous output from the code rows, a word at a time (at 64 lanes each
thread keeps one chunk of a pixel) or, where the width is not a multiple
of 4, a byte at a time, and a partial chunk at either end of the run byte
by byte. These tests replay that in numpy: at small shapes every output
byte written once and equal to the plain version (and the JAX kernel,
through ``test_torch_ops``), at the S1 and S2 entries at b1 and b32 by
index counts alone, and the code table against the JAX kernel in
interpret mode on every byte value.

Integer index arithmetic only, in int64, on one thread (ROADMAP C5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from dnn_inference_engine_tpu.ops import pallas_conv as jpc

from dnn_inference_engine_tpu_torch.ops import fused_conv as tfc

SMS = 132                            # an H100 SXM
THREADS = 128                        # the kernel's block
SMEM_DEFAULT = 48 * 1024             # dynamic shared memory without opt-in
S1_BORDER = (1, 7, 1, 7)             # the fold_xla_k2 entry's zero border
SCALES = (1 / 127.0, 0.0078431377, 0.0123, 0.007919)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(torch_threads)


@pytest.fixture
def r():
    return np.random.default_rng(413)


# ---------------------------------------------------------------------------
# the kernel's rules, as the CUDA source states them
# ---------------------------------------------------------------------------

def _floor16(a):
    return a & ~np.int64(15)


def unit_plan(n, h, w, pad_hw, c_out, elem, sms, x_base=0, out_base=0):
    """The kernel's per-unit values, vectorised over units (int64 arrays):
    the unit's output row and pixels, its output bytes [g0, g1), and for
    each input row p (axis 1) the bulk copy (src, len, dst), the buffer
    byte of the run's first element (off) and its valid elements [lo, hi)
    (0, 0 for a row in the border). Addresses are byte offsets of x at
    ``x_base`` and of the output at ``out_base``."""
    top, bottom, left, right = pad_hw
    h4, w4 = (h + top + bottom) // 4, (w + left + right) // 4
    segs, run, grid = tfc.qs2d4_grid(n, h4, w4, sms)
    units = n * h4 * segs
    u = np.arange(units, dtype=np.int64)
    row = u // segs
    j0 = (u - row * segs) * run
    px = np.minimum(run, w4 - j0)
    img, i = row // h4, row % h4
    u0 = 12 * j0 - 3 * left
    p = np.arange(4, dtype=np.int64)[None, :]
    y = 4 * i[:, None] + p - top
    v0 = np.broadcast_to(np.maximum(u0, 0)[:, None], y.shape)
    v1 = np.broadcast_to(np.minimum(u0 + 12 * px, 3 * w)[:, None], y.shape)
    live = (y >= 0) & (y < h) & (v0 < v1)
    r0 = x_base + (img[:, None] * h + y) * w * 3 * elem
    first = r0 + u0[:, None] * elem
    base = _floor16(first)
    src = _floor16(r0 + v0 * elem)
    end = _floor16(r0 + v1 * elem + 15)
    z = np.zeros_like(y)
    plan = dict(
        segs=segs, run=run, units=units, grid=grid, row=row, j0=j0, px=px,
        h4=h4, w4=w4,
        src=np.where(live, src, z), len=np.where(live, end - src, z),
        dst=np.where(live, src - base, z), off=np.where(live, first - base, z),
        lo=np.where(live, v0 - u0[:, None], z),
        hi=np.where(live, v1 - u0[:, None], z), live=live,
        y=y, v0=v0, v1=v1, img=img)
    plan["g0"] = out_base + (row * w4 + j0) * c_out
    plan["g1"] = plan["g0"] + px * c_out
    plan["rb"] = tfc.qs2d4_row_bytes(run, elem)
    return plan


def _valid_mask(e, lo, hi):
    a = np.clip(lo - e, 0, 4)
    b = np.clip(hi - e, 0, 4)
    return (((np.int64(1) << (8 * b)) - 1) & ~((np.int64(1) << (8 * a)) - 1))


def _quant_f32(v, s):
    with np.errstate(all="ignore"):          # noise where masked anyway
        q = np.rint(v.astype(np.float32) / np.float32(s))
        return np.clip(q, -127, 127).astype(np.int64) & 255


def run_kernel(x, s, pad_hw, pad_to, sms, x_base, r):
    """The kernel replayed in numpy on global memory: x's bytes at
    ``x_base``, the output at a 16-byte aligned offset, shared memory that
    starts as noise. Returns (output codes, times each byte was written)."""
    u8 = x.dtype == np.uint8
    elem = 1 if u8 else 4
    n, h, w, _ = x.shape
    c_out = max(pad_to, 48)
    out_base = 256
    pl = unit_plan(n, h, w, pad_hw, c_out, elem, sms, x_base, out_base)
    rb, cb = pl["rb"], tfc.qs2d4_code_bytes(pl["run"])
    assert 4 * (rb + cb) <= SMEM_DEFAULT     # the block's shared memory
    raw = x.reshape(-1).view(np.uint8)
    gmem = r.integers(0, 256, x_base + raw.size + 32).astype(np.uint8)
    gmem[x_base:x_base + raw.size] = raw
    lo_ok, hi_ok = _floor16(np.int64(x_base)), _floor16(
        np.int64(x_base + raw.size + 15))
    total = n * pl["h4"] * pl["w4"] * c_out
    out = np.zeros(total, np.int64)
    count = np.zeros(total, np.int64)
    tbl = (tfc.qs2d4_code_table(s).astype(np.int64) & 255) if u8 else None
    for u in range(pl["units"]):                # block u: unit u
        sm = r.integers(0, 256, 4 * rb).astype(np.uint8)     # noise
        codes_b = r.integers(0, 256, (4, cb)).astype(np.int64)
        for p in range(4):
            ln = pl["len"][u, p]
            if ln == 0:
                continue
            src, dst = pl["src"][u, p], pl["dst"][u, p]
            # a bulk copy: 16-byte aligned both ends, inside the granules
            # that hold x, inside the row's buffer
            assert src % 16 == 0 and ln % 16 == 0 and dst % 16 == 0
            assert lo_ok <= src and src + ln <= hi_ok
            assert dst + ln <= rb
            sm[p * rb + dst:p * rb + dst + ln] = gmem[src:src + ln]
        px = pl["px"][u]
        sm32 = sm.view(np.uint32).astype(np.int64)
        smf = np.frombuffer(sm.tobytes(), np.float32)
        # the codes: word i of code row p, elements 4i .. 4i+3 of the run;
        # a row in the border zeros; uint8: the interior words [ia, ib)
        # unmasked, the ends masked; f32: every word masked
        for p in range(4):
            lo, hi = pl["lo"][u, p], pl["hi"][u, p]
            first = p * rb + pl["off"][u, p]
            n3 = 3 * px
            if lo == hi:
                codes_b[p, :12 * px] = 0
                continue
            ia = min((lo + 3) >> 2, n3) if u8 else 0
            ib = max(ia, min(hi >> 2, n3)) if u8 else 0
            inner = np.arange(ia, ib, dtype=np.int64)
            edge = np.arange(n3 - (ib - ia), dtype=np.int64)
            edge = np.where(edge < ia, edge, edge + (ib - ia))
            assert sorted(np.r_[inner, edge]) == list(range(n3))
            i = np.r_[inner, edge]
            e = 4 * i
            m = np.r_[np.full(len(inner), 0xFFFFFFFF, np.int64),
                      _valid_mask(4 * edge, lo, hi)]
            assert np.array_equal(m, _valid_mask(e, lo, hi))
            live = (m != 0) | (not u8)             # a word converted
            row_end = (p + 1) * rb                   # reads stay in the row
            if u8:
                ba = first + e
                assert np.all(((ba[live] >> 2) + 2) * 4 <= row_end)
                ba = np.where(live, ba, 0)
                x4 = ((sm32[(ba >> 2) + 1] << 32) | sm32[ba >> 2]) >> (
                    8 * (ba & 3))
                c = np.stack([tbl[(x4 >> (8 * q)) & 255] for q in range(4)],
                             axis=1)
            else:
                ba = first + 4 * e
                assert np.all(ba[live] % 4 == 0)
                assert np.all(ba[live] + 16 <= row_end)
                ba = np.where(live, ba, 0)
                c = np.stack([_quant_f32(smf[ba // 4 + q], s)
                              for q in range(4)], axis=1)
            keep = np.stack([(m >> (8 * q)) & 255 for q in range(4)], axis=1)
            crow = codes_b[p, :12 * px].reshape(-1, 4)
            crow[i] = c & keep
            codes_b[p, :12 * px] = crow.reshape(-1)

        def byte_at(o):
            jj, l = o // c_out, o % c_out
            p = np.minimum(l // 12, 3)
            idx = 12 * jj + l - 12 * p
            assert np.all(idx[l < 48] < 12 * px)     # a written code
            return np.where(l < 48, codes_b[p, np.minimum(idx, cb - 1)], 0)

        g0, g1 = pl["g0"][u], pl["g1"][u]
        if c_out == 64:
            # thread t: chunk t & 3 of pixels t // 4, t // 4 + THREADS // 4
            t = np.arange(THREADS, dtype=np.int64)
            q = t & 3
            jj = np.concatenate([np.arange(tt >> 2, px, THREADS // 4)
                                 for tt in t])
            qq = np.concatenate([np.full(len(range(tt >> 2, px,
                                                   THREADS // 4)), tt & 3)
                                 for tt in t])
            assert len(jj) == 4 * px
            byts = []
            for k in range(4):
                l = 16 * qq + 4 * k
                p = np.minimum(l // 12, 3)
                wi = np.where(l < 48, 3 * jj + (l - 12 * p) // 4, 0)
                assert np.all(wi < 3 * px)           # a written code word
                word = codes_b[p[:, None], 4 * wi[:, None] + np.arange(4)]
                byts.append(np.where((l < 48)[:, None], word, 0))
            byts = np.concatenate(byts, axis=1)
            at = (g0 + 64 * jj + 16 * qq)[:, None] + np.arange(16) - out_base
            assert g0 % 16 == 0 and q.size == THREADS
            np.add.at(count, at.reshape(-1), 1)
            out[at.reshape(-1)] = byts.reshape(-1)
            continue
        c0 = _floor16(g0)
        chunks = (g1 - c0 + 15) >> 4
        gb = c0 + 16 * np.arange(chunks, dtype=np.int64)
        full = (gb >= g0) & (gb + 16 <= g1)
        o = gb[full] - g0
        if c_out % 4 == 0:                   # a code word a word
            jj, l = o // c_out, o % c_out
            byts = []
            for q in range(4):
                p = np.minimum(l // 12, 3)
                i = 3 * jj + (l - 12 * p) // 4
                assert np.all(i[l < 48] < 3 * px)
                word = codes_b[p[:, None],
                               4 * np.minimum(i, 3 * px - 1)[:, None]
                               + np.arange(4)]
                byts.append(np.where((l < 48)[:, None], word, 0))
                l = l + 4
                wrap = l >= c_out
                assert c_out != 48 or q == 3 or not wrap.any()
                l = np.where(wrap, l - c_out, l)
                jj = jj + wrap
            byts = np.concatenate(byts, axis=1)
        else:
            byts = np.stack([byte_at(o + k) for k in range(16)], axis=1)
        at = (gb[full][:, None] + np.arange(16)) - out_base
        np.add.at(count, at.reshape(-1), 1)
        out[at.reshape(-1)] = byts.reshape(-1)
        for g in gb[~full]:                  # a partial chunk, byte by byte
            k = np.arange(16)
            inside = (g + k >= g0) & (g + k < g1)
            ob = g + k[inside]
            np.add.at(count, ob - out_base, 1)
            out[ob - out_base] = byte_at(ob - g0)
    codes_out = out.astype(np.uint8).view(np.int8)
    shape = (n, pl["h4"], pl["w4"], c_out)
    return codes_out.reshape(shape), count.reshape(shape)


# ---------------------------------------------------------------------------
# the replay at small shapes: every byte once, equal to the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_to", [0, 56, 64, 72, 50])
@pytest.mark.parametrize("shape,pad_hw,sms,x_base", [
    ((1, 16, 24, 3), (0, 0, 0, 0), 4, 0),       # 72-byte rows
    ((2, 24, 40, 3), S1_BORDER, 4, 3),          # 120-byte rows, border
    ((1, 16, 56, 3), (0, 0, 0, 0), 132, 9),     # rows split into runs
    ((1, 26, 18, 3), (3, 3, 5, 1), 132, 6),     # a wide left border
])
@pytest.mark.parametrize("ingest", ["uint8", "f32"])
def test_work_division_writes_every_byte_once(r, shape, pad_hw, sms, x_base,
                                              pad_to, ingest):
    """Every output byte written exactly once and equal to the plain
    version, at rows whose bytes are not a multiple of 16, x at unaligned
    addresses, and widths the kernel composes a word (48, 56, 64, 72) or
    a byte (50) at a time."""
    s = 0.0123
    if ingest == "uint8":
        x = r.integers(0, 256, shape).astype(np.uint8)
    else:
        x = r.uniform(-1, 1, shape).astype(np.float32)
        x_base = 4 * x_base
    got, count = run_kernel(x, s, pad_hw, pad_to, sms, x_base, r)
    assert count.min() == 1 and count.max() == 1
    ref = tfc.quant_space_to_depth4_plain(torch.from_numpy(x), s,
                                          pad_to=pad_to, pad_hw=pad_hw)
    np.testing.assert_array_equal(got, ref.numpy())


# ---------------------------------------------------------------------------
# the S1 and S2 entries at b1 and b32, by index counts alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c_out", [48, 64])
@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("entry", ["S1", "S2"])
@pytest.mark.parametrize("ingest", ["uint8", "f32"])
def test_entry_geometries_cover_input_and_output(entry, batch, c_out,
                                                 ingest):
    """At 416 px: the units' output runs tile the output (one contiguous
    run each, whole 16-byte chunks at these widths); each valid input
    byte is staged by exactly one unit; every copy is a legal bulk copy
    into its row's buffer, every shared read of the compose lies inside
    it; the b1 grid holds at least two blocks an SM."""
    elem = 1 if ingest == "uint8" else 4
    pad_hw = S1_BORDER if entry == "S1" else (0, 0, 0, 0)
    n, h, w = batch, 416, 416
    pl = unit_plan(n, h, w, pad_hw, c_out, elem, SMS, x_base=0)
    h4, w4 = pl["h4"], pl["w4"]
    assert (h4, w4) == ((106, 106) if entry == "S1" else (104, 104))
    # the grid: a block a unit, at least two an SM
    assert pl["grid"] == pl["units"] >= 2 * SMS
    assert pl["run"] <= tfc.QS2D4_MAX_RUN
    assert 4 * (pl["rb"] + tfc.qs2d4_code_bytes(pl["run"])) <= SMEM_DEFAULT
    # the output: runs in order, back to back, 16-byte chunks
    g0, g1 = pl["g0"], pl["g1"]
    assert g0[0] == 0 and g1[-1] == n * h4 * w4 * c_out
    assert np.array_equal(g0[1:], g1[:-1])
    assert np.all(g0 % 16 == 0) and np.all(g1 % 16 == 0)
    assert np.all(pl["px"] >= 1)
    # the input: on each input row the live runs tile its 3 W elements
    live = pl["live"]
    key = (pl["img"][:, None] * h + pl["y"])[live]
    v0, v1 = pl["v0"][live], pl["v1"][live]
    order = np.lexsort((v0, key))
    key, v0, v1 = key[order], v0[order], v1[order]
    starts = np.r_[True, key[1:] != key[:-1]]
    assert np.all(v0[starts] == 0)
    ends = np.r_[key[1:] != key[:-1], True]
    assert np.all(v1[ends] == 3 * w)
    assert np.array_equal(v0[~starts], v1[:-1][~starts[1:]])
    assert len(np.unique(key)) == n * h
    assert int((v1 - v0).sum()) == n * h * w * 3
    # the copies, and the compose's reads
    ln, src, dst, off = pl["len"], pl["src"], pl["dst"], pl["off"]
    assert np.all(ln % 16 == 0) and np.all(src % 16 == 0)
    assert np.all(dst % 16 == 0) and np.all(dst + ln <= pl["rb"])
    assert np.all(ln[live] > 0) and np.all(ln[~live] == 0)
    assert np.all(src[live] >= 0) and np.all(
        src[live] + ln[live] <= _floor16(np.int64(n * h * w * 3 * elem + 15)))
    last = off + elem * (12 * pl["px"][:, None] - 4)
    assert np.all(((last[live] >> 2) + 2) * 4 <= pl["rb"])
    assert np.all(off[live] % elem == 0)


# ---------------------------------------------------------------------------
# the code table
# ---------------------------------------------------------------------------

def _fold4(codes):
    """s2d(4) of (1, 8, 32, 3) codes, as the kernel lays them out."""
    return codes.reshape(1, 2, 4, 8, 4, 3).transpose(0, 1, 3, 2, 4, 5) \
        .reshape(1, 2, 8, 48)


@pytest.mark.parametrize("s_in", SCALES)
def test_code_table_matches_jax_on_every_byte_value(r, s_in):
    """The table the kernel builds (its Python mirror), applied to an
    image holding all 256 byte values and folded by s2d(4), against the
    JAX kernel in interpret mode and the plain version.

    With u / 255 correctly rounded (the port, the plain version, JAX's
    op-by-op normalise) the JAX kernel's codes equal the table's at every
    scale. Fed uint8, the JAX kernel normalises inside ``jax.jit``, where
    XLA turns / 255.0 into x f32(1/255): its codes are the table of that
    product, equal to the port's at three of the scales and 31 byte
    values apart at s = 0.0078431377 = f32(2/255), where u / 255 / s lands
    on a tie for odd u (ROADMAP C6)."""
    x = r.permutation(np.arange(8 * 32 * 3) % 256).astype(np.uint8)
    x = x.reshape(1, 8, 32, 3)
    assert len(np.unique(x)) == 256
    tbl = tfc.qs2d4_code_table(s_in)
    xf = x.astype(np.float32) / np.float32(255.0)
    ref = np.asarray(jpc.quant_space_to_depth4(jnp.asarray(xf),
                                               jnp.float32(s_in)))
    np.testing.assert_array_equal(_fold4(tbl[x]), ref)
    plain = tfc.quant_space_to_depth4_plain(torch.from_numpy(x), s_in)
    np.testing.assert_array_equal(_fold4(tbl[x]), plain.numpy())
    mul = np.arange(256, dtype=np.float32) * np.float32(1 / 255.0)
    tbl_mul = np.clip(np.rint(mul / np.float32(s_in)), -127, 127)
    tbl_mul = tbl_mul.astype(np.int8)
    ref_u8 = np.asarray(jpc.quant_space_to_depth4(jnp.asarray(x),
                                                  jnp.float32(s_in)))
    np.testing.assert_array_equal(_fold4(tbl_mul[x]), ref_u8)
    apart = int((tbl != tbl_mul).sum())
    assert apart == (31 if s_in == 0.0078431377 else 0)
    assert np.all(np.abs(tbl.astype(int) - tbl_mul) <= 1)


@pytest.mark.parametrize("s_in,ties", [(1 / 127.0, 0), (0.0078431377, 65)])
def test_code_table_ties_go_to_even(s_in, ties):
    """At s = 0.0078431377 = f32(2/255), u / 255 / s lands exactly on .5
    in float32 for 65 byte values; the table rounds those to even, as
    rintf does. At s = 1/127 none does."""
    q = np.arange(256, dtype=np.float32) / np.float32(255.0) / np.float32(s_in)
    at = np.flatnonzero(q - np.floor(q) == 0.5)
    assert at.size == ties
    tbl = tfc.qs2d4_code_table(s_in).astype(np.int64)
    assert np.all(tbl[at] % 2 == 0)
    assert np.all(np.abs(tbl[at] - q[at]) == 0.5)


def test_code_table_lookups_conflict_at_most_two_ways(r):
    """One 256-byte table spreads its 64 words two to a bank, so a warp's
    32 lookups touch at most two distinct words of any bank (a conflict of
    at most two ways). One copy a lane group at a plain stride adds
    distinct words to the same banks and conflicts more on random bytes;
    one copy a lane with all its words in the lane's own bank (word w of
    lane L's copy at shared word 32 w + L) never conflicts, at 32 times the
    table's build and an index computation a lookup, which measured slower
    on the card (PERF.md). Why the kernel keeps one copy."""
    v = r.integers(0, 256, (4000, 32))
    lane = np.arange(32)

    def mean_degree(words):
        return np.mean([np.bincount(np.unique(wd) % 32, minlength=32).max()
                        for wd in words])
    single = mean_degree(v // 4)
    assert 1.5 < single <= 2.0
    for groups in (2, 4, 32):
        for stride in (64, 65, 72):
            assert mean_degree((lane % groups) * stride + v // 4) > single
    assert mean_degree(32 * (v // 4) + lane) == 1.0
