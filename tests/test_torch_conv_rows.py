"""The small-Cin W8A8 conv (the "rows" route of ``ops/conv.conv2d_w8a8``,
``csrc/conv_w8a8_rows.cu``) on the CPU.

- ``conv2d_w8a8`` in the route's forms (k7/s2 and k3/s1 at Cin 3, both
  pad splits at stride 2, relu, leaky and linear, int8 codes and f32
  outputs) equals the JAX package's ``conv2d_w8a8`` bit for bit (on the
  CPU the route runs its plain version);
- the kernel's addressing replayed in numpy (``replay``): each unit's
  staged band (``rb``-byte rows, ``padb`` zero bytes before the row; a
  uint8 band translated in place through the table's per-lane copies),
  each kernel row a run of K, every 4-byte group of A read as two aligned
  words and a funnel shift by its phase mod 4 at the K offsets of the
  kernel's shared-memory table, the warpgroups' tiles and the warps'
  tensor stores covering every pixel once, times the B tile unswizzled
  from ``rows_tile_matrix``, equals ``conv_acc_plain``'s int32 sums at
  ResNet-18's stem, the YOLO entry conv and odd sizes; every read stays
  inside its staged row;
- the kernel's epilogue replayed in numpy: its one clamp (to +-RN(127
  s_out)) gives the plain version's codes on accumulators that cross
  both clamps; its staging buffers' 64-byte swizzle is the copy engine's,
  and no store of a warp meets another lane's in a bank;
- the uint8 entry form (``conv2d_w8a8_u8``): its code table equals
  JAX's op-by-op u / 255 and ``quantize_act`` on all 256 bytes at several
  scales (a rounding tie among them), its plain version equals JAX's
  ``xla`` entry stage (u / 255, ``quantize_act``, ``conv2d_w8a8``) bit for
  bit, and a ResNet-18 W8A8 engine fed a uint8 batch (which takes this
  form) equals the JAX engine run op by op;
  its table is made once by ``prepare_plan_params``, never by a forward;
- ``conv_w8a8_form``: the route at ResNet-18's stem and the YOLO entry
  conv at their batches; the im2col route kept for a group-max, the int32
  accumulator and kw Cin > 32.

The module runs on one thread: many small numpy and torch ops (ROADMAP
C5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from dnn_inference_engine_tpu.config import EngineConfig as JConfig
from dnn_inference_engine_tpu.ops import conv as jconv
from dnn_inference_engine_tpu.quant.quantize import (
    quantize_act as jquantize_act)
from dnn_inference_engine_tpu.runtime import plan as jplan
from dnn_inference_engine_tpu.runtime.engine import Engine as JEngine

from dnn_inference_engine_tpu_torch.config import EngineConfig
from dnn_inference_engine_tpu_torch.ops import conv as tconv
from dnn_inference_engine_tpu_torch.runtime import plan as tplan
from dnn_inference_engine_tpu_torch.runtime.engine import Engine

SMS = 132                            # an H100 SXM


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(torch_threads)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(seed, xs, k, cout):
    r = np.random.default_rng(seed)
    x = r.integers(-127, 128, xs).astype(np.int8)
    w = r.integers(-127, 128, (k, k, xs[3], cout)).astype(np.int8)
    s_w = (r.uniform(0.5, 1.5, cout) * 2e-4).astype(np.float32)
    b = r.standard_normal(cout).astype(np.float32)
    return x, w, s_w, b


# (x shape, k, stride, Cout): ResNet-18's stem form at two sizes (30: pads
# (2, 3), as at 224; 31 x 29: (3, 3)), the YOLO entry conv's
CASES = [((2, 30, 30, 3), 7, 2, 64), ((2, 31, 29, 3), 7, 2, 64),
         ((2, 20, 20, 3), 3, 1, 16)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-k{c[1]}s{c[2]}")
@pytest.mark.parametrize("act", ["relu", "leaky", "linear"])
@pytest.mark.parametrize("s_out", [0.05, None], ids=["int8", "f32"])
def test_rows_forms_match_jax_conv2d_w8a8(case, act, s_out):
    """Bit for bit against JAX: int8 codes (conv order) and f32 outputs."""
    xs, k, stride, cout = case
    x, w, s_w, b = _inputs(21, xs, k, cout)
    f = tconv.conv_w8a8_form(*xs, cout, k, k, stride, "SAME", None,
                             s_out is not None)
    assert f.route == "rows"
    want = np.asarray(jconv.conv2d_w8a8(
        jnp.asarray(x), jnp.float32(0.02), jnp.asarray(w), jnp.asarray(s_w),
        jnp.asarray(b), act=act, stride=stride,
        s_out=None if s_out is None else jnp.float32(s_out)))
    got = tconv.conv2d_w8a8(T(x), 0.02, T(w), T(s_w), T(b), act=act,
                            stride=stride, s_out=s_out)
    assert got.dtype == (torch.int8 if s_out else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rows_pads_split_as_xla():
    """The pads the kernel is given are XLA's SAME pads, asymmetric at
    stride 2: (2, 3) at 224 and 30 px for k7, (3, 3) at 31 and 29 px."""
    p = tconv.rows_plan(32, 224, 224, 3, 64, 7, 2, SMS)
    assert (p.pt, p.pl, p.ho, p.wo) == (2, 2, 112, 112)
    p = tconv.rows_plan(2, 30, 30, 3, 64, 7, 2, SMS)
    assert (p.pt, p.pl, p.ho, p.wo) == (2, 2, 15, 15)
    p = tconv.rows_plan(2, 31, 29, 3, 64, 7, 2, SMS)
    assert (p.pt, p.pl, p.ho, p.wo) == (3, 3, 16, 15)
    p = tconv.rows_plan(2, 416, 416, 3, 16, 3, 1, SMS)
    assert (p.pt, p.pl, p.ho, p.wo) == (1, 1, 416, 416)


def _unswizzle(tile, cout, kbytes):
    """The (Cout, kbytes) K-major B from the 128-byte swizzled tile: byte
    kk of row o at K atom kk // 128, row o, chunk (kk % 128) // 16 XOR o
    % 8."""
    o = np.arange(cout)[:, None]
    kk = np.arange(kbytes)[None, :]
    c = kk % 128
    idx = (kk // 128) * cout * 128 + o * 128 + ((c // 16) ^ (o % 8)) * 16 \
        + c % 16
    return tile[idx]


def koff_table(p, k):
    """The kernel's shared-memory K offsets: entry (2kc + h) 4 + t is
    4-byte group j = 8kc + 4h + t of K, kernel row j // (run/4), 4 (j %
    (run/4)) bytes into its run; a group past the last run reads the
    pixel's first word (it meets zero rows of B)."""
    gpr = p.run // 4
    j = np.arange(8 * 7)
    i = j // gpr
    return np.where(i < k, i * p.rb + 4 * (j - i * gpr), 0)


def translate(band, nbytes, codes):
    """The kernel's in-place translation of a landed uint8 band: word i
    goes to thread i % 256, whose lane l = i % 32 reads byte 32 u + l of
    the table's copies (each copy the 256 codes)."""
    tab = np.repeat(codes.view(np.uint8), 32)
    lane = (np.arange(nbytes // 4) % 256) % 32
    b = band[:nbytes].reshape(-1, 4).astype(np.int64)
    band[:nbytes] = tab[32 * b + lane[:, None]].reshape(-1)


def tile_rows(npx):
    """(unit pixel of each row a warp stores, the pixel its A reads) for
    one unit, in the kernel's order: warpgroup wgi takes tiles 64 wgi +
    128 i, each of 4 warps 16 rows (lane rows g and g + 8); a row past the
    unit's last pixel reads the last."""
    rows = []
    for wgi in range(2):
        for i in range((npx - 64 * wgi + 127) // 128):
            for w in range(4):
                rows.extend(64 * wgi + 128 * i + 16 * w + np.arange(16))
    rows = np.array(rows, np.int64)
    return rows, np.minimum(rows, npx - 1)


def replay(x, w, stride, codes=None):
    """The kernel's sums, in numpy, as ``csrc/conv_w8a8_rows.cu`` forms
    them: (N, Ho, Wo, Cout) int64. With ``codes`` x is the uint8 wire and
    each staged band is translated through the table first."""
    n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    p = tconv.rows_plan(n, h, wd, cin, cout, k, stride, SMS)
    assert p.ksteps <= 7 and p.padb % 16 == 0 and p.rb % 16 == 0
    assert p.upx % 64 == 0
    assert 0 < p.grid <= tconv.ROWS_BLOCKS_PER_SM[cout] * SMS
    tile = tconv.rows_tile_matrix(T(w)).numpy()
    kbytes = 32 * p.ksteps
    bmat = _unswizzle(tile, cout, kbytes).astype(np.int64)
    gpr = p.run // 4
    j = np.arange(8 * p.ksteps)                  # 4-byte groups of K
    i = j // gpr
    koff = koff_table(p, k)[:8 * p.ksteps]
    total = p.ho * p.wo
    out = np.zeros((n, total, cout), np.int64)
    seen = np.zeros((n, total), np.int64)
    for u in range(p.units):
        img, ui = divmod(u, p.units_img)
        px0 = ui * p.upx
        npx = min(p.upx, total - px0)
        y0, y1 = px0 // p.wo, (px0 + npx - 1) // p.wo
        nr = stride * (y1 - y0) + k
        assert nr <= p.nr
        band = np.zeros(p.nr * p.rb, np.uint8)
        for r in range(nr):
            row = stride * y0 - p.pt + r
            if 0 <= row < h:
                band[r * p.rb + p.padb:r * p.rb + p.padb + wd * cin] = (
                    x[img, row].reshape(-1).view(np.uint8))
        if codes is not None:
            translate(band, nr * p.rb, codes)
        stored, read = tile_rows(npx)
        # a row past the unit is past the image: the tensor map clips it
        assert (stored < npx).all() or px0 + npx == total
        pix = px0 + read[stored < npx]
        oy, ox = pix // p.wo, pix % p.wo
        base = (stride * (oy - y0) * p.rb + stride * ox * cin + p.padb
                - p.pl * cin)
        addr = (base & ~3)[:, None] + koff[None, :]
        # a group's two words lie inside the staged row it reads
        row_of = (base // p.rb)[:, None] + np.where(i < k, i, 0)[None, :]
        assert (addr >= row_of * p.rb).all()
        assert (addr + 8 <= (row_of + 1) * p.rb).all()
        words = band.view(np.uint32).astype(np.uint64)
        lo, hi = words[addr // 4], words[addr // 4 + 1]
        sh = (8 * (base & 3)).astype(np.uint64)[:, None]
        val = (((hi << np.uint64(32)) | lo) >> sh) & np.uint64(0xFFFFFFFF)
        a = val.astype(np.uint32).view(np.uint8).reshape(len(pix), -1)
        a = a.view(np.int8).astype(np.int64)
        out[img, pix] = a @ bmat.T
        np.add.at(seen[img], pix, 1)
    assert (seen == 1).all()
    return out.reshape(n, p.ho, p.wo, cout)


# (x shape, k, stride, Cout): the stem at 224 px, the YOLO entry conv at
# 416 px, odd sizes (a width whose rows are not 16-byte multiples: the
# word-by-word staging), Cin 8 (runs of 24 bytes, aligned) and Cin 5 k5
@pytest.mark.parametrize("case", [
    ((1, 224, 224, 3), 7, 2, 64), ((1, 416, 416, 3), 3, 1, 16),
    ((2, 31, 29, 3), 7, 2, 64), ((2, 20, 20, 3), 3, 1, 16),
    ((3, 17, 23, 3), 3, 2, 16), ((2, 12, 13, 8), 3, 1, 16),
    ((2, 15, 15, 5), 5, 2, 64), ((1, 9, 9, 3), 7, 1, 64)],
    ids=lambda c: f"{c[0]}-k{c[1]}s{c[2]}")
def test_replayed_addressing_equals_conv_acc_plain(case):
    xs, k, stride, cout = case
    x, w, _, _ = _inputs(33, xs, k, cout)
    want = tconv.conv_acc_plain(T(x), T(w), stride).numpy()
    np.testing.assert_array_equal(replay(x, w, stride), want)


def test_rows_tile_matrix_is_cached_and_holds_every_weight_once():
    x, w, _, _ = _inputs(5, (1, 8, 8, 3), 7, 64)
    wt = T(w)
    tile = tconv.rows_tile_matrix(wt)
    assert tconv.rows_tile_matrix(wt) is tile
    assert tile.numel() == tconv.rows_tile_bytes(3, 64, 7) == 2 * 64 * 128
    idx = tconv.rows_tile_index(3, 64, 7).reshape(-1)
    assert len(set(idx.tolist())) == idx.numel() == 7 * 7 * 3 * 64
    rest = np.ones(tile.numel(), bool)
    rest[idx.numpy()] = False
    assert not tile.numpy()[rest].any()          # padding bytes are zero
    wt.add_(0)                                   # written in place
    assert tconv.rows_tile_matrix(wt) is not tile


@pytest.mark.parametrize("batch", [32, 1])
def test_form_resnet18_stem_takes_rows(batch):
    f = tconv.conv_w8a8_form(batch, 224, 224, 3, 64, 7, 7, 2, "SAME", None,
                             True)
    p = tconv.rows_plan(batch, 224, 224, 3, 64, 7, 2, SMS)
    assert f == tconv.ConvForm("rows", 24, 6, p.units, p.grid)
    assert (p.run, p.ksteps, p.padb) == (24, 6, 16)


@pytest.mark.parametrize("batch", [1, 2, 8, 32])
def test_form_yolo_entry_conv_takes_rows(batch):
    f = tconv.conv_w8a8_form(batch, 416, 416, 3, 16, 3, 3, 1, "SAME", None,
                             True)
    assert f.route == "rows" and (f.kb, f.steps) == (12, 2)
    assert 0 < f.grid <= tconv.ROWS_BLOCKS_PER_SM[16] * SMS
    assert f.tiles >= f.grid


@pytest.mark.parametrize("kw", [
    dict(gmax=True), dict(quantized=False, raw=True)], ids=["gmax", "raw"])
def test_form_group_max_and_int32_keep_im2col(kw):
    args = dict(quantized=True, **kw) if "gmax" in kw else kw
    for k, stride, cout in ((3, 1, 16), (7, 2, 64)):
        f = tconv.conv_w8a8_form(2, 20, 20, 3, cout, k, k, stride, "SAME",
                                 None, **args)
        assert f.route == "im2col"


@pytest.mark.parametrize("shape", [
    (12, 3, 1, 16), (3, 11, 2, 64), (3, 3, 1, 32), (3, 3, 1, 48),
    (3, 3, 1, 128), (3, 4, 1, 16), (3, 3, 3, 16)],
    ids=lambda s: f"cin{s[0]}k{s[1]}s{s[2]}co{s[3]}")
def test_form_refused_rows_shapes_keep_im2col(shape):
    """kw Cin > 32 (Cin 12 at k3, Cin 3 at k11), a Cout other than 16 or
    64, an even k, stride 3."""
    cin, k, stride, cout = shape
    f = tconv.conv_w8a8_form(2, 20, 20, cin, cout, k, k, stride, "SAME")
    assert f.route == "im2col"


# (x shape, k, stride, Cout, s_in): the uint8 wire at the stem's and the
# entry conv's forms; s_in 0.0035 saturates the bytes above 227
U8_CASES = [((1, 224, 224, 3), 7, 2, 64, 0.0078125),
            ((2, 31, 29, 3), 7, 2, 64, 0.0035),
            ((1, 416, 416, 3), 3, 1, 16, 0.0041),
            ((3, 17, 23, 3), 3, 2, 16, 0.0078125)]


@pytest.mark.parametrize("case", U8_CASES,
                         ids=lambda c: f"{c[0]}-k{c[1]}s{c[2]}")
def test_replayed_uint8_band_equals_conv_acc_plain_of_its_codes(case):
    """The uint8 form: the band staged from the wire, translated through
    the table's per-lane copies, read as the int8 form reads its codes."""
    xs, k, stride, cout, s_in = case
    r = np.random.default_rng(34)
    xu = r.integers(0, 256, xs).astype(np.uint8)
    _, w, _, _ = _inputs(34, (1, 1, 1, 3), k, cout)
    codes = tconv.entry_code_table(s_in, "cpu").numpy()
    assert codes[0] == 0
    want = tconv.conv_acc_plain(T(codes[xu]), T(w), stride).numpy()
    np.testing.assert_array_equal(replay(xu, w, stride, codes), want)


def test_k_offsets_table_is_the_per_thread_offsets():
    """The shared-memory offsets the kernel reads are each thread's
    offsets: koff[kk] for group j = (kk/2) 8 + (kk%2) 4 + t, at every
    (kk, t)."""
    for args in ((32, 224, 224, 3, 64, 7, 2), (8, 416, 416, 3, 16, 3, 1),
                 (2, 15, 15, 5, 64, 5, 2)):
        p = tconv.rows_plan(*args, SMS)
        k, gpr = args[5], p.run // 4
        tab = koff_table(p, k)
        for kk in range(14):
            for t in range(4):
                j = (kk // 2) * 8 + (kk % 2) * 4 + t
                i = j // gpr
                want = i * p.rb + 4 * (j - i * gpr) if i < k else 0
                assert tab[kk * 4 + t] == want


def epilogue_codes(acc, scale, bias, act, s_out):
    """The kernel's out_value<0> in numpy float32, each step rounded: y =
    act(f32(acc) scale + bias), clamped once to +-RN(127 s_out), divided
    (correctly rounded, as wg::div_rn), rounded half to even with no
    further clamp."""
    y = acc.astype(np.float32) * scale + bias
    if act == "leaky":
        y = np.where(y > 0, y, np.float32(0.1) * y)
    elif act == "relu":
        y = np.where(y > 0, y, np.float32(0))
    s = np.float32(s_out)
    clip = np.float32(127) * s
    q = np.clip(y, -clip, clip) / s
    assert q.dtype == np.float32 and (np.abs(q) <= 127.5).all()
    return np.rint(q).astype(np.int8)


@pytest.mark.parametrize("s_out", [0.05, 0.0173, 3.3e-3, 1.7, 2.0 ** -7])
@pytest.mark.parametrize("act", ["relu", "leaky", "linear"])
def test_epilogue_one_clamp_gives_the_plain_codes(act, s_out):
    """Accumulators across the whole code range and past both ends (and
    densely around +-127.5 s_out), through the kernel's single clamp,
    against ``conv_epilogue``'s codes (clamp after the division)."""
    r = np.random.default_rng(35)
    cout = 64
    s_in = 0.02
    s_w = (r.uniform(0.5, 1.5, cout) * 2e-4).astype(np.float32)
    b = (r.standard_normal(cout) * 0.3).astype(np.float32)
    scale = np.float32(s_in) * s_w
    edge = np.round(127.5 * np.float32(s_out) / scale).astype(np.int64)
    near = np.concatenate([e + np.arange(-300, 301)[:, None] * np.array([1])
                           for e in (edge, -edge)], 0)
    wide = r.integers(-(2 ** 21), 2 ** 21, (2000, cout))
    acc = np.clip(np.concatenate([near, wide], 0), -(2 ** 21), 2 ** 21)
    acc = acc.astype(np.int32)
    want = tconv.conv_epilogue(T(acc), s_in, T(s_w), T(b), act,
                               s_out).numpy()
    np.testing.assert_array_equal(epilogue_codes(acc, scale, b, act, s_out),
                                  want)


@pytest.mark.parametrize("cout,es", [(64, 1), (16, 1), (16, 4), (64, 4)],
                         ids=["int8-64", "int8-16", "f32-16", "f32-64"])
def test_staging_buffers_are_the_tensor_stores_boxes(cout, es):
    """A warp's staging buffer as the epilogue writes it (lane 4g + t:
    rows g and g + 8, columns 8j + 2t and 8j + 2t + 1; a 64-byte pixel in
    the 64-byte swizzle) and as the copy engine reads it back for the
    tensor store (chunk c of row r at c ^ ((r / 2) % 4)): every output
    byte once, in its place; where the pixel is 16 or 64 bytes of codes,
    no store meets another lane's word in a bank."""
    rb = cout * es
    sw = rb == 64
    where = np.full(16 * rb, -1, np.int64)      # staged byte -> output byte
    for j in range(cout // 8):
        for h in range(2):
            banks = {}
            for lane in range(32):
                g, t = lane // 4, lane % 4
                row, c = g + 8 * h, es * (8 * j + 2 * t)
                xr = ((g >> 1) & 3) << 4 if sw else 0
                off = row * rb + (((c & ~15) ^ xr) | (c & 15))
                for b in range(2 * es):
                    assert where[off + b] == -1
                    where[off + b] = row * rb + c + b
                for word in range(off // 4, (off + 2 * es - 1) // 4 + 1):
                    banks.setdefault(word % 32, set()).add(word)
            if es == 1:
                assert all(len(v) == 1 for v in banks.values()), (j, h)
    assert (where >= 0).all()
    o = np.arange(16 * rb)
    row, x = o // rb, o % rb
    back = row * rb + (((((x >> 4) ^ ((row >> 1) & 3)) << 4) | (x & 15))
                       if sw else x)
    np.testing.assert_array_equal(back, where)


# input scales for the table: 1/127.5, 1/127, a saturating one, a
# calibration-like one, and 2 f32(1/255), at which byte 1 is the tie 0.5
TABLE_SCALES = [0.0078431377, 1 / 127, 0.003, 0.00412,
                float(2 * (np.float32(1) / np.float32(255)))]


@pytest.mark.parametrize("s_in", TABLE_SCALES)
def test_code_table_equals_jax_op_by_op_on_every_byte(s_in):
    u = np.arange(256, dtype=np.uint8)
    got = tconv.entry_code_table(s_in, "cpu").numpy()
    want = np.asarray(jquantize_act(jnp.asarray(u).astype(jnp.float32)
                                    / 255.0, jnp.float32(s_in)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tconv.entry_codes_plain(T(u), s_in).numpy())
    v = np.float32(1) / np.float32(255)
    if s_in == float(2 * v):
        assert v / np.float32(s_in) == np.float32(0.5) and got[1] == 0
    assert got[0] == 0


@pytest.mark.parametrize("case", [
    ((2, 64, 64, 3), 7, 2, 64, "relu"), ((2, 31, 29, 3), 7, 2, 64, "relu"),
    ((2, 64, 64, 3), 3, 1, 16, "leaky"), ((2, 20, 20, 3), 3, 1, 16, "leaky")],
    ids=lambda c: f"{c[0]}-k{c[1]}s{c[2]}")
@pytest.mark.parametrize("s_out", [0.05, None], ids=["int8", "f32"])
def test_uint8_entry_plain_matches_jax_xla_entry(case, s_out):
    """``conv2d_w8a8_u8`` on the CPU (its plain version) against JAX's
    ``xla`` entry stage op by op: u / 255, ``quantize_act``,
    ``conv2d_w8a8``, bit for bit."""
    xs, k, stride, cout, act = case
    s_in = 0.0078125
    r = np.random.default_rng(36)
    xu = r.integers(0, 256, xs).astype(np.uint8)
    _, w, s_w, b = _inputs(36, (1, 1, 1, 3), k, cout)
    xq = jquantize_act(jnp.asarray(xu).astype(jnp.float32) / 255.0,
                       jnp.float32(s_in))
    want = np.asarray(jconv.conv2d_w8a8(
        xq, jnp.float32(s_in), jnp.asarray(w), jnp.asarray(s_w),
        jnp.asarray(b), act=act, stride=stride,
        s_out=None if s_out is None else jnp.float32(s_out)))
    e = tconv.entry_codes(s_in, T(s_w))
    got = tconv.conv2d_w8a8_u8(T(xu), e, T(w), T(s_w), T(b), act=act,
                               stride=stride, s_out=s_out)
    np.testing.assert_array_equal(got.numpy(), want)


def test_uint8_entry_refuses_other_forms():
    _, w, s_w, b = _inputs(37, (1, 1, 1, 16), 3, 16)
    e = tconv.entry_codes(0.01, T(s_w))
    xu = torch.zeros((1, 8, 8, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8 form"):
        tconv.conv2d_w8a8_u8(xu, e, T(w), T(s_w), T(b))
    _, w, s_w, b = _inputs(37, (1, 1, 1, 3), 3, 16)
    with pytest.raises(ValueError, match="uint8 form"):
        tconv.conv2d_w8a8_u8(torch.zeros((1, 8, 8, 3), dtype=torch.int8), e,
                             T(w), T(s_w), T(b))


def test_resnet18_engine_reads_uint8_as_jax_op_by_op(monkeypatch):
    """A ResNet-18 W8A8 engine (the all-xla plan) takes its uint8 batch
    into the entry conv's uint8 form (no /255 pass in front): the stem's
    output equals JAX's plan run op by op on the batch / 255 bit for bit,
    and ``classify`` equals the JAX engine run op by op within 1e-5 of the
    largest logit (the pool sums in another order)."""
    kw = dict(model="resnet18", mode="w8a8", batch=2, input_size=64,
              num_classes=10)
    calib = np.random.default_rng(12).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32)
    jeng = JEngine(JConfig(kernel="auto", **kw)).load_weights(
        key=jax.random.PRNGKey(0)).prepare(calib)
    teng = Engine(EngineConfig(**kw), device="cpu").load_weights(
        params=jax.tree.map(np.asarray, jeng.params),
        act_scales=jeng.act_scales).prepare()
    assert tplan.plan_entry_u8_rows(teng.model, teng._plan)
    assert not tplan.plan_input_uint8_ok(teng._plan)
    u8 = np.random.default_rng(13).integers(0, 256, (2, 64, 64, 3),
                                            dtype=np.uint8)
    assert teng._input(T(u8)).dtype == torch.uint8
    assert teng._bench_input(2).dtype == torch.uint8
    trec, jrec = [], []
    tplan.plan_forward_w8a8(teng.model, teng._plan, teng._plan_params,
                            teng.act_scales, T(u8), record_states=trec)
    jplan.plan_forward_w8a8(jeng.model, jeng._plan, jeng._plan_params,
                            jeng.act_scales,
                            jnp.asarray(u8).astype(jnp.float32) / 255.0,
                            record_states=jrec)
    assert "entry_codes" in teng._plan_params[0]
    np.testing.assert_array_equal(trec[1][0].numpy(), np.asarray(jrec[1][0]))
    monkeypatch.setattr(jax, "jit", lambda f=None, **k: f)
    want = np.asarray(jeng.classify(u8))
    got = teng.classify(u8)
    assert got.shape == (2, 10)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_plan_entry_u8_rows_only_for_an_xla_small_cin_entry():
    """The port's own predicate: ResNet-18's all-xla plan and a YOLO plan
    with an ``xla`` entry take the uint8 form; the YOLO pins (a fused
    entry kernel) and a gemm-tier entry do not."""
    from dnn_inference_engine_tpu_torch.models import build_model
    res = build_model("resnet18", num_classes=10)
    assert tplan.plan_entry_u8_rows(res, tplan.build_plan(res, {}))
    yolo = build_model("yolov2-tiny")
    pin = tplan.build_plan(yolo, None, batch=32, mode="w8a8")
    assert pin[0].kind == "stem_rs"
    assert not tplan.plan_entry_u8_rows(yolo, pin)
    xla = tplan.build_plan(yolo, {0: ("xla", 1)}, mode="w8a8")
    assert xla[0].kind == "xla" and tplan.plan_entry_u8_rows(yolo, xla)
    gemm = tplan.build_plan(yolo, {0: ("gemm", 1)}, mode="w8a8")
    assert gemm[0].kind == "gemm" and not tplan.plan_entry_u8_rows(yolo,
                                                                   gemm)


def test_entry_codes_built_once_by_prepare_plan_params():
    """The uint8 entry's code table is made with the plan's params, not by
    the forward: ``prepare_plan_params`` given the scales holds
    ``entry_codes`` at the entry's scale (the table ``entry_code_table``
    gives), a forward leaves the params as they were, and params prepared
    without the scales make a uint8 forward raise rather than build it."""
    from dnn_inference_engine_tpu_torch.models import build_model
    from dnn_inference_engine_tpu_torch.quant.quantize import (
        quantize_model_params)
    model = build_model("yolov2-tiny")
    stages = tplan.build_plan(model, {0: ("xla", 1)}, mode="w8a8")
    assert tplan.plan_entry_u8_rows(model, stages)
    q = quantize_model_params(model.init_params(
        torch.Generator().manual_seed(3), device="cpu"), model.layers)
    scales = [0.0078431377 * (1 + i % 3) for i in range(len(model.layers))]
    pp = tplan.prepare_plan_params(model, q, stages[:1], scales)
    e = pp[0]["entry_codes"]
    assert e.s_in == scales[0]
    assert torch.equal(e.codes, tconv.entry_code_table(scales[0], "cpu"))
    u8 = T(np.random.default_rng(21).integers(0, 256, (1, 16, 16, 3),
                                              dtype=np.uint8))
    keys, codes = sorted(pp[0]), e.codes.clone()
    tplan._run_stage(model.layers, stages[0], pp[0], u8, None, 1, scales)
    assert sorted(pp[0]) == keys and pp[0]["entry_codes"] is e
    assert torch.equal(e.codes, codes)
    bare = tplan.prepare_plan_params(model, q, stages[:1])
    assert "entry_codes" not in bare[0]
    with pytest.raises(ValueError, match="entry_codes"):
        tplan._run_stage(model.layers, stages[0], bare[0], u8, None, 1,
                         scales)
