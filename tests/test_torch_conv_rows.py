"""The small-Cin W8A8 conv (the "rows" route of ``ops/conv.conv2d_w8a8``,
``csrc/conv_w8a8_rows.cu``) on the CPU.

- ``conv2d_w8a8`` in the route's forms (k7/s2 and k3/s1 at Cin 3, both
  pad splits at stride 2, relu, leaky and linear, int8 codes and f32
  outputs) equals the JAX package's ``conv2d_w8a8`` bit for bit (on the
  CPU the route runs its plain version);
- the kernel's addressing replayed in numpy (``replay``): each unit's
  staged band (``rb``-byte rows, ``padb`` zero bytes before the row),
  each kernel row a run of K, every 4-byte group of A read as two aligned
  words and a funnel shift by its phase mod 4, times the B tile unswizzled
  from ``rows_tile_matrix``, equals ``conv_acc_plain``'s int32 sums at
  ResNet-18's stem, the YOLO entry conv and odd sizes; every read stays
  inside its staged row;
- ``conv_w8a8_form``: the route at ResNet-18's stem and the YOLO entry
  conv at their batches; the im2col route kept for a group-max, the int32
  accumulator and kw Cin > 32.

The module runs on one thread: many small numpy and torch ops (ROADMAP
C5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from dnn_inference_engine_tpu.ops import conv as jconv

from dnn_inference_engine_tpu_torch.ops import conv as tconv

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


def replay(x, w, stride):
    """The kernel's sums, in numpy, as ``csrc/conv_w8a8_rows.cu`` forms
    them: (N, Ho, Wo, Cout) int64."""
    n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    p = tconv.rows_plan(n, h, wd, cin, cout, k, stride, SMS)
    assert p.ksteps <= 7 and p.padb % 16 == 0 and p.rb % 16 == 0
    assert p.upx % 64 == 0 and 0 < p.grid <= 2 * SMS
    tile = tconv.rows_tile_matrix(T(w)).numpy()
    kbytes = 32 * p.ksteps
    bmat = _unswizzle(tile, cout, kbytes).astype(np.int64)
    gpr = p.run // 4
    j = np.arange(8 * p.ksteps)                  # 4-byte groups of K
    i = j // gpr
    koff = np.where(i < k, i * p.rb + 4 * (j % gpr), 0)
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
        pix = px0 + np.arange(npx)
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
        a = val.astype(np.uint32).view(np.uint8).reshape(npx, -1)
        a = a.view(np.int8).astype(np.int64)
        out[img, px0:px0 + npx] = a @ bmat.T
        seen[img, px0:px0 + npx] += 1
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
    assert 0 < f.grid <= 2 * SMS and f.tiles >= f.grid


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
