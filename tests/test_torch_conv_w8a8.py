"""The W8A8 conv of the xla tier (``ops/conv.py``, ``csrc/conv_w8a8.cu``) on
the CPU.

Three things, at toy sizes:

- ``conv2d_w8a8_plain`` bit for bit against the JAX package's
  ``conv2d_w8a8`` (XLA's int8 conv) and against the JAX plan's
  ``_run_stage`` for the ``fold_xla``, ``fold_xla_k2`` (its input from
  ``shift_s2d2_pallas``, run as the JAX tests run it on the CPU) and
  ``xla`` stages, at every form the pins give the kernel (k3 SAME, the
  trimmed k2 VALID fold, Cin 384, the group-max) and with ``s_out`` values
  that take the kernel's mode 4;
- a numpy replay of the kernel's two ways of bringing A to wgmma (PATCH:
  16 x 8 pixel tiles, a TMA box a tap row with the copy engine's zero
  fill, the taps as row shifts, the trimmed output; at stride 2 (ResNet-18's
  3x3/s2 and 1x1/s2 convs, XLA's SAME pads) two boxes a tap row landing
  every other column and row, held to ``extract_patches``; TAP: the batch as
  flat rows, the copy engine's im2col box a (tap, chunk) step, walking
  the output grid across rows and images with its zero fill) under its
  schedules (round robin, stream-K pieces summed by the fixup), its
  pool-major columns and its epilogue, against the plain version;
- ``conv_w8a8_form`` taking the kernel for every 3x3 conv of the YOLOv2
  b1, b8 and b32 pins and the YOLOv3 pin at b16 and b1 at 416 px (each
  plan driven at batch 1 on the CPU, its convs' shapes scaled to the
  pin's batch).

The replays make many small integer products in int64 (no BLAS), and the
module pins one thread (ROADMAP C5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from dnn_inference_engine_tpu.ops import conv as jconv
from dnn_inference_engine_tpu.runtime import plan as jplan

from dnn_inference_engine_tpu_torch.ops import conv as tconv
from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
    _same_pads, extract_patches)
from dnn_inference_engine_tpu_torch.ops.fused_conv import (
    group_max4, rs_tile_matrix)
from dnn_inference_engine_tpu_torch.ops.gemm import kmajor_weights
from dnn_inference_engine_tpu_torch.runtime import plan as tplan

SMS = 132                            # an H100 SXM


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(torch_threads)


def T(a):
    return torch.from_numpy(np.array(a))


def _args(r, xs, k, cout, s_out=0.05, s_in=0.02, gmax=False):
    """x, w, s_w, b with codes spread over +-127 at |s_out|; with the
    group-max the four groups share s_w and b, as in a fold stage."""
    cin = xs[3]
    x = r.integers(-127, 128, xs).astype(np.int8)
    w = r.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    spread = abs(s_out) * 60.0 / (s_in * (k * k * cin) ** 0.5 * 5376.0)
    n = cout // 4 if gmax else cout
    s_w = (r.uniform(0.5, 1.5, n) * spread).astype(np.float32)
    b = (r.standard_normal(n) * 20.0 * abs(s_out)).astype(np.float32)
    if gmax:
        s_w, b = np.tile(s_w, 4), np.tile(b, 4)
    return x, w, s_w, b


# (x shape, k, Cout, trimmed output, group-max): the kernel's forms at toy
# size -- k3 SAME of the fold-2 tensor and of the tail (Cin 64 .. 384), the
# shifted k2 fold trimmed to its real rows and columns, a ragged Cout
FORMS = [((2, 12, 12, 64), 3, 128, None, True),
         ((2, 10, 9, 128), 2, 256, (8, 8), True),
         ((2, 10, 10, 64), 3, 128, None, False),
         ((2, 5, 5, 384), 3, 64, None, False),
         ((1, 7, 6, 256), 3, 512, None, False),
         ((3, 5, 4, 48), 2, 80, (3, 3), True),
         ((2, 9, 7, 32), 3, 40, None, False)]
# s_out values: normal (the kernel's conv order, wg::div_rn), then values
# that take its mode 4 (the double product): negative, and so large that
# 128 s_out overflows float32
S_OUTS = [0.05, -0.05, 2.7e36]


@pytest.mark.parametrize("s_out", S_OUTS)
@pytest.mark.parametrize("form", FORMS, ids=str)
def test_plain_matches_jax_conv2d_w8a8(form, s_out):
    xs, k, cout, out_hw, gmax = form
    r = np.random.default_rng(sum(xs) + cout)
    x, w, s_w, b = _args(r, xs, k, cout, s_out)
    padding = "SAME" if k == 3 else "VALID"
    ref = np.asarray(jconv.conv2d_w8a8(
        jnp.asarray(x), jnp.float32(0.02), jnp.asarray(w), jnp.asarray(s_w),
        jnp.asarray(b), act="leaky", padding=padding,
        s_out=jnp.float32(s_out)))
    if out_hw is not None:
        ref = ref[:, :out_hw[0], :out_hw[1]]
    if gmax:
        ref = np.asarray(group_max4(T(ref)))
    got = tconv.conv2d_w8a8_plain(T(x), 0.02, T(w), T(s_w), T(b),
                                  padding=padding, s_out=s_out,
                                  out_hw=out_hw, gmax=gmax)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the CPU wrapper takes the kernel's route through the plain version
    f = tconv.conv_w8a8_form(*xs, cout, k, k, 1, padding, out_hw, True, gmax)
    assert f.route in ("patch", "tap")
    got = tconv.conv2d_w8a8(T(x), 0.02, T(w), T(s_w), T(b), padding=padding,
                            s_out=s_out, out_hw=out_hw, gmax=gmax)
    np.testing.assert_array_equal(got.numpy(), ref)


def _stage(cls, kind, fold, k):
    return cls(kind=kind, conv_li=0, pool_li=1 if fold > 1 else None,
               fold=fold, k=k)


# (kind, entry x shape, fold of the entry tensor, Cout of the folded conv,
# k): a fold-2 k3 stage on the fold-2 tensor, a fold-2 k2 stage on the
# plain tensor (through shift_s2d2), xla stages at Cin 64 and 384
STAGES = [("fold_xla", (2, 12, 12, 64), 2, 128, 3),
          ("fold_xla_k2", (2, 16, 16, 32), 1, 256, 2),
          ("fold_xla_k2", (1, 10, 14, 64), 1, 128, 2),
          ("xla", (2, 9, 9, 64), 1, 96, 3),
          ("xla", (2, 5, 5, 384), 1, 128, 3)]


@pytest.mark.parametrize("s_out", [0.05, -0.05])
@pytest.mark.parametrize("case", STAGES, ids=str)
def test_plain_stage_matches_jax_run_stage(case, s_out):
    """The port's stage (conv2d_w8a8 with its group-max and trim) against
    the JAX plan's op-by-op stage on the same entry state."""
    kind, xs, cur_fold, cout, k = case
    r = np.random.default_rng(len(kind) + sum(xs))
    cin = xs[3] * (4 if kind == "fold_xla_k2" else 1)
    x = r.integers(-127, 128, xs).astype(np.int8)
    w = r.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    spread = abs(s_out) * 60.0 / (0.02 * (k * k * cin) ** 0.5 * 5376.0)
    s_w = (r.uniform(0.5, 1.5, cout) * spread).astype(np.float32)
    b = (r.standard_normal(cout) * 20.0 * abs(s_out)).astype(np.float32)
    fold = 1 if kind == "xla" else 2
    scales = [0.02, s_out]
    jst = _stage(jplan.Stage, kind, fold, k)
    tst = _stage(tplan.Stage, kind, fold, k)
    jpp = {"wq": jnp.asarray(w), "s_w": jnp.asarray(s_w),
           "b": jnp.asarray(b)}
    tpp = {"wq": T(w), "s_w": T(s_w), "b": T(b), "wt": kmajor_weights(T(w))}
    want, ws, wf = jplan._run_stage([None, None], jst, jpp, jnp.asarray(x),
                                    jnp.float32(0.02), cur_fold, scales, {})
    got, gs, gf = tplan._run_stage([None, None], tst, tpp, T(x), 0.02,
                                   cur_fold, scales)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gf == wf and np.float32(gs) == np.float32(ws)


# ---------------------------------------------------------------------------
# numpy replay of the kernel's addressing
# ---------------------------------------------------------------------------

TR, TC, PC = tconv.CONV_TR, tconv.CONV_TC, tconv.CONV_TC + 2
BM = BN = 128


def _b_rows(w, go):
    """The K-major weight matrix the kernel reads, as int64."""
    bt = rs_tile_matrix(T(w), go) if go else kmajor_weights(T(w))
    return bt.numpy().astype(np.int64)


def _b_box(bt, row0, k0, kb):
    """The TMA box of 128 rows x kb bytes of B at (k0, row0), zeros past
    the matrix."""
    out = np.zeros((BN, kb), np.int64)
    rows = bt[row0:row0 + BN, k0:k0 + kb]
    out[:rows.shape[0], :rows.shape[1]] = rows
    return out


def _col_channel(cl, nt, go, cout):
    """The conv channel of tile column cl of column block nt (load_scb),
    or -1 past the output."""
    if go:
        ch = nt * 32 + cl % 32
        return cl // 32 * go + ch if ch < go else -1
    col = nt * BN + cl
    return col if col < cout else -1


def _sum_units(f, tile_sum):
    """Each tile's int sum as the kernel forms it under ``f``'s schedule:
    every block's units (ops/conv.py block_work, the kernel's span/work),
    a piece of a straddled tile added to the tile's other pieces (the
    fixup), each (tile, step) checked to be summed once."""
    totals, steps_seen = {}, {}
    for b in range(f.grid):
        for w in tconv.block_work(f, b):
            part = tile_sum(w.tile, w.sb, w.se)
            totals[w.tile] = totals.get(w.tile, 0) + part
            steps_seen.setdefault(w.tile, []).extend(range(w.sb, w.se))
    assert sorted(steps_seen) == list(range(f.tiles))
    for t, st in steps_seen.items():
        assert sorted(st) == list(range(f.steps)), (t, st)
    return totals


def _box(xi, n, c0, iy0, ix0, rows, cols, step, kb):
    """A TMA box of ``rows`` x ``cols`` pixels of kb bytes from (c0, ix0,
    iy0, n), every ``step``-th column and row (the map's traversal
    strides), zeros outside the tensor."""
    _, h, wd, _ = xi.shape
    box = np.zeros((rows, cols, kb), np.int64)
    for j in range(rows):
        iy = iy0 + step * j
        for i in range(cols):
            ix = ix0 + step * i
            if 0 <= iy < h and 0 <= ix < wd:
                src = xi[n, iy, ix, c0:c0 + kb]
                box[j, i, :src.shape[0]] = src
    return box


def replay_patch(x, w, pad, ho, wo, go, f, stride=1):
    """The PATCH route's int32 sums in (N, Ho, Wo, conv channel) order,
    under form ``f`` (kb, steps, schedule), with every tile row's pixel as
    the epilogue maps it. ``pad``: the pad before rows and columns (an
    int) or (pad_h, pad_w). At stride 2 a step's A is two boxes with
    traversal strides 2 (csrc/conv_w8a8.cu, Patch<KB, RES, KS, 2>): the
    even columns, TC + (k-1)/2 of them, and for k = 3 the odd ones, TC;
    tap column dw reads the even box from column dw/2 or the odd box."""
    n_img, h, wd, cin = x.shape
    pad_h, pad_w = (pad, pad) if isinstance(pad, int) else pad
    ks, cout = w.shape[0], w.shape[3]
    bt = _b_rows(w, go)
    kb = f.kb
    kc = -(-cin // kb)
    assert f.steps == ks * kc
    rtiles, ctiles = -(-ho // TR), -(-wo // TC)
    ptiles = n_img * rtiles * ctiles
    xi = x.astype(np.int64)

    def tile_sum(tile, sb, se):
        nt, pt = divmod(tile, ptiles)
        n = pt // (rtiles * ctiles)
        rest = pt % (rtiles * ctiles)
        y0, x0 = rest // ctiles * TR, rest % ctiles * TC
        part = np.zeros((BM, BN), np.int64)
        for s in range(sb, se):
            dh, c0 = s // kc, s % kc * kb
            iy0, ix0 = stride * y0 + dh - pad_h, stride * x0 - pad_w
            if stride == 1:
                # the box {kb, PC, TR, 1} at (c0, x0-pad, y0+dh-pad, n)
                boxes = [_box(xi, n, c0, iy0, ix0, TR, PC, 1, kb)]
            else:
                boxes = [_box(xi, n, c0, iy0, ix0, TR, TC + (ks - 1) // 2,
                              2, kb)]
                if ks > 1:
                    boxes.append(_box(xi, n, c0, iy0, ix0 + 1, TR, TC, 2,
                                      kb))
            for dw in range(ks):
                # core matrix j: box row j from the tap's column
                if stride == 1:
                    a = boxes[0][:, dw:dw + TC]
                else:
                    a = boxes[dw % 2][:, dw // 2:dw // 2 + TC]
                a = a.reshape(BM, kb)
                bbox = _b_box(bt, nt * BN, (ks * dh + dw) * cin + c0, kb)
                part += a @ bbox.T
        return part

    acc_out = np.zeros((n_img, ho, wo, cout), np.int64)
    seen = np.zeros((n_img, ho, wo, cout), np.int64)
    for tile, total in _sum_units(f, tile_sum).items():
        nt, pt = divmod(tile, ptiles)
        n = pt // (rtiles * ctiles)
        rest = pt % (rtiles * ctiles)
        y0, x0 = rest // ctiles * TR, rest % ctiles * TC
        for r in range(BM):
            oy, ox = y0 + r // TC, x0 + r % TC
            if oy >= ho or ox >= wo:
                continue
            for cl in range(BN):
                ch = _col_channel(cl, nt, go, cout)
                if ch >= 0:
                    acc_out[n, oy, ox, ch] = total[r, cl]
                    seen[n, oy, ox, ch] += 1
    return acc_out, seen


def im2col_box(x, c0, w0, h0, n0, ow, oh, pixels=BM, lower=-1, upper=-1):
    """The copy engine's im2col box of the TAP route: ``pixels`` pixels of
    128 channels from c0, walking the bounding box (columns lower .. W-1
    + upper, then rows lower .. H-1 + upper, then images) from (w0, h0,
    n0), each sampled at (w + ow, h + oh); zeros outside the tensor."""
    n_img, h, wd, cin = x.shape
    box = np.zeros((pixels, 128), np.int64)
    wc, hc, nc = w0, h0, n0
    for i in range(pixels):
        sw, sh = wc + ow, hc + oh
        if nc < n_img and 0 <= sh < h and 0 <= sw < wd:
            src = x[nc, sh, sw, c0:c0 + 128]
            box[i, :src.shape[0]] = src
        wc += 1
        if wc > wd - 1 + upper:
            wc, hc = lower, hc + 1
            if hc > h - 1 + upper:
                hc, nc = lower, nc + 1
    return box


def replay_tap(x, w, go, f):
    """The TAP route's int32 sums (k3 SAME) under form ``f``, as
    replay_patch: a step's A is the im2col box of tap (dh, dw) from the
    tile's first pixel's top-left tap."""
    n_img, h, wd, cin = x.shape
    cout = w.shape[3]
    bt = _b_rows(w, go)
    m_all = n_img * h * wd
    n_tiles = -(-go // 32) if go else -(-cout // BN)
    assert f.steps == 9 * (cin // 128)
    xi = x.astype(np.int64)

    def tile_sum(tile, sb, se):
        mt, nt = divmod(tile, n_tiles)
        n0, r0 = divmod(mt * BM, h * wd)
        oy0, ox0 = divmod(r0, wd)
        part = np.zeros((BM, BN), np.int64)
        for s in range(sb, se):
            ch, tap = divmod(s, 9)
            a = im2col_box(xi, ch * 128, ox0 - 1, oy0 - 1, n0, tap % 3,
                           tap // 3)
            bbox = _b_box(bt, nt * BN, tap * cin + ch * 128, 128)
            part += a @ bbox.T
        return part

    acc_out = np.zeros((m_all, cout), np.int64)
    seen = np.zeros((m_all, cout), np.int64)
    for tile, total in _sum_units(f, tile_sum).items():
        mt, nt = divmod(tile, n_tiles)
        for r in range(BM):
            mr = mt * BM + r
            if mr >= m_all:
                continue
            for cl in range(BN):
                c = _col_channel(cl, nt, go, cout)
                if c >= 0:
                    acc_out[mr, c] = total[r, cl]
                    seen[mr, c] += 1
    return (acc_out.reshape(n_img, h, wd, cout),
            seen.reshape(n_img, h, wd, cout))


def _acc_plain(x, w, pad, ho, wo):
    """The int32 conv sums in int64, over the trimmed output."""
    ks = w.shape[0]
    xp = np.pad(x.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    acc = 0
    for dh in range(ks):
        for dw in range(ks):
            acc = acc + np.einsum("nhwc,co->nhwo",
                                  xp[:, dh:dh + ho, dw:dw + wo],
                                  w[dh, dw].astype(np.int64))
    return acc


def _codes(acc, s_w, b, s_out, gmax):
    """The kernel's epilogue on int sums: with the group-max, the groups'
    largest sum (smallest where scale and s_out differ in sign) under the
    shared first quarter of s_w and b; then the conv order (float32
    steps, each rounded)."""
    if gmax:
        go = acc.shape[-1] // 4
        groups = acc.reshape(acc.shape[:-1] + (4, go))
        rising = (np.float32(0.02) * s_w[:go] >= 0) == (s_out >= 0)
        acc = np.where(rising, groups.max(-2), groups.min(-2))
        s_w, b = s_w[:go], b[:go]
    y = torch.from_numpy(acc.astype(np.int32)).to(torch.float32)
    y = y * (torch.tensor(np.float32(0.02)) * T(s_w)) + T(b)
    y = torch.where(y > 0, y, 0.1 * y)
    return torch.clamp(torch.round(y / torch.tensor(np.float32(s_out))),
                       -127, 127).to(torch.int8)


def _scheduled(f, schedule):
    """``f`` under (kind, blocks): "own" (conv_w8a8_form's on that many
    SMs, as given), "sk" (every tile stream-K over ``blocks`` blocks) or
    "last" (the last round's tiles on ``blocks`` SMs stream-K, the rest
    round robin)."""
    kind, blocks = schedule
    if kind == "sk":
        grid = min(blocks, f.tiles * f.steps)
        f = f._replace(grid=grid, sk_tiles=f.tiles, sk_blocks=grid)
    elif kind == "last":
        rem = f.tiles % blocks
        f = f._replace(grid=blocks, sk_tiles=rem,
                       sk_blocks=min(blocks, rem * f.steps))
    return f._replace(slots=tconv.sk_slots(f))


# (x shape, k, Cout, trimmed output, group-max, schedule on SMs): PATCH
# forms under conv_w8a8_form's own schedule (round robin), stream-K of the
# last round's tile before round-robin tiles, and every tile stream-K
# (pieces that cross tiles; one tile of 4 streamed-B steps on 3 blocks)
PATCH_CASES = [((1, 19, 21, 16), 3, 80, None, True, ("last", 5)),
               ((2, 9, 9, 64), 3, 72, None, False, ("own", 3)),
               ((1, 12, 11, 128), 2, 128, (9, 10), True, ("sk", 4)),
               ((1, 6, 7, 160), 2, 64, (5, 5), False, ("sk", 3)),
               ((1, 9, 10, 48), 3, 256, None, True, ("sk", 5))]


@pytest.mark.parametrize("case", PATCH_CASES, ids=str)
def test_patch_replay_matches_plain(case):
    xs, k, cout, out_hw, gmax, schedule = case
    r = np.random.default_rng(sum(xs))
    x, w, s_w, b = _args(r, xs, k, cout, gmax=gmax)
    pad = 1 if k == 3 else 0
    padding = "SAME" if k == 3 else "VALID"
    ho, wo = tconv.conv_out_hw(xs[1], xs[2], k, padding, out_hw)
    f = tconv.conv_w8a8_form(*xs, cout, k, k, 1, padding, out_hw, True,
                             gmax, schedule[1])
    assert f.route == "patch" and f.kb == (64 if xs[3] <= 64 else 128)
    assert f.steps == k * -(-xs[3] // f.kb)
    f = _scheduled(f, schedule)
    assert (f.slots > 1) == (schedule[0] != "own")
    go = cout // 4 if gmax else 0
    acc, seen = replay_patch(x, w, pad, ho, wo, go, f)
    ref = _acc_plain(x, w, pad, ho, wo)
    # every channel of every output pixel (with the group-max: of every
    # pool group) lands once
    np.testing.assert_array_equal(seen, 1)
    np.testing.assert_array_equal(acc, ref)
    got = _codes(acc, s_w, b, 0.05, gmax)
    want = tconv.conv2d_w8a8_plain(T(x), 0.02, T(w), T(s_w), T(b),
                                   padding=padding, s_out=0.05,
                                   out_hw=out_hw, gmax=gmax)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# (x shape, k, Cout, schedule on SMs): the stride-2 PATCH forms of
# ResNet-18 (k = 3 and the 1x1 projection, SAME) at even sizes (no pad at
# the top: output row i reads rows 2i .. 2i+2) and odd ones (one pad row
# at the top), 64-byte and 128-byte steps (Cin 160: a ragged last chunk),
# a tile's rows past the input, round robin and stream-K
S2_CASES = [((2, 14, 14, 64), 3, 128, ("own", 4)),
            ((1, 15, 13, 64), 3, 72, ("own", 3)),
            ((1, 36, 20, 32), 3, 64, ("sk", 5)),
            ((1, 9, 18, 160), 3, 128, ("sk", 3)),
            ((2, 14, 12, 64), 1, 128, ("own", 3)),
            ((1, 13, 17, 256), 1, 136, ("sk", 4))]


@pytest.mark.parametrize("f32out", [False, True])
@pytest.mark.parametrize("case", S2_CASES, ids=str)
def test_patch_stride2_replay_matches_extract_patches(case, f32out):
    """The stride-2 PATCH route's sums equal the int product of
    ``extract_patches`` (XLA's SAME pads) with the weights; its int8 codes
    (or, ``f32out``, the float32 epilogue, each step rounded) equal the
    plain version."""
    xs, k, cout, schedule = case
    r = np.random.default_rng(sum(xs) + k)
    x, w, s_w, b = _args(r, xs, k, cout)
    n, h, wd, cin = xs
    ho, wo = -(-h // 2), -(-wd // 2)
    f = tconv.conv_w8a8_form(*xs, cout, k, k, 2, "SAME", None, not f32out,
                             False, schedule[1])
    assert f.route == "patch" and f.kb == (64 if cin <= 64 else 128)
    assert f.steps == k * -(-cin // f.kb)
    f = _scheduled(f, schedule)
    pads = (_same_pads(h, k, 2)[0], _same_pads(wd, k, 2)[0])
    acc, seen = replay_patch(x, w, pads, ho, wo, 0, f, stride=2)
    np.testing.assert_array_equal(seen, 1)
    patches = extract_patches(T(x), k, k, 2, "SAME").numpy().astype(np.int64)
    ref = patches @ w.reshape(k * k * cin, cout).astype(np.int64)
    np.testing.assert_array_equal(acc, ref)
    want = tconv.conv2d_w8a8_plain(T(x), 0.02, T(w), T(s_w), T(b),
                                   stride=2, s_out=None if f32out else 0.05)
    if f32out:
        y = (acc.astype(np.int32).astype(np.float32)
             * (np.float32(0.02) * s_w) + b)
        got = np.where(y > 0, y, np.float32(0.1) * y)
        np.testing.assert_array_equal(got, want.numpy())
    else:
        got = _codes(acc, s_w, b, 0.05, False)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


# (x shape, Cout, group-max, schedule on SMs): the TAP forms (ragged last
# M tile; tiles that cross rows, images (3 x 7 x 9: 63 pixels an image)
# and W = 31), every tile stream-K, conv_w8a8_form's own schedule (on 5
# SMs the 13 x 13 x 384 layer's 2 tiles stream-K over 4 blocks), and the
# last round's tiles stream-K
WINDOW_CASES = [((2, 7, 6, 128), 96, False, ("sk", 2)),
                ((1, 5, 5, 256), 64, True, ("sk", 3)),
                ((1, 13, 13, 384), 40, False, ("own", 5)),
                ((3, 7, 9, 128), 40, False, ("own", 5)),
                ((2, 9, 31, 128), 40, False, ("last", 3))]


@pytest.mark.parametrize("case", WINDOW_CASES, ids=str)
def test_window_replay_matches_plain(case):
    xs, cout, gmax, schedule = case
    r = np.random.default_rng(sum(xs) + 1)
    x, w, s_w, b = _args(r, xs, 3, cout, gmax=gmax)
    f = tconv.conv_w8a8_form(*xs, cout, 3, 3, 1, "SAME", None, True, gmax,
                             schedule[1])
    assert f.route == "tap" and f.steps == 9 * (xs[3] // 128)
    go = cout // 4 if gmax else 0
    acc, seen = replay_tap(x, w, go, _scheduled(f, schedule))
    np.testing.assert_array_equal(seen, 1)
    np.testing.assert_array_equal(acc, _acc_plain(x, w, 1, xs[1], xs[2]))
    got = _codes(acc, s_w, b, 0.05, gmax)
    want = tconv.conv2d_w8a8_plain(T(x), 0.02, T(w), T(s_w), T(b),
                                   s_out=0.05, gmax=gmax)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_im2col_walk_is_the_flat_output_grid():
    """The TAP box's walk from a tile's first pixel visits the flat
    output pixels m0, m0 + 1, ... across rows and images: with offsets
    (1, 1) (the centre tap) the box is x's rows m0 .. m0 + 127, zeros past
    the batch."""
    r = np.random.default_rng(8)
    x = r.integers(-127, 128, (3, 5, 7, 128)).astype(np.int64)
    flat = x.reshape(-1, 128)
    for m0 in (0, 34, 70, 128):
        n0, rest = divmod(m0, 35)
        oy, ox = divmod(rest, 7)
        box = im2col_box(x, 0, ox - 1, oy - 1, n0, 1, 1)
        want = np.zeros((128, 128), np.int64)
        rows = flat[m0:m0 + 128]
        want[:rows.shape[0]] = rows
        np.testing.assert_array_equal(box, want)


@pytest.mark.parametrize("s_out", [0.05, -0.05])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_group_max_of_codes_is_the_code_of_the_extreme_sum(sign, s_out):
    """With shared scale and bias the largest of the four groups' codes
    (the plain version, JAX's order) is the code of the largest int32 sum
    where scale and s_out have one sign, of the smallest where they
    differ: the kernel's epilogue (pick)."""
    r = np.random.default_rng(int(sign * 3 + s_out * 100) + 10)
    x, w, s_w, b = _args(r, (2, 9, 11, 32), 3, 64, s_out, gmax=True)
    s_w = (s_w * sign).astype(np.float32)
    acc = _acc_plain(x, w, 1, 9, 11)
    got = _codes(acc, s_w, b, s_out, True)
    want = tconv.conv2d_w8a8_plain(T(x), 0.02, T(w), T(s_w), T(b),
                                   s_out=s_out, gmax=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert len(np.unique(want.numpy())) > 40


@pytest.mark.parametrize("steps,splits", [(3, 1), (3, 2), (3, 3), (8, 6),
                                          (2, 2), (24, 5)])
def test_split_ranges_cover_k_once(steps, splits):
    """The pieces of a tile split over blocks (stream-K of one tile over
    ``splits`` blocks) are disjoint, non-empty and cover every step once,
    in block order."""
    f = tconv.ConvForm("tap", steps=steps, tiles=1, grid=splits,
                       sk_tiles=1, sk_blocks=splits)
    ranges = [(w.sb, w.se) for b in range(splits)
              for w in tconv.block_work(f, b)]
    covered = [s for sb, se in ranges for s in range(sb, se)]
    assert covered == list(range(steps))
    assert all(se > sb for sb, se in ranges) and len(ranges) == splits
    assert tconv.sk_slots(f) == splits


def test_pool_major_columns_hold_each_groups_channel():
    """With the group-max, tile column cl of column block nt is channel
    k*go + 32nt + i (k = cl / 32, i = cl % 32) in rs_tile_matrix's rows,
    so a thread's register columns i' + 4k hold one channel of every
    group: the epilogue's max runs over its own codes."""
    r = np.random.default_rng(3)
    go = 40
    w = r.integers(-127, 128, (3, 3, 16, 4 * go)).astype(np.int8)
    bt = _b_rows(w, go)
    wk = kmajor_weights(T(w)).numpy()
    for nt in range(-(-go // 32)):
        for cl in range(BN):
            ch = _col_channel(cl, nt, go, 4 * go)
            row = bt[nt * BN + cl]
            if ch < 0:
                assert not row.any()
            else:
                np.testing.assert_array_equal(row, wk[ch])
    # thread t of a quad holds columns 8j + 2t + e; j = i' + 4k is group k
    for t in range(4):
        for ii in range(4):
            for e in range(2):
                chans = {(8 * (ii + 4 * k) + 2 * t + e) % 32
                         for k in range(4)}
                groups = {(8 * (ii + 4 * k) + 2 * t + e) // 32
                          for k in range(4)}
                assert len(chans) == 1 and groups == {0, 1, 2, 3}


# ---------------------------------------------------------------------------
# the pins' convs take the kernel
# ---------------------------------------------------------------------------

# (model, batch): the W8A8 pins chip_smoke.py drives, and the b8 pin
PINNED = [("yolov2-tiny", 32), ("yolov2-tiny", 8), ("yolov2-tiny", 1),
          ("yolov3-tiny", 16), ("yolov3-tiny", 1)]


def _pin_convs(model_name, batch):
    """Every conv2d_w8a8 call of one forward of the (model, batch) pin at
    416 px: its plan driven at batch 1 on the CPU, each call's shape
    arguments recorded (the plan's kinds and shapes do not depend on the
    batch)."""
    from dnn_inference_engine_tpu_torch.models import build_model
    from dnn_inference_engine_tpu_torch.quant.quantize import (
        quantize_model_params)
    model = build_model(model_name)
    fp32 = model.init_params(torch.Generator().manual_seed(0), "cpu")
    q = quantize_model_params(fp32, model.layers)
    stages = tplan.build_plan(model, batch=batch)
    pp = tplan.prepare_plan_params(model, q, stages)
    scales = [0.05] * (len(model.layers) + 1)
    fn, seen = tplan.conv2d_w8a8, []

    def record(xq, s_in, wq, *args, **kw):
        seen.append((tuple(xq.shape[1:]), tuple(wq.shape), kw))
        return fn(xq, s_in, wq, *args, **kw)
    tplan.conv2d_w8a8 = record
    try:
        tplan.plan_forward_w8a8(model, stages, pp, scales,
                                torch.zeros((1, 416, 416, 3),
                                            dtype=torch.uint8))
    finally:
        tplan.conv2d_w8a8 = fn
    return seen


@pytest.mark.parametrize("model_name,batch", PINNED)
def test_pins_take_the_kernel_for_every_3x3_conv(model_name, batch):
    convs = _pin_convs(model_name, batch)
    routes = []
    for (h, w, cin), (kh, kw_, _, cout), kw in convs:
        f = tconv.conv_w8a8_form(batch, h, w, cin, cout, kh, kw_, 1,
                                 kw.get("padding", "SAME"),
                                 kw.get("out_hw"), kw.get("s_out") is not None,
                                 kw.get("gmax", False), SMS)
        routes.append(("k3" if kh == 3 else "k2" if kh == 2 else "1x1",
                       f.route))
        if kh > 1:
            assert f.route in ("patch", "tap"), (h, w, cin, cout, f)
        else:
            assert f.route == "gemm"
    kernel = sum(r in ("patch", "tap") for _, r in routes)
    gemm = sum(r == "gemm" for _, r in routes)
    assert (kernel, gemm) == {"yolov2-tiny": (7, 1),
                              "yolov3-tiny": (8, 4)}[model_name], routes
