"""The W8A8 conv kernel's schedule and fast epilogue (``ops/conv.py``
``conv_schedule``/``block_work``, ``csrc/conv_w8a8.cu`` ``span``/``work``
and ``code8``) on the CPU.

- The schedule at every conv_w8a8 launch shape of the main paths (YOLOv2
  pin b32 and b1, YOLOv3 pin b16 and b1, the strategies S1-S3 at b32, each
  plan driven at batch 1 on the CPU with its shapes scaled to the batch),
  as conv_w8a8_form gives it and with the last round's tiles forced onto
  stream-K: every (tile, K step) is summed exactly once, each stream-K
  block runs the mean number of steps within one, and under any order of
  the pieces' arrival the fixup ends each straddled tile once, with every
  other piece's slot written before it reads them.
- The fast epilogue's decision, modelled in numpy float32: the code of
  q0 = RN(y rs) wherever it is not near a half-integer, else div_rn's,
  equals the correctly rounded quotient's code on 10^6 seeded quotients and
  on quotients built within 1-4 ulps of every n + 0.5, n in [-128, 127].
"""

import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu_torch.ops import conv as tconv
from dnn_inference_engine_tpu_torch.runtime import plan as tplan

SMS = 132                            # an H100 SXM

# the strategies chip_smoke.py drives (YOLOv2-tiny, w8a8)
STRATEGIES = {
    "S1": {0: ["fold_xla_k2", 4, {"cin_pad": 64}], 2: ["fold_xla_s2", 2],
           4: ["fold_xla_k2", 2], 6: ["rs2", 2], 8: ["rs", 2],
           10: ["gemm", 1], 12: ["auto", 1], 13: ["auto", 1],
           14: ["xla", 1]},
    "S2": {0: ["fold_xla", 4, {"cin_pad": 64}], 2: ["rs", 2],
           4: ["rs2", 2], 6: ["auto", 1], 8: ["auto", 1], 10: ["xla", 1],
           12: ["gemm", 1], 13: ["xla", 1], 14: ["gemm", 1]},
    "S3": {0: ["s0", 4], 2: ["fold_xla", 2], 4: ["fold_xla_k2", 2],
           6: ["xla", 1], 8: ["xla", 1], 10: ["xla", 1], 12: ["xla", 1],
           13: ["xla", 1], 14: ["xla", 1]},
}
# (model, batch, strategy): the W8A8 main paths
PATHS = [("yolov2-tiny", 32, None), ("yolov2-tiny", 1, None),
         ("yolov3-tiny", 16, None), ("yolov3-tiny", 1, None),
         ("yolov2-tiny", 32, "S1"), ("yolov2-tiny", 32, "S2"),
         ("yolov2-tiny", 32, "S3")]

_forms_cache = {}


def _kernel_forms(model_name, batch, strategy):
    """The ConvForm of every conv_w8a8 launch of one forward of the path
    at 416 px: the plan driven at batch 1 on the CPU, each call's shape
    scaled to the batch (the plan's kinds and shapes do not depend on
    it)."""
    key = (model_name, batch, strategy)
    if key in _forms_cache:
        return _forms_cache[key]
    from dnn_inference_engine_tpu_torch.models import build_model
    from dnn_inference_engine_tpu_torch.quant.quantize import (
        quantize_model_params)
    model = build_model(model_name)
    fp32 = model.init_params(torch.Generator().manual_seed(0), "cpu")
    q = quantize_model_params(fp32, model.layers)
    strat = ({li: tuple(e) for li, e in STRATEGIES[strategy].items()}
             if strategy else None)
    stages = tplan.build_plan(model, strat, batch=batch)
    pp = tplan.prepare_plan_params(model, q, stages)
    scales = [0.05] * (len(model.layers) + 1)
    fn, forms = tconv.conv_w8a8_form, []

    def record(n, h, w, cin, cout, kh, kw, *args, **kw_):
        f = fn(batch, h, w, cin, cout, kh, kw, *args, **kw_)
        if f.route in ("patch", "tap"):
            forms.append(((batch, h, w, cin, cout, kh), f))
        return fn(n, h, w, cin, cout, kh, kw, *args, **kw_)
    tconv.conv_w8a8_form = record
    try:
        x = torch.zeros((1, 416, 416, 3), dtype=torch.uint8)
        if strategy:
            x = x.to(torch.float32)
        tplan.plan_forward_w8a8(model, stages, pp, scales, x)
    finally:
        tconv.conv_w8a8_form = fn
    _forms_cache[key] = forms
    return forms


# launches of conv_w8a8 a forward (chip_smoke.py's launch counts)
LAUNCHES = {("yolov2-tiny", None): 7, ("yolov3-tiny", None): 8,
            ("yolov2-tiny", "S1"): 3, ("yolov2-tiny", "S2"): 4,
            ("yolov2-tiny", "S3"): 7}


def _with_last_round(forms):
    """Each form, and where its tiles fill more than a round of SMs but
    not whole rounds, the same with the last round's tiles stream-K over
    every block (the kernel's other schedule)."""
    out = []
    for shape, f in forms:
        out.append((shape, f))
        rounds, rem = divmod(f.tiles, SMS)
        if rounds and rem:
            g = f._replace(grid=SMS, sk_tiles=rem,
                           sk_blocks=min(SMS, rem * f.steps))
            out.append((shape, g._replace(slots=tconv.sk_slots(g))))
    return out


@pytest.mark.parametrize("path", PATHS, ids=str)
def test_schedule_sums_every_step_once_and_balances(path):
    model_name, batch, strategy = path
    forms = _kernel_forms(*path)
    assert len(forms) == LAUNCHES[(model_name, strategy)]
    for shape, f in _with_last_round(forms):
        assert f.grid <= SMS and f.sk_blocks <= f.grid, (shape, f)
        seen = np.zeros((f.tiles, f.steps), np.int64)
        per_block = []
        for b in range(f.grid):
            work = tconv.block_work(f, b)
            # the pieces first, then the whole tiles
            whole = [w.sb == 0 and w.se == f.steps and w.parts == 1
                     for w in work]
            assert whole == sorted(whole), (shape, b, work)
            for w in work:
                assert 0 <= w.sb < w.se <= f.steps, (shape, b, w)
                assert 0 <= w.slot < w.parts <= f.slots, (shape, b, w)
                seen[w.tile, w.sb:w.se] += 1
            per_block.append(sum(w.se - w.sb for w in work))
        np.testing.assert_array_equal(seen, 1, err_msg=str((shape, f)))
        if f.sk_tiles:
            # stream-K: every block within one step of the stream-K
            # blocks' mean, round-robin tiles aside
            rr = [sum(w.se - w.sb for w in tconv.block_work(f, b)
                      if w.tile >= f.sk_tiles) for b in range(f.grid)]
            sk = [a - r for a, r in zip(per_block, rr)][:f.sk_blocks]
            mean = f.sk_tiles * f.steps / f.sk_blocks
            assert max(sk) - mean < 1 and mean - min(sk) < 1, (shape, f)
            assert max(rr) - min(rr) <= f.steps, (shape, f)
        # the busiest block runs at most the round-robin schedule's
        rr_busiest = -(-f.tiles // min(f.tiles, SMS)) * f.steps
        assert max(per_block) <= rr_busiest, (shape, f)


def test_schedule_follows_the_measured_rule():
    """Round robin wherever the tiles fill the SMs (stream-K of the last
    round measured slower at every b32 and b16 shape); at b1 stream-K over
    every tile where the tile's K is long enough to pay for the fixups:
    the TAP layers L12 and L13 (4 and 6 pieces a tile), not L8, L10 or the
    PATCH layers."""
    for path in PATHS:
        for shape, f in _kernel_forms(*path):
            if f.tiles >= SMS:
                assert (f.grid, f.sk_tiles, f.slots) == (SMS, 0, 1), shape
    b1 = {s[3:5]: f for s, f in _kernel_forms("yolov2-tiny", 1, None)}
    split = {cin_cout for cin_cout, f in b1.items() if f.sk_tiles}
    assert split == {(512, 1024), (1024, 1024)}, b1
    assert b1[(1024, 1024)].grid == 96 and b1[(512, 1024)].grid == 64
    for f in b1.values():
        assert f.sk_tiles in (0, f.tiles)


@pytest.mark.parametrize("path", PATHS, ids=str)
def test_fixup_ends_each_tile_once_in_any_order(path):
    """A model of wg::splitk_fixup under seeded random orders of the
    pieces' arrival: each piece writes its slot, then counts in; the one
    that counts the tile's last sees every other slot written, reads them
    and runs the epilogue; the counter is left zero."""
    r = np.random.default_rng(len(str(path)))
    for shape, f in _with_last_round(_kernel_forms(*path)):
        pieces = {}
        for b in range(f.grid):
            for w in tconv.block_work(f, b):
                if w.parts > 1:
                    pieces.setdefault(w.tile, []).append(w)
        for tile, ws in pieces.items():
            assert sorted(w.slot for w in ws) == list(range(ws[0].parts))
            assert all(w.parts == len(ws) for w in ws)
            for _ in range(3):
                counter, written, epilogues = 0, set(), 0
                for w in r.permutation(len(ws)):
                    written.add(ws[w].slot)
                    done = counter == ws[w].parts - 1
                    counter = 0 if done else counter + 1
                    if done:
                        epilogues += 1
                        assert written == set(range(ws[w].parts))
                assert epilogues == 1 and counter == 0, (shape, tile)


# ---------------------------------------------------------------------------
# the fast epilogue's decision (code8)
# ---------------------------------------------------------------------------

F32 = np.float32
MAGIC = F32(12582912.0)              # 1.5 * 2^23
NEAR = F32(0.5) - F32(2.0 ** -14)


def _codes_ref(y, s):
    """The conv order's code of y / s: RN(clip(y, +-128 s) / s), rounded
    to even and clipped to +-127 (wg::div_rn is the correctly rounded
    quotient; RN_f32 of the double quotient is, too: a quotient of two
    24-bit significands lies at least 2^-49 from every float midpoint)."""
    lim = (F32(128.0) * s).astype(F32)
    yc = np.clip(y, -lim, lim)
    q = (yc.astype(np.float64) / s.astype(np.float64)).astype(F32)
    return np.clip(np.rint(q), -127, 127).astype(np.int64)


def _codes_fast(y, s):
    """code8's fast path: (codes, near) from q0 = RN(y * RN(1/s))."""
    rs = (F32(1.0) / s).astype(F32)
    q0 = (y.astype(np.float64) * rs.astype(np.float64)).astype(F32)
    qc = np.clip(q0, F32(-127.0), F32(127.0)).astype(F32)
    t = (qc + MAGIC).astype(F32)
    f = (qc - (t - MAGIC).astype(F32)).astype(F32)
    near = np.abs(f) >= NEAR
    return (t.astype(np.float64) - float(MAGIC)).astype(np.int64), near


def _check(y, s, min_near=0):
    want = _codes_ref(y, s)
    fast, near = _codes_fast(y, s)
    # wherever the fast path decides, its code is the quotient's ...
    np.testing.assert_array_equal(fast[~near], want[~near])
    # ... and where it does not, div_rn's (the reference) is taken
    got = np.where(near, want, fast)
    np.testing.assert_array_equal(got, want)
    assert int(near.sum()) >= min_near
    return near


def test_fast_epilogue_equals_div_rn_on_seeded_quotients():
    r = np.random.default_rng(12)
    n = 1_000_000
    s = (r.uniform(0.5, 2.0, n) * 10.0 ** r.uniform(-6, 3, n)).astype(F32)
    # quotients spread over +-140, and the epilogue's own y: acc * sc + b
    z = r.uniform(-140, 140, n)
    y = (z * s).astype(F32)
    near = _check(y, s)
    # a quotient is near a half-integer about once in 2^13
    assert 0 < near.mean() < 0.0005
    acc = r.integers(-2 ** 24, 2 ** 24, n).astype(np.int32)
    sc = (r.uniform(0.5, 1.5, n) * 1e-5).astype(F32)
    b = r.standard_normal(n).astype(F32)
    y = ((acc.astype(F32) * sc).astype(F32) + b).astype(F32)
    y = np.where(y > 0, y, (F32(0.1) * y).astype(F32)).astype(F32)
    _check(y, (np.abs(y).max() / F32(100.0) * np.ones(n)).astype(F32))


def test_fast_epilogue_equals_div_rn_near_every_half_integer():
    """Quotients built within 1 to 4 ulps of n + 0.5 for every n in
    [-128, 127] (+-127.5 among them), on both sides, under many scales:
    the near test sends each to div_rn, or the fast code is right."""
    r = np.random.default_rng(3)
    half = np.arange(-128, 128, dtype=np.float64) + 0.5
    zs = []
    for k in range(1, 5):
        for h in half.astype(F32):
            up, down = h, h
            for _ in range(k):
                up = np.nextafter(up, F32(np.inf), dtype=F32)
                down = np.nextafter(down, F32(-np.inf), dtype=F32)
            zs += [up, down]
    zs += [F32(127.5), F32(-127.5), F32(126.5), F32(-126.5)]
    z = np.array(zs, F32)
    for _ in range(40):
        s = (r.uniform(0.5, 2.0) * 10.0 ** r.uniform(-6, 3)) * np.ones_like(z)
        s = s.astype(F32)
        y = (z.astype(np.float64) * s).astype(F32)
        near = _check(y, s)
        # every built quotient within 1-4 ulps of a half-integer below
        # 126.5 in magnitude is sent to div_rn
        inner = np.abs(z) < 126.75
        assert near[inner].all()


def test_fast_quotient_lies_within_the_near_margin():
    """|q0 - RN(y/s)| <= 2^-15 wherever |y/s| < 128: the near test's
    margin, 2^-14, covers it twice over."""
    r = np.random.default_rng(5)
    n = 200_000
    s = (r.uniform(0.5, 2.0, n) * 10.0 ** r.uniform(-6, 3, n)).astype(F32)
    y = (r.uniform(-128, 128, n) * s).astype(F32)
    rs = (F32(1.0) / s).astype(F32)
    q0 = (y.astype(np.float64) * rs.astype(np.float64)).astype(F32)
    q = (y.astype(np.float64) / s.astype(np.float64)).astype(F32)
    ok = np.abs(q) < 128
    assert np.abs(q0[ok].astype(np.float64) - q[ok]).max() <= 2.0 ** -15
