"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test asks the ``cuda`` fixture for the device, which
skips when there is no card. Run on a machine with one:

    python -m pytest -m gpu tests/

The int8 comparisons are exact: the kernels round every epilogue
operation as the plain versions do, and int32 accumulation is
order-independent. The float GEMM (gemm_f32) and the float engines sum
in float32 in their own order, so each of their tests states its
tolerance.
"""

import faulthandler

import numpy as np
import pytest
import torch

from dnn_inference_engine_tpu_torch.ops import fused_conv as fc
from dnn_inference_engine_tpu_torch.ops import gemm as gm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def deadline():
    """Ends the process (with every thread's traceback) if the test runs
    past 120 s: a kernel that never finishes blocks the host inside CUDA,
    where no Python exception can reach it."""
    faulthandler.dump_traceback_later(120, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _i8(g, dev, *shape):
    return torch.randint(-127, 128, shape, generator=g, device=dev,
                         dtype=torch.int8)


@pytest.mark.parametrize("mode", ["conv", "folded", "f32", "raw_acc"])
@pytest.mark.parametrize("m,k,n", [(300, 576, 125), (130, 100, 64),
                                   (17, 1024, 256), (5, 32, 3)])
def test_gemm_fused_kernel_matches_plain(cuda, mode, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m * k + n)
    a, bt = _i8(g, cuda, m, k), _i8(g, cuda, n, k)
    scale = torch.rand(n, generator=g, device=cuda) * 1e-3
    bias = torch.randn(n, generator=g, device=cuda)
    kw = {"conv": dict(s_out=0.037), "folded": dict(quantize_out=True),
          "f32": {}, "raw_acc": dict(raw_acc=True)}[mode]
    for act in ("leaky", "linear", "relu"):
        before = gm.gemm_fused.launches
        got = gm.gemm_fused(a, bt, scale, bias, act=act, **kw)
        assert gm.gemm_fused.launches == before + 1
        ref = gm.gemm_fused_plain(a, bt, scale, bias, act=act, **kw)
        torch.cuda.synchronize()
        assert got.dtype == ref.dtype
        assert torch.equal(got, ref), (mode, act)


# (K, N) of every gemm_fused launch on the W8A8 main paths: the YOLOv2-tiny
# pin (b32 and b1) and YOLOv3-tiny's (b16 and b1); N = 125 and 75 are the
# f32 heads
MAIN_KN = [(576, 128), (512, 256), (1152, 256), (2304, 512), (4608, 1024),
           (9216, 1024), (1024, 125), (1024, 256), (512, 75), (256, 128),
           (3456, 256), (256, 75)]
# (M, K, N) of those launches at full size: YOLOv2-tiny b32 and b1,
# YOLOv3-tiny b16
MAIN_SHAPES = [(346112, 576, 128), (86528, 512, 256), (86528, 576, 128),
               (21632, 1152, 256), (5408, 2304, 512), (5408, 4608, 1024),
               (5408, 9216, 1024), (5408, 1024, 125),
               (10816, 576, 128), (2704, 1152, 256), (2704, 576, 128),
               (676, 1152, 256), (169, 2304, 512), (169, 4608, 1024),
               (169, 9216, 1024), (169, 1024, 125),
               (173056, 576, 128), (43264, 512, 256), (43264, 576, 128),
               (10816, 1152, 256), (2704, 2304, 512), (2704, 4608, 1024),
               (2704, 1024, 256), (2704, 512, 75), (2704, 256, 128),
               (10816, 3456, 256), (10816, 256, 75)]
GEMM_MODES = {"conv": dict(s_out=0.037), "folded": dict(quantize_out=True),
              "f32": {}, "raw_acc": dict(raw_acc=True)}


@pytest.mark.parametrize("mode", list(GEMM_MODES))
@pytest.mark.parametrize("m", [169, 2053])
@pytest.mark.parametrize("k,n", MAIN_KN)
def test_gemm_fused_main_path_widths_match_plain(cuda, deadline, k, n, m,
                                                 mode):
    """Every main-path (K, N) at a reduced M with ragged M and N edges, in
    all four epilogues, bit for bit; M = 169 (b1) takes the split-K path
    for every K past 576, M = 2053 a wider grid."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a, bt = _i8(g, cuda, m, k), _i8(g, cuda, n, k)
    scale = torch.rand(n, generator=g, device=cuda) * 2e-4
    bias = torch.randn(n, generator=g, device=cuda)
    form = gm.gemm_form(m, n, k, True, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert form.form == "wgmma"
    if m == 169 and k > 576:
        assert form.splits > 1
    before = gm.gemm_fused.ragged_launches
    for act in ("leaky", "linear"):
        got = gm.gemm_fused(a, bt, scale, bias, act=act, **GEMM_MODES[mode])
        ref = gm.gemm_fused_plain(a, bt, scale, bias, act=act,
                                  **GEMM_MODES[mode])
        torch.cuda.synchronize()
        assert got.dtype == ref.dtype and torch.equal(got, ref), (act, form)
    assert gm.gemm_fused.ragged_launches == before


def test_gemm_fused_main_path_shapes_take_the_wgmma_form(cuda, deadline):
    """Each main-path launch at full size takes the wgmma form (by the
    form counter), and its output is equal to the same launch repeated (a
    split-K counter left nonzero would show here)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    for m, k, n in MAIN_SHAPES:
        a, bt = _i8(g, cuda, m, k), _i8(g, cuda, n, k)
        scale = torch.rand(n, generator=g, device=cuda) * 2e-5
        bias = torch.randn(n, generator=g, device=cuda)
        launches = gm.gemm_fused.launches
        ragged = gm.gemm_fused.ragged_launches
        first = gm.gemm_fused(a, bt, scale, bias, s_out=0.05)
        again = gm.gemm_fused(a, bt, scale, bias, s_out=0.05)
        torch.cuda.synchronize()
        assert gm.gemm_fused.launches == launches + 2
        assert gm.gemm_fused.ragged_launches == ragged, (m, k, n)
        assert torch.equal(first, again), (m, k, n)


@pytest.mark.parametrize("s_out", [2.0, 6.0, 10.0, 14.0, 254.0, 0.5, 3.0,
                                   7.0, 0.1, 0.3, 1.7, 97.5, 127.5, 100.1,
                                   255.0, 0.037, 1e-40, -0.5, 3e38])
def test_gemm_fused_conv_order_quotients_are_exact(cuda, deadline, s_out):
    """The conv-order epilogue divides by s_out without a division
    instruction (two corrections of y times RN(1/s_out); a double product
    when s_out is not a positive normal float): its codes equal the plain
    version's, whose quotient is PyTorch's IEEE division, for sums that
    are products of two codes (one nonzero a row of A), so quotients land
    on and beside the rounding ties (k + 0.5; with an inexact reciprocal
    at s_out 6, 10, 14 and 254) and the clip (127.5)."""
    m, k, n = 2048, 32, 256
    g = torch.Generator(device=cuda).manual_seed(11)
    a = torch.zeros((m, k), dtype=torch.int8, device=cuda)
    rows = torch.arange(m, device=cuda)
    a[rows, rows % k] = _i8(g, cuda, m)
    bt = _i8(g, cuda, n, k)
    ones = torch.ones(n, device=cuda)
    for scale, bias in ((ones, torch.zeros(n, device=cuda)),
                        (ones * 0.25, torch.full((n,), 0.125, device=cuda))):
        for act in ("linear", "leaky"):
            got = gm.gemm_fused(a, bt, scale, bias, act=act, s_out=s_out)
            ref = gm.gemm_fused_plain(a, bt, scale, bias, act=act,
                                      s_out=s_out)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (act, float(scale[0]))


@pytest.mark.parametrize("mode", list(GEMM_MODES))
def test_gemm_fused_misaligned_a_takes_the_ragged_form(cuda, deadline, mode):
    """An A view that starts 1 byte past 16-byte alignment (K % 16 == 0)
    takes the ragged form, by counter, and matches the plain version;
    K = 100 takes it too."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for m, k, n in ((300, 576, 125), (130, 100, 64)):
        buf = _i8(g, cuda, m * k + 1)
        a = buf[1:].view(m, k) if k % 16 == 0 else buf[:m * k].view(m, k)
        bt = _i8(g, cuda, n, k)
        scale = torch.rand(n, generator=g, device=cuda) * 1e-3
        bias = torch.randn(n, generator=g, device=cuda)
        before = gm.gemm_fused.ragged_launches
        got = gm.gemm_fused(a, bt, scale, bias, **GEMM_MODES[mode])
        torch.cuda.synchronize()
        assert gm.gemm_fused.ragged_launches == before + 1
        assert torch.equal(got, gm.gemm_fused_plain(a, bt, scale, bias,
                                                    **GEMM_MODES[mode]))


# (M, K, N) of the gemm_f32 launches of the fp32 auto forward (and the
# w8 gemm tier's deep layers) at 416 px: YOLOv2-tiny b32 and b1,
# YOLOv3-tiny b16 and b1
F32_DETECT_SHAPES = [(21632, 1152, 256), (5408, 2304, 512),
                     (5408, 4608, 1024), (5408, 9216, 1024),
                     (5408, 1024, 125),
                     (676, 1152, 256), (169, 2304, 512), (169, 4608, 1024),
                     (169, 9216, 1024), (169, 1024, 125),
                     (10816, 1152, 256), (2704, 2304, 512),
                     (2704, 4608, 1024), (2704, 1024, 256),
                     (2704, 2304, 512), (10816, 3456, 256),
                     (169, 1024, 256), (169, 2304, 512), (676, 3456, 256)]


@pytest.mark.parametrize("b_dtype", ["f32", "int8"])
@pytest.mark.parametrize("act", ["leaky", "linear", "relu"])
@pytest.mark.parametrize("m,k,n", [(300, 576, 125), (37, 27, 16),
                                   (130, 1030, 70), (5408, 1024, 125),
                                   (1, 9216, 1024), (169, 9216, 1024),
                                   (169, 4608, 1024), (169, 2304, 512),
                                   (676, 1152, 256), (169, 1024, 125),
                                   (2053, 1028, 200)])
def test_gemm_f32_kernel_matches_plain(cuda, m, k, n, act, b_dtype):
    """The float GEMM (f32 B, and int8 codes as B) against its plain
    version, which sums in float64: within 8 sqrt(K) + 4 float32
    half-ulps of the largest sum |a||b||scale| (the kernel's float32
    sum in its own order; ragged M, N and K, K = 27 included; the b1
    shapes, M = 169 and K = 9216 among them, split K)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    form = gm.gemm_f32_form(m, n, k, True, sms)
    if m == 169:
        assert form.form == "wgmma" and form.splits > 1
    g = torch.Generator(device=cuda).manual_seed(m * k + n)
    a = torch.rand((m, k), generator=g, device=cuda) - 0.25
    if b_dtype == "int8":
        bt = _i8(g, cuda, n, k)
        scale = torch.rand(n, generator=g, device=cuda) * 1e-3
    else:
        bt = torch.randn((n, k), generator=g, device=cuda)
        scale = torch.rand(n, generator=g, device=cuda) + 0.5
    bias = torch.randn(n, generator=g, device=cuda)
    before = gm.gemm_f32.launches
    got = gm.gemm_f32(a, bt, scale, bias, act=act)
    assert gm.gemm_f32.launches == before + 1
    ref = gm.gemm_f32_plain(a, bt, scale, bias, act=act)
    torch.cuda.synchronize()
    bound = float((a.double().abs() @ bt.double().abs().t()
                   * scale.double().abs()).max())
    tol = (8 * k ** 0.5 + 4) * 2.0 ** -24 * bound
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert float((got.double() - ref.double()).abs().max()) <= tol


@pytest.mark.parametrize("b_dtype", ["f32", "int8"])
def test_gemm_f32_detect_shapes_take_the_wgmma_form(cuda, deadline,
                                                    b_dtype):
    """Every fp32 and w8 detect shape at full size takes the wgmma form
    (by the form counter), within the tolerance of the test above, and
    its output equals the same launch repeated (the split-K sum is taken
    in split order, and a counter left nonzero would show here)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m, k, n in F32_DETECT_SHAPES:
        form = gm.gemm_f32_form(m, n, k, True, sms)
        assert form.form == "wgmma"
        assert form.splits > 1 or m > 676        # every b1 shape splits
        a = torch.rand((m, k), generator=g, device=cuda) - 0.25
        if b_dtype == "int8":
            bt = _i8(g, cuda, n, k)
            scale = torch.rand(n, generator=g, device=cuda) * 1e-3
        else:
            bt = torch.randn((n, k), generator=g, device=cuda)
            scale = torch.rand(n, generator=g, device=cuda) + 0.5
        bias = torch.randn(n, generator=g, device=cuda)
        launches = gm.gemm_f32.launches
        ragged = gm.gemm_f32.ragged_launches
        first = gm.gemm_f32(a, bt, scale, bias, act="leaky")
        again = gm.gemm_f32(a, bt, scale, bias, act="leaky")
        ref = gm.gemm_f32_plain(a, bt, scale, bias, act="leaky")
        torch.cuda.synchronize()
        assert gm.gemm_f32.launches == launches + 2
        assert gm.gemm_f32.ragged_launches == ragged, (m, k, n)
        assert torch.equal(first, again), (m, k, n)
        bound = float((a.double().abs() @ bt.double().abs().t()
                       * scale.double().abs()).max())
        tol = (8 * k ** 0.5 + 4) * 2.0 ** -24 * bound
        err = float((first.double() - ref.double()).abs().max())
        assert err <= tol, (m, k, n, err, tol)


@pytest.mark.parametrize("m,k,n,ragged", [(37, 27, 16, True),
                                          (130, 1030, 70, True),
                                          (130, 1028, 70, False),
                                          (300, 576, 125, False)])
def test_gemm_f32_ragged_form_only_where_tma_cannot_map(cuda, deadline, m,
                                                        k, n, ragged):
    """K % 4 != 0 (27, 1030) takes the ragged form, and so does an A that
    does not start on 16 bytes; every other shape the wgmma form."""
    g = torch.Generator(device=cuda).manual_seed(k)
    a = torch.rand((m, k + 1), generator=g, device=cuda)
    bt = torch.randn((n, k), generator=g, device=cuda)
    scale = torch.ones(n, device=cuda)
    bias = torch.zeros(n, device=cuda)
    for view, want in ((a[:, :k].contiguous(), ragged),
                       (a.reshape(-1)[1:1 + m * k].view(m, k), True)):
        before = gm.gemm_f32.ragged_launches
        got = gm.gemm_f32(view, bt, scale, bias, act="linear")
        ref = gm.gemm_f32_plain(view, bt, scale, bias, act="linear")
        torch.cuda.synchronize()
        assert gm.gemm_f32.ragged_launches == before + want
        bound = float((view.double().abs() @ bt.double().abs().t()).max())
        tol = (8 * k ** 0.5 + 4) * 2.0 ** -24 * bound
        assert float((got.double() - ref.double()).abs().max()) <= tol


@pytest.mark.parametrize("mode,kernel", [("fp32", "auto"), ("w8", "auto"),
                                         ("w8", "pallas"), ("w8a8", "xla"),
                                         ("w8a8", "pallas")])
def test_mode_engine_card_matches_cpu(cuda, mode, kernel):
    """The fp32 and w8 engines and the generic W8A8 tiers at 64 px: W8A8
    heads identical (exact int8 epilogues); fp32 and the f32 w8 gemm tier
    within 2**-12 of the largest head (float32 sums in other orders); the
    w8 plan within 2**-7 (a bf16 rounding edge straddled moves a value by
    a bf16 ulp)."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    cfg = EngineConfig(mode=mode, kernel=kernel, batch=2, input_size=64)
    gpu = Engine(cfg).load_weights(seed=0).prepare()
    params = [{k: v.cpu().numpy() for k, v in p.items()}
              for p in gpu.fp32_params]
    cpu = Engine(cfg, device="cpu").load_weights(
        params=params, act_scales=gpu.act_scales).prepare()
    imgs = np.random.default_rng(0).integers(
        0, 256, (2, 64, 64, 3)).astype(np.uint8)
    before = gm.gemm_f32.launches
    ragged = gm.gemm_f32.ragged_launches
    hg, hc = gpu.classify(imgs), cpu.classify(imgs)
    torch.cuda.synchronize()
    gemm_f32 = {("fp32", "auto"): 5, ("w8", "pallas"): 9}.get((mode, kernel),
                                                             0)
    assert gm.gemm_f32.launches == before + gemm_f32
    # only layer 0's K = 27 (w8 on the gemm tier) takes the ragged form
    assert gm.gemm_f32.ragged_launches == ragged + (
        (mode, kernel) == ("w8", "pallas"))
    rel = {"fp32": 2.0 ** -12, "w8": 2.0 ** -12 if kernel == "pallas"
           else 2.0 ** -7, "w8a8": 0.0}[mode]
    np.testing.assert_allclose(hg, hc, rtol=0,
                               atol=rel * float(np.abs(hc).max()))


@pytest.mark.parametrize("ingest", ["f32", "exact_u8"])
@pytest.mark.parametrize("cin", [48, 64])
@pytest.mark.parametrize("rows", [1, 2, 4])
def test_stem_kernel_matches_plain(cuda, monkeypatch, ingest, cin, rows):
    """Every band height, on 56 px rows (14 output rows: the last band of
    4 is partial)."""
    monkeypatch.setattr(fc, "_stem_k2_rows",
                        lambda n, hout, wout, sms, max_rows: rows)
    g = torch.Generator(device=cuda).manual_seed(cin)
    w = _i8(g, cuda, 2, 2, cin, 256)
    scale = torch.rand(256, generator=g, device=cuda) * 1e-2
    bias = torch.randn(256, generator=g, device=cuda)
    xu = torch.randint(0, 256, (2, 56, 72, 3), generator=g, device=cuda,
                       dtype=torch.uint8)
    x = xu.float() / 255.0 if ingest == "f32" else xu
    exact = ingest == "exact_u8"
    got = fc.stem_fused_k2(x, w, scale, bias, 0.0123, exact_u8=exact)
    ref = fc.stem_fused_k2_plain(x, w, scale, bias, 0.0123, exact_u8=exact)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("ingest", ["f32", "exact_u8"])
@pytest.mark.parametrize("batch", [1, 8, 32])
def test_stem_kernel_main_path_batches_match_plain(cuda, deadline, batch,
                                                   ingest):
    """The persistent schedule at 416 px with the band height and grid
    the wrapper picks at b1, b8 and b32 (1, 8 (f32: 4) and 4 rows), bit
    for bit, and the same codes launched again: the bands come by one
    bulk copy of raw rows each."""
    g = torch.Generator(device=cuda).manual_seed(batch)
    w = _i8(g, cuda, 2, 2, 64, 256)
    scale = torch.rand(256, generator=g, device=cuda) * 1e-2
    bias = torch.randn(256, generator=g, device=cuda)
    xu = torch.randint(0, 256, (batch, 416, 416, 3), generator=g,
                       device=cuda, dtype=torch.uint8)
    x = xu.float() / 255.0 if ingest == "f32" else xu
    exact = ingest == "exact_u8"
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fc._stem_k2_rows(batch, 104, 104, sms, 8 if exact else 4) == {
        1: 1, 8: 8 if exact else 4, 32: 4}[batch]
    got = fc.stem_fused_k2(x, w, scale, bias, 0.0123, exact_u8=exact)
    again = fc.stem_fused_k2(x, w, scale, bias, 0.0123, exact_u8=exact)
    ref = fc.stem_fused_k2_plain(x, w, scale, bias, 0.0123, exact_u8=exact)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(again, ref)


@pytest.mark.parametrize("ingest", ["f32", "exact_u8"])
@pytest.mark.parametrize("cin", [48, 64])
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
@pytest.mark.parametrize("batch", [1, 2, 16, 32])
def test_stem_dg_kernel_matches_plain(cuda, monkeypatch, batch, rows, cin,
                                      ingest):
    """Every band height at batches 1, 2, 16 and 32, on 56 px rows (14
    output rows: the last band of 4 or 8 is partial) 72 px wide (a band's
    last 64-pixel tile is ragged), each activation; equal to the k2
    kernel too."""
    monkeypatch.setattr(fc, "_stem_k2_rows",
                        lambda n, hout, wout, sms, max_rows: rows)
    g = torch.Generator(device=cuda).manual_seed(batch * 100 + cin)
    w = _i8(g, cuda, 2, 2, cin, 256)
    scale = torch.rand(256, generator=g, device=cuda) * 1e-2
    bias = torch.randn(256, generator=g, device=cuda)
    xu = torch.randint(0, 256, (batch, 56, 72, 3), generator=g, device=cuda,
                       dtype=torch.uint8)
    x = xu.float() / 255.0 if ingest == "f32" else xu
    exact = ingest == "exact_u8"
    for act in ("leaky", "linear", "relu"):
        before = fc.stem_fused_dg.launches
        got = fc.stem_fused_dg(x, w, scale, bias, 0.0123, act=act,
                               exact_u8=exact)
        assert fc.stem_fused_dg.launches == before + 1
        ref = fc.stem_fused_dg_plain(x, w, scale, bias, 0.0123, act=act,
                                     exact_u8=exact)
        k2 = fc.stem_fused_k2(x, w, scale, bias, 0.0123, act=act,
                              exact_u8=exact)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), act
        assert torch.equal(got, k2), act


@pytest.mark.parametrize("ingest", ["f32", "exact_u8"])
@pytest.mark.parametrize("batch", [1, 16, 32])
def test_stem_dg_kernel_main_path_batches_match_plain(cuda, deadline, batch,
                                                      ingest):
    """The slab-fed persistent stem at 416 px with the band height and
    grid the wrapper picks (exact u8: 1, 8, 4 rows; f32: 1, 1, 4), bit
    for bit, and the same codes launched again (the slabs laid out anew in
    every block)."""
    g = torch.Generator(device=cuda).manual_seed(batch + 7)
    w = _i8(g, cuda, 2, 2, 64, 256)
    scale = torch.rand(256, generator=g, device=cuda) * 1e-2
    bias = torch.randn(256, generator=g, device=cuda)
    xu = torch.randint(0, 256, (batch, 416, 416, 3), generator=g,
                       device=cuda, dtype=torch.uint8)
    x = xu.float() / 255.0 if ingest == "f32" else xu
    exact = ingest == "exact_u8"
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rows, _ = fc.stem_grid(batch, 104, 104, sms, 8 if exact else 4)
    assert rows == {1: 1, 16: 8 if exact else 1, 32: 4}[batch]
    got = fc.stem_fused_dg(x, w, scale, bias, 0.0123, exact_u8=exact)
    again = fc.stem_fused_dg(x, w, scale, bias, 0.0123, exact_u8=exact)
    ref = fc.stem_fused_dg_plain(x, w, scale, bias, 0.0123, exact_u8=exact)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(again, ref)


@pytest.mark.parametrize("shape", [(2, 16, 16, 32), (1, 10, 14, 5),
                                   (3, 26, 26, 128)])
def test_shift_s2d2_kernel_matches_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = _i8(g, cuda, *shape)
    got = fc.shift_s2d2(x)
    torch.cuda.synchronize()
    assert torch.equal(got, fc.shift_s2d2_plain(x))


@pytest.mark.parametrize("pad_hw", [(0, 0, 0, 0), (1, 7, 1, 7)])
@pytest.mark.parametrize("pad_to", [0, 64])
@pytest.mark.parametrize("ingest", ["f32", "uint8"])
@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 40, 24, 3)])
def test_quant_space_to_depth4_kernel_matches_plain(cuda, shape, ingest,
                                                    pad_to, pad_hw):
    """Both entries: the k3 entry (no border) and the k2 entry's (1, 7)
    border read as zeros; a scale whose reciprocal is inexact."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + pad_to)
    xu = torch.randint(0, 256, shape, generator=g, device=cuda,
                       dtype=torch.uint8)
    x = (torch.rand(shape, generator=g, device=cuda) * 2 - 1
         if ingest == "f32" else xu)
    s = 0.007919 if ingest == "f32" else 0.0123
    before = fc.quant_space_to_depth4.launches
    got = fc.quant_space_to_depth4(x, s, pad_to=pad_to, pad_hw=pad_hw)
    assert fc.quant_space_to_depth4.launches == before + 1
    ref = fc.quant_space_to_depth4_plain(x, s, pad_to=pad_to, pad_hw=pad_hw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


# scales at which u x f32(1/255) / s lands on (0.0078431377) or near a tie
QS2D4_SCALES = (1 / 127.0, 0.0078431377, 0.0123, 0.007919)


@pytest.mark.parametrize("pad_hw", [(0, 0, 0, 0), (1, 7, 1, 7)])
@pytest.mark.parametrize("s", QS2D4_SCALES)
def test_quant_space_to_depth4_kernel_every_byte_value(cuda, s, pad_hw):
    """Every uint8 value, each many times, through the kernel's code
    table, against the plain version's product by f32(1/255) and division
    by s; 120-byte rows."""
    g = torch.Generator(device=cuda).manual_seed(5)
    n = 2 * 24 * 40 * 3
    perm = torch.randperm(n, generator=g, device=cuda)
    x = (perm % 256).to(torch.uint8).reshape(2, 24, 40, 3)
    for pad_to in (0, 64):
        got = fc.quant_space_to_depth4(x, s, pad_to=pad_to, pad_hw=pad_hw)
        ref = fc.quant_space_to_depth4_plain(x, s, pad_to=pad_to,
                                             pad_hw=pad_hw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), pad_to


@pytest.mark.parametrize("s", QS2D4_SCALES)
def test_quant_space_to_depth4_kernel_table_is_the_product(cuda, s):
    """The kernel's uint8 codes are ``qs2d4_code_table`` (u x f32(1/255),
    then / s, as JAX's kernel computes them) on all 256 byte values: at s
    = f32(2/255) every odd byte lands on a tie and rounds to even."""
    x = (torch.arange(8 * 32 * 3, device=cuda) % 256).to(torch.uint8)
    x = x.reshape(1, 8, 32, 3)
    got = fc.quant_space_to_depth4(x, s).cpu().numpy()
    tbl = fc.qs2d4_code_table(s)
    want = tbl[x.cpu().numpy()].reshape(1, 2, 4, 8, 4, 3) \
        .transpose(0, 1, 3, 2, 4, 5).reshape(1, 2, 8, 48)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ingest", ["uint8", "f32"])
@pytest.mark.parametrize("entry", ["S1", "S2"])
@pytest.mark.parametrize("batch", [1, 32])
def test_quant_space_to_depth4_kernel_entries(cuda, deadline, batch, entry,
                                              ingest):
    """The S1 entry (the (1, 7, 1, 7) border) and the S2 entry at 416 px,
    64 lanes: at b1 each output row is cut into runs, so the grid holds at
    least two blocks an SM."""
    g = torch.Generator(device=cuda).manual_seed(batch)
    xu = torch.randint(0, 256, (batch, 416, 416, 3), generator=g,
                       device=cuda, dtype=torch.uint8)
    x = xu.float() / 255.0 if ingest == "f32" else xu
    pad_hw = (1, 7, 1, 7) if entry == "S1" else (0, 0, 0, 0)
    h4 = 106 if entry == "S1" else 104
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    segs, run, blocks = fc.qs2d4_grid(batch, h4, h4, sms)
    assert blocks >= (2 * sms if batch == 1 else batch * h4)
    got = fc.quant_space_to_depth4(x, 0.0078431377, pad_to=64, pad_hw=pad_hw)
    ref = fc.quant_space_to_depth4_plain(x, 0.0078431377, pad_to=64,
                                         pad_hw=pad_hw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("pad_to", [0, 50, 56, 64, 72])
@pytest.mark.parametrize("offset", [0, 3, 8])
@pytest.mark.parametrize("ingest", ["uint8", "f32"])
@pytest.mark.parametrize("shape,pad_hw", [
    ((1, 16, 24, 3), (0, 0, 0, 0)),        # 72-byte rows
    ((2, 24, 40, 3), (1, 7, 1, 7)),        # 120-byte rows, the border
    ((1, 16, 56, 3), (0, 0, 0, 0)),        # 168-byte rows
    ((1, 26, 18, 3), (3, 3, 5, 1)),        # a wide left border
])
def test_quant_space_to_depth4_kernel_ragged_rows_and_widths(
        cuda, shape, pad_hw, ingest, offset, pad_to):
    """Rows whose bytes are not a multiple of 16, x starting ``offset``
    elements past an aligned address (a view into a larger buffer), and
    widths that are not multiples of 16 (a partial chunk at each end of a
    run: 56, 72) or of 4 (50, a byte at a time)."""
    g = torch.Generator(device=cuda).manual_seed(offset + pad_to)
    numel = int(np.prod(shape))
    dtype = torch.uint8 if ingest == "uint8" else torch.float32
    buf = torch.zeros(numel + 16, dtype=dtype, device=cuda)
    x = buf[offset:offset + numel].view(shape)
    if ingest == "uint8":
        x.copy_(torch.randint(0, 256, shape, generator=g, device=cuda,
                              dtype=torch.uint8))
    else:
        x.copy_(torch.rand(shape, generator=g, device=cuda) * 2 - 1)
    got = fc.quant_space_to_depth4(x, 0.0123, pad_to=pad_to, pad_hw=pad_hw)
    ref = fc.quant_space_to_depth4_plain(x, 0.0123, pad_to=pad_to,
                                         pad_hw=pad_hw)
    torch.cuda.synchronize()
    assert got.shape[-1] == max(pad_to, 48)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape,go", [((2, 16, 16, 32), 8),
                                      ((1, 26, 22, 128), 32),
                                      ((2, 104, 104, 128), 32),
                                      ((1, 10, 6, 20), 5)])
def test_gmax_shift_s2d2_kernel_matches_plain(cuda, shape, go):
    g = torch.Generator(device=cuda).manual_seed(go)
    y = _i8(g, cuda, *shape)
    before = fc.gmax_shift_s2d2.launches
    got = fc.gmax_shift_s2d2(y, go)
    assert fc.gmax_shift_s2d2.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, fc.gmax_shift_s2d2_plain(y, go))


RS_CASES = [
    # (n, h, w, cin, cout, ksize, pool, quantize_out, s2d_out)
    (2, 13, 13, 64, 128, 3, ("gmaxm", 2, 32), True, False),
    (2, 9, 11, 32, 64, 3, ("gmaxm", 2, 16), True, False),
    (2, 14, 15, 128, 256, 2, ("gmaxm", 2, 64), True, False),
    (1, 7, 5, 16, 48, 3, None, True, False),
    (1, 7, 5, 16, 200, 3, None, False, False),
    (2, 9, 9, 64, 64, 2, ("gmaxm", 2, 16), False, False),
    (2, 12, 13, 48, 128, 3, ("gmaxm", 2, 32), True, True),
    (2, 9, 9, 32, 32, 2, None, True, True),
    (1, 5, 7, 512, 1024, 3, ("gmaxm", 2, 256), True, False),
    (1, 8, 8, 48, 64, 3, ("gmaxm", 4, 4), True, False),
]


@pytest.mark.parametrize("act", ["leaky", "linear", "relu"])
@pytest.mark.parametrize("case", RS_CASES)
def test_conv3x3_rs_kernel_matches_plain(cuda, case, act):
    """k 2 and 3, pool None and 'gmaxm' (i32-first with int8 out, per
    group with f32 out), s2d_out, odd H and W, go not a multiple of 32,
    Cout not a multiple of 128."""
    n, h, w, cin, cout, k, pool, qo, s2d = case
    g = torch.Generator(device=cuda).manual_seed(h * w + cin)
    x, wq = _i8(g, cuda, n, h, w, cin), _i8(g, cuda, k, k, cin, cout)
    scale = torch.rand(cout, generator=g, device=cuda) * 1e-4 + 1e-5
    bias = torch.randn(cout, generator=g, device=cuda)
    kw = dict(act=act, quantize_out=qo, pool=pool, ksize=k, s2d_out=s2d)
    before = fc.conv3x3_rs.launches
    got = fc.conv3x3_rs(x, wq, scale, bias, **kw)
    assert fc.conv3x3_rs.launches == before + 1
    ref = fc.conv3x3_rs_plain(x, wq, scale, bias, **kw)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref)


# conv3x3_rs at S1's batch-1 stages (L6 rs2, L8 rs) and S2's batch-32
# stage L4 at batch 1: (x shape, ksize, Cout, pool-major group-max co)
RS_B1_CASES = [((1, 27, 27, 256), 2, 512, 128),
               ((1, 13, 13, 512), 3, 1024, 256),
               ((1, 53, 53, 128), 2, 256, 64)]


@pytest.mark.parametrize("qo", [True, False])
@pytest.mark.parametrize("case", RS_B1_CASES)
def test_conv3x3_rs_split_k_matches_plain(cuda, deadline, case, qo):
    """The batch-1 shapes, where the tiles leave SMs idle and K is split
    across blocks: equal to the plain version with int8 and f32 out, and
    to a second launch (the split-K counters are left zero)."""
    xs, k, cout, co = case
    g = torch.Generator(device=cuda).manual_seed(cout)
    x, wq = _i8(g, cuda, *xs), _i8(g, cuda, k, k, xs[3], cout)
    scale = torch.rand(cout, generator=g, device=cuda) * 2e-5 + 1e-5
    bias = torch.randn(cout, generator=g, device=cuda)
    n, h, w, cin = xs
    m = n * (h - (k == 2)) * (w - (k == 2))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    kw = dict(quantize_out=qo, pool=("gmaxm", 2, co), ksize=k)
    got = fc.conv3x3_rs(x, wq, scale, bias, **kw)
    again = fc.conv3x3_rs(x, wq, scale, bias, **kw)
    ref = fc.conv3x3_rs_plain(x, wq, scale, bias, **kw)
    torch.cuda.synchronize()
    assert fc.rs_form(m, cout, cout // 4, k * k * cin, sms).splits > 1
    assert torch.equal(got, ref) and torch.equal(got, again)


def test_conv3x3_rs_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 8, 8, 24), dtype=torch.int8, device=cuda)
    w = torch.zeros((3, 3, 24, 32), dtype=torch.int8, device=cuda)
    sb = torch.zeros(32, device=cuda)
    with pytest.raises(ValueError, match="Cin"):
        fc.conv3x3_rs(x, w, sb, sb)
    x = torch.zeros((1, 8, 8, 32), dtype=torch.int8, device=cuda)
    w = torch.zeros((3, 3, 32, 32), dtype=torch.int8, device=cuda)
    for pool in ("pool2", ("gmax", 2, 8)):
        with pytest.raises(ValueError, match="B4"):
            fc.conv3x3_rs(x, w, sb, sb, pool=pool)


def test_engine_card_matches_cpu(cuda):
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    cfg = EngineConfig(mode="w8a8", batch=2, input_size=64,
                       score_thresh=0.02)
    gpu = Engine(cfg).load_weights(seed=0).prepare()
    params = [{k: v.cpu().numpy() for k, v in p.items()} for p in gpu.params]
    cpu = Engine(cfg, device="cpu").load_weights(
        params=params, act_scales=gpu.act_scales).prepare()
    imgs = np.random.default_rng(0).integers(
        0, 256, (2, 64, 64, 3)).astype(np.uint8)
    np.testing.assert_array_equal(gpu.classify(imgs), cpu.classify(imgs))
    bg, sg, cg = gpu.detect(imgs)
    bc, sc, cc = cpu.detect(imgs)
    np.testing.assert_array_equal(cg, cc)
    np.testing.assert_array_equal((sg > 0).sum(1), (sc > 0).sum(1))
    np.testing.assert_allclose(bg, bc, rtol=0, atol=1e-3)


def test_yolov3_engine_card_matches_cpu(cuda):
    """YOLOv3-tiny at 64 px: both heads identical, detections equal."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    cfg = EngineConfig(model="yolov3-tiny", mode="w8a8", batch=2,
                       input_size=64, score_thresh=0.02)
    gpu = Engine(cfg).load_weights(seed=0).prepare()
    params = [{k: v.cpu().numpy() for k, v in p.items()} for p in gpu.params]
    cpu = Engine(cfg, device="cpu").load_weights(
        params=params, act_scales=gpu.act_scales).prepare()
    assert gpu._plan[0].kind == "stem_dg"
    imgs = np.random.default_rng(0).integers(
        0, 256, (2, 64, 64, 3)).astype(np.uint8)
    for hg, hc in zip(gpu.classify(imgs), cpu.classify(imgs), strict=True):
        np.testing.assert_array_equal(hg, hc)
    bg, sg, cg = gpu.detect(imgs)
    bc, sc, cc = cpu.detect(imgs)
    np.testing.assert_array_equal(cg, cc)
    np.testing.assert_array_equal((sg > 0).sum(1), (sc > 0).sum(1))
    np.testing.assert_allclose(bg, bc, rtol=0, atol=1e-3)


STRATEGIES = {
    "s1": {"0": ["fold_xla_k2", 4, {"cin_pad": 64}], "2": ["fold_xla_s2", 2],
           "4": ["fold_xla_k2", 2], "6": ["rs2", 2], "8": ["rs", 2],
           "10": ["gemm", 1], "12": ["auto", 1], "13": ["auto", 1],
           "14": ["xla", 1]},
    "s2": {"0": ["fold_xla", 4, {"cin_pad": 64}], "2": ["rs", 2],
           "4": ["rs2", 2], "6": ["auto", 1], "8": ["auto", 1],
           "10": ["xla", 1], "12": ["gemm", 1], "13": ["xla", 1],
           "14": ["gemm", 1]},
}


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_strategy_engine_card_matches_cpu(cuda, tmp_path, name):
    """The strategy plans at 64 px: the card's head identical to the
    CPU's, detections equal, and the new kernels launched."""
    import json

    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({"strategy": STRATEGIES[name]}))
    cfg = EngineConfig(mode="w8a8", batch=2, input_size=64,
                       score_thresh=0.02, strategy=str(path))
    gpu = Engine(cfg).load_weights(seed=0).prepare()
    params = [{k: v.cpu().numpy() for k, v in p.items()} for p in gpu.params]
    cpu = Engine(cfg, device="cpu").load_weights(
        params=params, act_scales=gpu.act_scales).prepare()
    imgs = np.random.default_rng(0).integers(
        0, 256, (2, 64, 64, 3)).astype(np.uint8)
    before = (fc.quant_space_to_depth4.launches, fc.conv3x3_rs.launches)
    np.testing.assert_array_equal(gpu.classify(imgs), cpu.classify(imgs))
    assert fc.quant_space_to_depth4.launches == before[0] + 1
    assert fc.conv3x3_rs.launches == before[1] + 2
    bg, sg, cg = gpu.detect(imgs)
    bc, sc, cc = cpu.detect(imgs)
    np.testing.assert_array_equal(cg, cc)
    np.testing.assert_array_equal((sg > 0).sum(1), (sc > 0).sum(1))
    np.testing.assert_allclose(bg, bc, rtol=0, atol=1e-3)


def _stage0_operands(dev, r):
    """v2's operand and a (64,) epilogue from a random conv1."""
    from dnn_inference_engine_tpu_torch.ops.attic import stage0 as st0
    wq = r.integers(-127, 128, (3, 3, 3, 16)).astype(np.int8)
    s_w = r.uniform(1e-3, 1e-2, 16).astype(np.float32)
    b = r.standard_normal(16).astype(np.float32)
    w, scale, bias = st0.stage0_params_v2(torch.from_numpy(wq).to(dev),
                                          s_w, b, 0.00789, 0.0511)
    return wq, s_w, b, w, scale.to(dev), bias.to(dev)


@pytest.mark.parametrize("act", ["leaky", "linear", "relu"])
@pytest.mark.parametrize("rows", [1, 2, 4])
@pytest.mark.parametrize("shape", [(2, 56, 72, 3), (1, 64, 64, 3),
                                   (16, 56, 72, 3), (32, 32, 40, 3)])
def test_stage0_kernel_matches_plain(cuda, monkeypatch, shape, rows, act):
    """stage0_fused_v2 on the card against the plain version on the same
    dense-K operand: every band height at batches 1, 2, 16 and 32 (56 px:
    14 output rows, the last band of 4 partial; 72 and 40 px wide: a
    band's last 64-pixel tile ragged), one launch counted."""
    from dnn_inference_engine_tpu_torch.ops.attic import stage0 as st0
    monkeypatch.setattr(fc, "_stem_k2_rows",
                        lambda n, hout, wout, sms, max_rows: rows)
    g = torch.Generator(device=cuda).manual_seed(rows)
    _, _, _, w, scale, bias = _stage0_operands(
        cuda, np.random.default_rng(rows))
    x = torch.rand(shape, generator=g, device=cuda) * 1.2 - 0.1
    before = st0.stage0_fused.launches
    got = st0.stage0_fused_v2(x, w, scale, bias, 0.00789, act=act)
    assert st0.stage0_fused.launches == before + 1
    ref = st0.stage0_fused_plain(x, st0.dense_k_from_v2(w), scale, bias,
                                 0.00789, act=act)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.equal(got, ref)


@pytest.mark.parametrize("kernel", ["k2", "dg", "stage0"])
def test_stem_kernels_stage_from_device_memory_where_raw_rows_do_not_fit(
        cuda, monkeypatch, kernel):
    """f32 rows 416 px wide at 8 output rows a band: the raw rows do not
    fit beside the rest, so the producer stages each band from device
    memory; the codes are the plain version's all the same."""
    from dnn_inference_engine_tpu_torch.ops.attic import stage0 as st0
    monkeypatch.setattr(fc, "_stem_k2_rows",
                        lambda n, hout, wout, sms, max_rows: 8)
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.rand((2, 72, 416, 3), generator=g, device=cuda)
    if kernel == "stage0":
        _, _, _, w, scale, bias = _stage0_operands(
            cuda, np.random.default_rng(11))
        got = st0.stage0_fused_v2(x, w, scale, bias, 0.00789)
        ref = st0.stage0_fused_plain(x, st0.dense_k_from_v2(w), scale, bias,
                                     0.00789)
    else:
        w = _i8(g, cuda, 2, 2, 48, 256)
        scale = torch.rand(256, generator=g, device=cuda) * 1e-2
        bias = torch.randn(256, generator=g, device=cuda)
        fn = fc.stem_fused_k2 if kernel == "k2" else fc.stem_fused_dg
        got = fn(x, w, scale, bias, 0.0123)
        ref = fc.stem_fused_k2_plain(x, w, scale, bias, 0.0123)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("batch", [1, 2, 32])
@pytest.mark.parametrize("ht", [4, 8])
def test_stage0_v1_kernel_matches_plain_and_v2(cuda, deadline, ht, batch):
    """v1's operand at 416 px gives the same codes as v2's on the card, at
    the band height and grid the wrapper picks (b1: 1 row, b2: 2, b32:
    4), and again on a second launch."""
    from dnn_inference_engine_tpu_torch.ops.attic import stage0 as st0
    r = np.random.default_rng(ht)
    g = torch.Generator(device=cuda).manual_seed(ht)
    wq, s_w, b, w, scale, bias = _stage0_operands(cuda, r)
    wb, _, _ = st0.stage0_params(torch.from_numpy(wq).to(cuda), s_w, b,
                                 0.00789, 0.0511, ht=ht)
    x = torch.rand((batch, 416, 416, 3), generator=g, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fc.stem_grid(batch, 104, 104, sms, 4)[0] == {1: 1, 2: 2,
                                                        32: 4}[batch]
    before = st0.stage0_fused.launches
    got = st0.stage0_fused(x, wb, scale, bias, 0.00789, ht=ht)
    assert st0.stage0_fused.launches == before + 1
    again = st0.stage0_fused(x, wb, scale, bias, 0.00789, ht=ht)
    ref = st0.stage0_fused_plain(x, st0.dense_k_from_v1(wb, ht), scale, bias,
                                 0.00789)
    v2 = st0.stage0_fused_v2(x, w, scale, bias, 0.00789)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(got, v2)
    assert torch.equal(again, ref)


BT_CASES = [
    # (n, h, w, cin, cout, quantize_out)
    (2, 13, 13, 128, 256, True),
    (3, 13, 13, 256, 128, True),
    (2, 26, 26, 128, 128, True),
    (1, 8, 8, 128, 125, False),
    (1, 13, 13, 512, 1024, True),
    (2, 5, 31, 128, 64, True),
    (1, 13, 13, 128, 200, False),
    # YOLOv2-tiny's tail at 416 px (chip_smoke.py BT_SHAPES): b32 L8, L10,
    # L12 (also f32 out), L13; b1 L12, L13 (K split across blocks)
    (32, 26, 26, 128, 256, True),
    (32, 13, 13, 256, 512, True),
    (32, 13, 13, 512, 1024, True),
    (32, 13, 13, 512, 1024, False),
    (32, 13, 13, 1024, 1024, True),
    (1, 13, 13, 512, 1024, True),
    (1, 13, 13, 1024, 1024, True),
    (1, 13, 13, 1024, 1024, False),
]


@pytest.mark.parametrize("act", ["leaky", "linear", "relu"])
@pytest.mark.parametrize("case", BT_CASES)
def test_conv3x3_bt_kernel_matches_plain_and_rs(cuda, case, act):
    """int8 and f32 out, M and Cout not multiples of 128, W = 31 (the
    widest window): equal to the plain version and to conv3x3_rs with pool
    None on the same inputs."""
    from dnn_inference_engine_tpu_torch.ops.attic import tail
    n, h, w, cin, cout, qo = case
    g = torch.Generator(device=cuda).manual_seed(h * w + cout)
    x, wq = _i8(g, cuda, n, h, w, cin), _i8(g, cuda, 3, 3, cin, cout)
    scale = torch.rand(cout, generator=g, device=cuda) * 1e-4 + 1e-5
    bias = torch.randn(cout, generator=g, device=cuda)
    before = tail.conv3x3_bt.launches
    got = tail.conv3x3_bt(x, wq, scale, bias, act=act, quantize_out=qo)
    assert tail.conv3x3_bt.launches == before + 1
    ref = tail.conv3x3_bt_plain(x, wq, scale, bias, act=act, quantize_out=qo)
    rs = fc.conv3x3_rs(x, wq, scale, bias, act=act, quantize_out=qo)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref) and torch.equal(got, rs)


def test_s0_plan_card_matches_cpu(cuda):
    """The s0 strategy on the 416 px model fed 64 px f32 images: the
    card's plan (stage0_fused_v2's kernel) gives the CPU plan's head."""
    from dnn_inference_engine_tpu_torch.models import build_model
    from dnn_inference_engine_tpu_torch.ops.attic import stage0 as st0
    from dnn_inference_engine_tpu_torch.quant.quantize import (
        calibrate, quantize_model_params)
    from dnn_inference_engine_tpu_torch.runtime import plan
    model = build_model("yolov2-tiny")
    strat = {**plan._YOLOV2_STRATEGY, 0: ("s0", 4)}
    fp32 = model.init_params(torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    scales = calibrate(model, fp32, x.numpy(), device="cpu")
    qcpu = quantize_model_params(fp32, model.layers)
    heads = []
    for dev in ("cpu", cuda):
        q = [{k: v.to(dev) for k, v in p.items()} for p in qcpu]
        stages = plan.build_plan(model, strat)
        assert stages[0].kind == "s0"
        pp = plan.prepare_plan_params(model, q, stages)
        before = st0.stage0_fused.launches
        heads.append(plan.plan_forward_w8a8(model, stages, pp, scales,
                                            x.to(dev)).cpu())
        assert st0.stage0_fused.launches == before + (dev != "cpu")
    assert torch.equal(heads[0], heads[1])


# conv_dma: (N, H, W, Cin, go, ht); the prototype's width, ht past H,
# ragged H and W (tiles past the image), W past one 128-pixel tile, Cin
# 16, 32 and 48 (the box's zero fill past Cin pads K to 64 bytes), 128
# (128-byte steps) and go 64 (two column blocks, one block each)
DMA_CASES = [(2, 26, 104, 64, 32, 13), (1, 13, 104, 64, 32, 26),
             (3, 11, 17, 32, 32, 4), (2, 9, 40, 16, 32, 3),
             (1, 7, 24, 48, 32, 5), (2, 8, 8, 64, 64, 8),
             (1, 5, 200, 16, 32, 2), (1, 6, 256, 16, 32, 3),
             (2, 12, 13, 128, 32, 5),
             # Cin above 128: two steps a tap, B streamed with A
             (1, 9, 21, 144, 32, 4), (2, 7, 11, 256, 64, 7),
             # the tool's own shape at each of its ht
             (32, 104, 104, 64, 32, 13), (32, 104, 104, 64, 32, 26),
             (32, 104, 104, 64, 32, 8)]
# a block's walk crossing column blocks with B resident: 182 units on 132
# blocks (blocks 0-49 take a unit of each column block, on their two
# consumers), 728 (both consumers own units in each), 128-byte steps, and
# four column blocks
DMA_HANDOVER_CASES = [(1, 104, 104, 64, 64, 13), (4, 104, 104, 64, 64, 13),
                      (1, 104, 104, 128, 64, 13), (2, 52, 104, 32, 128, 13)]


@pytest.mark.parametrize("case", DMA_CASES)
def test_conv_dma_kernel_matches_plain_and_rs(cuda, case):
    from dnn_inference_engine_tpu_torch.tools import proto_conv_dma as pc
    n, h, w, cin, go, ht = case
    g = torch.Generator(device=cuda).manual_seed(h * w + cin)
    x, wq = _i8(g, cuda, n, h, w, cin), _i8(g, cuda, 3, 3, cin, 4 * go)
    scale = torch.rand(go, generator=g, device=cuda) * 1e-4 + 1e-5
    bias = torch.randn(go, generator=g, device=cuda)
    before = pc.conv_dma.launches
    got = pc.conv_dma(x, wq, scale, bias, ht=ht)
    assert pc.conv_dma.launches == before + 1
    ref = pc.conv_dma_plain(x, wq, scale, bias)
    rs = fc.conv3x3_rs(x, wq, scale.repeat(4), bias.repeat(4),
                       pool=("gmaxm", 2, go))
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (n, h, w, go)
    assert torch.equal(got, ref) and torch.equal(got, rs)


@pytest.mark.parametrize("case", DMA_HANDOVER_CASES)
def test_conv_dma_resident_b_handover_matches_plain(cuda, deadline, case):
    """Where a block's walk reaches another column block, the resident B
    is copied again only after both consumers released it, and each
    consumer multiplies against its unit's copy: five launches, each
    against the plain version and conv3x3_rs."""
    from dnn_inference_engine_tpu_torch.tools import proto_conv_dma as pc
    n, h, w, cin, go, ht = case
    f = pc.conv_dma_form(n, h, w, cin, go)
    assert f.resident and f.units > f.grid
    g = torch.Generator(device=cuda).manual_seed(h * w + cin + go)
    x, wq = _i8(g, cuda, n, h, w, cin), _i8(g, cuda, 3, 3, cin, 4 * go)
    scale = torch.rand(go, generator=g, device=cuda) * 1e-4 + 1e-5
    bias = torch.randn(go, generator=g, device=cuda)
    ref = pc.conv_dma_plain(x, wq, scale, bias)
    rs = fc.conv3x3_rs(x, wq, scale.repeat(4), bias.repeat(4),
                       pool=("gmaxm", 2, go))
    outs = [pc.conv_dma(x, wq, scale, bias, ht=ht) for _ in range(5)]
    torch.cuda.synchronize()
    assert torch.equal(ref, rs)
    for got in outs:
        assert torch.equal(got, ref)


def test_conv_dma_kernel_takes_an_unaligned_x(cuda):
    """A view of x 1 byte into its buffer is copied to an aligned base."""
    from dnn_inference_engine_tpu_torch.tools import proto_conv_dma as pc
    g = torch.Generator(device=cuda).manual_seed(5)
    flat = _i8(g, cuda, 2 * 6 * 20 * 32 + 1)
    x = flat[1:].view(2, 6, 20, 32)
    wq = _i8(g, cuda, 3, 3, 32, 128)
    scale = torch.rand(32, generator=g, device=cuda) * 1e-4
    bias = torch.randn(32, generator=g, device=cuda)
    got = pc.conv_dma(x, wq, scale, bias, ht=4)
    torch.cuda.synchronize()
    assert torch.equal(got, pc.conv_dma_plain(x, wq, scale, bias))


def test_tma_probe_matches_the_rules(cuda):
    """Every case: the encode's verdict is tma_box_legal's, and an
    accepted box equals the slice with zeros outside the source."""
    from dnn_inference_engine_tpu_torch.tools import probe_dma_rules as pr
    for case in pr.CASES:
        src = pr.case_source(case, cuda)
        legal, why = pr.tma_box_legal(tuple(src.shape), src.stride(),
                                      case.box, src.data_ptr() % 16)
        before = pr.probe.launches
        v = pr.probe(src, case.start, case.box)
        torch.cuda.synchronize()
        assert v.accepted == legal, (case.name, v.cu_result, why)
        assert pr.probe.launches == before + legal
        if legal:
            assert v.cu_result == 0
            assert torch.equal(v.out, pr.probe_plain(src, case.start,
                                                     case.box)), case.name


def test_tma_box_leaving_a_ragged_inner_dimension_faults(cuda):
    """What ``probe`` refuses, shown on the card in a process of its own
    (the fault poisons its context): cuTensorMapEncodeTiled accepts a
    rank-1 map of
    1000 bytes, and the copy of a 256-byte box at 900 traps; at 1024
    bytes the same box copies (zero-filled past the end)."""
    import subprocess
    import sys
    code = (
        "import ctypes, torch\n"
        "from dnn_inference_engine_tpu_torch.ops import _build\n"
        "from dnn_inference_engine_tpu_torch.tools import probe_dma_rules "
        "as pr\n"
        "src = torch.zeros(1000, dtype=torch.int8, device='cuda')\n"
        "out = torch.empty(256, dtype=torch.int8, device='cuda')\n"
        "cu = ctypes.c_int(-1)\n"
        "p, i = ctypes.c_void_p, ctypes.c_int\n"
        "fn = _build.function('tma_probe', 'tma_probe', "
        "[p, i, p, p, p, p, i, p, p, p])\n"
        "err = fn(src.data_ptr(), 1, pr._inner((1000,), ctypes.c_longlong), "
        "pr._inner((), ctypes.c_longlong), pr._inner((256,), ctypes.c_int), "
        "pr._inner((900,), ctypes.c_int), 1, out.data_ptr(), "
        "ctypes.byref(cu), torch.cuda.current_stream().cuda_stream)\n"
        "print('encode', cu.value, 'launch', err, flush=True)\n"
        "torch.cuda.synchronize()\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert "encode 0 launch 0" in r.stdout, (r.stdout, r.stderr)
    assert r.returncode != 0 and "illegal instruction" in r.stderr, (
        r.stdout, r.stderr[-2000:])
    from dnn_inference_engine_tpu_torch.tools import probe_dma_rules as pr
    src = torch.arange(1024, device=cuda).to(torch.int8)
    v = pr.probe(src, (896,), (256,))
    torch.cuda.synchronize()
    assert v.accepted and torch.equal(v.out, pr.probe_plain(src, (896,),
                                                            (256,)))



# The W8A8 conv kernel (csrc/conv_w8a8.cu) at the forms of the W8A8 pins:
# (tag, x shape, k, Cout, group-max, trimmed output, route). YOLOv2-tiny's
# 3x3 convs at b32 and b1, the b32 pin's L4 and the b8 pin's L8 shifted
# folds (k2 VALID over shift_s2d2's rows, trimmed), YOLOv3-tiny's convs at
# b16 and b1 (L20: Cin 384, from a route concat), S1's fold-4 entry and
# its 26 px k2 fold, and small shapes with a ragged last M tile, a ragged
# Cout and Cin below 64
CONV_CASES = [
    ("v2 b32 L2", (32, 104, 104, 64), 3, 128, True, None, "patch"),
    ("v2 b32 L4 k2", (32, 56, 53, 128), 2, 256, True, (52, 52), "patch"),
    ("v2 b32 L6", (32, 52, 52, 64), 3, 128, False, None, "patch"),
    ("v2 b32 L8", (32, 26, 26, 128), 3, 256, False, None, "tap"),
    ("v2 b32 L10", (32, 13, 13, 256), 3, 512, False, None, "tap"),
    ("v2 b32 L12", (32, 13, 13, 512), 3, 1024, False, None, "tap"),
    ("v2 b32 L13", (32, 13, 13, 1024), 3, 1024, False, None, "tap"),
    ("v2 b1 L2", (1, 104, 104, 64), 3, 128, True, None, "patch"),
    ("v2 b1 L4", (1, 52, 52, 128), 3, 256, True, None, "patch"),
    ("v2 b1 L6", (1, 52, 52, 64), 3, 128, False, None, "patch"),
    ("v2 b1 L8", (1, 26, 26, 128), 3, 256, False, None, "tap"),
    ("v2 b1 L10", (1, 13, 13, 256), 3, 512, False, None, "tap"),
    ("v2 b1 L12", (1, 13, 13, 512), 3, 1024, False, None, "tap"),
    ("v2 b1 L13", (1, 13, 13, 1024), 3, 1024, False, None, "tap"),
    ("v2 b8 L8 k2", (8, 16, 14, 512), 2, 1024, True, (13, 13), "patch"),
    ("v3 b16 L2", (16, 104, 104, 64), 3, 128, True, None, "patch"),
    ("v3 b16 L4 k2", (16, 56, 53, 128), 2, 256, True, (52, 52), "patch"),
    ("v3 b16 L6", (16, 52, 52, 64), 3, 128, False, None, "patch"),
    ("v3 b16 L8", (16, 26, 26, 128), 3, 256, False, None, "tap"),
    ("v3 b16 L10", (16, 13, 13, 256), 3, 512, False, None, "tap"),
    ("v3 b16 L12", (16, 13, 13, 512), 3, 1024, False, None, "tap"),
    ("v3 b16 L14", (16, 13, 13, 256), 3, 512, False, None, "tap"),
    ("v3 b16 L20", (16, 26, 26, 384), 3, 256, False, None, "tap"),
    ("v3 b1 L20", (1, 26, 26, 384), 3, 256, False, None, "tap"),
    ("S1 entry k2 f4", (2, 106, 106, 64), 2, 256, True, (104, 104),
     "patch"),
    ("S1 b32 L4 k2", (32, 28, 27, 512), 2, 1024, True, (26, 26), "patch"),
    ("ragged M, Cout", (3, 11, 9, 32), 3, 48, False, None, "patch"),
    ("ragged gmax", (2, 19, 21, 16), 3, 80, True, None, "patch"),
    ("Cin 48 k2", (2, 10, 13, 48), 2, 64, True, (8, 11), "patch"),
    ("ragged window", (3, 7, 5, 128), 3, 72, False, None, "tap"),
    ("W 31 window", (2, 9, 31, 128), 3, 128, False, None, "tap"),
]
# The schedules' cases on 132 blocks: (tag, x shape, k, Cout, group-max,
# trimmed output). Three rounds of tiles, the last partial (L8 b32: 338
# tiles; forced "last", 74 of them straddle blocks before the
# round-robin tiles), every tile split (b1 L13), single-tile blocks (L10
# b16: 88 tiles), and PATCH layers, with their resident B, forced onto
# stream-K.
SCHEDULE_CASES = [
    ("straddled, then whole tiles", (32, 26, 26, 128), 3, 256, False, None),
    ("every tile split", (1, 13, 13, 1024), 3, 1024, False, None),
    ("one tile a block", (16, 13, 13, 256), 3, 512, False, None),
    ("patch straddled", (4, 52, 52, 64), 3, 128, False, None),
    ("patch gmax k2 straddled", (2, 56, 53, 128), 2, 256, True, (52, 52)),
]


def _conv_inputs(g, dev, xs, k, cout, s_out, gmax=False):
    """x, w, s_in, s_w, b for codes spread over +-127 at ``s_out``; with
    the group-max the four groups share s_w and b, as in a fold stage."""
    cin = xs[3]
    s_in = 1.0 if s_out < 1e-30 else 0.02
    spread = s_out * 60.0 / (s_in * (k * k * cin) ** 0.5 * 5376.0)
    n = cout // 4 if gmax else cout
    s_w = (torch.rand(n, generator=g, device=dev) + 0.5) * spread
    b = torch.randn(n, generator=g, device=dev) * (20.0 * s_out)
    if gmax:
        s_w, b = s_w.repeat(4), b.repeat(4)
    return (_i8(g, dev, *xs), _i8(g, dev, k, k, cin, cout), s_in, s_w, b)


@pytest.mark.parametrize("s_out", [0.05, 1e-39])   # 1e-39: mode 4
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv_w8a8_kernel_matches_plain(cuda, deadline, case, s_out):
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops import _build
    tag, xs, k, cout, gmax, out_hw, route = case
    g = torch.Generator(device=cuda).manual_seed(sum(xs) + k + cout)
    x, w, s_in, s_w, b = _conv_inputs(g, cuda, xs, k, cout, s_out, gmax)
    padding = "SAME" if k == 3 else "VALID"
    f = cv.conv_w8a8_form(*xs, cout, k, k, 1, padding, out_hw, True, gmax,
                          _build.sm_count(cuda))
    assert f.route == route, f
    kw = dict(act="leaky", padding=padding, s_out=s_out, out_hw=out_hw,
              gmax=gmax)
    before = (cv.conv2d_w8a8.launches, cv.conv2d_w8a8.im2col_launches)
    got = cv.conv2d_w8a8(x, s_in, w, s_w, b, **kw)
    assert (cv.conv2d_w8a8.launches,
            cv.conv2d_w8a8.im2col_launches) == (before[0] + 1, before[1])
    ref = cv.conv2d_w8a8_plain(x, s_in, w, s_w, b, **kw)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == torch.int8
    assert got.shape == ref.shape
    assert torch.equal(got, ref), (tag, int((got != ref).sum()))
    assert int(ref.abs().max()) > 0


@pytest.mark.parametrize("act", ["linear", "relu"])
@pytest.mark.parametrize("case", [c for c in CONV_CASES if c[1][0] <= 3],
                         ids=[c[0] for c in CONV_CASES if c[1][0] <= 3])
def test_conv_w8a8_kernel_activations_match_plain(cuda, deadline, case, act):
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    tag, xs, k, cout, gmax, out_hw, _ = case
    g = torch.Generator(device=cuda).manual_seed(len(tag))
    x, w, s_in, s_w, b = _conv_inputs(g, cuda, xs, k, cout, 0.04, gmax)
    kw = dict(act=act, padding="SAME" if k == 3 else "VALID", s_out=0.04,
              out_hw=out_hw, gmax=gmax)
    got = cv.conv2d_w8a8(x, s_in, w, s_w, b, **kw)
    ref = cv.conv2d_w8a8_plain(x, s_in, w, s_w, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), tag


def test_conv_w8a8_split_k_forms(cuda):
    """The b1 pin's L12 and L13 split every tile across blocks (stream-K
    over all of them); its other convs, and every conv of the b32 pin,
    run whole tiles round robin, the b32 ones over every SM."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    for tag, xs, k, cout, gmax, out_hw, _ in CONV_CASES:
        f = cv.conv_w8a8_form(*xs, cout, k, k, 1,
                              "SAME" if k == 3 else "VALID", out_hw, True,
                              gmax, 132)
        split = tag.startswith(("v2 b1 L12", "v2 b1 L13"))
        if tag.startswith("v2 b1"):
            assert (f.sk_tiles == f.tiles and f.slots > 1) == split, (tag, f)
        if tag.startswith("v2 b32"):
            assert (f.grid, f.sk_tiles) == (132, 0) and f.tiles > 132, (
                tag, f)


def _forced(f, sms, schedule):
    """``f`` with the round-robin schedule ("rr": whole tiles, no split),
    stream-K over every tile ("all"), stream-K over the last round's
    tiles ("last", at least as many tiles as SMs), or its own."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    rounds, rem = divmod(f.tiles, sms)
    if schedule == "last" and rounds and rem:
        f = f._replace(grid=sms, sk_tiles=rem,
                       sk_blocks=min(sms, rem * f.steps))
        return f._replace(slots=cv.sk_slots(f))
    if schedule == "rr":
        return f._replace(grid=min(f.tiles, sms), sk_tiles=0, sk_blocks=0,
                          slots=1)
    if schedule == "all":
        grid = min(sms, f.tiles * f.steps)
        f = f._replace(grid=grid, sk_tiles=f.tiles, sk_blocks=grid)
        return f._replace(slots=cv.sk_slots(f))
    return f


@pytest.mark.parametrize("schedule", ["own", "rr", "all", "last"])
@pytest.mark.parametrize("case", SCHEDULE_CASES,
                         ids=[c[0] for c in SCHEDULE_CASES])
def test_conv_w8a8_schedules_match_plain(cuda, deadline, case, schedule):
    """Every schedule the kernel takes (its own, round robin, stream-K
    over every tile or over the last round's tiles) gives the plain
    version's codes."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    from dnn_inference_engine_tpu_torch.ops import fused_conv as fc
    from dnn_inference_engine_tpu_torch.quant.quantize import f32_scalar
    tag, xs, k, cout, gmax, out_hw = case
    g = torch.Generator(device=cuda).manual_seed(sum(xs) + cout)
    x, w, s_in, s_w, b = _conv_inputs(g, cuda, xs, k, cout, 0.05, gmax)
    padding = "SAME" if k == 3 else "VALID"
    f = cv.conv_w8a8_form(*xs, cout, k, k, 1, padding, out_hw, True, gmax,
                          132)
    ref = cv.conv2d_w8a8_plain(x, s_in, w, s_w, b, padding=padding,
                               s_out=0.05, out_hw=out_hw, gmax=gmax)
    go = cout // 4 if gmax else 0
    bt = fc.rs_tile_matrix(w, go) if gmax else gm.kmajor_weights(w)
    scale = f32_scalar(s_in, cuda) * s_w
    ho, wo = cv.conv_out_hw(xs[1], xs[2], k, padding, out_hw)
    ff = _forced(f, 132, schedule)
    got = cv.conv_w8a8_launch(x, bt, scale, b, 0.05, k, ho, wo, go, "leaky",
                              ff)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), (tag, ff, int((got != ref).sum()))


def test_conv_w8a8_refused_forms_take_the_im2col_route(cuda):
    """Cin % 16 != 0 takes the small-Cin kernel (conv_w8a8_rows, its own
    counter) where kw Cin <= 32, k <= 7 and Cout is 16 or 64 (a 3x3 or a
    7x7/s2 stem at Cin 3), else the im2col + gemm_fused route (its own
    counter, no kernel launch: Cout 32, Cin 12 at k3, Cin 3 at k9, and a
    group-max at Cin 3); f32
    output from a 3x3 conv and the stride-2 forms (3x3 int8 out, 1x1 f32
    out) take the conv_w8a8 kernel; a 1x1 stride-1 conv the GEMM on a
    view (no counter); each equals the plain version, bit for bit."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    g = torch.Generator(device=cuda).manual_seed(5)
    # (x shape, k, stride, Cout, s_out, group-max, conv_w8a8, rows and
    # im2col launches)
    cases = [((2, 20, 20, 3), 3, 1, 16, 0.05, False, 0, 1, 0),
             ((2, 20, 20, 3), 7, 2, 64, None, False, 0, 1, 0),
             ((2, 20, 20, 3), 3, 1, 32, 0.05, False, 0, 0, 1),
             ((2, 20, 20, 12), 3, 1, 16, 0.05, False, 0, 0, 1),
             ((2, 20, 20, 3), 9, 1, 64, 0.05, False, 0, 0, 1),
             ((2, 20, 20, 3), 3, 1, 64, 0.05, True, 0, 0, 1),
             ((2, 13, 13, 64), 3, 1, 32, None, False, 1, 0, 0),
             ((2, 14, 14, 32), 3, 2, 32, 0.05, False, 1, 0, 0),
             ((2, 13, 15, 128), 3, 2, 32, 0.05, False, 1, 0, 0),
             ((2, 14, 14, 64), 1, 2, 32, None, False, 1, 0, 0),
             ((2, 13, 13, 64), 1, 1, 32, 0.05, False, 0, 0, 0),
             ((2, 13, 13, 64), 1, 1, 32, None, False, 0, 0, 0)]

    def counts():
        return (cv.conv2d_w8a8.launches, cv.conv_w8a8_rows.launches,
                cv.conv2d_w8a8.im2col_launches)
    for xs, k, stride, cout, s_out, gmax, kern, rows, im2col in cases:
        x, w, s_in, s_w, b = _conv_inputs(g, cuda, xs, k, cout, 0.05, gmax)
        kw = dict(stride=stride, s_out=s_out, gmax=gmax)
        before = counts()
        got = cv.conv2d_w8a8(x, s_in, w, s_w, b, **kw)
        assert counts() == (before[0] + kern, before[1] + rows,
                            before[2] + im2col), (xs, k, stride, s_out)
        ref = cv.conv2d_w8a8_plain(x, s_in, w, s_w, b, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (xs, k, stride, s_out)


# the small-Cin kernel (conv_w8a8_rows): ResNet-18's stem (224 px, k7/s2,
# Cin 3 -> 64, relu) and the YOLO entry conv (416 px, k3/s1, Cin 3 -> 16,
# leaky) at their batches, f32 output, mode 4 (an s_out that is not a
# normal float), odd sizes and a misaligned x (rows staged word by word
# from device memory), Cin 8 and 5: (tag, x shape, k, stride, Cout,
# s_out, act)
ROWS_CASES = [("r18 stem b2", (2, 224, 224, 3), 7, 2, 64, 0.05, "relu"),
              ("r18 stem b1", (1, 224, 224, 3), 7, 2, 64, 0.05, "relu"),
              ("r18 stem b2 f32", (2, 224, 224, 3), 7, 2, 64, None,
               "linear"),
              ("yolo entry b2", (2, 416, 416, 3), 3, 1, 16, 0.05, "leaky"),
              ("yolo entry b8", (8, 416, 416, 3), 3, 1, 16, 0.05, "leaky"),
              ("yolo entry b1 f32", (1, 416, 416, 3), 3, 1, 16, None,
               "leaky"),
              ("mode 4", (2, 20, 20, 3), 3, 1, 16, 1e-39, "leaky"),
              ("odd 31x29 k7s2", (2, 31, 29, 3), 7, 2, 64, 0.05, "relu"),
              ("odd 21x19 k3s1", (3, 21, 19, 3), 3, 1, 16, 0.05, "leaky"),
              ("odd k3s2", (2, 17, 23, 3), 3, 2, 16, None, "relu"),
              ("cin 8 k3", (2, 14, 14, 8), 3, 1, 16, 0.05, "leaky"),
              ("cin 5 k5s2", (2, 15, 16, 5), 5, 2, 64, 0.05, "linear"),
              ("misaligned x", (2, 32, 32, 3), 7, 2, 64, 0.05, "relu")]


@pytest.mark.parametrize("case", ROWS_CASES, ids=[c[0] for c in ROWS_CASES])
def test_conv_w8a8_rows_matches_plain(cuda, deadline, case):
    """conv2d_w8a8's "rows" route: one conv_w8a8_rows launch, no other
    kernel and no im2col, equal to conv2d_w8a8_plain bit for bit (codes,
    and the f32 outputs: the same rounding order)."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    tag, xs, k, stride, cout, s_out, act = case
    g = torch.Generator(device=cuda).manual_seed(23)
    x, w, s_in, s_w, b = _conv_inputs(g, cuda, xs, k, cout,
                                      s_out or 0.05)
    if tag == "misaligned x":
        buf = torch.empty(x.numel() + 1, dtype=torch.int8, device=cuda)
        x = buf[1:].view(xs).copy_(x)
        assert x.data_ptr() % 16
    assert cv.conv_w8a8_form(*xs, cout, k, k, stride, "SAME", None,
                             s_out is not None).route == "rows", tag
    before = (cv.conv2d_w8a8.launches, cv.conv_w8a8_rows.launches,
              cv.conv2d_w8a8.im2col_launches, gm.gemm_fused.launches)
    got = cv.conv2d_w8a8(x, s_in, w, s_w, b, act=act, stride=stride,
                         s_out=s_out)
    assert (cv.conv2d_w8a8.launches, cv.conv_w8a8_rows.launches,
            cv.conv2d_w8a8.im2col_launches, gm.gemm_fused.launches) == (
        before[0], before[1] + 1, before[2], before[3]), tag
    ref = cv.conv2d_w8a8_plain(x, s_in, w, s_w, b, act=act, stride=stride,
                               s_out=s_out)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref), (tag, int((got != ref).sum()))


# conv_w8a8's int32-accumulator form at the row-parallel convs' shards
# (416 px: YOLOv2-tiny L13, YOLOv3-tiny L12; ResNet-18 L3 at 224 px), at
# b2 and b1 and a straddled stream-K tile (b1), and the refused Cin 8:
# (tag, x shape, Cout, route, stride)
ACC_CASES = [("v2 L13 Cin512 b2", (2, 13, 13, 512), 1024, "tap", 1),
             ("v2 L13 Cin256 b1", (1, 13, 13, 256), 1024, "tap", 1),
             ("v2 L13 Cin128 b2", (2, 13, 13, 128), 1024, "tap", 1),
             ("v3 L12 Cin256 b2", (2, 13, 13, 256), 1024, "tap", 1),
             ("r18 L3 Cin32 b2", (2, 56, 56, 32), 64, "patch", 1),
             ("r18 L3 Cin16 b1", (1, 56, 56, 16), 64, "patch", 1),
             ("odd Cout", (2, 9, 11, 64), 42, "patch", 1),
             ("stride 2", (2, 14, 14, 32), 48, "patch", 2),
             ("Cin 8", (2, 13, 13, 8), 64, "im2col", 1)]


@pytest.mark.parametrize("case", ACC_CASES, ids=[c[0] for c in ACC_CASES])
def test_conv_w8a8_int32_form_matches_plain(cuda, deadline, case):
    """conv2d_w8a8_acc: the kernel's raw int32 store (or, Cin % 16 != 0,
    im2col + gemm_fused's raw accumulator) equal to conv_acc_plain, int32
    for int32, counted as its route is."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    tag, xs, cout, route, stride = case
    g = torch.Generator(device=cuda).manual_seed(17)
    x, w = _i8(g, cuda, *xs), _i8(g, cuda, 3, 3, xs[3], cout)
    f = cv.conv_w8a8_form(*xs, cout, 3, 3, stride, quantized=False,
                          raw=True)
    assert f.route == route, tag
    before = (cv.conv2d_w8a8.acc_launches, cv.conv2d_w8a8.im2col_launches)
    got = cv.conv2d_w8a8_acc(x, w, stride)
    kern = int(route != "im2col")
    assert (cv.conv2d_w8a8.acc_launches, cv.conv2d_w8a8.im2col_launches) \
        == (before[0] + kern, before[1] + 1 - kern), tag
    ref = cv.conv_acc_plain(x, w, stride)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, ref), (
        tag, int((got != ref).sum()))


@pytest.mark.parametrize("schedule", ["rr", "all"])
def test_conv_w8a8_int32_form_schedules(cuda, deadline, schedule):
    """The raw store after a straddled tile's fixup (stream-K over every
    tile) and round robin: one int32 sum."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops import gemm as gmm
    g = torch.Generator(device=cuda).manual_seed(19)
    xs, cout = (1, 13, 13, 512), 1024
    x, w = _i8(g, cuda, *xs), _i8(g, cuda, 3, 3, 512, cout)
    f = _forced(cv.conv_w8a8_form(*xs, cout, 3, 3, quantized=False,
                                  raw=True), 132, schedule)
    got = cv.conv_w8a8_launch(x, gmm.kmajor_weights(w), None, None, None, 3,
                              13, 13, 0, "linear", f, raw=True)
    torch.cuda.synchronize()
    assert torch.equal(got, cv.conv_acc_plain(x, w)), f


@pytest.mark.parametrize("tier", ["xla", "pallas"])
def test_row_parallel_epilogue_equals_the_unsharded_conv(cuda, deadline,
                                                         tier):
    """The Cin shards' int32 sums on the card, added, then the row-parallel
    conv's epilogue (PyTorch passes): the unsharded conv's codes bit for
    bit, conv_w8a8's conv order on the xla tier, gemm_fused's folded order
    on the gemm tier."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
        conv2d_w8a8_gemm)
    g = torch.Generator(device=cuda).manual_seed(23)
    x, w, s_in, s_w, b = _conv_inputs(g, cuda, (8, 13, 13, 1024), 3, 1024,
                                      0.05)
    acc = sum(cv.conv2d_w8a8_acc(x[..., i:i + 512],
                                 w[:, :, i:i + 512].contiguous())
              for i in (0, 512))
    folded = tier == "pallas"
    got = cv.conv_epilogue(acc, s_in, s_w, b, "leaky", 0.05, folded=folded)
    want = (conv2d_w8a8_gemm(x, s_in, w, s_w, b, s_out=0.05) if folded
            else cv.conv2d_w8a8(x, s_in, w, s_w, b, s_out=0.05))
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


# ResNet-18's conv_w8a8 forms at 224 px (b2 and b1): (tag, x shape, k,
# stride, Cout, requantizes)
RESNET_CONV_CASES = [
    ("L3 f32 patch", (2, 56, 56, 64), 3, 1, 64, False),
    ("L8 s2", (2, 56, 56, 64), 3, 2, 128, True),
    ("L9 f32 tap", (2, 28, 28, 128), 3, 1, 128, False),
    ("L11 proj", (2, 56, 56, 64), 1, 2, 128, False),
    ("L16 s2", (2, 28, 28, 128), 3, 2, 256, True),
    ("L19 proj", (2, 28, 28, 128), 1, 2, 256, False),
    ("L24 s2", (1, 14, 14, 256), 3, 2, 512, True),
    ("L27 proj", (1, 14, 14, 256), 1, 2, 512, False),
    ("L30 f32 tap", (1, 7, 7, 512), 3, 1, 512, False)]


@pytest.mark.parametrize("act", ["relu", "linear"])
@pytest.mark.parametrize("case", RESNET_CONV_CASES,
                         ids=[c[0] for c in RESNET_CONV_CASES])
def test_conv_w8a8_resnet_forms_match_plain(cuda, deadline, case, act):
    """The stride-2 and f32-output forms at ResNet-18's shapes: one kernel
    launch, equal to the plain
    version bit for bit, f32 output included (the same rounding order)."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    tag, xs, k, stride, cout, quant = case
    g = torch.Generator(device=cuda).manual_seed(len(tag) + k)
    x, w, s_in, s_w, b = _conv_inputs(g, cuda, xs, k, cout, 0.05)
    s_out = 0.05 if quant else None
    before = cv.conv2d_w8a8.launches
    got = cv.conv2d_w8a8(x, s_in, w, s_w, b, act=act, stride=stride,
                         s_out=s_out)
    assert cv.conv2d_w8a8.launches == before + 1, tag
    ref = cv.conv2d_w8a8_plain(x, s_in, w, s_w, b, act=act, stride=stride,
                               s_out=s_out)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref), (tag, float((got.double()
                                               - ref.double()).abs().max()))


@pytest.mark.parametrize("sign,s_out", [(-1.0, 0.05), (1.0, -0.05),
                                        (-1.0, -0.05)])
def test_conv_w8a8_group_max_follows_the_sign_of_scale(cuda, sign, s_out):
    """The group-max takes the code of the groups' largest int32 sum where
    scale and s_out have one sign and of the smallest where they differ
    (a negative s_out is mode 4): equal to the plain version's largest
    code."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    g = torch.Generator(device=cuda).manual_seed(9)
    for xs, k, out_hw in (((2, 20, 18, 64), 3, None),
                          ((2, 12, 11, 128), 2, (10, 9))):
        x, w, s_in, s_w, b = _conv_inputs(g, cuda, xs, k, 128, 0.05, True)
        kw = dict(padding="SAME" if k == 3 else "VALID", s_out=s_out,
                  out_hw=out_hw, gmax=True)
        got = cv.conv2d_w8a8(x, s_in, w, s_w * sign, b, **kw)
        ref = cv.conv2d_w8a8_plain(x, s_in, w, s_w * sign, b, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (xs, sign, s_out)


def test_batcher_rows_equal_detect_on_card(cuda, deadline):
    """The b32 pin behind ContinuousBatcher at 416 px: 40 requests from 4
    threads, every result equal to its row of detect on the padded batch
    shipped; the kernels of the pin launched once per batch."""
    import threading
    import warnings
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    from dnn_inference_engine_tpu_torch.runtime.serve import (
        ContinuousBatcher)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")            # noise calibration
        eng = Engine(EngineConfig(mode="w8a8", batch=32, serve_max_batch=32,
                                  score_thresh=0.02)).load_weights(
            seed=0).prepare()
    imgs = np.random.default_rng(4).integers(
        0, 256, (40, 416, 416, 3)).astype(np.uint8)
    shipped, results = [], {}
    real = eng.detect_device
    eng.detect_device = lambda x: (shipped.append(x.copy()), real(x))[1]
    before = (cv.conv2d_w8a8.launches, fc.stem_fused_k2.launches)
    b = ContinuousBatcher(eng).start()
    try:
        def client(idx):
            futs = [(i, b.submit(imgs[i])) for i in idx]
            for i, f in futs:
                results[i] = f.result(timeout=100)
        ts = [threading.Thread(target=client, args=(range(t, 40, 4),))
              for t in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=100)
        assert not any(t.is_alive() for t in ts)
    finally:
        b.stop()
        del eng.detect_device
    n = len(shipped)
    assert len(results) == 40 and n >= 2
    assert cv.conv2d_w8a8.launches - before[0] == 7 * n
    assert fc.stem_fused_k2.launches - before[1] == n
    for x in shipped:
        ref = eng.detect(x)
        for r in range(32):
            for i in range(40):
                if np.array_equal(imgs[i], x[r]):
                    for got, want in zip(results[i], ref):
                        np.testing.assert_array_equal(got, want[r])
    assert any((results[i][1] > 0).any() for i in range(40))


def test_yolov3_darknet_file_on_card(cuda, deadline, tmp_path):
    """A YOLOv3-tiny darknet file (chip_smoke.py's seeded writer) calibrated
    from an .npy batch: the card engine at b1 (its pin's per-tap stem,
    stem_fused_dg, under file weights) gives the CPU engine's heads and
    detections."""
    from chip_smoke import write_darknet
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.models import build_model
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    path = str(write_darknet(build_model("yolov3-tiny"),
                             tmp_path / "v3.weights", 5))
    calib = str(tmp_path / "calib.npy")
    np.save(calib, np.random.default_rng(6).integers(
        0, 256, (4, 300, 400, 3)).astype(np.uint8))
    kw = dict(model="yolov3-tiny", mode="w8a8", batch=1, weights=path,
              calib=calib, score_thresh=0.02)
    gpu = Engine(EngineConfig(**kw)).load_weights().prepare()
    cpu = Engine(EngineConfig(**{**kw, "calib": None}), device="cpu")
    cpu.load_weights()
    cpu.act_scales = list(gpu.act_scales)
    cpu.prepare()
    img = np.random.default_rng(7).integers(
        0, 256, (1, 416, 416, 3)).astype(np.uint8)
    before = fc.stem_fused_dg.launches
    hg = gpu.classify(img)
    assert fc.stem_fused_dg.launches == before + 1
    for a, c in zip(hg, cpu.classify(img)):
        np.testing.assert_array_equal(a, c)
    (bg, sg, cg), (bc, sc, cc) = gpu.detect(img), cpu.detect(img)
    np.testing.assert_array_equal((sg > 0).sum(), (sc > 0).sum())
    np.testing.assert_array_equal(cg, cc)
    np.testing.assert_allclose(bg, bc, atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# profiling on the card (runtime/profiling.py, Engine.stage_times*)
# ---------------------------------------------------------------------------

def test_conv_w8a8_launch_is_attributed_to_its_scope(cuda, deadline):
    """A conv_w8a8 launch (ctypes, no ATen op around it) inside a stage
    scope is traced into that scope."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.runtime.profiling import (
        scope, trace_attribution)
    g = torch.Generator(device=cuda).manual_seed(5)
    x, w = _i8(g, cuda, 2, 52, 52, 128), _i8(g, cuda, 3, 3, 128, 256)
    s_w = torch.rand(256, generator=g, device=cuda) * 1e-3
    b = torch.randn(256, generator=g, device=cuda)

    def fn(xx):
        with scope("stage0_xla_L0"):
            return cv.conv2d_w8a8(xx, 0.05, w, s_w, b, s_out=0.05)
    art = trace_attribution(fn, x, runs=3)
    conv = [r for r in art["top_ops"] if r["group"] == "conv_w8a8"]
    assert conv and all(r["scope"] == "stage0_xla_L0" for r in conv)
    assert not any(k.startswith("unattributed/conv_w8a8")
                   for k in art["by_scope_us"])


def _w8a8_pin_engine(batch):
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    with pytest.warns(UserWarning, match="uniform noise"):
        return Engine(EngineConfig(mode="w8a8", batch=batch)).load_weights(
            seed=0).prepare()


def test_trace_attribution_rows_sum_to_the_module_time(cuda, deadline):
    """The W8A8 pin's b2 forward: the scope rows sum to the device busy
    time within 2%, every stage has device time, and every port kernel's
    traced count equals its launch counter (checked inside)."""
    from dnn_inference_engine_tpu_torch.runtime.profiling import (
        trace_attribution)
    eng = _w8a8_pin_engine(2)
    art = trace_attribution(eng._fwd, eng._bench_input(2), runs=5)
    module = art["module_device_us_per_run"]
    assert abs(sum(art["by_scope_us"].values()) - module) < 0.02 * module
    stages = [k for k in art["by_scope_us"] if k.startswith("stage")]
    assert len(stages) == len(eng._plan)


def test_stage_times_on_card_stay_under_the_roofline(cuda, deadline):
    """No stage of the W8A8 pin's b2 plan reads more than 105% of its
    binding floor: in context (the trace's device time) nor, where
    resolved, looped alone."""
    eng = _w8a8_pin_engine(2)
    rows = [r for r in eng.stage_times_traced(batch=2, runs=5)["stages"]
            if r["stage"] is not None]
    assert len(rows) == len(eng._plan)
    for r in rows:
        assert r["trace_pct_of_binding"] is not None, r
        for k in ("pct_of_binding", "trace_pct_of_binding"):
            assert r[k] is None or r[k] <= 105.0, r


# the NMS's suppress stage: the CPU tests' seeded box cases, and the card's
# main-path sizes (the pins' b32 and b1 at the default topk 256, the eval
# grades' every-candidate-valid K 845 on a cluster with the bitmatrix in
# shared memory and K 2535 in the global scratch; YOLOv3-tiny's pools at
# 544 px, K 4335, the largest whose lists fit in shared memory, and at 608
# px, K 5415, the lists in global memory too), and chains K - 1 deep
NMS_CARD_CASES = ["k256", "k100", "k100_ties", "k256_ties", "k256_empty",
                  "k100_chain", "k65_chain", "ulp", "oidx_reversed",
                  "dup_keys", "nonfinite", "degenerate", "k845_all_valid",
                  "k2535_all_valid", "b32_k256", "b1_k256", "b2_k845",
                  "b2_k2535", "b2_k4335", "b2_k5415", "k256_chain",
                  "k2535_chain", "k5415_chain"]


def _nms_card_case(name):
    import _torch_nms_cases as nc
    if name == "b32_k256":
        return nc.box_case(32, 20, 256, seed=6)
    if name == "b1_k256":
        return nc.box_case(1, 20, 256, seed=16)
    if name == "b2_k845":
        return nc.box_case(2, 20, 845, seed=17, valid_share=1)
    if name == "b2_k2535":
        return nc.box_case(2, 20, 2535, seed=7, valid_share=1)
    if name == "b2_k4335":
        return nc.box_case(2, 20, 4335, seed=27, valid_share=1)
    if name == "b2_k5415":
        return nc.box_case(2, 20, 5415, seed=37, valid_share=1)
    if name == "k5415_chain":
        return nc.box_chain_case(5415)
    if name == "k256_chain":
        return nc.box_chain_case(256)
    if name == "k2535_chain":
        return nc.box_chain_case(2535)
    return nc.BOX_CASES[name]()


@pytest.mark.parametrize("name", NMS_CARD_CASES)
def test_nms_suppress_kernel_matches_plain(cuda, deadline, name):
    """One launch; keep masks equal to the plain version's bit for bit."""
    import _torch_nms_cases as nc
    from dnn_inference_engine_tpu_torch import postprocess as pp
    xyxy, s, oidx = (torch.from_numpy(a).to(cuda)
                     for a in _nms_card_case(name))
    if name in ("b2_k4335", "b2_k5415", "k5415_chain"):
        form = pp.nms_suppress_form(*s.shape)
        assert form["lists_in_smem"] == (name == "b2_k4335")
        assert not form["rows_in_smem"]
    th = (nc.IOU_THRESH, nc.SCORE_THRESH)
    before = pp.nms_suppress.launches
    keep = pp.nms_suppress(xyxy, s, oidx, *th)
    assert pp.nms_suppress.launches == before + 1
    ref = pp.nms_suppress_plain(xyxy, s, oidx, *th)
    torch.cuda.synchronize()
    assert torch.equal(keep, ref)
    assert torch.equal(pp.nms_suppress(xyxy, s, oidx, *th), ref)


def test_nms_on_card_reads_no_host(cuda, deadline):
    """device_nms_cols on the card: one nms_suppress launch, no host read
    of the plain loop, and nothing that synchronizes the host (PyTorch's
    sync debug mode raises on a synchronizing call)."""
    from dnn_inference_engine_tpu_torch import postprocess as pp
    g = torch.Generator(device=cuda).manual_seed(8)
    head = torch.randn((32, 13, 13, 125), generator=g, device=cuda) * 2
    boxes, scores = pp.decode_yolov2_cols(head)
    pp.device_nms_cols(boxes, scores, score_thresh=0.05)     # build, warm
    torch.cuda.synchronize()
    pp._greedy_fixpoint.host_syncs = 0
    before = pp.nms_suppress.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pp.device_nms_cols(boxes, scores, score_thresh=0.05)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pp.nms_suppress.launches == before + 1
    assert pp._greedy_fixpoint.host_syncs == 0
    ref = pp.device_nms_cols(boxes.cpu(), scores.cpu(), score_thresh=0.05)
    for a, b in zip(out, ref):
        assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# the bench's timers and run_bench on the card
# ---------------------------------------------------------------------------

def test_card_timers_time_one_known_kernel(cuda, deadline):
    """``device_ms``, ``throughput_ms`` and ``latency_ms`` of shift_s2d2 at
    the pin's b32 input (PERF.md row 3): each call one launch, the device
    time no longer than either host-inclusive time, all finite."""
    from dnn_inference_engine_tpu_torch.runtime import benchlib
    g = torch.Generator(device=cuda).manual_seed(3)
    x = _i8(g, cuda, 32, 104, 104, 32)
    before = fc.shift_s2d2.launches
    dev = benchlib.device_ms(lambda: fc.shift_s2d2(x), 20, device=x)
    thr = benchlib.throughput_ms(lambda: fc.shift_s2d2(x), 20)
    lat = benchlib.latency_ms(lambda: fc.shift_s2d2(x), 20, device=cuda)
    assert fc.shift_s2d2.launches == before + 3 * 21
    assert all(np.isfinite(v) and v > 0 for v in (dev, thr, lat))
    assert dev <= 1.05 * thr and dev <= 1.05 * lat, (dev, thr, lat)
    assert benchlib.card_line(cuda).startswith(
        torch.cuda.get_device_name(cuda))
    assert set(benchlib.clocks(cuda)) == {"sm_mhz", "mem_mhz"}


def test_run_bench_on_card_at_batch_2(cuda, deadline):
    """``run_bench`` at b2 on the card: the JAX contract's keys, the card
    line, the b1 detect's device time from the trace at most its wall p50
    and the sum of its split, ``value`` the forward's images/s."""
    from dnn_inference_engine_tpu_torch.bench import run_bench
    from dnn_inference_engine_tpu_torch.runtime import benchlib
    faulthandler.dump_traceback_later(300, exit=True)   # three engines
    res = run_bench(batch=2)
    d = res["detail"]
    assert d["backend"] == "cuda" and d["card"] == benchlib.card_line(cuda)
    assert res["value"] == pytest.approx(2e3 / d["ms_per_batch"], rel=1e-3,
                                         abs=0.05)
    dev, split = d["single_image_device_ms"], d["single_image_split_device_ms"]
    assert 0 < dev <= d["p50_single_image_ms"]
    assert sum(split.values()) == pytest.approx(dev, abs=2e-4)
    assert all(v > 0 for v in split.values()), split
    assert d["clocks_before"]["sm_mhz"] > 0
