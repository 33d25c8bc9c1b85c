"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test asks the ``cuda`` fixture for the device, which
skips when there is no card. Run on a machine with one:

    python -m pytest -m gpu tests/

Every comparison is exact: the kernels round every epilogue operation as
the plain versions do, and int32 accumulation is order-independent.
"""

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


@pytest.mark.parametrize("ingest", ["f32", "exact_u8"])
@pytest.mark.parametrize("cin", [48, 64])
@pytest.mark.parametrize("rows", [1, 2, 4])
def test_stem_kernel_matches_plain(cuda, monkeypatch, ingest, cin, rows):
    """Every band height, on 56 px rows (14 output rows: the last band of
    4 is partial)."""
    monkeypatch.setattr(fc, "_stem_band_rows", lambda n, hout, sms: rows)
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
@pytest.mark.parametrize("cin", [48, 64])
@pytest.mark.parametrize("rows", [1, 2, 4])
@pytest.mark.parametrize("batch", [1, 2, 16])
def test_stem_dg_kernel_matches_plain(cuda, monkeypatch, batch, rows, cin,
                                      ingest):
    """Every band height at batches 1, 2 and 16, on 56 px rows (14 output
    rows: the last band of 4 is partial); equal to the k2 kernel too."""
    monkeypatch.setattr(fc, "_stem_band_rows", lambda n, hout, sms: rows)
    g = torch.Generator(device=cuda).manual_seed(batch * 100 + cin)
    w = _i8(g, cuda, 2, 2, cin, 256)
    scale = torch.rand(256, generator=g, device=cuda) * 1e-2
    bias = torch.randn(256, generator=g, device=cuda)
    xu = torch.randint(0, 256, (batch, 56, 72, 3), generator=g, device=cuda,
                       dtype=torch.uint8)
    x = xu.float() / 255.0 if ingest == "f32" else xu
    exact = ingest == "exact_u8"
    before = fc.stem_fused_dg.launches
    got = fc.stem_fused_dg(x, w, scale, bias, 0.0123, exact_u8=exact)
    assert fc.stem_fused_dg.launches == before + 1
    ref = fc.stem_fused_dg_plain(x, w, scale, bias, 0.0123, exact_u8=exact)
    k2 = fc.stem_fused_k2(x, w, scale, bias, 0.0123, exact_u8=exact)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(got, k2)


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
    cfg = EngineConfig(batch=2, input_size=64, score_thresh=0.02)
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
    cfg = EngineConfig(model="yolov3-tiny", batch=2, input_size=64,
                       score_thresh=0.02)
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
    cfg = EngineConfig(batch=2, input_size=64, score_thresh=0.02,
                       strategy=str(path))
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
