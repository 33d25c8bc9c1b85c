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
