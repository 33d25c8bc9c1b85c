"""The port's copy-engine tools against the JAX repo's, on the CPU.

``dnn_inference_engine_tpu_torch/tools/proto_conv_dma.py`` (the 3x3 conv
whose im2col matrix TMA assembles) and ``tools/probe_dma_rules.py`` (the
TMA rule probe) against the JAX repo's ``tools/`` modules of the same
names, loaded by path (``tools/`` is no package) and run in Pallas
interpret mode. Inputs are made with numpy from a seed; the port's
wrappers take their plain versions for CPU tensors. int8 codes are
compared exactly.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dnn_inference_engine_tpu_torch.ops.fused_conv import conv3x3_rs_plain
from dnn_inference_engine_tpu_torch.tools import probe_dma_rules as pr
from dnn_inference_engine_tpu_torch.tools import proto_conv_dma as pc

ROOT = Path(__file__).resolve().parents[1]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jconv():
    return _jax_tool("proto_conv_dma")


@pytest.fixture(scope="module")
def jprobe():
    return _jax_tool("probe_dma_rules")


def _conv_inputs(seed, n, h, w, cin, go, bias=True):
    r = np.random.default_rng(seed)
    x = r.integers(-127, 128, (n, h, w, cin), dtype=np.int8)
    wq = r.integers(-20, 21, (3, 3, cin, 4 * go), dtype=np.int8)
    scale = r.uniform(1e-3, 3e-3, go).astype(np.float32)
    b = (r.standard_normal(go) * 3).astype(np.float32) if bias \
        else np.zeros(go, np.float32)
    return x, wq, scale, b


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# conv_dma
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ht,aligned", [(13, False), (26, False),
                                        (13, True)])
def test_conv_dma_plain_matches_jax(jconv, ht, aligned):
    """The JAX prototype at (2,26,104,64) -> 128, go 32 (its W and go),
    positive scale, nonzero bias: codes identical. ``aligned`` only spaces
    its tap blocks; the port has no such argument."""
    x, w, scale, bias = _conv_inputs(7, 2, 26, 104, 64, 32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jconv.conv_dma(x, w, scale, bias, ht=ht,
                                         aligned=aligned))
    got = pc.conv_dma(T(x), T(w), T(scale), T(bias), ht=ht)
    assert got.dtype == torch.int8 and got.shape == (2, 26, 104, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 100          # codes across the range


@pytest.mark.parametrize("shape", [(2, 11, 40, 64, 32), (1, 7, 17, 16, 32),
                                   (3, 5, 9, 48, 64), (1, 13, 104, 64, 32)])
def test_conv_dma_plain_is_conv3x3_rs_gmaxm(shape):
    """conv_dma is conv3x3_rs with pool ('gmaxm', 2, go) and scale, bias
    tiled 4x; ragged H, W other than 104, go other than 32."""
    n, h, w, cin, go = shape
    x, wq, scale, b = map(T, _conv_inputs(sum(shape), n, h, w, cin, go))
    got = pc.conv_dma_plain(x, wq, scale, b)
    want = conv3x3_rs_plain(x, wq, scale.repeat(4), b.repeat(4),
                            pool=("gmaxm", 2, go))
    assert got.shape == (n, h, w, go)
    assert torch.equal(got, want)
    before = pc.conv_dma.launches
    assert torch.equal(pc.conv_dma(x, wq, scale, b, ht=4), want)
    assert pc.conv_dma.launches == before          # the CPU launches nothing


def _bad(**kw):
    x, w, scale, bias = map(T, _conv_inputs(0, 1, 4, 8, 64, 32))
    args = dict(x=x, w=w, scale=scale, bias=bias, ht=2)
    args.update(kw)
    return args


@pytest.mark.parametrize("args,err,words", [
    (_bad(x=torch.zeros(1, 4, 8, 64)), TypeError, "int8"),
    (_bad(w=torch.zeros(3, 3, 32, 128, dtype=torch.int8)), ValueError,
     "w must be"),
    (_bad(scale=torch.zeros(16), bias=torch.zeros(16)), ValueError,
     "4 x go"),
    (_bad(scale=torch.zeros(32, dtype=torch.float64)), ValueError,
     "scale must be float32"),
    (_bad(bias=torch.zeros(32, 1)), ValueError, "bias must be"),
    (_bad(x=torch.zeros(1, 4, 8, 24, dtype=torch.int8),
          w=torch.zeros(3, 3, 24, 128, dtype=torch.int8)), ValueError,
     "multiple of 16"),
    (_bad(x=torch.zeros(1, 4, 8, 272, dtype=torch.int8),
          w=torch.zeros(3, 3, 272, 128, dtype=torch.int8)), ValueError,
     "up to 256"),
    (_bad(x=torch.zeros(1, 4, 300, 64, dtype=torch.int8)), ValueError,
     "W must be at most 256"),
    (_bad(ht=0), ValueError, "ht must be"),
], ids=["x-dtype", "w-shape", "cout", "scale-dtype", "bias-shape", "cin-16",
        "cin-256", "w-256", "ht"])
def test_conv_dma_refuses_by_name(args, err, words):
    with pytest.raises(err, match="conv_dma") as info:
        pc.conv_dma(**args)
    assert words in str(info.value)


def test_conv_dma_layout_at_the_prototype_shape():
    """(32,104,104,64) -> 128: tiles of 16 x 8 pixels (2,912 of them over
    132 persistent blocks), three 64-byte steps a tile (one patch box of
    16 rows x 10 columns a tap row), B resident beside 12 stages: 197,856
    bytes of shared memory; both maps the kernel encodes obey the TMA
    rules with the 64-byte swizzle."""
    assert (pc.TR, pc.TC) == (16, 8)
    f = pc.conv_dma_form(32, 104, 104, 64, 32)
    assert f == pc.DmaForm(kb=64, steps=3, resident=True, stages=12,
                           smem=197_856, units=2912, grid=132)
    assert f.smem <= pr.SMEM_LIMIT
    x = torch.zeros(32, 104, 104, 64, dtype=torch.int8)
    maps = pc.conv_dma_maps(x.shape, x.stride(), 32, f)
    assert [box for _, _, box in maps] == [(1, 16, 10, 64), (128, 64)]
    for shape, strides, box in maps:
        assert pr.tma_box_legal(shape, strides, box, 0, swizzle=64) == \
            (True, "")
    # fewer pixels than a tile take one; each column block its own units
    assert pc.conv_dma_form(3, 11, 17, 32, 32).units == 3 * 1 * 3
    assert pc.conv_dma_form(1, 5, 9, 48, 32).units == 2
    assert pc.conv_dma_form(1, 6, 256, 16, 64).units == 32 * 2


@pytest.mark.parametrize("cin,kb,steps,resident,stages", [
    (16, 64, 3, True, 12), (64, 64, 3, True, 12), (80, 128, 3, True, 3),
    (128, 128, 3, True, 3), (144, 128, 6, False, 3),
    (256, 128, 6, False, 3)])
def test_conv_dma_form_fits_every_cin(cin, kb, steps, resident, stages):
    """Every Cin the kernel takes fits one block at W 104: B resident up
    to Cin 128 (9 x 128 x kb bytes), streamed with the patches above.
    Both maps obey the TMA rules at the step's swizzle."""
    f = pc.conv_dma_form(1, 4, 104, cin, 32)
    assert (f.kb, f.steps, f.resident, f.stages) == (kb, steps, resident,
                                                     stages)
    assert f.smem <= pr.SMEM_LIMIT
    x = torch.zeros(1, 4, 104, cin, dtype=torch.int8)
    for shape, strides, box in pc.conv_dma_maps(x.shape, x.stride(), 32, f):
        assert pr.tma_box_legal(shape, strides, box, 0, swizzle=kb)[0]


def test_tma_box_legal_swizzle_span():
    """With a swizzle the box's inner extent may not pass its span."""
    assert pr.tma_box_legal((4, 256), (256, 1), (8, 128), 0, swizzle=128) \
        == (True, "")
    legal, why = pr.tma_box_legal((4, 256), (256, 1), (8, 128), 0,
                                  swizzle=64)
    assert not legal and "above the 64-byte swizzle span" in why
    assert not pr.tma_box_legal((4, 256), (256, 1), (8, 64), 0,
                                swizzle=48)[0]


def test_proto_conv_dma_main_cpu(capsys):
    assert pc.main(["--device", "cpu", "--batch", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[-1] for ln in lines[1:]] == ["ht13", "ht26", "ht8",
                                                    "gmaxm"]
    assert all("exact=True" in ln for ln in lines[1:])


def test_proto_conv_dma_main_raises_on_an_inexact_variant(monkeypatch):
    monkeypatch.setattr(pc, "conv3x3_rs",
                        lambda x, *a, **k: torch.zeros(
                            x.shape[:3] + (pc.GO,), dtype=torch.int8))
    with pytest.raises(AssertionError, match="conv3x3_rs gmaxm"):
        pc.main(["--device", "cpu", "--batch", "1"])


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------

JAX_CASES = pr.CASES[:9]


@pytest.mark.parametrize("i", range(9), ids=[c.name for c in JAX_CASES])
def test_probe_jax_cases(jprobe, i):
    """The JAX probe copies each of its 9 slices exactly in interpret mode;
    the port's case is the same slice, and probe_plain copies it as numpy
    slices it."""
    name, shape, sl = jprobe.CASES[i]
    case = pr.CASES[i]
    assert (case.name, case.shape) == (name, shape)
    assert case.start == tuple(s.start for s in sl)
    assert case.box == tuple(s.size for s in sl)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pltpu.force_tpu_interpret_mode():
        jprobe.probe(name, shape, sl)
    assert buf.getvalue().split() == ["OK", name, "exact=True"]
    sl = tuple(slice(s, s + b) for s, b in zip(case.start, case.box))
    # the JAX probe's own source, whose copy it found exact, and the port's
    jsrc = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    for src in (torch.from_numpy(jsrc.astype(np.int8)),
                pr.case_source(case, "cpu")):
        np.testing.assert_array_equal(
            pr.probe_plain(src, case.start, case.box).numpy(),
            src.numpy()[sl])


RULES = {
    "2d-sub-off1": "box extent 1280",
    "2d-sub-off2e8": "box extent 1152",
    "inner-8B": "inner extent is 8 bytes",
    "box-257": "box extent 257",
    "base+1": "1 bytes off 16-byte alignment",
    "stride-100": "global stride 100 bytes",
}


@pytest.mark.parametrize("case", pr.CASES, ids=[c.name for c in pr.CASES])
def test_tma_box_legal_verdicts(case):
    """The documented verdict of every case: refused with the rule it
    breaks, or accepted, with coordinates anywhere."""
    src = pr.case_source(case, "cpu")
    assert src.data_ptr() % 16 == case.base_offset
    legal, why = pr.tma_box_legal(tuple(src.shape), src.stride(), case.box,
                                  src.data_ptr() % 16)
    if case.name in RULES:
        assert not legal and RULES[case.name] in why
    else:
        assert legal and why == ""
    v = pr.probe(src, case.start, case.box)
    assert v.accepted == legal and v.cu_result is None
    assert (v.out is None) == (not legal)


def _numpy_box(src, start, box):
    """The box by padding the source with zeros on every side."""
    pads = [(max(0, -s), max(0, s + b - n))
            for s, b, n in zip(start, box, src.shape)]
    padded = np.pad(src, pads)
    return padded[tuple(slice(s + lo, s + lo + b)
                        for s, b, (lo, _) in zip(start, box, pads))]


@pytest.mark.parametrize("name", ["oob-neg1", "oob-past-end",
                                  "rank1-past-end", "conv-halo"])
def test_probe_plain_zero_fills_out_of_bounds(name):
    case = next(c for c in pr.CASES if c.name == name)
    src = pr.case_source(case, "cpu")
    got = pr.probe_plain(src, case.start, case.box)
    want = _numpy_box(src.numpy(), case.start, case.box)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < np.count_nonzero(want) < want.size


def test_probe_refuses_a_box_leaving_a_ragged_inner_dimension():
    """A box may leave the inner dimension only where its bytes are a
    multiple of 16 (the card faults otherwise, though the encode accepts
    the map); inside it, any inner extent copies."""
    src = torch.arange(1000).to(torch.int8)
    with pytest.raises(ValueError, match="probe: the box leaves an inner "
                                         "dimension of 1000 bytes"):
        pr.probe(src, (900,), (256,))
    with pytest.raises(ValueError, match="1000 bytes"):
        pr.probe(torch.zeros(2016, dtype=torch.int8).as_strided(
            (2, 1000), (1008, 1)), (0, -16), (1, 256))
    v = pr.probe(src, (744,), (256,))
    assert v.accepted and torch.equal(v.out, src[744:])


def test_probe_dma_rules_main_cpu(capsys):
    assert pr.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(pr.CASES)
    assert sum(ln.startswith("REJ") for ln in lines) == len(RULES)
    assert all(ln.startswith("OK") and "exact=True" in ln
               for ln in lines if not ln.startswith("REJ"))


def test_probe_dma_rules_main_raises_on_a_mismatch(monkeypatch):
    monkeypatch.setattr(pr, "probe", lambda src, start, box: pr.Verdict(
        True, None, torch.zeros(tuple(box), dtype=torch.int8)))
    with pytest.raises(AssertionError, match="base\\+1: the encode accepts"):
        pr.main(["--device", "cpu"])
