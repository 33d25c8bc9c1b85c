"""A configuration's family (``families/<family>.py``) is what the harness
asks for the model's weights, reference, operation count and the
program's int8 codes: a configuration without ``"family"`` is a layer
list, an unknown family names the file it looked for, both layer-list
configurations get the weights, codes, scales and heads they got before
families existed, bit for bit, and a family that is not a layer list is
what the judgement, the control and ``step_mfu_pct`` take."""

import hashlib
import json
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import cell, control, families, inputs, judge, metrics
from benchmark import roofline, spec
from benchmark.families import layer_list
from benchmark.tasks import classify

BENCH = spec.load()
SEED = 2 ** 33 + 5
SMALL = {"input_size": 64, "batch": 4, "pool_batches": 2,
         "sample_batches": 3, "trace_batches": 2}

# sha256 (first 32 hex digits) of the float32 and int8 bytes at SEED, 64
# px, on the CPU with 2 threads: the weights (each layer's "b" then "w"),
# and for qmax 127 and 7 the reference's codes (each layer's "wq" then
# "s_w"), its calibrated scales (float64) and its head of the first pool
# batch of 4. Made by the code of the commit before families existed
# (``inputs.weights``, ``reference.int8_net.Reference`` called directly),
# run from a copy of that tree through the same steps as ``digests``
# below. Float32 convolutions (the calibration, YOLO's standardized head)
# round otherwise on one thread, so the tests run on two.
PARENT = {
    "yolov2-tiny-w8a8": {
        "weights": "e3812dbb88db0d3f3ae583875e6514a1",
        "q127": {"codes": "76f751005e3f96d338c9ad3316395bbd",
                 "scales": "b3afbb65fcb109ea47ec9a072775183a",
                 "head": "31b3ba0b266dd854b056a2e9c02a2ec1"},
        "q7": {"codes": "6c0ce8e3bfbe27dc02b33c8ea8f522ff",
               "scales": "44e29740d60b437e434c63235b7ca6b5",
               "head": "2765dde21a1da42e9c19fac157a49783"}},
    "resnet18-w8a8": {
        "weights": "d5a30afbdbeaf5d88aeb5c6e50b18b2c",
        "q127": {"codes": "48e72b72f5e8377392234d241d4129c6",
                 "scales": "31e265862abf4580c072db3a17d0bedc",
                 "head": "d49d054e0a14d0bd886364182422c207"},
        "q7": {"codes": "d1910e51d55b9fc0b0bf098ac1bced53",
               "scales": "5af2ae727cbac7ef78fc6dd44ea1809e",
               "head": "cd908c443dfa94872f8effd0e675fc9d"}},
}


@pytest.fixture(autouse=True)
def two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def config(name):
    conf = next(c for c in BENCH["configs"] if c["name"] == name)
    with open(spec.ROOT / conf["file"]) as f:
        return json.load(f)


def sha(arrays):
    d = hashlib.sha256()
    for a in arrays:
        d.update(np.ascontiguousarray(a).tobytes())
    return d.hexdigest()[:32]


def digests(cfg):
    family = families.of(cfg)
    calib = inputs.calib_images(cfg, SEED, "cpu", 64)
    params = inputs.weights(cfg, SEED, "cpu", calib)
    x = inputs.pool(cfg, SEED, "cpu", 64, 4, 1)[0]
    out = {"weights": sha(p[k].numpy() for p in params for k in sorted(p))}
    for qmax in (127.0, 7.0):
        ref = family.reference(cfg, params, qmax)
        ref.calibrate(calib)
        out[f"q{int(qmax)}"] = {
            "codes": sha(q[k].numpy() for q in ref.qparams
                         for k in ("wq", "s_w") if q),
            "scales": sha([np.asarray(ref.scales, np.float64)]),
            "head": sha([ref.forward(x).numpy()])}
    return out


# -- resolution -------------------------------------------------------------

def test_a_configuration_without_a_family_is_a_layer_list():
    assert families.of({"name": "x"}) is layer_list
    for conf in BENCH["configs"]:
        cfg = config(conf["name"])
        assert "family" not in cfg
        assert families.of(cfg) is layer_list


def test_an_unknown_family_names_the_file_it_expected():
    with pytest.raises(ModuleNotFoundError) as e:
        families.of({"name": "x", "family": "no_such_family"})
    assert str(families.HERE / "no_such_family.py") in str(e.value)


# -- the layer lists, bit for bit -------------------------------------------

@pytest.mark.parametrize("name", sorted(PARENT))
def test_weights_codes_scales_and_heads_are_the_parents(name):
    assert digests(config(name)) == PARENT[name]


# -- a family that is not a layer list --------------------------------------

TOY_OPS = 2.0 * (48 * 8 + 8 * 5)
TOY_CFG = {"name": "toy", "family": "toy_linear", "task": "classify",
           "input_size": 4, "in_channels": 3, "num_classes": 5}
TOY_SIZES = {"input_size": 4, "batch": 2, "pool_batches": 2}


class ToyReference:
    """Two float32 linear layers (48 -> 8, ReLU, 8 -> 5) on the uint8
    batch / 255, weights per output column and activations per tensor at
    ``qmax``. Its weights are a dict of layers, not a list."""
    made = []

    def __init__(self, cfg, params, qmax):
        self.params = [params["fc1"], params["fc2"]]
        self.qmax, self.scales = float(qmax), None
        self.qparams = []
        for p in self.params:
            s_w = p["w"].abs().amax(0).clamp_min(1e-12) / self.qmax
            wq = torch.clamp(torch.round(p["w"] / s_w), -qmax, qmax)
            self.qparams.append({"wq": wq.to(torch.int8), "s_w": s_w})
        ToyReference.made.append(self)

    def _layers(self, x, ws):
        seen = [x]
        for i, (w, p) in enumerate(zip(ws, self.params)):
            x = x @ w + p["b"]
            if i == 0:
                x = torch.clamp_min(x, 0.0)
            seen.append(x)
        return seen

    def calibrate(self, images):
        x = images.reshape(images.shape[0], -1)
        seen = self._layers(x, [p["w"] for p in self.params])
        self.scales = [max(float(t.abs().max()), 1e-12) / self.qmax
                       for t in seen]
        return self.scales

    def forward(self, u8):
        x = u8.reshape(u8.shape[0], -1).to(torch.float32) / 255.0
        ws = [q["wq"].to(torch.float32) * q["s_w"] for q in self.qparams]
        return self._layers(x, ws)[-1]


def toy_module():
    mod = types.ModuleType("benchmark.families.toy_linear")

    def weights(cfg, seed, device, calib):
        g = inputs.generator(seed, inputs.WEIGHTS, device)
        return {"fc1": {"w": torch.randn(48, 8, generator=g, device=device),
                        "b": torch.randn(8, generator=g, device=device)},
                "fc2": {"w": torch.randn(8, 5, generator=g, device=device),
                        "b": torch.randn(5, generator=g, device=device)}}

    mod.weights = weights
    mod.reference = ToyReference
    mod.ops_per_image = lambda cfg: TOY_OPS
    mod.program_codes = lambda engine: (engine.codes, engine.scales)
    return mod


@pytest.fixture
def toy(monkeypatch):
    monkeypatch.setitem(sys.modules, "benchmark.families.toy_linear",
                        toy_module())
    ToyReference.made.clear()
    return spec.Cell(name="toy.offline", chips=1, config=TOY_CFG,
                     traffic={"batch": 2, "pool_batches": 2},
                     limits={"weight_codes_off": 0, "scales_gap": 1e-4,
                             "head_gap": 1e-4},
                     end_to_end=[], per_layer=[])


def test_judge_outputs_takes_the_familys_reference_and_codes(toy):
    cfg = toy.config
    calib = inputs.calib_images(cfg, 3, "cpu", 4)
    params = inputs.to_numpy(inputs.weights(cfg, 3, "cpu", calib))
    pool = inputs.pool(cfg, 3, "cpu", 4, 2, 2)
    # the program: the toy family's own int8 network, its codes read back
    # through the family
    prog = ToyReference(cfg, inputs.to_torch(params, "cpu"), judge.INT8)
    prog.calibrate(calib)
    engine = types.SimpleNamespace(codes=prog.qparams, scales=prog.scales)
    codes, scales = families.of(cfg).program_codes(engine)
    outs = [prog.forward(x).numpy() for x in pool]
    given = (params, calib.numpy())

    def judged(codes):
        ToyReference.made.clear()
        numbers = cell.judge_outputs(
            toy, classify, given, "cpu", 4, pool, [(0, outs[0], None)],
            {1: outs[1]}, codes, scales)
        assert [r.qmax for r in ToyReference.made] == [judge.INT8]
        return numbers

    assert judged(codes) == {"weight_codes_off": 0.0, "scales_gap": 0.0,
                             "head_gap": 0.0}
    altered = [dict(q) for q in codes]
    altered[1]["wq"] = altered[1]["wq"].clone()
    altered[1]["wq"][0, 0] += 1
    assert judged(altered)["weight_codes_off"] == 1


def test_the_control_takes_the_familys_reference(toy):
    numbers = control.readings(toy, 3, "cpu", sizes=TOY_SIZES)
    assert sorted(r.qmax for r in ToyReference.made) == [control.INT4,
                                                         judge.INT8]
    assert numbers["weight_codes_off"] > 0
    assert not judge.verdict(numbers, toy.limits)[0]


def test_step_mfu_takes_the_familys_count(toy):
    assert roofline.ops_per_image(toy.config) == TOY_OPS
    ctx = {"cfg": toy.config, "batch": 2,
           "device_name": "NVIDIA H100 80GB HBM3",
           "trace": {"busy_s": 1e-6, "batches": 3}}
    assert metrics.read("step_mfu_pct", ctx) == pytest.approx(
        100.0 * TOY_OPS * 2 * 3 / 1e-6 / 1979e12, rel=1e-12)


def test_a_cell_run_takes_the_programs_codes_from_the_family(monkeypatch):
    """One code of the program's altered where the family reads it back:
    the run counts it."""
    def read_back(engine):
        codes, scales = read_back.original(engine)
        li = next(i for i, q in enumerate(codes) if q)
        codes[li] = dict(codes[li], wq=codes[li]["wq"].clone())
        codes[li]["wq"].view(-1)[0] += 1
        return codes, scales
    read_back.original = layer_list.program_codes
    monkeypatch.setattr(layer_list, "program_codes", read_back)
    c = spec.cell(BENCH, "resnet18-w8a8.offline-b512")
    r = cell.run(c, SEED, 0.3, False, 0.0, device="cpu", sizes=SMALL)
    assert r["checks"]["weight_codes_off"]["value"] == 1
    assert not r["correct"]
