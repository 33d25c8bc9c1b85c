"""The channel-sharded W8A8 forward and its int32 accumulators, on the CPU.

- ``conv2d_int8_acc`` (im2col + ``gemm_fused``'s raw accumulator) and
  ``conv2d_w8a8_acc`` (the conv_w8a8 kernel's int32 form; on the CPU its
  plain version, ``conv_acc_plain``) equal the JAX package's int32
  accumulators exactly: JAX ``conv2d_int8_acc`` (Pallas, interpret mode)
  and XLA's int8 conv with ``preferred_element_type=int32``, at the
  shapes of the row-parallel convs' routes, scaled down;
- ``conv_w8a8_form(..., raw=True)`` at the row-parallel convs of the
  pins at 416 px: YOLOv2-tiny's L13 and YOLOv3-tiny's L12 take TAP,
  ResNet-18's L3 (224 px) PATCH, a Cin that is not a multiple of 16 the
  im2col;
- ``conv_epilogue`` on the exact accumulator is ``conv2d_w8a8_plain``
  (the conv order) and ``conv2d_w8a8_gemm`` (the folded order) bit for
  bit, and the Cin shards' accumulators summed and run through
  ``row_parallel_conv_w8a8`` give the unsharded conv's codes;
- ``make_shardmap_forward`` on gloo ranks (meshes (1, 2), (2, 1),
  (2, 2)) equals the port's single-device ``Model.forward_w8a8`` bit for
  bit, and JAX ``make_shardmap_forward`` within 1e-5 of the largest head
  value: the f32 head's epilogue, which XLA contracts into an FMA under
  jit, is why there is a tolerance. For ResNet-18 that contraction also
  moves codes mid-network (ROADMAP section C), so there the JAX side
  runs op by op, ``jax.jit`` as the identity. Where JAX's GSPMD tier
  (``sharding.make_sharded_forward`` with channel-sharded params) sums
  f32-converted partials and flips codes (JAX ``sharding.py:144-151``),
  the port has no such tier: its channel case always sums int32 and is
  exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import _torch_dist as td

from dnn_inference_engine_tpu.models import build_model as jbuild
from dnn_inference_engine_tpu.ops.conv import _conv as jconv
from dnn_inference_engine_tpu.ops.conv_lowering import (
    conv2d_int8_acc as j_int8_acc)
from dnn_inference_engine_tpu.parallel.shard_map_forward import (
    make_shardmap_forward as j_shardmap_forward)
from dnn_inference_engine_tpu.parallel.sharding import (
    input_sharding as j_input_sharding, shard_params as j_shard_params)

from dnn_inference_engine_tpu_torch.models import build_model
from dnn_inference_engine_tpu_torch.models.weights import (
    load_checkpoint, params_from_numpy)
from dnn_inference_engine_tpu_torch.ops import conv as cv
from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
    conv2d_int8_acc, conv2d_w8a8_gemm)
from dnn_inference_engine_tpu_torch.parallel.shard_map_forward import (
    row_parallel_conv_w8a8)

MESHES = [(1, 2), (2, 1), (2, 2)]
FORWARD_CASES = ["v2_xla", "v3_auto", "r18_xla"]
MODEL_OF = {"v2_xla": ("yolov2-tiny", "xla"),
            "v3_auto": ("yolov3-tiny", "auto"),
            "r18_xla": ("resnet18", "xla")}


@pytest.fixture(autouse=True)
def _one_thread():
    """int64 and float64 products on one thread (ROADMAP C5)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _codes(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, shape).astype(
        np.int8)


# (x shape, k, Cout, stride): the TAP form (Cin % 128, narrow), PATCH at
# Cin 32 and 16, a Cin the kernel refuses (8), a 1x1 conv, stride 2
ACC_SHAPES = [((2, 5, 5, 256), 3, 64, 1), ((2, 12, 12, 32), 3, 40, 1),
              ((1, 9, 11, 16), 3, 16, 1), ((2, 7, 7, 8), 3, 24, 1),
              ((2, 6, 6, 48), 1, 32, 1), ((2, 9, 9, 32), 3, 16, 2)]


@pytest.mark.parametrize("xs,k,cout,stride", ACC_SHAPES)
def test_int32_accumulators_equal_jax(xs, k, cout, stride):
    x, w = _codes(xs, 1), _codes((k, k, xs[3], cout), 2)
    want = np.asarray(jconv(jnp.asarray(x), jnp.asarray(w), stride, "SAME",
                            preferred_element_type=jnp.int32))
    assert want.dtype == np.int32
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = cv.conv2d_w8a8_acc(tx, tw, stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cv.conv_acc_plain(tx, tw, stride).numpy(), want)
    np.testing.assert_array_equal(conv2d_int8_acc(tx, tw, stride).numpy(),
                                  want)
    if stride == 1:
        np.testing.assert_array_equal(
            np.asarray(j_int8_acc(jnp.asarray(x), jnp.asarray(w))), want)


@pytest.mark.parametrize("tag,n,h,cin,cout,route", [
    ("v2 L13 mp2 b32", 32, 13, 512, 1024, "tap"),
    ("v2 L13 mp4 b32", 32, 13, 256, 1024, "tap"),
    ("v2 L13 mp8 b16", 16, 13, 128, 1024, "tap"),
    ("v2 L13 mp2 b1", 1, 13, 512, 1024, "tap"),
    ("v3 L12 mp2 b16", 16, 13, 256, 1024, "tap"),
    ("v3 L12 mp4 b16", 16, 13, 128, 1024, "tap"),
    ("r18 L3 mp2 b32", 32, 56, 32, 64, "patch"),
    ("r18 L3 mp4 b32", 32, 56, 16, 64, "patch"),
    ("cin 8", 2, 13, 8, 64, "im2col")])
def test_raw_form_routes(tag, n, h, cin, cout, route):
    """The int32 accumulator takes the f32 output's route, but where the
    f32 output takes the small-Cin kernel ("rows", no raw store): there
    the im2col route."""
    f = cv.conv_w8a8_form(n, h, h, cin, cout, 3, 3, quantized=False,
                          raw=True)
    assert f.route == route, tag
    f32 = cv.conv_w8a8_form(n, h, h, cin, cout, 3, 3, quantized=False)
    if route == "im2col":
        assert f32.route == "rows", tag
    else:
        assert f == f32, tag


def test_raw_form_refuses_codes_and_the_group_max():
    for kw in (dict(gmax=True, quantized=False), dict(quantized=True)):
        with pytest.raises(ValueError, match="int32 accumulator"):
            cv.conv_w8a8_form(1, 13, 13, 128, 64, 3, 3, raw=True, **kw)


def _conv_case(seed, cin=64, cout=48, h=9):
    g = np.random.default_rng(seed)
    x = torch.from_numpy(_codes((2, h, h, cin), seed))
    w = torch.from_numpy(_codes((3, 3, cin, cout), seed + 1))
    s_w = torch.from_numpy(g.uniform(1e-3, 4e-3, cout).astype(np.float32))
    b = torch.from_numpy(g.normal(0, 0.3, cout).astype(np.float32))
    return x, w, s_w, b


@pytest.mark.parametrize("act", ["leaky", "linear", "relu"])
@pytest.mark.parametrize("s_out", [0.05, 0.013, None])
def test_conv_epilogue_is_both_orders_of_the_unsharded_conv(act, s_out):
    x, w, s_w, b = _conv_case(3)
    acc = cv.conv_acc_plain(x, w)
    want = cv.conv2d_w8a8_plain(x, 0.021, w, s_w, b, act, s_out=s_out)
    assert torch.equal(cv.conv_epilogue(acc, 0.021, s_w, b, act, s_out),
                       want)
    assert torch.equal(cv.conv2d_w8a8(x, 0.021, w, s_w, b, act,
                                      s_out=s_out), want)
    folded = conv2d_w8a8_gemm(x, 0.021, w, s_w, b, act, s_out=s_out)
    assert torch.equal(cv.conv_epilogue(acc, 0.021, s_w, b, act, s_out,
                                        folded=True), folded)


class _Layer:
    stride, padding, act = 1, "SAME", "leaky"


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("tier", ["xla", "auto", "pallas"])
def test_summed_cin_shards_give_the_unsharded_codes(parts, tier):
    """The Cin shards' int32 accumulators add up to the whole's, and the
    row-parallel conv's epilogue on their sum (group None: the sum is
    taken here) rounds as the conv it stands for: the conv order on the
    xla tier, the folded order where the gemm tier takes the conv (at 2x2
    px and K 9*256 ``use_pallas`` says so)."""
    x, w, s_w, b = _conv_case(5, cin=256, cout=32, h=2)
    step = 256 // parts
    accs = [cv.conv2d_w8a8_acc(x[..., i * step:(i + 1) * step],
                               w[:, :, i * step:(i + 1) * step].clone())
            for i in range(parts)]
    assert torch.equal(sum(accs), cv.conv_acc_plain(x, w))

    def rowpar(xx, ww):
        return row_parallel_conv_w8a8(
            xx, {"wq": ww, "s_w": s_w, "b": b}, _Layer, 0.02, 0.04,
            use_pallas_tier=tier != "xla", force_pallas=tier == "pallas")
    want = (cv.conv2d_w8a8(x, 0.02, w, s_w, b, s_out=0.04) if tier == "xla"
            else conv2d_w8a8_gemm(x, 0.02, w, s_w, b, s_out=0.04))
    assert torch.equal(rowpar(x, w), want)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard_map_forward")
    td.write_inputs(str(d))
    for mesh in MESHES:
        outs = td.spawn("forward", mesh[0] * mesh[1], str(d), mesh,
                        timeout=240)
        td.check_ranks(outs, "forward")
    return str(d)


def _heads(h):
    return h if isinstance(h, tuple) else (h,)


@pytest.mark.parametrize("case", FORWARD_CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_shardmap_forward_equals_single_device(runs, mesh, case):
    name, kernel = MODEL_OF[case]
    model = build_model(name, 10 if name == "resnet18" else None)
    params, scales = params_from_numpy(
        *load_checkpoint(f"{runs}/{name}.npz"), device="cpu")
    x = torch.from_numpy(np.load(f"{runs}/images.npy")).float() / 255.0
    want = _heads(model.forward_w8a8(params, scales, x, kernel=kernel))
    for r in range(mesh[0] * mesh[1]):
        got = td.load(td.rank_file(runs, "forward", mesh, case, r))
        assert len(got) == len(want)
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[f"head{i}"], w.numpy(),
                                          err_msg=f"rank {r} head {i}")


@pytest.mark.parametrize("mesh,case", [
    ((1, 2), "v2_xla"), ((2, 1), "v2_xla"), ((2, 2), "v2_xla"),
    ((1, 2), "v3_auto"), ((2, 1), "v3_auto"), ((2, 2), "v3_auto"),
    ((2, 2), "r18_xla")], ids=lambda v: v if isinstance(v, str)
    else f"{v[0]}x{v[1]}")
def test_shardmap_forward_matches_jax(runs, mesh, case, monkeypatch):
    name, kernel = MODEL_OF[case]
    if name == "resnet18":
        # op by op (jax.jit of a function at call time returns it), one
        # mesh (about 20 s on the CPU): jitted, the shortcuts' f32
        # epilogues contract into FMAs, which move codes mid-network
        monkeypatch.setattr(jax, "jit", lambda f=None, **kw: f)
    jm = jbuild(name, **({"num_classes": 10} if name == "resnet18" else {}))
    params, scales = load_checkpoint(f"{runs}/{name}.npz")
    jmesh = JMesh(np.asarray(jax.devices()[:mesh[0] * mesh[1]]).reshape(
        mesh), ("data", "model"))
    fwd = j_shardmap_forward(jm, jmesh, scales, "channel", kernel)
    x = jax.device_put(jnp.asarray(np.load(f"{runs}/images.npy"),
                                   jnp.float32) / 255.0,
                       j_input_sharding(jmesh))
    want = _heads(fwd(j_shard_params(params, jmesh, jm, "channel"), x))
    got = td.load(td.rank_file(runs, "forward", mesh, case, 0))
    for i, w in enumerate(want):
        w = np.asarray(w)
        np.testing.assert_allclose(got[f"head{i}"], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
