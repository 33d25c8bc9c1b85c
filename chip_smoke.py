"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):

1. identify the card (name and power limit from nvidia-smi, versions);
2. build every CUDA kernel from ``dnn_inference_engine_tpu_torch/csrc``
   (one nvcc per source, in parallel) and print ptxas' registers and
   shared memory;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes its main path gives it (YOLOv2-tiny at batch 32; the per-tap
   stem and the GEMM shapes of YOLOv3-tiny at batch 16), requiring
   identical results, and time kernel, plain version and (for the GEMM)
   ``torch._int_mm``; the per-tap stem is timed beside the k2 stem on the
   same inputs;
4. card against CPU, W8A8 at 416 px from seeded random weights:
   YOLOv2-tiny at batch 2 (the batch-32 plan: all three of its kernels)
   and batch 1 (its own pinned plan), YOLOv3-tiny at batch 2 and batch 1
   (its one pin). The CPU engine (plain versions) gets the card's weights
   and scales; heads must be identical and detections equal. The card's
   YOLOv2 calibration scales must match a CPU calibration of the same
   weights to a few float32 ulps (no TF32 in the reference conv);
5. drive each main path: YOLOv2-tiny at batch 32 and batch 1, YOLOv3-tiny
   at batch 16 and batch 1. The launch counters, set to 0 just before
   each detect and read just after, must show it ran through its
   kernels; then throughput (forwards and detects back to back), latency
   (each call synced), and the device time and operations per forward by
   kernel from ``torch.profiler``. Before them, the host's wait for one
   scale upload behind a busy card (``upload_wait_ms``).

The lines before the last are the card line, the ``kernels`` JSON line;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = {
    "gemm_fused": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/gemm_fused.cu",
        replaces="dnn_inference_engine_tpu/ops/pallas_gemm.py:112"),
    "stem_fused_k2": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/stem_fused_k2.cu",
        replaces="dnn_inference_engine_tpu/ops/pallas_conv.py:339"),
    "shift_s2d2": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/shift_s2d2.cu",
        replaces="dnn_inference_engine_tpu/ops/pallas_conv.py:477"),
    "stem_fused_dg": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/stem_fused_dg.cu",
        replaces="dnn_inference_engine_tpu/ops/pallas_conv.py:722"),
}

# (layer, M, K, N) of every GEMM of one batch-32 forward at 416 px
B32_GEMMS = [("L2", 346112, 576, 128), ("L4", 86528, 512, 256),
             ("L6", 86528, 576, 128), ("L8", 21632, 1152, 256),
             ("L10", 5408, 2304, 512), ("L12", 5408, 4608, 1024),
             ("L13", 5408, 9216, 1024), ("L14", 5408, 1024, 125)]
# ... and of one YOLOv3-tiny batch-16 forward (L15, L21: the f32 heads)
B16_V3_GEMMS = [("L2", 173056, 576, 128), ("L4", 43264, 512, 256),
                ("L6", 43264, 576, 128), ("L8", 10816, 1152, 256),
                ("L10", 2704, 2304, 512), ("L12", 2704, 4608, 1024),
                ("L13", 2704, 1024, 256), ("L14", 2704, 2304, 512),
                ("L15", 2704, 512, 75), ("L17", 2704, 256, 128),
                ("L20", 10816, 3456, 256), ("L21", 10816, 256, 75)]
HEADS = {"yolov2-tiny": {"L14"}, "yolov3-tiny": {"L15", "L21"}}


def peaks(name: str):
    """(dense int8 ops/s, HBM bytes/s) from NVIDIA's data sheets for the
    H100 variant the card's name gives."""
    if "PCIe" in name:
        return 1513e12, 2.0e12
    if "NVL" in name:
        return 1671e12, 3.9e12
    return 1979e12, 3.35e12          # SXM


def device_ms(fn, reps: int) -> float:
    """Median device time of ``reps`` calls after one warm-up: a spin
    kernel holds the card while the host queues every call, each between
    its own pair of CUDA events, so the host's launch work is hidden."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)        # ~25-30 ms of clock cycles
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def throughput_ms(fn, reps: int) -> float:
    """Time per call of ``reps`` calls run back to back between one pair
    of CUDA events, from an idle card to the last result (host gaps and
    stalls included): what a stream of batches gets."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def latency_ms(fn, reps: int) -> float:
    """Median of ``reps`` calls, each from an idle card to its result,
    between its own pair of CUDA events and synced before the next: what
    one request waits."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    return float((a.double() - b.double()).abs().max())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from dnn_inference_engine_tpu_torch.ops import _build
    t0 = time.time()
    reports = _build.build_all(force=True)
    print(f"build: {len(reports)} kernels in {time.time() - t0:.1f} s")
    for name, rep in reports.items():
        for line in (rep or "").splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")


def _bound(ops: float, nbytes: float, ops_peak: float, bw: float):
    """(bound ms, what binds) for work of ``ops`` int8 operations moving
    ``nbytes`` bytes."""
    by = "operations" if ops / ops_peak >= nbytes / bw else "bytes"
    return max(ops / ops_peak, nbytes / bw) * 1e3, by


def gemm_shapes(g, dev, table, heads, ops_peak, bw, tag):
    """gemm_fused against its plain version at each (layer, M, K, N) of
    ``table``, timed beside ``torch._int_mm``: conv-order int8 epilogue,
    f32 for the ``heads``."""
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    shapes = []
    for layer, m, k, n in table:
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                           dtype=torch.int8)
        scale = torch.rand(n, generator=g, device=dev) * 2e-5 + 1e-5
        bias = torch.randn(n, generator=g, device=dev) * 0.1
        head = layer in heads
        kw = (dict(act="linear") if head
              else dict(act="leaky", s_out=0.05))
        got = gm.gemm_fused(a, bt, scale, bias, **kw)
        ref = gm.gemm_fused_plain(a, bt, scale, bias, **kw)
        err = max_abs_err(got, ref)
        ms = device_ms(lambda: gm.gemm_fused(a, bt, scale, bias, **kw),
                       10)
        plain_ms = device_ms(
            lambda: gm.gemm_fused_plain(a, bt, scale, bias, **kw), 2)
        # the int8 product alone; for N not a multiple of 8 on B padded
        # to the next one, the nearest shape torch._int_mm takes
        bl = bt if n % 8 == 0 else torch.cat(
            [bt, bt.new_zeros(8 - n % 8, k)])
        lib_ms = device_ms(lambda: torch._int_mm(a, bl.t()), 10)
        bound, by = _bound(2.0 * m * k * n,
                           m * k + n * k + 8 * n + m * n * (4 if head else 1),
                           ops_peak, bw)
        shapes.append(dict(layer=layer, M=m, K=k, N=n, max_abs_err=err,
                           ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound, bound_by=by))
        print(f"  gemm_fused {tag} {layer} M={m} K={k} N={n}: err={err} "
              f"ms={ms:.4f} plain_ms={plain_ms:.3f} int_mm_ms={lib_ms:.4f} "
              f"bound_ms={bound:.4f} ({by})")
        if err != 0:
            raise AssertionError(f"gemm_fused {tag} {layer}: kernel != plain")
        del a, bt, ref, got
    return shapes


def phase_kernels(dev, ops_peak, bw):
    """Each kernel against its plain version at its main path's shapes."""
    from dnn_inference_engine_tpu_torch.ops import fused_conv as fc

    g = torch.Generator(device=dev).manual_seed(0)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    rows = {}
    # --- gemm_fused: one YOLOv2 b32 forward's 8 launches make the row
    # (sums; bound by what binds most); YOLOv3's b16 shapes beside it ---
    shapes = gemm_shapes(g, dev, B32_GEMMS, HEADS["yolov2-tiny"], ops_peak,
                         bw, "v2-b32")
    v3_shapes = gemm_shapes(g, dev, B16_V3_GEMMS, HEADS["yolov3-tiny"],
                            ops_peak, bw, "v3-b16")
    by_ops = sum(s["bound_ms"] for s in shapes
                 if s["bound_by"] == "operations")
    rows["gemm_fused"] = dict(
        max_abs_err=max(s["max_abs_err"] for s in shapes + v3_shapes),
        ms=sum(s["ms"] for s in shapes),
        plain_ms=sum(s["plain_ms"] for s in shapes),
        bound_ms=sum(s["bound_ms"] for s in shapes),
        bound_by=("operations" if 2 * by_ops >= sum(s["bound_ms"]
                                                    for s in shapes)
                  else "bytes"),
        library_ms=sum(s["library_ms"] for s in shapes), shapes=shapes,
        v3_b16_shapes=v3_shapes,
        v3_b16_ms=sum(s["ms"] for s in v3_shapes))
    print(f"  gemm_fused sums: v2 b32 {rows['gemm_fused']['ms']:.4f} ms, "
          f"v3 b16 {rows['gemm_fused']['v3_b16_ms']:.4f} ms")

    # --- stem_fused_k2 on (32,416,416,3), uint8 exact and f32 ---
    wq = i8(2, 2, 64, 256)
    wq[:, :, 48:] = 0
    scale = torch.rand(256, generator=g, device=dev) * 1e-3 + 1e-3
    bias = torch.randn(256, generator=g, device=dev)
    xu = torch.randint(0, 256, (32, 416, 416, 3), generator=g, device=dev,
                       dtype=torch.uint8)
    xf = xu.float() / 255.0
    errs = []
    for x, kw in ((xu, dict(exact_u8=True)), (xf, {})):
        got = fc.stem_fused_k2(x, wq, scale, bias, 0.00787, **kw)
        ref = fc.stem_fused_k2_plain(x, wq, scale, bias, 0.00787, **kw)
        errs.append(max_abs_err(got, ref))
    print(f"  stem_fused_k2 exact-u8 err={errs[0]} f32 err={errs[1]}")
    if max(errs) != 0:
        raise AssertionError("stem_fused_k2: kernel != plain")
    ms = device_ms(lambda: fc.stem_fused_k2(xu, wq, scale, bias, 0.00787,
                                            exact_u8=True), 20)
    plain_ms = device_ms(lambda: fc.stem_fused_k2_plain(
        xu, wq, scale, bias, 0.00787, exact_u8=True), 2)
    m = 32 * 104 * 104
    bound, by = _bound(2.0 * m * 192 * 256,      # the 48 real lanes of 4 taps
                       xu.numel() + wq.numel() + 2 * 64 * 4 + m * 64,
                       ops_peak, bw)
    rows["stem_fused_k2"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
        bound_ms=bound, bound_by=by)
    del xu, xf

    # --- stem_fused_dg on (16,416,416,3), uint8 exact and f32, with
    # w (2,2,48,256) and (2,2,64,256) (the kernel drops rows 48..) ---
    w48 = i8(2, 2, 48, 256)
    w64 = torch.cat([w48, i8(2, 2, 16, 256)], dim=2)
    xu = torch.randint(0, 256, (16, 416, 416, 3), generator=g, device=dev,
                       dtype=torch.uint8)
    xf = xu.float() / 255.0
    errs = []
    for w in (w48, w64):
        for x, kw in ((xu, dict(exact_u8=True)), (xf, {})):
            got = fc.stem_fused_dg(x, w, scale, bias, 0.00787, **kw)
            ref = fc.stem_fused_dg_plain(x, w, scale, bias, 0.00787, **kw)
            errs.append(max_abs_err(got, ref))
    print(f"  stem_fused_dg (w48, w64) x (exact-u8, f32) errs={errs}")
    if max(errs) != 0:
        raise AssertionError("stem_fused_dg: kernel != plain")
    ms = device_ms(lambda: fc.stem_fused_dg(xu, w48, scale, bias, 0.00787,
                                            exact_u8=True), 20)
    plain_ms = device_ms(lambda: fc.stem_fused_dg_plain(
        xu, w48, scale, bias, 0.00787, exact_u8=True), 2)
    k2_ms = device_ms(lambda: fc.stem_fused_k2(xu, w48, scale, bias, 0.00787,
                                               exact_u8=True), 20)
    x1 = xu[:1].clone()
    b1_ms = device_ms(lambda: fc.stem_fused_dg(x1, w48, scale, bias,
                                               0.00787, exact_u8=True), 50)
    b1_k2_ms = device_ms(lambda: fc.stem_fused_k2(x1, w48, scale, bias,
                                                  0.00787, exact_u8=True), 50)
    m = 16 * 104 * 104
    bound, by = _bound(2.0 * m * 192 * 256,
                       xu.numel() + w48.numel() + 2 * 64 * 4 + m * 64,
                       ops_peak, bw)
    rows["stem_fused_dg"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
        bound_ms=bound, bound_by=by, k2_ms=k2_ms, b1_ms=b1_ms,
        b1_k2_ms=b1_k2_ms)
    print(f"  stem at v3 shapes, exact-u8: b16 dg {ms:.4f} ms vs k2 "
          f"{k2_ms:.4f} ms; b1 dg {b1_ms:.4f} ms vs k2 {b1_k2_ms:.4f} ms")
    del xu, xf, x1

    # --- shift_s2d2 on (32,104,104,32) ---
    x = i8(32, 104, 104, 32)
    got = fc.shift_s2d2(x)
    err = max_abs_err(got, fc.shift_s2d2_plain(x))
    if err != 0:
        raise AssertionError("shift_s2d2: kernel != plain")
    ms = device_ms(lambda: fc.shift_s2d2(x), 50)
    plain_ms = device_ms(lambda: fc.shift_s2d2_plain(x), 10)
    rows["shift_s2d2"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              library_ms=None,
                              bound_ms=(x.numel() + got.numel()) / bw * 1e3,
                              bound_by="bytes")
    for name in ("stem_fused_k2", "stem_fused_dg", "shift_s2d2"):
        r = rows[name]
        print(f"  {name}: err={r['max_abs_err']} ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']})")
    return rows


def _counters():
    from dnn_inference_engine_tpu_torch.ops import fused_conv as fc
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    return {"gemm_fused": gm.gemm_fused, "stem_fused_k2": fc.stem_fused_k2,
            "shift_s2d2": fc.shift_s2d2, "stem_fused_dg": fc.stem_fused_dg}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {k: fn.launches for k, fn in _counters().items()}


def _heads(h):
    return h if isinstance(h, tuple) else (h,)


MAX_DET_CHECKED = {"yolov2-tiny": 1024, "yolov3-tiny": 20 * 256}
# head shapes at 416 px, per image
HEAD_SHAPES = {"yolov2-tiny": [(13, 13, 125)],
               "yolov3-tiny": [(13, 13, 75), (26, 26, 75)]}


def phase_card_vs_cpu(model: str, batch: int, check_calibration: bool):
    """416 px: the card engine against a CPU engine (plain versions) with
    the card's weights and scales."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine

    # serving threshold and capped NMS pool; room for every survivor
    # (YOLOv3's sigmoid class scores keep up to 20 classes x 256 of them)
    cfg = EngineConfig(model=model, batch=batch,
                       max_detections=MAX_DET_CHECKED[model])
    gpu = Engine(cfg).load_weights(seed=0).prepare()
    fp32 = [{k: v.cpu().numpy() for k, v in p.items()}
            for p in gpu.fp32_params]
    cpu = Engine(cfg, device="cpu").load_weights(
        params=fp32, act_scales=gpu.act_scales).prepare()
    imgs = np.random.default_rng(1).integers(
        0, 256, (batch, 416, 416, 3)).astype(np.uint8)
    hg, hc = _heads(gpu.classify(imgs)), _heads(cpu.classify(imgs))
    want = [(batch,) + s for s in HEAD_SHAPES[model]]
    if ([h.shape for h in hg] != want
            or not all(np.isfinite(h).all() for h in hg)):
        raise AssertionError(f"bad heads {[h.shape for h in hg]}")
    for i, (a, b) in enumerate(zip(hg, hc)):
        if not np.array_equal(a, b):
            raise AssertionError(f"{model} b{batch} card head {i} != CPU "
                                 f"head: max diff {np.abs(a - b).max()}")
    bg, sg, cg = gpu.detect(imgs)
    bc, sc, cc = cpu.detect(imgs)
    ng, nc = (sg > 0).sum(axis=1), (sc > 0).sum(axis=1)
    if not (np.array_equal(ng, nc) and np.array_equal(cg, cc)
            and np.abs(bg - bc).max() <= 1e-3):
        raise AssertionError(f"{model} b{batch} detections differ: "
                             f"survivors {ng} vs {nc}, box diff "
                             f"{np.abs(bg - bc).max()}")
    print(f"card vs CPU {model} @416 b{batch} "
          f"({[st.kind for st in gpu._plan]}): {len(hg)} heads identical, "
          f"survivors {ng.tolist()}, box max diff "
          f"{float(np.abs(bg - bc).max())}")
    if check_calibration:
        # the same noise batch, calibrated on the CPU
        ref = Engine(cfg, device="cpu").load_weights(params=fp32).prepare()
        rel = np.abs(np.array(gpu.act_scales) / np.array(ref.act_scales) - 1)
        eps = float(np.finfo(np.float32).eps)
        print(f"calibration card vs CPU: max relative diff {rel.max()} "
              f"({rel.max() / eps:.1f} float32 eps)")
        if rel.max() > 32 * eps:
            raise AssertionError("card calibration != CPU calibration")


KERNEL_GROUPS = (("gemm_fused", "gemm_fused_kernel"),
                 ("stem_fused_k2", "stem_kernel"),
                 ("stem_fused_dg", "stem_dg_kernel"),
                 ("shift_s2d2", "shift_s2d2_kernel"),
                 ("im2col and route torch.cat", "CatArrayBatchedCopy"),
                 ("host-to-device copies", "Memcpy HtoD"))


def device_breakdown(fn, reps: int = 5):
    """Device time and device operations per call by kernel group, from
    ``torch.profiler`` over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = [g for g, _ in KERNEL_GROUPS] + ["other"]
    groups, ops = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        group = next((g for g, key in KERNEL_GROUPS if key in ev.key),
                     "other")
        groups[group] += us / 1e3 / reps
        ops[group] += ev.count / reps   # a fraction: the trace lost events
    return groups, ops


def upload_wait_ms() -> float:
    """Host time of one float32 scale upload from a Python float (as the
    plan's stages make them) queued behind ~25-30 ms of device work: near
    0 if the upload is asynchronous, near the queued work if the host
    waits for the card."""
    from dnn_inference_engine_tpu_torch.quant.quantize import f32_scalar
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    f32_scalar(0.05, torch.device("cuda"))
    wait = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wait * 1e3


def phase_main_path(model: str, batch: int, want: dict, card: str):
    """Build the engine, drive detect once with the launch counters set to
    0 just before and read just after (they must equal ``want``), then
    time it and break its device time down."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine

    eng = Engine(EngineConfig(model=model, batch=batch)).load_weights(
        seed=0).prepare()
    imgs = np.random.default_rng(2).integers(
        0, 256, (batch, 416, 416, 3)).astype(np.uint8)
    x = torch.as_tensor(imgs).cuda()
    _reset_counts()
    b, s, c = eng.detect(imgs)
    torch.cuda.synchronize()
    counts = _read_counts()
    tag = f"{model} b{batch}"
    if b.shape != (batch, 128, 4) or not np.isfinite(b).all():
        raise AssertionError(f"{tag}: bad detections {b.shape}")
    if counts != want:
        raise AssertionError(f"{tag} launches {counts} != {want}")
    run = eng.detect_fn()

    def fwd():
        return eng._fwd(x)

    def det():
        return run(x)

    t = dict(fwd_tp=throughput_ms(fwd, 20), det_tp=throughput_ms(det, 20),
             fwd_lat=latency_ms(fwd, 20), det_lat=latency_ms(det, 20))
    groups, ops = device_breakdown(fwd)
    busy = sum(groups.values())
    print(f"{tag} launches per detect {counts}")
    print(f"{tag} device ms per forward (torch.profiler, 5 forwards): "
          + ", ".join(f"{g} {v:.4f}" for g, v in groups.items())
          + f"; busy {busy:.4f} = {busy / t['fwd_tp']:.2f} of the "
          f"back-to-back forward")
    print(f"{tag} device operations per forward: "
          + ", ".join(f"{g} {n:g}" for g, n in ops.items())
          + f"; total {sum(ops.values()):g}")
    print(f"{tag} back to back: forward {t['fwd_tp']:.3f} ms = "
          f"{batch * 1e3 / t['fwd_tp']:.1f} img/s, detect {t['det_tp']:.3f} "
          f"ms = {batch * 1e3 / t['det_tp']:.1f} img/s; latency (median of "
          f"20, synced): forward {t['fwd_lat']:.3f} ms, detect "
          f"{t['det_lat']:.3f} ms [{card}]")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import dnn_inference_engine_tpu_torch  # noqa: F401  (fails outside the repo)

    card = card_line()
    name = torch.cuda.get_device_name(0)
    ops_peak, bw = peaks(name)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"peaks used for bounds: {ops_peak / 1e12:.0f} int8 TOP/s, "
          f"{bw / 1e12:.2f} TB/s")
    t0 = time.time()
    phase_build()
    rows = phase_kernels(torch.device("cuda"), ops_peak, bw)
    torch.cuda.empty_cache()
    phase_card_vs_cpu("yolov2-tiny", 2, check_calibration=True)
    phase_card_vs_cpu("yolov2-tiny", 1, check_calibration=False)
    phase_card_vs_cpu("yolov3-tiny", 2, check_calibration=False)
    phase_card_vs_cpu("yolov3-tiny", 1, check_calibration=False)
    print(f"host wait of one scale upload behind a busy card: "
          f"{upload_wait_ms():.3f} ms")
    v2 = dict(gemm_fused=8, stem_fused_k2=1, stem_fused_dg=0)
    v3 = dict(gemm_fused=12, stem_fused_k2=0, stem_fused_dg=1, shift_s2d2=1)
    counts = {
        "yolov2-tiny": phase_main_path("yolov2-tiny", 32,
                                       dict(v2, shift_s2d2=1), card),
        "yolov3-tiny": phase_main_path("yolov3-tiny", 16, v3, card),
    }
    phase_main_path("yolov2-tiny", 1, dict(v2, shift_s2d2=0), card)
    phase_main_path("yolov3-tiny", 1, v3, card)
    print(f"total {time.time() - t0:.1f} s")

    # each kernel's launches from the main path that runs it: the YOLOv2
    # b32 detect, and the YOLOv3 b16 detect for the per-tap stem
    kernels = []
    for kname, meta in KERNELS.items():
        path = "yolov3-tiny" if kname == "stem_fused_dg" else "yolov2-tiny"
        row = dict(name=kname, **meta, launches=counts[path][kname])
        row.update(rows[kname])
        kernels.append(row)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
