"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):

1. identify the card (name and power limit from nvidia-smi, versions);
2. build every CUDA kernel from ``dnn_inference_engine_tpu_torch/csrc``
   (one nvcc per source, in parallel) and print ptxas' registers and
   shared memory;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes its main path gives it (YOLOv2-tiny at batch 32; the per-tap
   stem and the GEMM shapes of YOLOv3-tiny at batch 16; the strategy
   plans S1 and S2 at batch 32 for quant_space_to_depth4,
   gmax_shift_s2d2 and conv3x3_rs), requiring identical results, and
   time kernel, plain version and (for the GEMM and conv3x3_rs)
   ``torch._int_mm``; the per-tap stem is timed beside the k2 stem on
   the same inputs;
4. card against CPU, W8A8 at 416 px from seeded random weights:
   YOLOv2-tiny at batch 2 (the batch-32 plan: all three of its kernels)
   and batch 1 (its own pinned plan), YOLOv3-tiny at batch 2 and batch 1
   (its one pin), and YOLOv2-tiny at batch 2 under the strategy files S1
   and S2. The CPU engine (plain versions) gets the card's weights and
   scales; heads must be identical and detections equal. The card's
   YOLOv2 calibration scales must match a CPU calibration of the same
   weights to a few float32 ulps (no TF32 in the reference conv);
5. drive each main path: YOLOv2-tiny at batch 32 and batch 1, YOLOv3-tiny
   at batch 16 and batch 1, S1 at batch 32 and 1, S2 at batch 32. The
   launch counters, set to 0 just before each detect and read just
   after, must show it ran through its kernels and no others; then
   throughput (forwards and detects back to back), latency (each call
   synced), and the device time and operations per forward by kernel
   from ``torch.profiler``. Before them, the host's wait for one scale
   upload behind a busy card (``upload_wait_ms``);
6. S2's stage 1 (``rs``, no im2col) against the pinned plan's L2 stage
   (``fold_xla``: im2col, GEMM, group-max) on the same b32 entry state;
7. the ported plan sweep (YOLOv2-tiny w8a8, batch 8, every candidate,
   short fixed loop counts): no candidate may crash or fail parity, and
   an engine built from its artifact must have its kinds and run detect.

The lines before the last are the card line, the ``kernels`` JSON line;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

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
    "quant_space_to_depth4": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/quant_space_to_depth4.cu",
        replaces="dnn_inference_engine_tpu/ops/pallas_conv.py:209"),
    "gmax_shift_s2d2": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/gmax_shift_s2d2.cu",
        replaces="dnn_inference_engine_tpu/ops/pallas_conv.py:598"),
    "conv3x3_rs": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/conv3x3_rs.cu",
        replaces="dnn_inference_engine_tpu/ops/pallas_conv.py:928"),
}

# Two strategy plans (YOLOv2-tiny, w8a8) that between them run every new
# kernel and every plan kind the sweep proposes; written as JSON under
# build/ at run time and given to the engine as EngineConfig.strategy.
STRATEGIES = {
    "S1": {0: ["fold_xla_k2", 4, {"cin_pad": 64}], 2: ["fold_xla_s2", 2],
           4: ["fold_xla_k2", 2], 6: ["rs2", 2], 8: ["rs", 2],
           10: ["gemm", 1], 12: ["auto", 1], 13: ["auto", 1],
           14: ["xla", 1]},
    "S2": {0: ["fold_xla", 4, {"cin_pad": 64}], 2: ["rs", 2],
           4: ["rs2", 2], 6: ["auto", 1], 8: ["auto", 1], 10: ["xla", 1],
           12: ["gemm", 1], 13: ["xla", 1], 14: ["gemm", 1]},
}
# conv3x3_rs at the b32 shapes of S1 (L6 rs2, L8 rs) and S2 (L2 rs, L4
# rs2): (tag, x shape, ksize, Cout, pool-major group-max co)
RS_SHAPES = [("S1 L6 rs2", (32, 27, 27, 256), 2, 512, 128),
             ("S1 L8 rs", (32, 13, 13, 512), 3, 1024, 256),
             ("S2 L2 rs", (32, 104, 104, 64), 3, 128, 32),
             ("S2 L4 rs2", (32, 53, 53, 128), 2, 256, 64)]

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


def phase_strategy_kernels(dev, ops_peak, bw):
    """The three kernels of the strategy plans against their plain
    versions at the b32 shapes S1 and S2 give them, timed beside their
    bounds (and, for conv3x3_rs, ``torch._int_mm`` on the im2col'd A)."""
    from dnn_inference_engine_tpu_torch.ops import fused_conv as fc
    from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
        extract_patches)

    g = torch.Generator(device=dev).manual_seed(3)
    rows = {}

    def check(name, got, ref, what):
        err = max_abs_err(got, ref)
        print(f"  {name} {what}: err={err}")
        if err != 0:
            raise AssertionError(f"{name} {what}: kernel != plain")
        return err

    # --- quant_space_to_depth4: the S1 entry reads (32,416,416,3) through
    # a (1,7) zero border, i.e. as (32,424,424,3); the S2 entry reads it
    # as it is ---
    xu = torch.randint(0, 256, (32, 416, 416, 3), generator=g, device=dev,
                       dtype=torch.uint8)
    xf = xu.float() / 255.0
    s_in = 0.0078431377
    border = (1, 7, 1, 7)
    errs = []
    for x, dt in ((xu, "u8"), (xf, "f32")):
        for pad_to in (0, 64):
            for pad_hw, entry in ((border, "k2"), ((0, 0, 0, 0), "k3")):
                kw = dict(pad_to=pad_to, pad_hw=pad_hw)
                errs.append(check(
                    "quant_space_to_depth4",
                    fc.quant_space_to_depth4(x, s_in, **kw),
                    fc.quant_space_to_depth4_plain(x, s_in, **kw),
                    f"{dt} pad_to={pad_to} {entry} entry"))
    x424 = torch.nn.functional.pad(xu, (0, 0, 1, 7, 1, 7))
    errs.append(check("quant_space_to_depth4",
                      fc.quant_space_to_depth4(x424, s_in, pad_to=64),
                      fc.quant_space_to_depth4(xu, s_in, pad_to=64,
                                               pad_hw=border),
                      "(32,424,424,3) u8 vs the border read"))
    out = 32 * 106 * 106 * 64

    def q_ms(x, **kw):
        return device_ms(lambda: fc.quant_space_to_depth4(x, s_in, **kw), 20)
    ms = q_ms(xu, pad_to=64, pad_hw=border)
    plain_ms = device_ms(lambda: fc.quant_space_to_depth4_plain(
        xu, s_in, pad_to=64, pad_hw=border), 3)
    s2_ms = q_ms(xu, pad_to=64)
    f32_ms = q_ms(xf, pad_to=64, pad_hw=border)
    x424_ms = q_ms(x424, pad_to=64)
    rows["quant_space_to_depth4"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
        bound_ms=(xu.numel() + out) / bw * 1e3, bound_by="bytes",
        s2_entry_ms=s2_ms,
        s2_entry_bound_ms=(xu.numel() + 32 * 104 * 104 * 64) / bw * 1e3,
        f32_ms=f32_ms, f32_bound_ms=(4 * xu.numel() + out) / bw * 1e3,
        padded_424_ms=x424_ms,
        padded_424_bound_ms=(x424.numel() + out) / bw * 1e3)
    r = rows["quant_space_to_depth4"]
    print(f"  quant_space_to_depth4 S1 entry (u8, border, 64 lanes) "
          f"ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms="
          f"{r['bound_ms']:.4f}; S2 entry {s2_ms:.4f} (bound "
          f"{r['s2_entry_bound_ms']:.4f}); f32 {f32_ms:.4f} (bound "
          f"{r['f32_bound_ms']:.4f}); padded (32,424,424,3) u8 "
          f"{x424_ms:.4f} (bound {r['padded_424_bound_ms']:.4f})")
    del xu, xf, x424

    # --- gmax_shift_s2d2: the S1 L2 seam, (32,104,104,128), go = 32 ---
    y = torch.randint(-127, 128, (32, 104, 104, 128), generator=g,
                      device=dev, dtype=torch.int8)
    got = fc.gmax_shift_s2d2(y, 32)
    err = check("gmax_shift_s2d2", got, fc.gmax_shift_s2d2_plain(y, 32),
                "(32,104,104,128) go=32")
    rows["gmax_shift_s2d2"] = dict(
        max_abs_err=err, ms=device_ms(lambda: fc.gmax_shift_s2d2(y, 32), 20),
        plain_ms=device_ms(lambda: fc.gmax_shift_s2d2_plain(y, 32), 5),
        library_ms=None, bound_ms=(y.numel() + got.numel()) / bw * 1e3,
        bound_by="bytes")
    r = rows["gmax_shift_s2d2"]
    print(f"  gmax_shift_s2d2 ms={r['ms']:.4f} plain_ms={r['plain_ms']:.3f} "
          f"bound_ms={r['bound_ms']:.4f}")
    del y, got

    # --- conv3x3_rs at the four b32 shapes, then pool None (int8 and f32
    # out) and s2d_out at one shape each ---
    shapes, errs = [], []
    for tag, xs, k, cout, co in RS_SHAPES:
        x = torch.randint(-127, 128, xs, generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, k, xs[3], cout), generator=g,
                          device=dev, dtype=torch.int8)
        scale = torch.rand(cout, generator=g, device=dev) * 2e-5 + 1e-5
        bias = torch.randn(cout, generator=g, device=dev)
        kw = dict(quantize_out=True, pool=("gmaxm", 2, co), ksize=k)
        variants = [(tag, kw)]
        if tag == "S1 L8 rs":
            variants += [(tag + " pool None int8", dict(kw, pool=None)),
                         (tag + " pool None f32",
                          dict(kw, pool=None, quantize_out=False))]
        if tag == "S2 L2 rs":
            variants.append((tag + " s2d_out", dict(kw, s2d_out=True)))
        for name, vkw in variants:
            errs.append(check("conv3x3_rs",
                              fc.conv3x3_rs(x, w, scale, bias, **vkw),
                              fc.conv3x3_rs_plain(x, w, scale, bias, **vkw),
                              name))
        n, h, wd, cin = xs
        ho, wo = (h, wd) if k == 3 else (h - 1, wd - 1)
        m = n * ho * wo
        a = extract_patches(x, k, k, 1, "SAME" if k == 3 else "VALID")
        a = a.reshape(m, k * k * cin)
        wt = fc.rs_weight_matrix(w)
        bound, by = _bound(2.0 * m * a.shape[1] * cout,
                           x.numel() + w.numel() + 8 * cout + m * cout // 4,
                           ops_peak, bw)
        row = dict(shape=tag, M=m, K=a.shape[1], N=cout,
                   ms=device_ms(lambda: fc.conv3x3_rs(x, w, scale, bias,
                                                      **kw), 10),
                   plain_ms=device_ms(lambda: fc.conv3x3_rs_plain(
                       x, w, scale, bias, **kw), 2),
                   library_ms=device_ms(lambda: torch._int_mm(a, wt.t()),
                                        10),
                   bound_ms=bound, bound_by=by)
        shapes.append(row)
        print(f"  conv3x3_rs {tag} M={m} K={a.shape[1]} N={cout}: "
              f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.3f} "
              f"int_mm_ms={row['library_ms']:.4f} bound_ms={bound:.4f} "
              f"({by})")
        del x, w, a, wt
    s1 = [r for r in shapes if r["shape"].startswith("S1")]
    rows["conv3x3_rs"] = dict(
        max_abs_err=max(errs), ms=sum(r["ms"] for r in s1),
        plain_ms=sum(r["plain_ms"] for r in s1),
        library_ms=sum(r["library_ms"] for r in s1),
        bound_ms=sum(r["bound_ms"] for r in s1),
        bound_by=("operations" if all(r["bound_by"] == "operations"
                                      for r in s1) else "bytes"),
        shapes=shapes)
    print(f"  conv3x3_rs sums over S1's 2 launches: "
          f"ms={rows['conv3x3_rs']['ms']:.4f} "
          f"bound_ms={rows['conv3x3_rs']['bound_ms']:.4f}")
    return rows


def _counters():
    from dnn_inference_engine_tpu_torch.ops import fused_conv as fc
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    return {"gemm_fused": gm.gemm_fused, "stem_fused_k2": fc.stem_fused_k2,
            "shift_s2d2": fc.shift_s2d2, "stem_fused_dg": fc.stem_fused_dg,
            "quant_space_to_depth4": fc.quant_space_to_depth4,
            "gmax_shift_s2d2": fc.gmax_shift_s2d2,
            "conv3x3_rs": fc.conv3x3_rs}


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


def strategies_dir() -> Path:
    """build/strategies/ at the root of the checkout (gitignored)."""
    path = Path(__file__).resolve().parent / "build" / "strategies"
    path.mkdir(parents=True, exist_ok=True)
    return path


def strategy_file(name: str) -> str:
    """STRATEGIES[name] written as a strategy JSON under build/."""
    path = strategies_dir() / f"{name}.json"
    path.write_text(json.dumps({"strategy": STRATEGIES[name]}))
    return str(path)


def phase_card_vs_cpu(model: str, batch: int, check_calibration: bool,
                      strategy=None):
    """416 px: the card engine against a CPU engine (plain versions) with
    the card's weights and scales; under the pinned plan, or under
    STRATEGIES[strategy]."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine

    # serving threshold and capped NMS pool; room for every survivor
    # (YOLOv3's sigmoid class scores keep up to 20 classes x 256 of them)
    cfg = EngineConfig(model=model, batch=batch,
                       max_detections=MAX_DET_CHECKED[model],
                       strategy=strategy and strategy_file(strategy))
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
    print(f"card vs CPU {model} {strategy or 'pin'} @416 b{batch} "
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


# (group, substring of the kernel's name); first match wins, so
# gmax_shift_s2d2 comes before shift_s2d2
KERNEL_GROUPS = (("gemm_fused", "gemm_fused_kernel"),
                 ("stem_fused_k2", "stem_kernel"),
                 ("stem_fused_dg", "stem_dg_kernel"),
                 ("quant_space_to_depth4", "qs2d4_kernel"),
                 ("gmax_shift_s2d2", "gmax_shift_s2d2_kernel"),
                 ("conv3x3_rs", "conv_rs_kernel"),
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


def phase_main_path(model: str, batch: int, want: dict, card: str,
                    strategy=None):
    """Build the engine (pinned plan, or STRATEGIES[strategy]), drive
    detect once with the launch counters set to 0 just before and read
    just after (they must equal ``want``, every counter named), then time
    it and break its device time down."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine

    want = {**dict.fromkeys(_counters(), 0), **want}
    eng = Engine(EngineConfig(
        model=model, batch=batch,
        strategy=strategy and strategy_file(strategy))).load_weights(
        seed=0).prepare()
    imgs = np.random.default_rng(2).integers(
        0, 256, (batch, 416, 416, 3)).astype(np.uint8)
    x = torch.as_tensor(imgs).cuda()
    _reset_counts()
    b, s, c = eng.detect(imgs)
    torch.cuda.synchronize()
    counts = _read_counts()
    tag = f"{model} {strategy or 'pin'} b{batch}"
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
    print(f"{tag} launches per detect {counts} [{card}]")
    print(f"{tag} device ms per forward (torch.profiler, 5 forwards): "
          + ", ".join(f"{g} {v:.4f}" for g, v in groups.items())
          + f"; busy {busy:.4f} = {busy / t['fwd_tp']:.2f} of the "
          f"back-to-back forward [{card}]")
    print(f"{tag} device operations per forward: "
          + ", ".join(f"{g} {n:g}" for g, n in ops.items())
          + f"; total {sum(ops.values()):g} [{card}]")
    print(f"{tag} back to back: forward {t['fwd_tp']:.3f} ms = "
          f"{batch * 1e3 / t['fwd_tp']:.1f} img/s, detect {t['det_tp']:.3f} "
          f"ms = {batch * 1e3 / t['det_tp']:.1f} img/s; latency (median of "
          f"20, synced): forward {t['fwd_lat']:.3f} ms, detect "
          f"{t['det_lat']:.3f} ms [{card}]")
    return counts


def phase_stage_compare(card: str):
    """S2's stage 1 (L2 as ``rs``: conv3x3_rs reads the fold-2 tensor, no
    im2col) against the pinned plan's L2 stage (``fold_xla``: im2col
    ``torch.cat``, gemm_fused, group-max) on the same b32 entry state:
    device busy time per stage call (``torch.profiler``) and its time
    between CUDA events (host launch gaps and scale uploads included)."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    from dnn_inference_engine_tpu_torch.runtime.plan import (
        _run_stage, build_plan, plan_forward_w8a8, prepare_plan_params)

    eng = Engine(EngineConfig(batch=32, strategy=strategy_file(
        "S2"))).load_weights(seed=0).prepare()
    x = torch.as_tensor(np.random.default_rng(2).integers(
        0, 256, (32, 416, 416, 3)).astype(np.uint8)).cuda()
    states = []
    plan_forward_w8a8(eng.model, eng._plan, eng._plan_params,
                      eng.act_scales, x, record_states=states)
    xs, cs, cf, _ = states[1]
    pin = build_plan(eng.model, batch=32)
    pin_pp = prepare_plan_params(eng.model, eng.params, pin)
    stages = {"S2 stage 1 (rs)": (eng._plan[1], eng._plan_params[1]),
              "pin stage 1 (fold_xla)": (pin[1], pin_pp[1])}
    for tag, (st, pp) in stages.items():
        if st.conv_li != 2 or st.fold != 2:
            raise AssertionError(f"{tag}: not the L2 fold-2 stage: {st}")

        def fn(st=st, pp=pp):
            return _run_stage(eng.model.layers, st, pp, xs, cs, cf,
                              eng.act_scales)
        groups, _ = device_breakdown(fn, reps=10)
        busy = sum(groups.values())
        print(f"{tag} at b32, entry (32,104,104,64) fold 2: device busy "
              f"{busy:.4f} ms per call ("
              + ", ".join(f"{g} {v:.4f}" for g, v in groups.items() if v)
              + f"); between events {latency_ms(fn, 20):.4f} ms [{card}]")


def phase_sweep(card: str):
    """The ported plan sweep at 416 px, batch 8, every candidate
    (quick=False) with short fixed loop counts: no candidate may crash
    or fail parity, and an engine built from the artifact must run its
    kinds stage by stage."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    from dnn_inference_engine_tpu_torch.runtime.plan_sweep import (
        load_strategy, sweep)

    t0 = time.time()
    art = sweep("yolov2-tiny", "w8a8", batch=8, quick=False,
                auto_iters=False, iters=(6, 2), reps=1, verbose=False)
    wall = time.time() - t0
    bad = {f"L{li} {c}": v for li, row in art["measurements"].items()
           for c, v in row.items() if isinstance(v, str)}
    if bad or art["crashed_candidates"]:
        raise AssertionError(f"sweep recorded failures: {bad}")
    n = sum(len(row) for row in art["measurements"].values())
    path = strategies_dir() / "sweep.json"
    path.write_text(json.dumps(art))
    eng = Engine(EngineConfig(batch=8, strategy=str(path))).load_weights(
        seed=0).prepare()
    by_li = {st.conv_li: st.kind for st in eng._plan}
    for li, entry in load_strategy(str(path)).items():
        if by_li[li] != {"rs2": "rs"}.get(entry[0], entry[0]):
            raise AssertionError(f"engine L{li} {by_li[li]} != artifact "
                                 f"{entry}")
    imgs = np.random.default_rng(3).integers(
        0, 256, (8, 416, 416, 3)).astype(np.uint8)
    b, _, _ = eng.detect(imgs)
    if b.shape != (8, 128, 4) or not np.isfinite(b).all():
        raise AssertionError(f"sweep engine: bad detections {b.shape}")
    print(f"sweep yolov2-tiny w8a8 b8 @416 (quick=False, iters (6, 2), 1 "
          f"rep): {n} entries over {art['passes']} passes, 0 crashed, 0 "
          f"parity rejections; strategy {json.dumps(art['strategy'])}; "
          f"whole_net_ms {art['whole_net_ms']}; wall {wall:.1f} s; its "
          f"engine's detect ran [{card}]")


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
    times = {}

    def timed(name, fn, *a, **kw):
        t = time.time()
        out = fn(*a, **kw)
        times[name] = time.time() - t
        print(f"[phase {name}: {times[name]:.1f} s]")
        return out

    timed("build", phase_build)
    rows = timed("kernels", phase_kernels, torch.device("cuda"), ops_peak,
                 bw)
    torch.cuda.empty_cache()
    rows.update(timed("strategy kernels", phase_strategy_kernels,
                      torch.device("cuda"), ops_peak, bw))
    torch.cuda.empty_cache()

    def card_vs_cpu():
        phase_card_vs_cpu("yolov2-tiny", 2, check_calibration=True)
        phase_card_vs_cpu("yolov2-tiny", 1, check_calibration=False)
        phase_card_vs_cpu("yolov3-tiny", 2, check_calibration=False)
        phase_card_vs_cpu("yolov3-tiny", 1, check_calibration=False)
        for name in STRATEGIES:
            phase_card_vs_cpu("yolov2-tiny", 2, False, strategy=name)
    timed("card vs CPU", card_vs_cpu)
    print(f"host wait of one scale upload behind a busy card: "
          f"{upload_wait_ms():.3f} ms")
    v2 = dict(gemm_fused=8, stem_fused_k2=1)
    v3 = dict(gemm_fused=12, stem_fused_dg=1, shift_s2d2=1)
    s1 = dict(gemm_fused=7, quant_space_to_depth4=1, gmax_shift_s2d2=1,
              conv3x3_rs=2)
    s2 = dict(gemm_fused=7, quant_space_to_depth4=1, conv3x3_rs=2)

    def main_paths():
        counts = {
            "yolov2-tiny": phase_main_path("yolov2-tiny", 32,
                                           dict(v2, shift_s2d2=1), card),
            "yolov3-tiny": phase_main_path("yolov3-tiny", 16, v3, card),
        }
        phase_main_path("yolov2-tiny", 1, v2, card)
        phase_main_path("yolov3-tiny", 1, v3, card)
        counts["S1"] = phase_main_path("yolov2-tiny", 32, s1, card, "S1")
        phase_main_path("yolov2-tiny", 1, s1, card, "S1")
        phase_main_path("yolov2-tiny", 32, s2, card, "S2")
        return counts
    counts = timed("main paths", main_paths)
    timed("stage compare", phase_stage_compare, card)
    timed("sweep", phase_sweep, card)
    print(f"total {time.time() - t0:.1f} s (phases: "
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items()) + ")")

    # each kernel's launches from the main path that runs it: the YOLOv2
    # b32 detect, the YOLOv3 b16 detect for the per-tap stem, and the S1
    # b32 detect for the strategy plans' kernels
    path_of = {"stem_fused_dg": "yolov3-tiny", "quant_space_to_depth4": "S1",
               "gmax_shift_s2d2": "S1", "conv3x3_rs": "S1"}
    kernels = []
    for kname, meta in KERNELS.items():
        path = path_of.get(kname, "yolov2-tiny")
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
