"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --qs2d4-ab DIR   # quant_space_to_depth4 against
                                          # the checkout in DIR, in turns
    python3 chip_smoke.py --rows-ab DIR    # conv_w8a8_rows the same way
    python3 chip_smoke.py --rows-sweep     # conv_w8a8_rows under every
                                          # unit size and 1-3 blocks an SM
    python3 chip_smoke.py --front-door    # phase 10 alone
    python3 chip_smoke.py --resnet18      # phase 11 alone
    python3 chip_smoke.py --profiling     # phase 12 alone
    python3 chip_smoke.py --multi-device  # phase 13 alone
    python3 chip_smoke.py --bench         # phase 14 alone (with the two
                                          # phase 12 figures it is held to)

Phases (each raises on failure, and the script then exits non-zero):

1. identify the card (name and power limit from nvidia-smi, versions);
2. build every CUDA kernel from ``dnn_inference_engine_tpu_torch/csrc``
   (one nvcc per source, in parallel) and print ptxas' registers and
   shared memory;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes its main path gives it (YOLOv2-tiny at batch 32 and, for the
   GEMM (the 1x1 convs) and the W8A8 conv, batch 1; the per-tap stem, the
   GEMM and the W8A8 conv shapes of YOLOv3-tiny at batch 16; the strategy
   plans S1 and S2 at batch 32 for
   quant_space_to_depth4, gmax_shift_s2d2 and conv3x3_rs, and S1 at
   batch 1 for conv3x3_rs and quant_space_to_depth4, whose every byte
   value at four input scales, widths 56 and 72, 120-byte input rows
   and S2's b1 entry are checked too), requiring identical results, and
   time kernel, plain version and (for the GEMM and conv3x3_rs)
   ``torch._int_mm``, printing each GEMM and conv3x3_rs row's form, tile,
   K-split and grid (``gemm_form``, ``rs_form``), and the host time of a
   ``gemm_fused`` call in both forms; the W8A8 conv (conv_w8a8, each
   layer's route, K steps and schedule printed: grid, stream-K tiles,
   blocks and slots, tiles a block, the busiest block's K steps) also in
   mode 4 and against the im2col + ``gemm_fused`` route it replaced,
   timed beside it, ``torch._int_mm`` on the im2col'd A, its bound, the
   previous kernel's time and the kernel's other schedules on the same
   inputs (round robin or stream-K), each bit for bit; its small-Cin
   kernel conv_w8a8_rows at the generic forward's entry conv (3x3, Cin 3
   -> 16, 416 px, b2 and b8) the same way, and its uint8 form (the wire
   batch read through the code table), beside the route it replaced and
   the epilogue's issue bound (its instructions an output from
   ``cuobjdump -sass`` of the built library; the run fails where they
   cannot be counted; to time another checkout's kernel in turns on one
   card: ``python3 chip_smoke.py --rows-ab DIR``);
   the per-tap stem is timed beside
   the k2 stem on the same inputs (b16 and b1), with the k2 stem's own
   b32 time beside them; then the attic kernels: stage0_fused
   through both of its wrappers (b32, b2 and b1, v1's operand at ht 4
   and 8) and conv3x3_bt
   at YOLOv2-tiny's tail shapes (b32 and b1, also held equal to
   conv3x3_rs and timed beside it and ``torch._int_mm``, each row with
   its K-split and grid), whose b32 tail pass gives its launch count; and
   gemm_f32 (the float form of gemm_fused: three TF32 products on
   wgmma, two for int8 codes) at the fp32 gemm tier's shapes
   (YOLOv2-tiny b32 and b1, YOLOv3-tiny b16 and b1) with a float32 and
   an int8 B, each launch in the wgmma form (K split at b1), within
   ``sum_tol`` of its float64-summed plain version, timed beside
   ``torch.matmul`` with TF32 off and both bounds (the three TF32
   products' and one float32 product's on the FMA pipe); the three
   stems also at b1;
4. the copy-engine tools' path: ``probe_dma_rules.main`` (every TMA
   encode verdict equal to ``tma_box_legal``, every accepted box equal to
   the slice) and ``proto_conv_dma.main`` (conv_dma at (32,104,104,64) ->
   128 for each ht, and conv3x3_rs on the same inputs), counters from 0;
   then conv_dma against its plain version and conv3x3_rs at that shape
   for each ht (every ht launches the same kernel, so one is timed),
   timed beside its bound, the plain version, conv3x3_rs and
   ``torch._int_mm``, and tma_probe against its plain copy, timed beside
   ``clone`` of the slice;
5. card against CPU, W8A8 at 416 px from seeded random weights:
   YOLOv2-tiny at batch 2 (the batch-32 plan: all three of its kernels)
   and batch 1 (its own pinned plan), YOLOv3-tiny at batch 2 and batch 1
   (its one pin), and YOLOv2-tiny at batch 2 under the strategy files S1,
   S2 and S3 (the pin with s0 at layer 0). The CPU engine (plain
   versions) gets the card's weights and scales; heads must be identical
   and detections equal. The card's
   YOLOv2 calibration scales must match a CPU calibration of the same
   weights to a few float32 ulps (no TF32 in the reference conv);
6. drive each main path: YOLOv2-tiny at batch 32 and batch 1, YOLOv3-tiny
   at batch 16 and batch 1, S1 at batch 32 and 1, S2 at batch 32, S3 at
   batch 32 and 1, then both models in fp32 (``EngineConfig()``'s
   defaults: the generic forward, gemm_f32 on the deep layers) and in w8
   (the bf16 plans) at the same batches. The
   launch counters, set to 0 just before each detect and read just
   after, must show it ran through its kernels and no others (in W8A8 no
   gemm_fused launch in the ragged form and no im2col on the xla tier:
   every 3x3 conv on conv_w8a8, every 1x1 conv on gemm_fused; on no path
   a gemm_f32 launch in the ragged form); the (M, K, N) of the GEMMs of
   a second detect must be the tables' (YOLOv2-tiny b32 and b1,
   YOLOv3-tiny b16); in W8A8 every conv_w8a8 launch of a detect must
   equal its plain version bit for bit; then
   throughput (forwards and detects back to back), latency (each call
   synced), and the device time and operations per forward by kernel
   from ``torch.profiler`` (a trace must hold every kernel as many times
   as its launch counter counted), with conv_w8a8's share of the device
   busy. Before them, the host's wait for one scale
   upload behind a busy card (``upload_wait_ms``);
7. S2's stage 1 (``rs``, no im2col) against the pinned plan's L2 stage
   (``fold_xla``: conv_w8a8 with its group-max) on the same b32 entry state,
   and S3's stage 0 (``s0``) against the pin's (``stem_rs``) on the same
   b32 f32 input, with the share of codes that differ;
8. the ported plan sweep (YOLOv2-tiny w8a8, batch 8, every candidate,
   short fixed loop counts): no candidate may crash or fail parity, and
   an engine built from its artifact must have its kinds and run detect;
9. card against CPU at 416 px, b2, for the fp32 and w8 modes and the generic
   W8A8 tiers: fp32
   and the w8 plans (heads within F32_REL_TOL and BF16_REL_TOL of the
   largest head, detections as sets within that: ``detections_close``),
   W8A8 with ``kernel="xla"`` and ``"pallas"`` and the fallback from an
   illegal strategy file (bit for bit), each with its launch counts (the
   xla tier's 3x3 convs on conv_w8a8 but the entry conv's, Cin 3, on
   conv_w8a8_rows, and no conv on the im2col route; the fallback's
   ``auto`` takes the gemm tier where use_pallas says so), and
   ``Model.forward(mode="w8", kernel="pallas")`` (gemm_f32 with int8
   codes on every conv; only layer 0's K = 27 in the ragged form);
10. the front door at 416 px, from files written here from seeds: a
   darknet ``.weights`` file (BN blocks) and an ``.npz`` of uint8
   calibration images build the W8A8 b32 engine (the noise calibration
   refused for file weights); its checkpoint (``Engine.save``) loads into
   a card and a CPU engine (heads identical, detections equal at b2); 96
   requests from 4 threads through ``ContinuousBatcher`` on the b32 pin
   and 16 on the b1 pin (``max_batch`` 1), each result equal to its row of
   the card's detect on the batch shipped, the launch counters set to 0
   just before the served run and read just after (each batch: 7
   conv_w8a8, 1 gemm_fused, 1 k2 stem, at b32 1 shift_s2d2; no im2col, no
   ragged GEMM, 1 nms_suppress and no host read in the NMS); then each
   pin's batcher timed with nothing of this script in its path (a warm-up
   batch, then 3 windows of 200 b32 or 400 b1 batches, 2 batches' worth
   of requests in flight: images/s, p50/p99 ms, batch fill per window);
   on the pins' and the eval grade's inputs the NMS's host ms through the
   kernel (one detect's NMS under PyTorch's sync debug mode "error": no
   call may synchronize the host) and through the plain loop for groups
   of 1-16 sweeps a read, its sweeps to convergence, and one plain
   sweep's device ms at serving and eval-grade K; nms_suppress against
   its plain version (keep masks bit for bit) on the candidates of real
   detects (the pins' b32 and b1 at K 256, the eval grade's b2 at K 845,
   YOLOv3-tiny's eval grade b2 at K 2535, and at 608 px K 5415), timed
   beside its bound, with the plain loop's sweeps on the same candidates;
   ``serve_http`` on port 0 (4 ``.npy`` POSTs equal to the direct
   detect's boxes in image coordinates, 20 more timed one after another,
   /stats, /healthz, a bad body 400); the eval-grade detect (score
   0.005, pool uncapped) card against CPU at b2; ``dump-goldens`` on the
   card held to a CPU dump, ``check-goldens`` in w8a8 at the CLI's limit
   (and failing against another seed's weights), each in a process of
   its own; where PIL imports (``{"pil": ...}`` says), ``evaluate_voc``
   over a JPEG tree card against CPU and ``cli detect --image --out``;
   the native host library in use; and one JSON line of the phase's
   numbers with the card;
11. ResNet-18 at 224 px, 1000 classes, from seeded random weights:
   conv_w8a8 at each of its new forms' shapes (the linear 3x3 convs'
   f32 output on PATCH and TAP, the 3x3/s2 convs, the 1x1/s2
   projections) at b32 and b1 against its plain version bit for bit
   (f32 outputs too), through the wrapper and launched directly, timed
   beside the im2col + ``gemm_fused`` route, ``torch._int_mm`` on the
   im2col'd A and the bound (a 1x1/s2 conv's bytes count the quarter of
   the input it reads); the stem (7x7/s2, Cin 3) on the small-Cin kernel
   conv_w8a8_rows the same way (int8 and uint8 forms), timed beside the
   route it replaced (im2col + ``gemm_fused``'s ragged form); card
   against CPU at b2 in
   w8a8 (every plan stage's entry state up to the pool identical, the
   logits within RESNET_LOGIT_TOL), fp32 and w8; ``classify`` at b32 and
   b1 in each mode with its launch counts (W8A8: 19 conv_w8a8, 1
   conv_w8a8_rows, no gemm_fused, no im2col; fp32: 11 gemm_f32; w8:
   none), every conv_w8a8 and conv_w8a8_rows launch of a W8A8 classify
   bit for bit (the stem's on the uint8 wire), the stem stage one
   conv_w8a8_rows launch that dispatches no other PyTorch operation but
   its output's allocation, throughput,
   latency and the device breakdown; and ``plan-sweep --quick`` at b32 in
   w8a8;
12. profiling: one conv_w8a8 launch traced inside a stage scope must
   land in it; ``Engine.stage_times_traced`` of the W8A8 YOLOv2-tiny pin
   at 416 px (b32, b1) and ResNet-18 at 224 px (b32), with auto-scaled
   loop counts and PROFILE_RUNS traced forwards: a line a stage (isolated
   and in-context ms, executed work, traffic, binding floor and its
   share), the trace's module time beside ``device_breakdown``'s busy time,
   the trace time by stage kind; it fails where the trace rows miss the
   module time by 2%, a kernel's traced count is not its launch count
   after 3 traces, or a stage reads over BINDING_PCT_MAX of its floor in
   context (or, resolved, looped alone); then the CLI's ``trace
   --detect`` at b1 over 30 detects (its post_decode and nms_* scopes;
   its module time is phase 14's reference) and ``layer-times`` (fp32)
   in processes of their own;
13. multi-device: conv_w8a8's int32-accumulator form (the row-parallel
   conv's) against its plain version, int32 for int32, at YOLOv2-tiny
   L13's Cin shards (512 and 256, b32 and b16), YOLOv3-tiny L12's (256,
   b16) and ResNet-18 L3's (32, b32), each timed beside the plain
   version, ``torch._int_mm`` on the im2col'd A and its bound; then ranks
   of this script that share the card over gloo with CUDA tensors: the
   YOLOv2-tiny W8A8 b32 pin at 416 px on meshes (1, 2) channel, (2, 1)
   replicated and (2, 2) channel, each rank's heads and detections equal
   to the single-device card detect bit for bit, with its launch counts
   set to 0 just before a detect and read just after (7 conv_w8a8, the
   raw form one of them on a channel mesh, 1 gemm_fused, 1 k2 stem, 1
   shift_s2d2); a one-rank NCCL group's int32 all_reduce on the card;
   two NCCL ranks on the one card (NCCL refuses a device shared by two
   ranks; the outcome is printed); and ``DistributedBatcher`` on (1, 2)
   with a leader and a follower: 64 submits and one ``POST /detect``,
   every row equal to the single-device detect, both ranks out with rc 0
   after ``stop``; then profiling on (1, 2) channel and (2, 1) ranks:
   each rank's ``stage_times_traced`` (auto-scaled loop counts, rank 0's
   on every rank) and ``layer_times``, row names equal to the
   single-device engine's, and ``cli trace --detect --mesh`` (its
   post_decode and nms_* scopes on rank 0). Wall times of ranks that
   share one card measure contention, not scaling;
14. the bench: ``cli bench --mode w8a8 --batch 32`` in a process of its
   own, its one JSON line held to the JAX bench's keys with the card
   line, its b1 detect device time (from the trace) at most its wall p50
   and within 5% of phase 12's traced b1 detect; ``bench_all`` over
   configs 3, 6 and 8 (all eleven run as a command of their own), no
   config's error, config 8's b1 detect device ms and config 6's module
   ms within 5% of phase 12's.

The lines before the last are the card line, the ``kernels`` JSON line;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from dnn_inference_engine_tpu_torch.runtime.benchlib import (
    card_line, device_ms, f32_peak, latency_ms, peaks, tf32_peak,
    throughput_ms)
from dnn_inference_engine_tpu_torch.runtime.profiling import (
    device_breakdown, kernel_counters, read_counts, reset_counts)

KERNELS = {
    "gemm_fused": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/gemm_fused.cu",
        replaces="dnn_inference_engine_tpu/ops/pallas_gemm.py:112"),
    "gemm_f32": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/gemm_f32.cu",
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
    "stage0_fused": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/stage0_fused.cu",
        replaces="dnn_inference_engine_tpu/ops/attic/pallas_stage0.py:177 "
                 "and :342"),
    "conv3x3_bt": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/conv3x3_bt.cu",
        replaces="dnn_inference_engine_tpu/ops/attic/pallas_tail.py:78"),
    "conv_dma": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/conv_dma.cu",
        replaces="tools/proto_conv_dma.py:82"),
    "tma_probe": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/tma_probe.cu",
        replaces="tools/probe_dma_rules.py:24"),
    # XLA's int8 conv (not a Pallas kernel), as the fold_xla, fold_xla_k2
    # and xla stages run it (dnn_inference_engine_tpu/runtime/plan.py:847,
    # :927)
    "conv_w8a8": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/conv_w8a8.cu",
        replaces="dnn_inference_engine_tpu/ops/conv.py:110"),
    # its small-Cin form (conv2d_w8a8's "rows" route): ResNet-18's 7x7/s2
    # stem (layer 0 of the all-xla pin) and the generic forward's entry
    # conv, Cin 3
    "conv_w8a8_rows": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/conv_w8a8_rows.cu",
        replaces="dnn_inference_engine_tpu/ops/conv.py:110"),
    # its int32-accumulator form (the raw store): XLA's int8 conv with
    # preferred_element_type=int32 in the row-parallel conv
    "conv_w8a8_acc": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/conv_w8a8.cu",
        replaces="dnn_inference_engine_tpu/parallel/shard_map_forward.py:96"),
    # the NMS's suppress stage: the IoU lines of device_nms_cols and
    # _greedy_fixpoint's dominance build and lax.while_loop (not a Pallas
    # kernel: XLA runs them on the device inside the jitted detect)
    "nms_suppress": dict(
        route="cuda",
        source="dnn_inference_engine_tpu_torch/csrc/nms_suppress.cu",
        replaces="dnn_inference_engine_tpu/postprocess.py:246"),
}

# Strategy plans (YOLOv2-tiny, w8a8): S1 and S2 between them run every
# plan kind the sweep proposes, S3 is the b32 pin with s0 at layer 0
# (stage0_fused_v2); written as JSON under build/ at run time and given to
# the engine as EngineConfig.strategy.
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
# conv3x3_rs at the b32 shapes of S1 (L6 rs2, L8 rs) and S2 (L2 rs, L4
# rs2): (tag, x shape, ksize, Cout, pool-major group-max co)
RS_SHAPES = [("S1 L6 rs2", (32, 27, 27, 256), 2, 512, 128),
             ("S1 L8 rs", (32, 13, 13, 512), 3, 1024, 256),
             ("S2 L2 rs", (32, 104, 104, 64), 3, 128, 32),
             ("S2 L4 rs2", (32, 53, 53, 128), 2, 256, 64)]
# ... and at S1's batch-1 stages, where K is split across blocks
RS_B1_SHAPES = [("S1 b1 L6 rs2", (1, 27, 27, 256), 2, 512, 128),
                ("S1 b1 L8 rs", (1, 13, 13, 512), 3, 1024, 256)]

# (layer, M, K, N) of every GEMM (the 1x1 convs) of one batch-32 forward
# at 416 px under YOLOv2-tiny's pin
B32_GEMMS = [("L14", 5408, 1024, 125)]
# ... of one batch-1 forward under YOLOv2-tiny's b1 pin
B1_GEMMS = [("L14", 169, 1024, 125)]
# ... and of one YOLOv3-tiny batch-16 forward (L15, L21: the f32 heads)
B16_V3_GEMMS = [("L13", 2704, 1024, 256), ("L15", 2704, 512, 75),
                ("L17", 2704, 256, 128), ("L21", 10816, 256, 75)]
# (layer, x shape, k, Cout, group-max, trimmed output) of every conv_w8a8
# launch (the 3x3 convs and the shifted k2 fold) of one forward at 416 px:
# YOLOv2-tiny b32 and b1 (its own folds: L4 a fold-2 3x3), YOLOv3-tiny b16
V2_B32_CONVS = [("L2", (32, 104, 104, 64), 3, 128, True, None),
                ("L4", (32, 56, 53, 128), 2, 256, True, (52, 52)),
                ("L6", (32, 52, 52, 64), 3, 128, False, None),
                ("L8", (32, 26, 26, 128), 3, 256, False, None),
                ("L10", (32, 13, 13, 256), 3, 512, False, None),
                ("L12", (32, 13, 13, 512), 3, 1024, False, None),
                ("L13", (32, 13, 13, 1024), 3, 1024, False, None)]
V2_B1_CONVS = [("L2", (1, 104, 104, 64), 3, 128, True, None),
               ("L4", (1, 52, 52, 128), 3, 256, True, None),
               ("L6", (1, 52, 52, 64), 3, 128, False, None),
               ("L8", (1, 26, 26, 128), 3, 256, False, None),
               ("L10", (1, 13, 13, 256), 3, 512, False, None),
               ("L12", (1, 13, 13, 512), 3, 1024, False, None),
               ("L13", (1, 13, 13, 1024), 3, 1024, False, None)]
V3_B16_CONVS = [("L2", (16, 104, 104, 64), 3, 128, True, None),
                ("L4", (16, 56, 53, 128), 2, 256, True, (52, 52)),
                ("L6", (16, 52, 52, 64), 3, 128, False, None),
                ("L8", (16, 26, 26, 128), 3, 256, False, None),
                ("L10", (16, 13, 13, 256), 3, 512, False, None),
                ("L12", (16, 13, 13, 512), 3, 1024, False, None),
                ("L14", (16, 13, 13, 256), 3, 512, False, None),
                ("L20", (16, 26, 26, 384), 3, 256, False, None)]
HEADS = {"yolov2-tiny": {"L14"}, "yolov3-tiny": {"L15", "L21"}}
# input scales of quant_space_to_depth4's every-byte check: u / 255 / s
# lands on a tie at 0.0078431377 = f32(2/255) for 65 byte values
QS2D4_SCALES = (1 / 127.0, 0.0078431377, 0.0123, 0.007919)
# conv_w8a8's previous kernel (commit 6ee0c98: a window route for the tap
# forms, the exact epilogue, no stream-K) at V2_B32_CONVS, ms a launch
# (chip_smoke.py's device_ms, H100 80GB HBM3 at 700.00 W; PERF.md section
# 6), and its sums at V2_B1_CONVS and V3_B16_CONVS
PREV_CONV_MS = {"L2": 0.0725, "L4": 0.0460, "L6": 0.0434, "L8": 0.0282,
                "L10": 0.0303, "L12": 0.0671, "L13": 0.1211}
PREV_CONV_SUM_MS = {"v2-b32": 0.4085, "v2-b1": 0.1249, "v3-b16": 0.2440}
# (layer, M, K, N) of the gemm_f32 launches of one fp32 kernel="auto"
# forward at 416 px: the layers where use_pallas takes the gemm tier
# (YOLOv2-tiny b32; YOLOv3-tiny b16); L14 is the linear head
F32_B32_GEMMS = [("L8", 21632, 1152, 256), ("L10", 5408, 2304, 512),
                 ("L12", 5408, 4608, 1024), ("L13", 5408, 9216, 1024),
                 ("L14", 5408, 1024, 125)]
F32_B16_V3_GEMMS = [("L8", 10816, 1152, 256), ("L10", 2704, 2304, 512),
                    ("L12", 2704, 4608, 1024), ("L13", 2704, 1024, 256),
                    ("L14", 2704, 2304, 512), ("L20", 10816, 3456, 256)]
# ... and at batch 1 (the same layers; K is split across blocks)
F32_B1_GEMMS = [("L8", 676, 1152, 256), ("L10", 169, 2304, 512),
                ("L12", 169, 4608, 1024), ("L13", 169, 9216, 1024),
                ("L14", 169, 1024, 125)]
F32_B1_V3_GEMMS = [("L8", 676, 1152, 256), ("L10", 169, 2304, 512),
                   ("L12", 169, 4608, 1024), ("L13", 169, 1024, 256),
                   ("L14", 169, 2304, 512), ("L20", 676, 3456, 256)]
F32_HEADS = {"L14"}
U32 = 2.0 ** -24                     # float32 unit roundoff
# conv3x3_bt at YOLOv2-tiny's 3x3 tail convs, 416 px: (tag, x shape, Cout)
BT_SHAPES = [("L8 b32", (32, 26, 26, 128), 256),
             ("L10 b32", (32, 13, 13, 256), 512),
             ("L12 b32", (32, 13, 13, 512), 1024),
             ("L13 b32", (32, 13, 13, 1024), 1024),
             ("L12 b1", (1, 13, 13, 512), 1024),
             ("L13 b1", (1, 13, 13, 1024), 1024)]


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    return float((a.double() - b.double()).abs().max())


def phase_build():
    from dnn_inference_engine_tpu_torch.ops import _build
    t0 = time.time()
    reports = _build.build_all(force=True)
    print(f"build: {len(reports)} kernels in {time.time() - t0:.1f} s")
    for name, rep in reports.items():
        for line in (rep or "").splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "Performance Loss" in line
                    or ("spill" in line and " 0 bytes spill stores" not in
                        line)):
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
    from dnn_inference_engine_tpu_torch.ops import _build
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    sms = _build.sm_count(dev)
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
        form = gm.gemm_form(m, n, k, True, sms)
        ragged = gm.gemm_fused.ragged_launches
        got = gm.gemm_fused(a, bt, scale, bias, **kw)
        ref = gm.gemm_fused_plain(a, bt, scale, bias, **kw)
        err = max_abs_err(got, ref)
        if gm.gemm_fused.ragged_launches != ragged or form.form != "wgmma":
            raise AssertionError(f"gemm_fused {tag} {layer}: not the "
                                 f"wgmma form")
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
                           bound_ms=bound, bound_by=by, form=form.form,
                           tile="128x128", splits=form.splits,
                           grid=form.grid))
        print(f"  gemm_fused {tag} {layer} M={m} K={k} N={n}: err={err} "
              f"ms={ms:.4f} plain_ms={plain_ms:.3f} int_mm_ms={lib_ms:.4f} "
              f"bound_ms={bound:.4f} ({by}); {form.form} 128x128 "
              f"split {form.splits} grid {form.grid}")
        if err != 0:
            raise AssertionError(f"gemm_fused {tag} {layer}: kernel != plain")
        del a, bt, ref, got
    return shapes


def gemm_host_us(g, dev, reps: int = 200):
    """Host microseconds a ``gemm_fused`` call takes to queue (wrapper,
    form choice, tensor-map encodes, launch) at b1's L13 shape, where K is
    split, and at a small unsplit shape, in the wgmma form and in the
    ragged form (A one byte off alignment: no encode, no split buffers).
    The calls run behind a spin kernel (~100 ms), so the host never
    waits."""
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    out = {}
    for tag, (m, k, n) in (("b1 L13", (169, 9216, 1024)),
                           ("b1 L14", (169, 1024, 125))):
        buf = torch.randint(-127, 128, (m * k + 1,), generator=g,
                            device=dev, dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                           dtype=torch.int8)
        scale = torch.rand(n, generator=g, device=dev) * 2e-5
        bias = torch.randn(n, generator=g, device=dev)
        for form, a in (("wgmma", buf[:m * k].view(m, k)),
                        ("ragged", buf[1:].view(m, k))):
            gm.gemm_fused(a, bt, scale, bias, s_out=0.05)
            torch.cuda.synchronize()
            torch.cuda._sleep(200_000_000)
            t0 = time.perf_counter()
            for _ in range(reps):
                gm.gemm_fused(a, bt, scale, bias, s_out=0.05)
            out[f"{tag} {form}"] = (time.perf_counter() - t0) / reps * 1e6
            torch.cuda.synchronize()
    return out


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
    b1_shapes = gemm_shapes(g, dev, B1_GEMMS, HEADS["yolov2-tiny"], ops_peak,
                            bw, "v2-b1")
    by_ops = sum(s["bound_ms"] for s in shapes
                 if s["bound_by"] == "operations")
    rows["gemm_fused"] = dict(
        max_abs_err=max(s["max_abs_err"]
                        for s in shapes + v3_shapes + b1_shapes),
        ms=sum(s["ms"] for s in shapes),
        plain_ms=sum(s["plain_ms"] for s in shapes),
        bound_ms=sum(s["bound_ms"] for s in shapes),
        bound_by=("operations" if 2 * by_ops >= sum(s["bound_ms"]
                                                    for s in shapes)
                  else "bytes"),
        library_ms=sum(s["library_ms"] for s in shapes), shapes=shapes,
        v3_b16_shapes=v3_shapes,
        v3_b16_ms=sum(s["ms"] for s in v3_shapes),
        v3_b16_library_ms=sum(s["library_ms"] for s in v3_shapes),
        b1_shapes=b1_shapes, b1_ms=sum(s["ms"] for s in b1_shapes),
        b1_library_ms=sum(s["library_ms"] for s in b1_shapes),
        b1_bound_ms=sum(s["bound_ms"] for s in b1_shapes),
        host_us=gemm_host_us(g, dev))
    r = rows["gemm_fused"]
    print(f"  gemm_fused sums: v2 b32 {r['ms']:.4f} ms (int_mm "
          f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f}), v2 b1 "
          f"{r['b1_ms']:.4f} ms (int_mm {r['b1_library_ms']:.4f}, bound "
          f"{r['b1_bound_ms']:.4f}), v3 b16 {r['v3_b16_ms']:.4f} ms (int_mm "
          f"{r['v3_b16_library_ms']:.4f}); host us a call {r['host_us']}")

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
    m = got.numel() // 64
    bound, by = _bound(2.0 * m * 192 * 256,      # the 48 real lanes of 4 taps
                       xu.numel() + wq.numel() + 2 * 64 * 4 + got.numel(),
                       ops_peak, bw)
    # batch 1 (the b1 pin's stage 0): its own band height and grid
    x1 = xu[:1].clone()
    b1_errs = [max_abs_err(
        fc.stem_fused_k2(x, wq, scale, bias, 0.00787, **kw),
        fc.stem_fused_k2_plain(x, wq, scale, bias, 0.00787, **kw))
        for x, kw in ((x1, dict(exact_u8=True)), (xf[:1].clone(), {}))]
    if max(b1_errs) != 0:
        raise AssertionError("stem_fused_k2 b1: kernel != plain")
    b1_ms = device_ms(lambda: fc.stem_fused_k2(x1, wq, scale, bias, 0.00787,
                                               exact_u8=True), 50)
    b1_bound, _ = _bound(2.0 * m / 32 * 192 * 256,
                         x1.numel() + wq.numel() + 2 * 64 * 4
                         + got.numel() // 32, ops_peak, bw)
    rows["stem_fused_k2"] = dict(
        max_abs_err=max(errs + b1_errs), ms=ms, plain_ms=plain_ms,
        library_ms=None, bound_ms=bound, bound_by=by, b1_ms=b1_ms,
        b1_bound_ms=b1_bound)
    print(f"  stem_fused_k2 b1: err={max(b1_errs)} ms={b1_ms:.4f} "
          f"bound_ms={b1_bound:.4f}")
    del xu, xf, x1

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
    b1_err = max_abs_err(
        fc.stem_fused_dg(x1, w48, scale, bias, 0.00787, exact_u8=True),
        fc.stem_fused_dg_plain(x1, w48, scale, bias, 0.00787, exact_u8=True))
    if b1_err != 0:
        raise AssertionError("stem_fused_dg b1: kernel != plain")
    m = got.numel() // 64
    bound, by = _bound(2.0 * m * 192 * 256,
                       xu.numel() + w48.numel() + 2 * 64 * 4 + got.numel(),
                       ops_peak, bw)
    b1_bound, _ = _bound(2.0 * m / 16 * 192 * 256,
                         x1.numel() + w48.numel() + 2 * 64 * 4
                         + got.numel() // 16, ops_peak, bw)
    rows["stem_fused_dg"] = dict(
        max_abs_err=max(errs + [b1_err]), ms=ms, plain_ms=plain_ms,
        library_ms=None, bound_ms=bound, bound_by=by, k2_ms=k2_ms,
        b1_ms=b1_ms, b1_k2_ms=b1_k2_ms, b1_bound_ms=b1_bound)
    print(f"  stem at v3 shapes, exact-u8: b16 dg {ms:.4f} ms vs k2 "
          f"{k2_ms:.4f} ms (bound {bound:.4f}); b1 dg {b1_ms:.4f} ms vs k2 "
          f"{b1_k2_ms:.4f} ms (bound {b1_bound:.4f}); k2 at v2 b32 "
          f"{rows['stem_fused_k2']['ms']:.4f} ms")
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


def conv_alternatives(f, sms, k):
    """The kernel's other schedules for a launch of form ``f`` (a k x k
    conv), by name:
    round robin ("rr": whole tiles, one a block and round), the last
    round's tiles stream-K over every block ("sk last round", at least as
    many tiles as SMs) or every tile stream-K over ``k_splits``' pieces a
    tile ("sk", fewer tiles), where that differs from ``f``."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops.gemm import k_splits
    rounds, rem = divmod(f.tiles, sms)
    alts = {"rr": f._replace(grid=min(f.tiles, sms), sk_tiles=0,
                             sk_blocks=0, slots=1)}
    if rounds and rem:
        alts["sk last round"] = f._replace(
            grid=sms, sk_tiles=rem, sk_blocks=min(sms, rem * f.steps))
    elif not rounds:
        step_bytes = k * f.kb if f.route == "patch" else 128
        pieces = min(k_splits(f.tiles, -(-f.steps * step_bytes // 128),
                              sms), f.steps)
        grid = min(sms, f.tiles * pieces)
        if pieces > 1:
            alts["sk"] = f._replace(grid=grid, sk_tiles=f.tiles,
                                    sk_blocks=grid)
    alts = {k: v._replace(slots=cv.sk_slots(v)) for k, v in alts.items()}
    return {f"{f.route} {k}": v for k, v in alts.items() if v != f}


def schedule_line(f) -> str:
    """A form's schedule: grid, stream-K tiles, blocks and slots, tiles a
    block, and the busiest block's K steps of the round-robin one's."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    busiest = max(cv.block_steps(f))
    rr = -(-f.tiles // min(f.tiles, f.grid)) * f.steps
    return (f"grid {f.grid}, {f.tiles} tiles of {f.steps} steps "
            f"({f.tiles / f.grid:.2f} a block), stream-K {f.sk_tiles} tiles "
            f"on {f.sk_blocks} blocks ({f.slots} slots), busiest block "
            f"{busiest} steps (round robin {rr})")


def conv_shapes(g, dev, table, ops_peak, bw, tag):
    """conv_w8a8 against its plain version (codes bit for bit; s_out 0.05,
    the conv order, and 1e-39, mode 4) at each (layer, x shape, k, Cout,
    group-max, trim) of ``table``, and against the im2col + ``gemm_fused``
    route it replaced on the same inputs; the kernel's launch timed on
    prepared operands beside that route, ``torch._int_mm`` on the
    im2col'd A (product only), the bound, the previous kernel's time and
    the kernel's
    other ways (``conv_alternatives``, each bit for bit)."""
    from dnn_inference_engine_tpu_torch.ops import _build
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops import fused_conv as fc
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
        extract_patches)
    from dnn_inference_engine_tpu_torch.quant.quantize import f32_scalar
    sms = _build.sm_count(dev)
    shapes = []
    for layer, xs, k, cout, gmax, out_hw in table:
        cin = xs[3]
        x = torch.randint(-127, 128, xs, generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, k, cin, cout), generator=g,
                          device=dev, dtype=torch.int8)
        spread = 0.05 * 60.0 / (0.02 * (k * k * cin) ** 0.5 * 5376.0)
        # a fold stage's pool groups share their layer's s_w and b
        reps = 4 if gmax else 1
        s_w = ((torch.rand(cout // reps, generator=g, device=dev) + 0.5)
               * spread).repeat(reps)
        b = torch.randn(cout // reps, generator=g, device=dev).repeat(reps)
        padding = "SAME" if k == 3 else "VALID"
        kw = dict(act="leaky", padding=padding, s_out=0.05, out_hw=out_hw,
                  gmax=gmax)
        form = cv.conv_w8a8_form(*xs, cout, k, k, 1, padding, out_hw, True,
                                 gmax, sms)
        launches = cv.conv2d_w8a8.launches
        got = cv.conv2d_w8a8(x, 0.02, w, s_w, b, **kw)
        if (cv.conv2d_w8a8.launches != launches + 1
                or form.route not in ("patch", "tap")):
            raise AssertionError(f"conv_w8a8 {tag} {layer}: not the kernel")
        ref = cv.conv2d_w8a8_plain(x, 0.02, w, s_w, b, **kw)
        err = max_abs_err(got, ref)
        # mode 4: s_out not a positive normal float (the double product)
        kw4 = dict(kw, s_out=1e-39)
        sw4 = s_w * (1e-39 / 0.05)
        err4 = max_abs_err(cv.conv2d_w8a8(x, 0.02, w, sw4, b * 1e-39, **kw4),
                           cv.conv2d_w8a8_plain(x, 0.02, w, sw4, b * 1e-39,
                                                **kw4))
        n = xs[0]
        ho, wo = cv.conv_out_hw(xs[1], xs[2], k, padding, out_hw)
        m, kk = n * ho * wo, k * k * cin
        a = extract_patches(x, k, k, 1, padding, out_hw).reshape(m, kk)
        wt = gm.kmajor_weights(w)
        # timed on prepared operands (the wrapper's scale upload blocks
        # the host behind the queued calls)
        go = cout // 4 if gmax else 0
        bt = fc.rs_tile_matrix(w, go) if gmax else wt
        scale = f32_scalar(0.02, dev) * s_w

        def kernel(f=form):
            return cv.conv_w8a8_launch(x, bt, scale, b, 0.05, k, ho, wo, go,
                                       "leaky", f)

        def im2col_gemm():
            y = gm.gemm_fused(extract_patches(x, k, k, 1, padding, out_hw)
                              .reshape(m, kk), wt, scale, b, s_out=0.05)
            y = y.reshape(n, ho, wo, cout)
            return fc.group_max4(y) if gmax else y
        err = max(err, max_abs_err(kernel(), got),
                  max_abs_err(im2col_gemm(), got))
        ms = device_ms(kernel, 10)
        alt_ms = {}
        for name, f in conv_alternatives(form, sms, k).items():
            err = max(err, max_abs_err(kernel(f), got))
            alt_ms[name] = device_ms(lambda f=f: kernel(f), 10)
        im2col_ms = device_ms(im2col_gemm, 10)
        plain_ms = device_ms(
            lambda: cv.conv2d_w8a8_plain(x, 0.02, w, s_w, b, **kw), 2)
        lib_ms = device_ms(lambda: torch._int_mm(a, wt.t()), 10)
        bound, by = _bound(2.0 * m * kk * cout,
                           x.numel() + w.numel() + 8 * cout + got.numel(),
                           ops_peak, bw)
        shapes.append(dict(layer=layer, x=list(xs), k=k, N=cout, M=m, K=kk,
                           gmax=gmax, max_abs_err=max(err, err4), ms=ms,
                           im2col_gemm_ms=im2col_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bound, bound_by=by,
                           route=form.route, kb=form.kb, steps=form.steps,
                           grid=form.grid, sk_tiles=form.sk_tiles,
                           sk_blocks=form.sk_blocks, slots=form.slots,
                           alt_ms=alt_ms))
        prev = PREV_CONV_MS.get(layer) if tag == "v2-b32" else None
        print(f"  conv_w8a8 {tag} {layer} x={xs} k={k} Cout={cout}"
              f"{' gmax' if gmax else ''}{f' trim {out_hw}' if out_hw else ''}"
              f" (M={m} K={kk}): err={err} mode-4 err={err4} ms={ms:.4f}"
              f"{f' (previous kernel {prev:.4f})' if prev else ''} "
              f"im2col+gemm_fused_ms={im2col_ms:.4f} int_mm_ms={lib_ms:.4f} "
              f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} ({by}); "
              f"{form.route} kb {form.kb}, {schedule_line(form)}; other "
              f"ways: " + ", ".join(f"{k_} {v:.4f}"
                                    for k_, v in alt_ms.items()))
        if err != 0 or err4 != 0:
            raise AssertionError(f"conv_w8a8 {tag} {layer}: kernel != plain")
        del x, a, ref, got
    return shapes


def phase_conv_w8a8(dev, ops_peak, bw):
    """The W8A8 conv kernel at every conv_w8a8 launch of the pins' main
    paths (YOLOv2-tiny b32 and b1, YOLOv3-tiny b16); the row sums the b32
    forward's 7 launches."""
    g = torch.Generator(device=dev).manual_seed(11)
    tabs = {"v2-b32": V2_B32_CONVS, "v2-b1": V2_B1_CONVS,
            "v3-b16": V3_B16_CONVS}
    got = {tag: conv_shapes(g, dev, tab, ops_peak, bw, tag)
           for tag, tab in tabs.items()}

    def total(tag, key):
        return sum(r[key] for r in got[tag])
    b32 = got["v2-b32"]
    row = dict(
        max_abs_err=max(r["max_abs_err"] for rows in got.values()
                        for r in rows),
        ms=total("v2-b32", "ms"), plain_ms=total("v2-b32", "plain_ms"),
        bound_ms=total("v2-b32", "bound_ms"),
        bound_by=("operations" if all(r["bound_by"] == "operations"
                                      for r in b32) else "bytes"),
        library_ms=total("v2-b32", "library_ms"),
        im2col_gemm_ms=total("v2-b32", "im2col_gemm_ms"), shapes=b32)
    for tag in ("v2-b1", "v3-b16"):
        key = tag.split("-")[1]
        row[f"{key}_shapes"] = got[tag]
        for what in ("ms", "im2col_gemm_ms", "library_ms", "bound_ms"):
            row[f"{key}_{what}"] = total(tag, what)
    for tag, prev in PREV_CONV_SUM_MS.items():
        alts = {}
        for r in got[tag]:
            for name, v in r["alt_ms"].items():
                alts[name] = alts.get(name, 0.0) + v
        print(f"  conv_w8a8 {tag} sum {total(tag, 'ms'):.4f} ms (previous "
              f"kernel {prev:.4f}); each layer's other ways, where taken: "
              + ", ".join(f"{k} {v:.4f}" for k, v in alts.items()))
    print(f"  conv_w8a8 sums: v2 b32 {row['ms']:.4f} ms (im2col+gemm_fused "
          f"{row['im2col_gemm_ms']:.4f}, int_mm {row['library_ms']:.4f}, "
          f"bound {row['bound_ms']:.4f}); v2 b1 {row['b1_ms']:.4f} ms "
          f"(im2col+gemm_fused {row['b1_im2col_gemm_ms']:.4f}, int_mm "
          f"{row['b1_library_ms']:.4f}, bound {row['b1_bound_ms']:.4f}); v3 "
          f"b16 {row['b16_ms']:.4f} ms (im2col+gemm_fused "
          f"{row['b16_im2col_gemm_ms']:.4f}, int_mm "
          f"{row['b16_library_ms']:.4f}, bound {row['b16_bound_ms']:.4f})")
    return {"conv_w8a8": row}


def sum_tol(abs_sum_max: float, k: int) -> float:
    """Tolerance of a float32 sum of K products against the same sum taken
    in another order: 8 sqrt(K) half-ulps of the largest sum of
    magnitudes, plus the epilogue's roundings (4 half-ulps)."""
    return (8 * k ** 0.5 + 4) * U32 * abs_sum_max


def gemm_f32_shapes(g, dev, table, peaks_f32, bw, tag):
    """gemm_f32 against gemm_f32_plain at each (layer, M, K, N) of
    ``table``, with a float32 B (fp32, unit scales) and with int8 codes
    (w8), timed beside ``torch.matmul`` of the same A and B with TF32 off
    (cuBLAS SGEMM, product only). A is positive like a leaky layer's
    output; the error must stay within ``sum_tol`` of the largest
    sum |a||b|*|scale|, and every launch must take the wgmma form.
    ``peaks_f32``: (TF32 tensor-core, float32 FMA) operations/s; the bound
    is the wgmma form's (3 TF32 products, 2 for int8 codes), the SIMT
    bound (one float32 product) beside it."""
    from dnn_inference_engine_tpu_torch.ops import _build
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    tf32_ops, f32_ops = peaks_f32
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = []
    for layer, m, k, n in table:
        a = torch.rand((m, k), generator=g, device=dev)
        act = "linear" if layer in F32_HEADS else "leaky"
        bias = torch.randn(n, generator=g, device=dev) * 0.1
        form = gm.gemm_f32_form(m, n, k, a.data_ptr() % 16 == 0,
                                _build.sm_count(dev))
        for bdt in ("f32", "int8"):
            if bdt == "f32":
                bt = torch.randn((n, k), generator=g, device=dev) * 0.05
                scale = torch.ones(n, device=dev)
            else:
                bt = torch.randint(-127, 128, (n, k), generator=g,
                                   device=dev, dtype=torch.int8)
                scale = torch.rand(n, generator=g, device=dev) * 1e-3 + 1e-4
            ragged = gm.gemm_f32.ragged_launches
            got = gm.gemm_f32(a, bt, scale, bias, act=act)
            if gm.gemm_f32.ragged_launches != ragged or form.form != "wgmma":
                raise AssertionError(f"gemm_f32 {tag} {layer}: not the "
                                     f"wgmma form")
            ref = gm.gemm_f32_plain(a, bt, scale, bias, act=act)
            err = max_abs_err(got, ref)
            bound_sum = float(((a @ bt.float().abs().t())
                               * scale.abs()).max())
            tol = sum_tol(bound_sum, k)
            bf = bt.float()
            row = dict(
                layer=layer, M=m, K=k, N=n, b=bdt, max_abs_err=err, tol=tol,
                form=form.form, splits=form.splits, grid=form.grid,
                ms=device_ms(lambda: gm.gemm_f32(a, bt, scale, bias,
                                                 act=act), 10),
                plain_ms=device_ms(lambda: gm.gemm_f32_plain(
                    a, bt, scale, bias, act=act), 2),
                library_ms=device_ms(lambda: torch.matmul(a, bf.t()), 10))
            nbytes = (4 * m * k + bt.element_size() * n * k + 8 * n
                      + 4 * m * n)
            products = 2 if bdt == "int8" else 3
            row["bound_ms"], row["bound_by"] = _bound(
                products * 2.0 * m * k * n, nbytes, tf32_ops, bw)
            row["simt_bound_ms"], _ = _bound(2.0 * m * k * n, nbytes,
                                             f32_ops, bw)
            shapes.append(row)
            print(f"  gemm_f32 {tag} {layer} B {bdt} M={m} K={k} N={n} "
                  f"{form.form} splits={form.splits} grid={form.grid}: "
                  f"err={err:.3g} (tol {tol:.3g}) ms={row['ms']:.4f} "
                  f"plain_ms={row['plain_ms']:.3f} "
                  f"matmul_ms={row['library_ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; "
                  f"SIMT {row['simt_bound_ms']:.4f})")
            if not err <= tol:
                raise AssertionError(f"gemm_f32 {tag} {layer} B {bdt}: "
                                     f"error {err} > {tol}")
            del bt, bf, got, ref
        del a
    return shapes


def _f32_sums(rows, b="f32"):
    """Sums over one forward's launches of a gemm_f32 table."""
    rs = [r for r in rows if r["b"] == b]
    return {key: sum(r[key] for r in rs)
            for key in ("ms", "library_ms", "bound_ms", "simt_bound_ms")}


def phase_gemm_f32(dev, peaks_f32, bw):
    """The float form of gemm_fused at the shapes of one fp32 auto forward:
    YOLOv2-tiny b32 (the row: sums over its 5 launches, f32 B) and b1,
    YOLOv3-tiny b16 and b1, both B dtypes."""
    g = torch.Generator(device=dev).manual_seed(6)
    tabs = {"v2-b32": F32_B32_GEMMS, "v2-b1": F32_B1_GEMMS,
            "v3-b16": F32_B16_V3_GEMMS, "v3-b1": F32_B1_V3_GEMMS}
    runs = {tag: gemm_f32_shapes(g, dev, tab, peaks_f32, bw, tag)
            for tag, tab in tabs.items()}
    v2 = runs["v2-b32"]
    row = [r for r in v2 if r["b"] == "f32"]
    out = dict(
        max_abs_err=max(r["max_abs_err"] for rs in runs.values()
                        for r in rs),
        **{key: sum(r[key] for r in row)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                       "simt_bound_ms")},
        bound_by=("operations" if all(r["bound_by"] == "operations"
                                      for r in row) else "bytes"),
        sums={tag: {b: _f32_sums(rs, b) for b in ("f32", "int8")}
              for tag, rs in runs.items()},
        shapes=[r for rs in runs.values() for r in rs])
    for tag in tabs:
        for b in ("f32", "int8"):
            sm = out["sums"][tag][b]
            print(f"  gemm_f32 sums {tag} B {b} ({len(tabs[tag])} "
                  f"launches): ms={sm['ms']:.4f} matmul_ms="
                  f"{sm['library_ms']:.4f} bound_ms={sm['bound_ms']:.4f} "
                  f"(SIMT {sm['simt_bound_ms']:.4f})")
    return {"gemm_f32": out}


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

    def q_check(x, s, what, **kw):
        errs.append(check("quant_space_to_depth4",
                          fc.quant_space_to_depth4(x, s, **kw),
                          fc.quant_space_to_depth4_plain(x, s, **kw), what))

    for x, dt in ((xu, "u8"), (xf, "f32")):
        for pad_to in (0, 64):
            for pad_hw, entry in ((border, "k2"), ((0, 0, 0, 0), "k3")):
                q_check(x, s_in, f"{dt} pad_to={pad_to} {entry} entry",
                        pad_to=pad_to, pad_hw=pad_hw)
    # every byte value (the b32 batch holds each ~195,000 times) through
    # the code table, at scales that put u / 255 / s on or near a tie;
    # widths that are not multiples of 16 (a partial chunk at each end of
    # a run); rows that are not multiples of 16 bytes (W = 40: 120 bytes)
    for s in QS2D4_SCALES:
        q_check(xu, s, f"u8 s={s} k2 entry, every byte value", pad_to=64,
                pad_hw=border)
    for pad_to in (56, 72):
        q_check(xu, s_in, f"u8 pad_to={pad_to} k2 entry", pad_to=pad_to,
                pad_hw=border)
    x40 = xu[:4, :64, :40].contiguous()
    for x, dt in ((x40, "u8"), (x40.float() / 255.0, "f32")):
        q_check(x, s_in, f"(4,64,40,3) {dt} k2 entry (120-byte rows)",
                pad_to=64, pad_hw=border)
    x424 = torch.nn.functional.pad(xu, (0, 0, 1, 7, 1, 7))
    errs.append(check("quant_space_to_depth4",
                      fc.quant_space_to_depth4(x424, s_in, pad_to=64),
                      fc.quant_space_to_depth4(xu, s_in, pad_to=64,
                                               pad_hw=border),
                      "(32,424,424,3) u8 vs the border read"))
    # the b1 entries, whose rows the grid cuts into runs
    x1 = xu[:1].contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for pad_hw, entry, h4 in ((border, "S1", 106), ((0, 0, 0, 0), "S2", 104)):
        segs, run, blocks = fc.qs2d4_grid(1, h4, h4, sms)
        for x, dt in ((x1, "u8"), (x1.float() / 255.0, "f32")):
            q_check(x, s_in, f"{entry} b1 entry {dt} ({blocks} blocks, "
                    f"{segs} runs of {run} px a row)", pad_to=64,
                    pad_hw=pad_hw)
    out = fc.quant_space_to_depth4(xu, s_in, pad_to=64,
                                   pad_hw=border).numel()
    out_s2 = fc.quant_space_to_depth4(xu, s_in, pad_to=64).numel()

    def q_ms(x, **kw):
        return device_ms(lambda: fc.quant_space_to_depth4(x, s_in, **kw), 20)
    ms = q_ms(xu, pad_to=64, pad_hw=border)
    plain_ms = device_ms(lambda: fc.quant_space_to_depth4_plain(
        xu, s_in, pad_to=64, pad_hw=border), 3)
    s2_ms = q_ms(xu, pad_to=64)
    f32_ms = q_ms(xf, pad_to=64, pad_hw=border)
    x424_ms = q_ms(x424, pad_to=64)
    b1_ms = q_ms(x1, pad_to=64, pad_hw=border)
    b1_plain_ms = device_ms(lambda: fc.quant_space_to_depth4_plain(
        x1, s_in, pad_to=64, pad_hw=border), 5)
    rows["quant_space_to_depth4"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
        bound_ms=(xu.numel() + out) / bw * 1e3, bound_by="bytes",
        s2_entry_ms=s2_ms,
        s2_entry_bound_ms=(xu.numel() + out_s2) / bw * 1e3,
        f32_ms=f32_ms, f32_bound_ms=(4 * xu.numel() + out) / bw * 1e3,
        padded_424_ms=x424_ms,
        padded_424_bound_ms=(x424.numel() + out) / bw * 1e3,
        b1_ms=b1_ms, b1_plain_ms=b1_plain_ms,
        b1_bound_ms=(x1.numel() + out // 32) / bw * 1e3)
    r = rows["quant_space_to_depth4"]
    print(f"  quant_space_to_depth4 S1 entry (u8, border, 64 lanes) "
          f"ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms="
          f"{r['bound_ms']:.4f}; S2 entry {s2_ms:.4f} (bound "
          f"{r['s2_entry_bound_ms']:.4f}); f32 {f32_ms:.4f} (bound "
          f"{r['f32_bound_ms']:.4f}); padded (32,424,424,3) u8 "
          f"{x424_ms:.4f} (bound {r['padded_424_bound_ms']:.4f}); S1 b1 "
          f"{b1_ms:.4f} (plain {b1_plain_ms:.3f}, bound "
          f"{r['b1_bound_ms']:.5f})")
    del xu, xf, x424, x40, x1

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

    # --- conv3x3_rs at the four b32 shapes and S1's two b1 shapes, then
    # pool None (int8 and f32 out) and s2d_out at one shape each ---
    from dnn_inference_engine_tpu_torch.ops import _build
    sms = _build.sm_count(dev)
    shapes, errs = [], []
    for tag, xs, k, cout, co in RS_SHAPES + RS_B1_SHAPES:
        x = torch.randint(-127, 128, xs, generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, k, xs[3], cout), generator=g,
                          device=dev, dtype=torch.int8)
        scale = torch.rand(cout, generator=g, device=dev) * 2e-5 + 1e-5
        bias = torch.randn(cout, generator=g, device=dev)
        kw = dict(quantize_out=True, pool=("gmaxm", 2, co), ksize=k)
        variants = [(tag, kw)]
        if tag in ("S1 L8 rs", "S1 b1 L8 rs"):
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
        form = fc.rs_form(m, cout, co, a.shape[1], sms)
        row = dict(shape=tag, M=m, K=a.shape[1], N=cout, form=form.form,
                   tile="128x128", splits=form.splits, grid=form.grid,
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
              f"({by}); wgmma 128x128 split {form.splits} grid "
              f"{form.grid}")
        del x, w, a, wt
    s1 = [r for r in shapes if r["shape"] in ("S1 L6 rs2", "S1 L8 rs")]
    s1b1 = [r for r in shapes if r["shape"].startswith("S1 b1")]
    rows["conv3x3_rs"] = dict(
        max_abs_err=max(errs), ms=sum(r["ms"] for r in s1),
        plain_ms=sum(r["plain_ms"] for r in s1),
        library_ms=sum(r["library_ms"] for r in s1),
        bound_ms=sum(r["bound_ms"] for r in s1),
        bound_by=("operations" if all(r["bound_by"] == "operations"
                                      for r in s1) else "bytes"),
        shapes=shapes, b1_ms=sum(r["ms"] for r in s1b1),
        b1_library_ms=sum(r["library_ms"] for r in s1b1),
        b1_bound_ms=sum(r["bound_ms"] for r in s1b1))
    r = rows["conv3x3_rs"]
    print(f"  conv3x3_rs sums over S1's 2 launches: b32 ms={r['ms']:.4f} "
          f"(int_mm {r['library_ms']:.4f}, bound {r['bound_ms']:.4f}); b1 "
          f"ms={r['b1_ms']:.4f} (int_mm {r['b1_library_ms']:.4f}, bound "
          f"{r['b1_bound_ms']:.4f})")
    return rows


def phase_attic_kernels(dev, ops_peak, bw):
    """stage0_fused (through both wrappers) and conv3x3_bt against their
    plain versions on the card, and conv3x3_bt against conv3x3_rs with
    pool None, all with max error 0; timed beside their bounds and plain
    versions (conv3x3_bt also beside conv3x3_rs and ``torch._int_mm`` on
    the im2col'd A, product only). conv3x3_bt is on no detect path (the
    JAX package wires it into none): its launches are those of the b32
    tail pass, one call at each b32 shape, counted from 0."""
    from dnn_inference_engine_tpu_torch.ops import _build
    from dnn_inference_engine_tpu_torch.ops import fused_conv as fc
    from dnn_inference_engine_tpu_torch.ops.attic import stage0 as st0
    from dnn_inference_engine_tpu_torch.ops.attic import tail
    from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
        extract_patches)

    g = torch.Generator(device=dev).manual_seed(4)
    rows = {}

    def check(name, got, ref, what):
        err = max_abs_err(got, ref)
        print(f"  {name} {what}: err={err}")
        if err != 0:
            raise AssertionError(f"{name} {what}: kernel != reference")
        return err

    # --- stage0_fused: v2 at (32,416,416,3), (2,64,64,3) and
    # (1,416,416,3), v1 at (32,416,416,3) with ht 4 and 8 ---
    r = np.random.default_rng(4)
    wq = torch.as_tensor(r.integers(-127, 128, (3, 3, 3, 16)).astype(
        np.int8), device=dev)
    s_w = r.uniform(1e-3, 1e-2, 16).astype(np.float32)
    b = r.standard_normal(16).astype(np.float32)
    s_in, s_out = 0.00789, 0.0511
    wv, scale, bias = st0.stage0_params_v2(wq, s_w, b, s_in, s_out)
    bv = st0.dense_k_from_v2(wv)
    x32 = torch.rand((32, 416, 416, 3), generator=g, device=dev)
    errs = []
    for x in (x32, torch.rand((2, 64, 64, 3), generator=g, device=dev)):
        errs.append(check("stage0_fused_v2",
                          st0.stage0_fused_v2(x, wv, scale, bias, s_in),
                          st0.stage0_fused_plain(x, bv, scale, bias, s_in),
                          str(tuple(x.shape))))
    for ht in (4, 8):
        wb, _, _ = st0.stage0_params(wq, s_w, b, s_in, s_out, ht=ht)
        errs.append(check(
            "stage0_fused (v1)", st0.stage0_fused(x32, wb, scale, bias, s_in,
                                                  ht=ht),
            st0.stage0_fused_plain(x32, st0.dense_k_from_v1(wb, ht), scale,
                                   bias, s_in), f"(32,416,416,3) ht={ht}"))
    x1 = x32[:1].clone()
    errs.append(check("stage0_fused_v2",
                      st0.stage0_fused_v2(x1, wv, scale, bias, s_in),
                      st0.stage0_fused_plain(x1, bv, scale, bias, s_in),
                      str(tuple(x1.shape))))

    def s0_work(x):
        """(useful operations, executed operations, bytes) of one call on
        ``x``: the 3x3x3 conv's MACs at every input pixel; the kernel's
        dense-K product of B per fold-2 pixel; f32 input, B, scale and
        bias, int8 output."""
        n, h, w, _ = x.shape
        m = n * (h // 4) * (w // 4)
        return (2.0 * n * h * w * wq.numel(), 2.0 * m * bv.numel(),
                4 * x.numel() + bv.numel() + 8 * scale.numel()
                + m * scale.numel())
    useful, executed, nbytes = s0_work(x32)
    bound, by = _bound(useful, nbytes, ops_peak, bw)
    rows["stage0_fused"] = dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: st0.stage0_fused_v2(x32, wv, scale, bias, s_in),
                     20),
        plain_ms=device_ms(lambda: st0.stage0_fused_plain(
            x32, bv, scale, bias, s_in), 2),
        library_ms=None, bound_ms=bound, bound_by=by,
        v1_ms=device_ms(lambda: st0.stage0_fused(x32, wb, scale, bias, s_in,
                                                 ht=8), 20),
        b1_ms=device_ms(lambda: st0.stage0_fused_v2(x1, wv, scale, bias,
                                                    s_in), 50),
        b1_bound_ms=_bound(*s0_work(x1)[::2], ops_peak, bw)[0])
    r0 = rows["stage0_fused"]
    print(f"  stage0_fused b32: ms={r0['ms']:.4f} (v1 operand "
          f"{r0['v1_ms']:.4f}) plain_ms={r0['plain_ms']:.3f} bound_ms="
          f"{bound:.4f} ({by}; the dense K executes {executed:.4g} "
          f"operations, {executed / ops_peak * 1e3:.4f} ms at peak); b1 "
          f"ms={r0['b1_ms']:.4f} bound_ms={r0['b1_bound_ms']:.5f}")
    del x32, x1

    # --- conv3x3_bt at the YOLOv2-tiny tail shapes ---
    inputs = []
    for tag, xs, cout in BT_SHAPES:
        inputs.append((tag, torch.randint(
            -127, 128, xs, generator=g, device=dev, dtype=torch.int8),
            torch.randint(-127, 128, (3, 3, xs[3], cout), generator=g,
                          device=dev, dtype=torch.int8),
            torch.rand(cout, generator=g, device=dev) * 2e-5 + 1e-5,
            torch.randn(cout, generator=g, device=dev)))
    tail.conv3x3_bt.launches = 0
    for tag, x, w, scale, bias in inputs:
        if tag.endswith("b32"):
            tail.conv3x3_bt(x, w, scale, bias)
    torch.cuda.synchronize()
    tail_launches = tail.conv3x3_bt.launches
    if tail_launches != 4:
        raise AssertionError(f"b32 tail pass: {tail_launches} launches")
    shapes, errs = [], []
    for tag, x, w, scale, bias in inputs:
        variants = [("int8", dict(quantize_out=True))]
        if tag == "L12 b32":
            variants.append(("f32", dict(quantize_out=False)))
        for what, kw in variants:
            got = tail.conv3x3_bt(x, w, scale, bias, **kw)
            errs.append(check("conv3x3_bt", got, tail.conv3x3_bt_plain(
                x, w, scale, bias, **kw), f"{tag} {what} vs plain"))
            errs.append(check("conv3x3_bt", got, fc.conv3x3_rs(
                x, w, scale, bias, **kw), f"{tag} {what} vs conv3x3_rs"))
        n, h, wd, cin = x.shape
        cout = int(w.shape[3])
        m, k = n * h * wd, 9 * cin
        a = extract_patches(x, 3, 3, 1, "SAME").reshape(m, k)
        wt = fc.rs_weight_matrix(w)
        bound, by = _bound(2.0 * m * k * cout,
                           x.numel() + w.numel() + 8 * cout + m * cout,
                           ops_peak, bw)
        form = tail.bt_form(m, cout, cin, _build.sm_count(dev))
        row = dict(
            shape=tag, M=m, K=k, N=cout, splits=form.splits, grid=form.grid,
            ms=device_ms(lambda: tail.conv3x3_bt(x, w, scale, bias), 10),
            plain_ms=device_ms(lambda: tail.conv3x3_bt_plain(
                x, w, scale, bias), 2),
            rs_ms=device_ms(lambda: fc.conv3x3_rs(x, w, scale, bias), 10),
            library_ms=device_ms(lambda: torch._int_mm(a, wt.t()), 10),
            bound_ms=bound, bound_by=by)
        shapes.append(row)
        print(f"  conv3x3_bt {tag} M={m} K={k} N={cout}: ms={row['ms']:.4f} "
              f"rs_ms={row['rs_ms']:.4f} plain_ms={row['plain_ms']:.3f} "
              f"int_mm_ms={row['library_ms']:.4f} bound_ms={bound:.4f} "
              f"({by}); 128x128 split {form.splits} grid {form.grid}")
        del a, wt
    b32 = [r for r in shapes if r["shape"].endswith("b32")]
    rows["conv3x3_bt"] = dict(
        max_abs_err=max(errs),
        **{key: sum(r[key] for r in b32)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms", "rs_ms")},
        bound_by=("operations" if all(r["bound_by"] == "operations"
                                      for r in b32) else "bytes"),
        shapes=shapes)
    r0 = rows["conv3x3_bt"]
    print(f"  conv3x3_bt sums over the b32 tail pass's 4 launches: "
          f"ms={r0['ms']:.4f} rs_ms={r0['rs_ms']:.4f} bound_ms="
          f"{r0['bound_ms']:.4f}")
    return rows, tail_launches


def phase_dma_kernels(dev, ops_peak, bw):
    """The copy-engine tools as a user runs them (the path of conv_dma and
    tma_probe: their counters set to 0 just before, read just after; each
    main raises on a mismatch), then each kernel against its plain version
    with max error 0: conv_dma at (32,104,104,64) -> 128, go 32, for each
    ht of the tool, also against conv3x3_rs ('gmaxm', scale and bias tiled
    4x), timed beside them and ``torch._int_mm`` on the im2col'd A
    (product only); tma_probe on every case the encode accepts, timed on
    the largest box inside its source beside a slice's ``clone``."""
    from dnn_inference_engine_tpu_torch.ops import _build
    from dnn_inference_engine_tpu_torch.ops import fused_conv as fc
    from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
        extract_patches)
    from dnn_inference_engine_tpu_torch.tools import probe_dma_rules as pr
    from dnn_inference_engine_tpu_torch.tools import proto_conv_dma as pc

    pr.probe.launches = pc.conv_dma.launches = 0
    pr.main([])
    pc.main([])
    torch.cuda.synchronize()
    launches = {"tma_probe": pr.probe.launches,
                "conv_dma": pc.conv_dma.launches}
    print(f"  tools' path launches: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"the tools' path skipped a kernel: {launches}")

    def check(name, got, ref, what):
        err = max_abs_err(got, ref)
        print(f"  {name} {what}: err={err}")
        if err != 0:
            raise AssertionError(f"{name} {what}: kernel != reference")
        return err

    rows = {}
    g = torch.Generator(device=dev).manual_seed(5)
    n, h, wd, cin, go = pc.N, pc.H, pc.W, pc.CIN, pc.GO
    x = torch.randint(-127, 128, (n, h, wd, cin), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 3, cin, 4 * go), generator=g,
                      device=dev, dtype=torch.int8)
    scale = torch.rand(go, generator=g, device=dev) * 2e-5 + 1e-5
    bias = torch.randn(go, generator=g, device=dev)
    s4, b4 = scale.repeat(4), bias.repeat(4)
    ref = pc.conv_dma_plain(x, w, scale, bias)
    rs = fc.conv3x3_rs(x, w, s4, b4, pool=("gmaxm", 2, go))
    errs = [check("conv3x3_rs", rs, ref, "vs conv_dma_plain")]
    sms = _build.sm_count(dev)
    f = pc.conv_dma_form(n, h, wd, cin, go, sms)
    for ht in pc.HTS:
        got = pc.conv_dma(x, w, scale, bias, ht=ht)
        errs.append(check("conv_dma", got, ref, f"ht {ht} vs plain"))
        errs.append(check("conv_dma", got, rs, f"ht {ht} vs conv3x3_rs"))
    # ht does not shape the launch: one time stands for every ht
    ht = pc.HTS[0]
    m, k = n * h * wd, 9 * cin
    a = extract_patches(x, 3, 3, 1, "SAME").reshape(m, k)
    wt = fc.rs_weight_matrix(w)
    bound, by = _bound(2.0 * m * k * 4 * go,
                       x.numel() + w.numel() + 8 * go + ref.numel(),
                       ops_peak, bw)
    rows["conv_dma"] = dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: pc.conv_dma(x, w, scale, bias, ht=ht), 10),
        plain_ms=device_ms(lambda: pc.conv_dma_plain(x, w, scale, bias), 2),
        library_ms=device_ms(lambda: torch._int_mm(a, wt.t()), 10),
        bound_ms=bound, bound_by=by,
        rs_ms=device_ms(lambda: fc.conv3x3_rs(x, w, s4, b4,
                                              pool=("gmaxm", 2, go)), 10))
    r = rows["conv_dma"]
    print(f"  conv_dma ({n},{h},{wd},{cin}) -> {4 * go}, go {go} (M={m} "
          f"K={k}), every ht of {pc.HTS}: tile {pc.TR}x{pc.TC}, {f.units} "
          f"units on {f.grid} blocks: ms={r['ms']:.4f} rs_ms="
          f"{r['rs_ms']:.4f} plain_ms={r['plain_ms']:.3f} int_mm_ms="
          f"{r['library_ms']:.4f} bound_ms={bound:.4f} ({by})")
    del x, w, a, wt, ref, rs

    errs, largest = [], None
    for case in pr.CASES:
        src = pr.case_source(case, dev)
        v = pr.probe(src, case.start, case.box)
        if v.out is None:
            continue
        errs.append(check("tma_probe", v.out, pr.probe_plain(
            src, case.start, case.box), case.name))
        inside = all(0 <= s and s + b <= d for s, b, d in
                     zip(case.start, case.box, case.shape))
        if inside and (largest is None
                       or v.out.numel() > largest[0].out.numel()):
            largest = (v, case, src)
    v, case, src = largest
    sl = tuple(slice(s, s + b) for s, b in zip(case.start, case.box))
    nbytes = v.out.numel()
    rows["tma_probe"] = dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: pr.probe(src, case.start, case.box), 20),
        plain_ms=device_ms(lambda: pr.probe_plain(src, case.start, case.box),
                           20),
        library_ms=device_ms(lambda: src[sl].clone(), 20),
        bound_ms=2 * nbytes / bw * 1e3, bound_by="bytes",
        timed_case=case.name, box_bytes=nbytes)
    r = rows["tma_probe"]
    print(f"  tma_probe {case.name} ({nbytes} bytes): ms={r['ms']:.4f} "
          f"plain_ms={r['plain_ms']:.4f} clone_ms={r['library_ms']:.4f} "
          f"bound_ms={r['bound_ms']:.6f} (bytes)")
    return rows, launches


class GemmShapes:
    """While active, records the (M, K, N) of every ``gemm_fused`` call:
    each module of the port that holds the wrapper gets a recorder in its
    place, which calls the wrapper (so its counters still count)."""

    def __enter__(self):
        from dnn_inference_engine_tpu_torch.ops import gemm as gm
        self.fn, self.shapes, self.mods = gm.gemm_fused, [], []

        def record(a, bt, *args, **kw):
            self.shapes.append((int(a.shape[0]), int(a.shape[1]),
                                int(bt.shape[0])))
            return self.fn(a, bt, *args, **kw)
        # the wrapper counts through its module's name, the recorder here
        record.launches = record.ragged_launches = 0
        record.folded_launches = 0
        for name, mod in list(sys.modules.items()):
            if (name.startswith("dnn_inference_engine_tpu_torch.")
                    and getattr(mod, "gemm_fused", None) is self.fn):
                mod.gemm_fused = record
                self.mods.append(mod)
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.gemm_fused = self.fn


class ConvCheck:
    """While active, keeps the inputs and output of every ``conv2d_w8a8``
    call that launches the conv_w8a8 kernel or the small-Cin kernel
    (conv_w8a8_rows), and of every ``conv2d_w8a8_u8`` call (the small-Cin
    kernel on the uint8 wire): each module of the port that calls a
    wrapper, but ops/conv.py itself, gets a recorder in its place, so the
    wrapper's own counters still count; ``verify`` then holds each output
    to its plain version (``conv2d_w8a8_plain``, ``conv2d_w8a8_u8_plain``)
    on the same inputs, bit for bit."""

    def __enter__(self):
        from dnn_inference_engine_tpu_torch.ops import conv as cv
        self.cv, self.calls, self.mods = cv, [], []
        self.fns = {"conv2d_w8a8": cv.conv2d_w8a8,
                    "conv2d_w8a8_u8": cv.conv2d_w8a8_u8}

        def launched():
            return cv.conv2d_w8a8.launches + cv.conv_w8a8_rows.launches

        def recorder(name):
            fn = self.fns[name]

            def record(*args, **kw):
                before = launched()
                out = fn(*args, **kw)
                if launched() != before:
                    self.calls.append((name, args, kw, out))
                return out
            return record
        for mname, mod in list(sys.modules.items()):
            if not mname.startswith("dnn_inference_engine_tpu_torch.") \
                    or mod is cv:
                continue
            for name, fn in self.fns.items():
                if getattr(mod, name, None) is fn:
                    setattr(mod, name, recorder(name))
                    self.mods.append((mod, name))
        return self

    def __exit__(self, *exc):
        for mod, name in self.mods:
            setattr(mod, name, self.fns[name])

    def plain(self, name, args, kw):
        if name == "conv2d_w8a8":
            return self.cv.conv2d_w8a8_plain(*args, **kw)
        xu, e, *rest = args
        return self.cv.conv2d_w8a8_u8_plain(xu, e.s_in, *rest, **kw)

    def verify(self, tag: str, want: int, want_u8: int = 0):
        n_u8 = sum(c[0] == "conv2d_w8a8_u8" for c in self.calls)
        if len(self.calls) != want or n_u8 != want_u8:
            raise AssertionError(f"{tag}: {len(self.calls)} conv_w8a8 and "
                                 f"conv_w8a8_rows launches checked ({n_u8} "
                                 f"on the uint8 wire), {want} ({want_u8}) "
                                 f"expected")
        for i, (name, args, kw, out) in enumerate(self.calls):
            ref = self.plain(name, args, kw)
            if not torch.equal(out, ref):
                raise AssertionError(
                    f"{tag}: {name} launch {i} ({tuple(args[0].shape)} x "
                    f"{tuple(args[2].shape)}) != its plain version in "
                    f"{int((out != ref).sum())} codes")
        print(f"{tag}: every conv_w8a8 and conv_w8a8_rows launch of the "
              f"detect ({len(self.calls)}, {n_u8} on the uint8 wire) equals "
              f"its plain version bit for bit")


class XlaTierIm2col:
    """While active, counts the im2col copies of the xla tier's W8A8 conv
    (``ops/conv.py``'s ``extract_patches``, a 1x1 conv's view included):
    on the plans' paths there are none, every 3x3 conv reads its input in
    place on conv_w8a8. The gemm tier's im2col (``conv_lowering``) is not
    counted."""

    def __enter__(self):
        from dnn_inference_engine_tpu_torch.ops import conv as cv
        self.fn, self.calls = cv.extract_patches, 0

        def record(*args, **kw):
            self.calls += 1
            return self.fn(*args, **kw)
        cv.extract_patches = record
        return self

    def __exit__(self, *exc):
        from dnn_inference_engine_tpu_torch.ops import conv as cv
        cv.extract_patches = self.fn


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


def _iou(box, boxes):
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)

    def area(b):
        return np.prod(np.clip(b[..., 2:] - b[..., :2], 0, None), axis=-1)
    return inter / np.maximum(area(box) + area(boxes) - inter, 1e-12)


def _candidates(model: str, heads):
    """Every candidate box of each image (xyxy, (B,M,4)) and its largest
    class score ((B,M)), decoded on the CPU from ``heads`` as
    ``Engine.postprocess`` decodes them before the NMS."""
    from dnn_inference_engine_tpu_torch.config import (
        YOLOV2_TINY_ANCHORS, YOLOV3_TINY_ANCHORS)
    from dnn_inference_engine_tpu_torch.postprocess import (
        decode_yolov2_cols, decode_yolov3_cols)
    hs = [torch.from_numpy(np.ascontiguousarray(h)) for h in heads]
    if model == "yolov3-tiny":
        parts = [decode_yolov3_cols(hs[0], YOLOV3_TINY_ANCHORS[3:]),
                 decode_yolov3_cols(hs[1], YOLOV3_TINY_ANCHORS[:3])]
        boxes = torch.cat([b for b, _ in parts], dim=-1)
        scores = torch.cat([sc for _, sc in parts], dim=-1)
    else:
        boxes, scores = decode_yolov2_cols(hs[0], YOLOV2_TINY_ANCHORS)
    c = boxes.numpy()
    xyxy = np.stack([c[:, 0] - c[:, 2] * np.float32(0.5),
                     c[:, 1] - c[:, 3] * np.float32(0.5),
                     c[:, 0] + c[:, 2] * np.float32(0.5),
                     c[:, 1] + c[:, 3] * np.float32(0.5)], axis=-1)
    return xyxy, scores.numpy().max(axis=1)


def detections_close(det_a, det_b, cand_a, cand_b, head_atol, cfg):
    """Detections of two engines as sets, within the heads' tolerance.

    A detection matches one of the other engine's with its class, its score
    within ``head_atol`` and its box within ``head_atol * (8 px + its
    larger side)`` (a logit moves a box centre by at most 8 px, a side by
    the side itself). One without a match is explained by an event within
    the tolerance (the first five are printed): its score at the score
    threshold; an NMS tie (the other engine kept an overlapping box of its
    class, IoU above the NMS threshold, whose score is within
    ``head_atol``); an overlap at the NMS threshold (the other engine kept
    a box of its class scored at least as high, less ``head_atol``, whose
    IoU with it lies within ``4 * head_atol`` of the threshold: a relative
    move of ``head_atol`` in each side of two boxes moves their IoU by
    about 4 times that); or its box's largest class score at either
    engine's cut of the NMS candidate pool (``cand_*``: the decoded
    candidates). Greedy NMS carries an event on: after a threshold or tie
    event the other unmatched detections of that class in that image are
    explained by it, after a pool event every unmatched one in that image.
    Any other unmatched detection fails. Returns the counts by reason."""
    counts = dict(matched=0, threshold=0, tie=0, overlap=0, pool=0,
                  carried=0)
    topk = cfg.resolved_nms_topk()
    sides = ((det_a, cand_a), (det_b, cand_b))
    for i in range(len(det_a[1])):
        cuts = []
        for _, (_, top) in sides:
            t = np.sort(top[i])[::-1]
            cuts.append(t[topk - 1] if len(t) > topk else -np.inf)
        flagged_img, flagged_cls, open_ = False, set(), []
        for me, (d1, (cb, cs)) in enumerate(sides):
            b1, s1, c1 = (x[i] for x in d1)
            b2, s2, c2 = (x[i] for x in sides[1 - me][0])
            for d in np.flatnonzero(s1 > 0):
                side = max(b1[d][2] - b1[d][0], b1[d][3] - b1[d][1])
                same = (c2 == c1[d]) & (s2 > 0)
                close = same & (np.abs(s2 - s1[d]) <= head_atol)
                if (close & (np.abs(b2 - b1[d]).max(axis=-1)
                             <= head_atol * (8 + side))).any():
                    counts["matched"] += 1
                    continue
                m = int(np.abs(cb[i] - b1[d]).max(axis=-1).argmin())
                top = cs[i][m]
                if any(abs(top - cut) <= 2 * head_atol for cut in cuts):
                    why = "pool"
                    flagged_img = True
                elif abs(s1[d] - cfg.score_thresh) <= head_atol:
                    why = "threshold"
                elif (close & (_iou(b1[d], b2) > cfg.nms_iou_thresh)).any():
                    why = "tie"
                elif (same & (s2 >= s1[d] - head_atol)
                      & (np.abs(_iou(b1[d], b2) - cfg.nms_iou_thresh)
                         <= 4 * head_atol)).any():
                    why = "overlap"
                else:
                    other = cand_b if me == 0 else cand_a
                    ov = _iou(b1[d], b2)
                    open_.append((d, c1[d], s1[d], b1[d], (
                        f"its box's top score {top:.6f} here, "
                        f"{other[1][i][m]:.6f} there; pool cuts "
                        f"{cuts[0]:.6f} / {cuts[1]:.6f}; the other "
                        "engine's boxes of its class (score, IoU): "
                        + str([(round(float(s2[j]), 4), round(float(ov[j]),
                                                              4))
                               for j in np.flatnonzero(same & (ov > 0.2))]))
                    ))
                    continue
                flagged_cls.add(int(c1[d]))
                counts[why] += 1
                if sum(counts.values()) - counts["matched"] <= 5:
                    print(f"    image {i}: score {s1[d]:.6f} of class "
                          f"{c1[d]} unmatched: {why} (its box's top score "
                          f"{top:.6f}, pool cuts {cuts[0]:.6f} / "
                          f"{cuts[1]:.6f})")
        for d, c, sc, b, why in open_:
            if flagged_img or int(c) in flagged_cls:
                counts["carried"] += 1
                continue
            raise AssertionError(f"image {i}: detection {d} (score {sc}, "
                                 f"class {c}, box {b}) has no counterpart "
                                 f"and no event explains it: {why}")
    return counts


def phase_card_vs_cpu(model: str, batch: int, check_calibration: bool,
                      strategy=None, mode="w8a8", kernel="auto",
                      rel_tol=0.0, strategy_path=None):
    """416 px: the card engine against a CPU engine (plain versions) with
    the card's weights and scales; under the pinned plan, or under
    STRATEGIES[strategy] (or the file ``strategy_path``). ``rel_tol`` 0:
    heads identical and detections equal; else heads within ``rel_tol``
    of the largest head magnitude and detections as equal sets within
    that (``detections_close``)."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine

    # serving threshold and capped NMS pool; room for every survivor
    # (YOLOv3's sigmoid class scores keep up to 20 classes x 256 of them)
    t0 = time.time()
    path = strategy_path or (strategy and strategy_file(strategy))
    cfg = EngineConfig(model=model, mode=mode, kernel=kernel, batch=batch,
                       max_detections=MAX_DET_CHECKED[model], strategy=path)
    gpu = Engine(cfg).load_weights(seed=0).prepare()
    fp32 = [{k: v.cpu().numpy() for k, v in p.items()}
            for p in gpu.fp32_params]
    cpu = Engine(cfg, device="cpu").load_weights(
        params=fp32, act_scales=gpu.act_scales).prepare()
    imgs = np.random.default_rng(1).integers(
        0, 256, (batch, 416, 416, 3)).astype(np.uint8)
    x = gpu._device_batch(imgs)
    # one card forward gives both the heads and the detections compared
    dev_heads = gpu._fwd(x)
    repeat = all(torch.equal(a, b) for a, b in zip(
        _heads(dev_heads), _heads(gpu._fwd(x))))
    hg = tuple(h.cpu().numpy() for h in _heads(dev_heads))
    hc = _heads(cpu.classify(imgs))
    want = [(batch,) + s for s in HEAD_SHAPES[model]]
    if ([h.shape for h in hg] != want
            or not all(np.isfinite(h).all() for h in hg)):
        raise AssertionError(f"bad heads {[h.shape for h in hg]}")
    head_atol = rel_tol * max(float(np.abs(h).max()) for h in hc)
    diffs = [float(np.abs(a - b).max()) for a, b in zip(hg, hc)]
    for i, (a, b) in enumerate(zip(hg, hc)):
        if not (np.array_equal(a, b) if rel_tol == 0
                else diffs[i] <= head_atol):
            raise AssertionError(f"{model} b{batch} card head {i} != CPU "
                                 f"head: max diff {diffs[i]} (tolerance "
                                 f"{head_atol})")
    bg, sg, cg = (t.cpu().numpy() for t in gpu.postprocess(dev_heads))
    bc, sc, cc = cpu.detect(imgs)
    ng, nc = (sg > 0).sum(axis=1), (sc > 0).sum(axis=1)
    near = {}
    if rel_tol == 0:
        if not (np.array_equal(ng, nc) and np.array_equal(cg, cc)
                and np.abs(bg - bc).max() <= 1e-3):
            raise AssertionError(f"{model} b{batch} detections differ: "
                                 f"survivors {ng} vs {nc}, box diff "
                                 f"{np.abs(bg - bc).max()}")
    else:
        # the card's own heads through the CPU's decode + NMS: the same
        # sets up to the decode's roundings (CUDA's exp and sigmoid against
        # the CPU's, an ulp or so: DECODE_ATOL)
        own = cpu.postprocess(tuple(torch.from_numpy(h) for h in hg)
                              if len(hg) > 1 else torch.from_numpy(hg[0]))
        cand_g = _candidates(model, hg)
        same = detections_close((bg, sg, cg), tuple(t.numpy() for t in own),
                                cand_g, cand_g, DECODE_ATOL, cfg)
        print(f"  {model} {mode} b{batch}: the card's detections against "
              f"the CPU's decode + NMS of the card's heads, by reason "
              f"{same}")
        near = detections_close((bg, sg, cg), (bc, sc, cc), cand_g,
                                _candidates(model, hc), head_atol, cfg)
    plan = ([st.kind for st in gpu._plan] if gpu._plan is not None
            else f"generic kernel={kernel}")
    print(f"card vs CPU {model} {mode} {strategy or 'pin'} @416 b{batch} "
          f"({plan}): {len(hg)} heads "
          + ("identical" if rel_tol == 0 else
             f"max diff {diffs} within {head_atol:.4g} ({rel_tol:.3g} of "
             f"the largest)")
          + f", survivors {ng.tolist()} vs {nc.tolist()}"
          + (f"; detections by reason {near}" if near else
             f", box max diff {float(np.abs(bg - bc).max())}")
          + f"; a second card forward identical: {repeat}"
          + f" [{time.time() - t0:.1f} s]")
    if check_calibration:
        # the same noise batch, calibrated on the CPU
        ref = Engine(cfg, device="cpu").load_weights(params=fp32).prepare()
        rel = np.abs(np.array(gpu.act_scales) / np.array(ref.act_scales) - 1)
        eps = float(np.finfo(np.float32).eps)
        print(f"calibration card vs CPU: max relative diff {rel.max()} "
              f"({rel.max() / eps:.1f} float32 eps)")
        if rel.max() > 32 * eps:
            raise AssertionError("card calibration != CPU calibration")
    return gpu


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
                    strategy=None, mode="w8a8", gemms=None):
    """Build the engine (pinned plan, or STRATEGIES[strategy]; in fp32 the
    default ``EngineConfig()``'s generic auto forward), drive detect once
    with the launch counters set to 0 just before and read just after
    (they must equal ``want``, every counter named; in W8A8 no
    ``gemm_fused`` launch may take the ragged form), then time it and
    break its device time down. ``gemms``: the (layer, M, K, N) table the
    detect's ``gemm_fused`` calls must match, in order (a second detect,
    under ``GemmShapes``)."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine

    # every detect ends in one NMS suppress launch
    want = {**dict.fromkeys(kernel_counters(), 0), "nms_suppress": 1, **want}
    cfg = EngineConfig(model=model, batch=batch,
                       strategy=strategy and strategy_file(strategy))
    if mode != cfg.mode:
        cfg = EngineConfig(model=model, mode=mode, batch=batch,
                           strategy=cfg.strategy)
    eng = Engine(cfg).load_weights(seed=0).prepare()
    imgs = np.random.default_rng(2).integers(
        0, 256, (batch, 416, 416, 3)).astype(np.uint8)
    x = torch.as_tensor(imgs).cuda()
    reset_counts()
    with XlaTierIm2col() as im2col:
        b, s, c = eng.detect(imgs)
        torch.cuda.synchronize()
    counts = read_counts()
    tag = f"{model} {mode} {strategy or 'pin'} b{batch}"
    if b.shape != (batch, 128, 4) or not np.isfinite(b).all():
        raise AssertionError(f"{tag}: bad detections {b.shape}")
    if counts != want:
        raise AssertionError(f"{tag} launches {counts} != {want}")
    if im2col.calls or cv.conv2d_w8a8.im2col_launches:
        raise AssertionError(f"{tag}: {im2col.calls} im2col copies on the "
                             f"xla tier, {cv.conv2d_w8a8.im2col_launches} "
                             f"conv2d_w8a8 calls on its im2col route")
    if mode == "w8a8" and gm.gemm_fused.ragged_launches:
        raise AssertionError(f"{tag}: {gm.gemm_fused.ragged_launches} "
                             f"gemm_fused launches took the ragged form")
    if gm.gemm_f32.ragged_launches:
        raise AssertionError(f"{tag}: {gm.gemm_f32.ragged_launches} "
                             f"gemm_f32 launches took the ragged form")
    if gemms is not None:
        with GemmShapes() as rec:
            eng.detect(imgs)
        if sorted(rec.shapes) != sorted(tuple(r[1:]) for r in gemms):
            raise AssertionError(f"{tag}: gemm_fused shapes {rec.shapes} "
                                 f"!= the table's {gemms}")
        print(f"{tag}: the detect's gemm_fused (M, K, N) equal the table's")
    if mode == "w8a8":
        with ConvCheck() as chk:
            eng.detect(imgs)
            torch.cuda.synchronize()
        chk.verify(tag, want["conv_w8a8"] + want["conv_w8a8_rows"])
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
          f"back-to-back forward; conv_w8a8 {groups['conv_w8a8']:.4f} = "
          f"{groups['conv_w8a8'] / busy:.2f} of the busy [{card}]")
    print(f"{tag} device operations per forward: "
          + ", ".join(f"{g} {n:g}" for g, n in ops.items())
          + f"; total {sum(ops.values()):g} [{card}]")
    print(f"{tag} back to back: forward {t['fwd_tp']:.3f} ms = "
          f"{batch * 1e3 / t['fwd_tp']:.1f} img/s, detect {t['det_tp']:.3f} "
          f"ms = {batch * 1e3 / t['det_tp']:.1f} img/s; latency (median of "
          f"20, synced): forward {t['fwd_lat']:.3f} ms, detect "
          f"{t['det_lat']:.3f} ms [{card}]")
    return counts


# scores decoded from the same heads on the card and on the CPU: the
# exp and sigmoid of the two round differently by an ulp or so
DECODE_ATOL = 1e-6
# the tolerances of card against CPU, as a share of the largest head
# magnitude: fp32 and the strict f32 w8 tier sum in float32 in another
# order (cuDNN with TF32 off, gemm_f32) than the CPU (MKL-DNN, float64
# products in gemm_f32_plain); the w8 plan rounds every conv input to
# bf16, so where the card's and the CPU's sums straddle a bf16 rounding
# edge a value moves by a bf16 ulp (2**-8) and the move spreads
F32_REL_TOL = 2.0 ** -12
BF16_REL_TOL = 2.0 ** -7
# an illegal strategy: fold_xla_s2 must feed a fold_xla_k2 stage (C1)
ILLEGAL_STRATEGY = {"2": ["fold_xla_s2", 2], "4": ["xla", 1]}


def _generic_counts(gpu, tag: str, want: dict, want_folded: int):
    """One classify of a b2 batch with the counters from 0: the launches
    must equal ``want`` (the others 0), ``want_folded`` of the int8 GEMMs
    must be in the folded order, the gemm tier's, and no W8A8 conv of the
    xla tier may take conv2d_w8a8's im2col route (the entry conv, Cin 3,
    runs conv_w8a8_rows)."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    imgs = np.random.default_rng(4).integers(
        0, 256, (2, 416, 416, 3)).astype(np.uint8)
    reset_counts()
    gpu.classify(imgs)
    torch.cuda.synchronize()
    counts, folded = read_counts(), gm.gemm_fused.folded_launches
    im2col = cv.conv2d_w8a8.im2col_launches
    want = {**dict.fromkeys(kernel_counters(), 0), **want}
    print(f"  {tag}: launches per forward {counts}, folded-order (gemm "
          f"tier) gemm_fused {folded}, conv2d_w8a8 im2col route {im2col}")
    if gm.gemm_f32.ragged_launches:
        raise AssertionError(f"{tag}: a gemm_f32 launch took the ragged "
                             f"form")
    if counts != want or folded != want_folded or im2col:
        raise AssertionError(f"{tag}: launches {counts}, folded {folded}, "
                             f"im2col {im2col} != {want}, {want_folded}, 0")


def phase_modes_card_vs_cpu():
    """The fp32 and w8 engines and the generic W8A8 tiers, card against
    CPU at 416 px, b2: fp32 (kernel auto: cuDNN and gemm_f32) within
    F32_REL_TOL, the w8 plans within BF16_REL_TOL, W8A8 with kernel xla
    and pallas and the C1 fallback from an illegal strategy file bit for
    bit, each with its launch counts: the xla tier's entry conv (Cin 3)
    on conv_w8a8_rows, no im2col route; the fallback's ``auto`` takes the
    gemm tier exactly where use_pallas says so (there the convs that
    requantize run in the folded order; a head is f32 in both tiers)."""
    from dnn_inference_engine_tpu_torch.models import build_model
    from dnn_inference_engine_tpu_torch.ops.dispatch import tier_report

    def tiers(model):
        m = build_model(model)
        report = tier_report(m, batch=2)
        quant = [li for li, _, _ in report if m.layers[li].act != "linear"]
        deep = [li for li, _, t in report if t == "pallas"]
        # the xla tier's convs that conv_w8a8 takes: 3x3 (stride 1 in
        # both models) with Cin % 16 == 0, requantizing; the entry conv
        # (Cin 3) takes conv_w8a8_rows
        kern = [li for li, d, _ in report if li in quant
                and d.startswith("conv3x3")
                and int(d.split()[1].split("->")[0]) % 16 == 0]
        entry = [li for li, d, _ in report
                 if int(d.split()[1].split("->")[0]) % 16]
        return len(report), quant, deep, kern, entry

    for model in ("yolov2-tiny", "yolov3-tiny"):
        n, quant, deep, kern, entry = tiers(model)
        gpu = phase_card_vs_cpu(model, 2, False, mode="fp32",
                                rel_tol=F32_REL_TOL)
        _generic_counts(gpu, f"{model} fp32 auto", {"gemm_f32": len(deep)},
                        0)
        phase_card_vs_cpu(model, 2, False, mode="w8", rel_tol=BF16_REL_TOL)
        gpu = phase_card_vs_cpu(model, 2, False, mode="w8a8", kernel="xla")
        _generic_counts(gpu, f"{model} w8a8 xla",
                        {"conv_w8a8": len(kern), "conv_w8a8_rows": len(entry),
                         "gemm_fused": n - len(kern) - len(entry)}, 0)
        gpu = phase_card_vs_cpu(model, 2, False, mode="w8a8",
                                kernel="pallas")
        _generic_counts(gpu, f"{model} w8a8 pallas", {"gemm_fused": n},
                        len(quant))
    n, quant, deep, kern, entry = tiers("yolov2-tiny")
    path = strategies_dir() / "illegal.json"
    path.write_text(json.dumps({"strategy": ILLEGAL_STRATEGY}))
    gpu = phase_card_vs_cpu("yolov2-tiny", 2, False, mode="w8a8",
                            strategy_path=str(path))
    if gpu._plan is not None:
        raise AssertionError("the illegal strategy built a plan")
    xla_kern = [li for li in kern if li not in deep]
    xla_entry = [li for li in entry if li not in deep]
    _generic_counts(gpu, "yolov2-tiny w8a8 C1 fallback (auto)",
                    {"conv_w8a8": len(xla_kern),
                     "conv_w8a8_rows": len(xla_entry),
                     "gemm_fused": n - len(xla_kern) - len(xla_entry)},
                    len(set(deep) & set(quant)))


def phase_w8_pallas_forward(card: str):
    """``Model.forward(mode="w8", kernel="pallas")`` at 416 px, b2: every
    conv is im2col + gemm_f32 with int8 codes (the f32 x int8 form),
    card against CPU within F32_REL_TOL, one gemm_f32 launch a conv."""
    from dnn_inference_engine_tpu_torch.models import build_model
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    from dnn_inference_engine_tpu_torch.quant.quantize import (
        quantize_model_params)
    for name in ("yolov2-tiny", "yolov3-tiny"):
        model = build_model(name)
        fp32 = model.init_params(torch.Generator().manual_seed(0), "cpu")
        q = quantize_model_params(fp32, model.layers)
        qg = [{k: v.cuda() for k, v in p.items()} for p in q]
        x = torch.rand((2, 416, 416, 3),
                       generator=torch.Generator().manual_seed(5))
        ref = _heads(model.forward(q, x, mode="w8", kernel="pallas"))
        reset_counts()
        got = _heads(model.forward(qg, x.cuda(), mode="w8",
                                   kernel="pallas"))
        torch.cuda.synchronize()
        counts = read_counts()
        ragged = gm.gemm_f32.ragged_launches
        convs = sum(1 for p in q if "wq" in p)
        atol = F32_REL_TOL * max(float(h.abs().max()) for h in ref)
        diffs = [float((g.cpu() - r).abs().max()) for g, r in zip(got, ref)]
        print(f"w8 kernel=pallas forward {name} @416 b2: head diffs {diffs}"
              f" (tolerance {atol:.4g}); launches {counts}, of them the "
              f"ragged form (layer 0, K = 27) {ragged} [{card}]")
        if max(diffs) > atol or ragged != 1 or counts != {
                **dict.fromkeys(kernel_counters(), 0), "gemm_f32": convs}:
            raise AssertionError(f"w8 pallas forward {name}: diffs {diffs},"
                                 f" launches {counts}")


def compare_stage(card: str, strategy: str, si: int, entry):
    """Stage ``si`` of STRATEGIES[strategy] at b32 against stage ``si`` of
    the pinned b32 plan, both run on the entry state ``(x, scale, fold)``
    that ``entry(engine)`` gives: device busy time per stage call
    (``torch.profiler``) and time between CUDA events (host launch gaps
    and scale uploads included). Returns the two stages' outputs."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    from dnn_inference_engine_tpu_torch.runtime.plan import (
        _run_stage, build_plan, prepare_plan_params)

    eng = Engine(EngineConfig(mode="w8a8", batch=32, strategy=strategy_file(
        strategy))).load_weights(seed=0).prepare()
    x, cs, cf = entry(eng)
    pin = build_plan(eng.model, batch=32)
    pin_pp = prepare_plan_params(eng.model, eng.params, pin[:si + 1])
    stages = {strategy: (eng._plan[si], eng._plan_params[si]),
              "pin": (pin[si], pin_pp[si])}
    outs = []
    for tag, (st, pp) in stages.items():
        if st.conv_li != pin[si].conv_li:
            raise AssertionError(f"{tag} stage {si} is not the pin's: {st}")

        def fn(st=st, pp=pp):
            return _run_stage(eng.model.layers, st, pp, x, cs, cf,
                              eng.act_scales)
        y, _, fold = fn()
        outs.append(y)
        groups, _ = device_breakdown(fn, reps=10)
        busy = sum(groups.values())
        print(f"{tag} stage {si} ({st.kind}) at b32, entry "
              f"{tuple(x.shape)} {x.dtype} fold {cf} -> {tuple(y.shape)} "
              f"fold {fold}: device busy {busy:.4f} ms per call ("
              + ", ".join(f"{g} {v:.4f}" for g, v in groups.items() if v)
              + f"); between events {latency_ms(fn, 20):.4f} ms [{card}]")
    return outs


def phase_stage_compare(card: str):
    """S2's stage 1 (L2 as ``rs``: conv3x3_rs reads the fold-2 tensor, no
    im2col) against the pinned plan's L2 stage (``fold_xla``: conv_w8a8
    with its group-max, no im2col either) on S2's b32 entry state; S3's
    stage 0 (``s0``: stage0_fused) against the pin's (``stem_rs``:
    stem_fused_k2) on one b32 f32 input, with the share of output codes
    that differ. The two fold the scales in other orders (s_w*(s_in/s_out)
    against (s_in*s_w)/s_out), so codes near a rounding edge differ by 1:
    a finding, not a check."""
    from dnn_inference_engine_tpu_torch.quant.quantize import f32_scalar
    from dnn_inference_engine_tpu_torch.runtime.plan import plan_forward_w8a8

    x = torch.as_tensor(np.random.default_rng(2).integers(
        0, 256, (32, 416, 416, 3)).astype(np.uint8)).cuda()

    def s2_entry(eng):
        states = []
        plan_forward_w8a8(eng.model, eng._plan, eng._plan_params,
                          eng.act_scales, x, record_states=states)
        return states[1][:3]
    compare_stage(card, "S2", 1, s2_entry)
    xf = x.to(torch.float32) / f32_scalar(255.0, x.device)
    a, b = compare_stage(card, "S3", 0, lambda eng: (xf, None, 1))
    if a.shape != b.shape:
        raise AssertionError(f"stage 0 outputs differ in shape: {a.shape} "
                             f"vs {b.shape}")
    d = (a.int() - b.int()).abs()
    print(f"s0 vs stem_rs stage-0 codes: {float((d > 0).double().mean()):.3e} "
          f"of {d.numel()} differ, max |diff| {int(d.max())}")


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
    eng = Engine(EngineConfig(mode="w8a8", batch=8,
                              strategy=str(path))).load_weights(
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


# ---------------------------------------------------------------------------
# Phase 11: ResNet-18 (224 px, 1000 classes)
# ---------------------------------------------------------------------------

# conv_w8a8's ResNet-18 forms at 224 px, one row a distinct shape: (layer,
# x (H, W, Cin) a image, k, stride, Cout, requantizes, launches a forward
# of that shape). The linear 3x3 convs emit f32 (L3 also stands for L6,
# L14 for L17, L22 for L25 and L30), the 3x3/s2 convs int8, the 1x1/s2
# projections f32. The int8 3x3 convs at stride 1 (L2, L5, L13, L21, L29)
# are the YOLO forms, held in the forward by ConvCheck.
RESNET_CONVS = [("L3", (56, 56, 64), 3, 1, 64, False, 2),
                ("L8", (56, 56, 64), 3, 2, 128, True, 1),
                ("L9", (28, 28, 128), 3, 1, 128, False, 1),
                ("L11", (56, 56, 64), 1, 2, 128, False, 1),
                ("L14", (14, 14, 256), 3, 1, 256, False, 2),
                ("L16", (28, 28, 128), 3, 2, 256, True, 1),
                ("L19", (28, 28, 128), 1, 2, 256, False, 1),
                ("L22", (7, 7, 512), 3, 1, 512, False, 3),
                ("L24", (14, 14, 256), 3, 2, 512, True, 1),
                ("L27", (14, 14, 256), 1, 2, 512, False, 1)]
# logits card against CPU, as a share of the largest: the global average
# pool sums in another order on the card
RESNET_LOGIT_TOL = 1e-5


def resnet_conv_rows(g, dev, batch, ops_peak, bw, tag):
    """conv_w8a8 at each RESNET_CONVS shape, through the wrapper and
    launched directly, each against the plain version bit for bit (int8
    codes, and the f32 outputs too: the same rounding order), timed
    beside the im2col + ``gemm_fused`` route on the same inputs,
    ``torch._int_mm`` on the im2col'd A (product only) and the bound."""
    from dnn_inference_engine_tpu_torch.ops import _build
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
        extract_patches)
    from dnn_inference_engine_tpu_torch.quant.quantize import f32_scalar
    sms = _build.sm_count(dev)
    rows = []
    for layer, (h, w, cin), k, stride, cout, quant, per in RESNET_CONVS:
        xs = (batch, h, w, cin)
        x = torch.randint(-127, 128, xs, generator=g, device=dev,
                          dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, k, cin, cout), generator=g,
                           device=dev, dtype=torch.int8)
        spread = 0.05 * 60.0 / (0.02 * (k * k * cin) ** 0.5 * 5376.0)
        s_w = (torch.rand(cout, generator=g, device=dev) + 0.5) * spread
        b = torch.randn(cout, generator=g, device=dev)
        act, s_out = ("relu", 0.05) if quant else ("linear", None)
        kw = dict(act=act, stride=stride, s_out=s_out)
        form = cv.conv_w8a8_form(*xs, cout, k, k, stride, "SAME", None,
                                 quant, False, sms)
        launches = cv.conv2d_w8a8.launches
        got = cv.conv2d_w8a8(x, 0.02, wq, s_w, b, **kw)
        if (cv.conv2d_w8a8.launches != launches + 1
                or form.route not in ("patch", "tap")):
            raise AssertionError(f"conv_w8a8 resnet18 {tag} {layer}: not "
                                 f"the kernel")
        ref = cv.conv2d_w8a8_plain(x, 0.02, wq, s_w, b, **kw)
        err = max_abs_err(got, ref)
        ho, wo = -(-h // stride), -(-w // stride)
        m, kk = batch * ho * wo, k * k * cin
        wt = gm.kmajor_weights(wq)
        scale = f32_scalar(0.02, dev) * s_w

        def kernel(f=form):
            return cv.conv_w8a8_launch(x, wt, scale, b, s_out, k, ho, wo, 0,
                                       act, f, stride)

        def im2col_gemm():
            a_ = extract_patches(x, k, k, stride, "SAME").reshape(m, kk)
            return gm.gemm_fused(a_, wt, scale, b, act=act,
                                 s_out=s_out).reshape(batch, ho, wo, cout)
        err = max(err, max_abs_err(kernel(), ref),
                  max_abs_err(im2col_gemm(), ref))
        ms = device_ms(kernel, 10)
        im2col_ms = device_ms(im2col_gemm, 10)
        plain_ms = device_ms(
            lambda: cv.conv2d_w8a8_plain(x, 0.02, wq, s_w, b, **kw), 2)
        a = extract_patches(x, k, k, stride, "SAME").reshape(m, kk)
        lib_ms = device_ms(lambda: torch._int_mm(a, wt.t()), 10)
        # a 1x1 conv reads only the pixels it lands on: the even rows and
        # columns at stride 2
        x_read = x.numel() if k > 1 else batch * ho * wo * cin
        bound, by = _bound(2.0 * m * kk * cout,
                           x_read + wq.numel() + 8 * cout
                           + got.numel() * got.element_size(), ops_peak, bw)
        rows.append(dict(layer=layer, x=list(xs), k=k, stride=stride,
                         N=cout, M=m, K=kk, f32out=not quant,
                         per_forward=per, route=form.route,
                         max_abs_err=err, ms=ms,
                         im2col_gemm_ms=im2col_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound, bound_by=by, kb=form.kb,
                         steps=form.steps, grid=form.grid,
                         sk_tiles=form.sk_tiles))
        print(f"  conv_w8a8 resnet18 {tag} {layer} x={xs} k={k} s={stride} "
              f"Cout={cout} {'int8' if quant else 'f32'} out (M={m} K={kk}, "
              f"{per} a forward): err={err} ms={ms:.4f} "
              f"im2col+gemm_fused_ms={im2col_ms:.4f} "
              f"int_mm_ms={lib_ms:.4f} plain_ms={plain_ms:.3f} "
              f"bound_ms={bound:.4f} ({by}); {form.route} kb {form.kb}, "
              f"{schedule_line(form)}")
        if err != 0:
            raise AssertionError(f"conv_w8a8 resnet18 {tag} {layer}: "
                                 f"kernel != plain")
        del x, a, got, ref
    return rows


def _sm_clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i",
         str(torch.cuda.current_device())],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.split()[0]) * 1e6


def rows_epilogue_instr(act: str):
    """(issued instructions an output of conv_w8a8_rows' epilogue under
    ``act``, how it was counted): from ``cuobjdump -sass`` of the built
    library, where the codes' instantiations <64, 0, 7, act> and <16, 0,
    7, act> (Cout 64 and 16, 7 steps) differ only in their unrolled
    epilogues: their instructions' difference (NOPs left out) over the
    difference of their outputs, four FFMA an output (the division's).
    Raises where the SASS cannot be read or the count falls outside 8-60
    instructions an output."""
    import re
    import shutil
    from dnn_inference_engine_tpu_torch.ops import _build
    from dnn_inference_engine_tpu_torch.ops.activations import (
        KERNEL_ACT_CODES)
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    lib = _build.BUILD_DIR / "libconv_w8a8_rows.so"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = [0, 0]
        elif cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?!NOP)\S", line):
            counts[cur][0] += 1
            counts[cur][1] += " FFMA" in line
    a = KERNEL_ACT_CODES[act]
    n = {c: next((v for f, v in counts.items()
                  if f"conv_rows_kernelILi{c}ELi0ELi7ELi{a}E" in f), None)
         for c in (64, 16)}
    if None in n.values() or n[64][1] <= n[16][1]:
        raise AssertionError(f"conv_w8a8_rows' SASS: no <64|16, 0, 7, {a}> "
                             f"instantiations to difference ({n})")
    per = (n[64][0] - n[16][0]) / ((n[64][1] - n[16][1]) / 4)
    if not 8 <= per <= 60:
        raise AssertionError(f"conv_w8a8_rows' SASS: {per:.2f} instructions "
                             f"an output of the epilogue, outside 8-60 ({n})")
    return per, (f"sass, {act} ({n[64][0]} and {n[16][0]} instructions, "
                 f"{n[64][1]} and {n[16][1]} FFMA)")


def rows_conv_row(g, dev, tag, xs, k, stride, cout, act, ops_peak, bw,
                  instr):
    """The small-Cin kernel (conv_w8a8_rows, conv2d_w8a8's "rows" route) at
    one shape: through the wrapper (one conv_w8a8_rows launch, no
    gemm_fused, no im2col) and launched directly, each against the plain
    version bit for bit, and its uint8 form (``conv2d_w8a8_u8``: the
    wire batch read through the code table) the same way; timed beside
    the route it replaced (im2col +
    ``gemm_fused`` in its ragged form, and the im2col alone),
    ``torch._int_mm`` on the im2col'd A (K padded to a multiple of 8, the
    nearest it takes), the plain version, the bound and the epilogue's
    issue bound (``instr``: ``rows_epilogue_instr``, an output on each
    lane of every SM at the highest SM clock; computed, not timed). The
    previous kernel is timed in turns with this one by ``--rows-ab``."""
    from dnn_inference_engine_tpu_torch.ops import _build
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
        extract_patches)
    from dnn_inference_engine_tpu_torch.quant.quantize import f32_scalar
    cin = xs[3]
    x = torch.randint(-127, 128, xs, generator=g, device=dev,
                      dtype=torch.int8)
    xu = torch.randint(0, 256, xs, generator=g, device=dev,
                       dtype=torch.uint8)
    wq = torch.randint(-127, 128, (k, k, cin, cout), generator=g, device=dev,
                       dtype=torch.int8)
    s_w = (torch.rand(cout, generator=g, device=dev) + 0.5) * 1e-3
    b = torch.randn(cout, generator=g, device=dev)
    kw = dict(act=act, stride=stride, s_out=0.05)

    def counters():
        return (cv.conv_w8a8_rows.launches, gm.gemm_fused.launches,
                cv.conv2d_w8a8.im2col_launches, cv.conv2d_w8a8.launches)
    before = counters()
    got = cv.conv2d_w8a8(x, 0.02, wq, s_w, b, **kw)
    e = cv.entry_codes(1 / 127, s_w)
    got_u8 = cv.conv2d_w8a8_u8(xu, e, wq, s_w, b, **kw)
    launched = tuple(a - c for a, c in zip(counters(), before))
    ref = cv.conv2d_w8a8_plain(x, 0.02, wq, s_w, b, **kw)
    ref_u8 = cv.conv2d_w8a8_u8_plain(xu, e.s_in, wq, s_w, b, **kw)
    plan = cv.rows_plan(*xs, cout, k, stride, _build.sm_count(dev))
    tile = cv.rows_tile_matrix(wq)
    scale = f32_scalar(0.02, dev) * s_w
    kk = k * k * cin
    wt = gm.kmajor_weights(wq)

    def kernel():
        return cv.conv_w8a8_rows(x, tile, scale, b, 0.05, k, stride, act,
                                 plan)

    def kernel_u8():
        return cv.conv_w8a8_rows(xu, tile, e.scale, b, 0.05, k, stride, act,
                                 plan, codes=e.codes)

    def route():
        # the route it replaced, on prepared operands (the wrapper's scale
        # upload would block the host behind the queued calls)
        return gm.gemm_fused(extract_patches(x, k, k, stride, "SAME").reshape(
            -1, kk), wt, scale, b, act=act, s_out=0.05).reshape(got.shape)
    ragged = gm.gemm_fused.ragged_launches
    err = max(max_abs_err(got, ref), max_abs_err(kernel(), ref),
              max_abs_err(route(), ref))
    ragged = gm.gemm_fused.ragged_launches - ragged
    err_u8 = max(max_abs_err(got_u8, ref_u8), max_abs_err(kernel_u8(),
                                                          ref_u8))
    ms = device_ms(kernel, 20)
    u8_ms = device_ms(kernel_u8, 20)
    route_ms = device_ms(route, 10)
    im2col_ms = device_ms(lambda: extract_patches(x, k, k, stride, "SAME"),
                          10)
    plain_ms = device_ms(
        lambda: cv.conv2d_w8a8_plain(x, 0.02, wq, s_w, b, **kw), 2)
    a = extract_patches(x, k, k, stride, "SAME").reshape(-1, kk)
    m, kp = a.shape[0], -(-kk // 8) * 8
    a8 = torch.cat([a, a.new_zeros(m, kp - kk)], 1)
    b8 = torch.cat([wt, a.new_zeros(cout, kp - kk)], 1)
    lib_ms = device_ms(lambda: torch._int_mm(a8, b8.t()), 10)
    bound, by = _bound(2.0 * m * kk * cout,
                       x.numel() + wq.numel() + 8 * cout + got.numel(),
                       ops_peak, bw)
    issue_ms = (m * cout * instr[0]
                / (_build.sm_count(dev) * 128 * _sm_clock_hz()) * 1e3)
    print(f"  {tag} ({k}x{k}/s{stride}, Cin {cin}, M={m} K={kk} N={cout}): "
          f"conv_w8a8_rows err={err} ms={ms:.4f}, uint8 form err={err_u8} "
          f"ms={u8_ms:.4f} (run {plan.run}, {plan.ksteps} k32 steps, "
          f"{plan.upx} px a unit, {plan.units} units, grid {plan.grid}); "
          f"im2col + gemm_fused (ragged) "
          f"{route_ms:.4f} (the im2col alone {im2col_ms:.4f}); int_mm_ms="
          f"{lib_ms:.4f} (K {kp}) plain_ms={plain_ms:.3f} bound_ms="
          f"{bound:.4f} ({by}) epilogue issue bound {issue_ms:.4f} ms "
          f"({instr[0]:.2f} instructions an output, {instr[1]})")
    if (err != 0 or err_u8 != 0 or launched != (2, 0, 0, 0)
            or ragged != 1):
        raise AssertionError(f"{tag}: err {err}, uint8 form err {err_u8}, "
                             f"launches (rows, gemm_fused, im2col, "
                             f"conv_w8a8) {launched}, the old route's "
                             f"ragged launches {ragged}")
    return dict(x=list(xs), k=k, stride=stride, M=m, K=kk, N=cout,
                max_abs_err=max(err, err_u8), ms=ms, u8_ms=u8_ms,
                im2col_gemm_ms=route_ms, im2col_ms=im2col_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, issue_bound_ms=issue_ms,
                epilogue_instr=instr[0], epilogue_instr_by=instr[1],
                upx=plan.upx, units=plan.units, grid=plan.grid)


def resnet_stem_row(g, dev, batch, ops_peak, bw):
    """ResNet-18's stem (7x7/s2, Cin 3 -> 64, 224 px, relu) on
    conv_w8a8_rows (``rows_conv_row``)."""
    return rows_conv_row(g, dev, f"resnet18 stem b{batch}",
                         (batch, 224, 224, 3), 7, 2, 64, "relu", ops_peak,
                         bw, rows_epilogue_instr("relu"))


def phase_rows_kernel(dev, ops_peak, bw):
    """conv_w8a8_rows at the generic W8A8 forward's entry conv (3x3/s1,
    Cin 3 -> 16, 416 px, leaky) at b2 (``_generic_counts``) and b8 (a
    card of bench_all's config 5)."""
    g = torch.Generator(device=dev).manual_seed(21)
    instr = rows_epilogue_instr("leaky")
    return {f"entry b{n}": rows_conv_row(
        g, dev, f"yolo entry conv b{n}", (n, 416, 416, 3), 3, 1, 16,
        "leaky", ops_peak, bw, instr) for n in (2, 8)}


def phase_resnet_kernels(dev, ops_peak, bw):
    """conv_w8a8's ResNet-18 forms at b32 and b1 and the stem; the sums
    a forward weighted by each shape's launches."""
    g = torch.Generator(device=dev).manual_seed(18)
    out = {}
    for batch in (32, 1):
        rows = resnet_conv_rows(g, dev, batch, ops_peak, bw, f"b{batch}")
        stem = resnet_stem_row(g, dev, batch, ops_peak, bw)

        def total(key, rows=rows):
            return sum(r[key] * r["per_forward"] for r in rows)
        print(f"  conv_w8a8 resnet18 b{batch}, the new forms a forward "
              f"({sum(r['per_forward'] for r in rows)} launches): kernel "
              f"{total('ms'):.4f} ms, im2col+gemm_fused "
              f"{total('im2col_gemm_ms'):.4f}, int_mm "
              f"{total('library_ms'):.4f}, bound {total('bound_ms'):.4f}")
        out[f"b{batch}"] = dict(ms=total("ms"),
                                im2col_gemm_ms=total("im2col_gemm_ms"),
                                library_ms=total("library_ms"),
                                bound_ms=total("bound_ms"), shapes=rows,
                                stem=stem)
    return out


def _resnet_engine(batch, mode, dev=None, calib=None, **kw):
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    cfg = EngineConfig(model="resnet18", input_size=224, num_classes=1000,
                       batch=batch, mode=mode)
    return Engine(cfg, device=dev).load_weights(**kw).prepare(calib)


def _resnet_calib():
    return np.random.default_rng(7).uniform(
        0, 1, (4, 224, 224, 3)).astype(np.float32)


def phase_resnet_card_vs_cpu(card: str):
    """ResNet-18 at 224 px, b2, card against a CPU engine (plain versions)
    with the card's weights and scales: W8A8 (the all-xla plan) every
    stage's entry state equal up to the global average pool, codes and
    the linear convs' f32 outputs alike, the logits within
    RESNET_LOGIT_TOL of the largest; fp32 within F32_REL_TOL and w8
    within BF16_REL_TOL."""
    from dnn_inference_engine_tpu_torch.runtime.plan import plan_forward_w8a8
    imgs = np.random.default_rng(8).integers(
        0, 256, (2, 224, 224, 3)).astype(np.uint8)
    for mode, tol in (("w8a8", RESNET_LOGIT_TOL), ("fp32", F32_REL_TOL),
                      ("w8", BF16_REL_TOL)):
        t0 = time.time()
        gpu = _resnet_engine(2, mode, calib=_resnet_calib(), seed=0)
        fp32 = [{k: v.cpu().numpy() for k, v in p.items()}
                for p in gpu.fp32_params]
        cpu = _resnet_engine(2, mode, dev="cpu", params=fp32,
                             act_scales=gpu.act_scales)
        got, want = gpu.classify(imgs), cpu.classify(imgs)
        if got.shape != (2, 1000) or not np.isfinite(got).all():
            raise AssertionError(f"resnet18 {mode}: bad logits {got.shape}")
        diff = float(np.abs(got - want).max())
        atol = tol * float(np.abs(want).max())
        states = ""
        if mode == "w8a8":
            recs = []
            for eng in (gpu, cpu):
                rec = []
                plan_forward_w8a8(eng.model, eng._plan, eng._plan_params,
                                  eng.act_scales, eng._device_batch(imgs),
                                  record_states=rec)
                recs.append(rec)
            gap = [st.kind for st in gpu._plan].index("gap")
            for si in range(gap + 1):
                a, b = recs[0][si][0].cpu(), recs[1][si][0]
                if not torch.equal(a, b):
                    raise AssertionError(f"resnet18 w8a8 stage {si} entry: "
                                         f"card != CPU in "
                                         f"{int((a != b).sum())} values")
            states = (f"; the {gap + 1} stage entry states up to the pool "
                      f"identical")
        print(f"card vs CPU resnet18 {mode} @224 b2: logits max diff {diff} "
              f"within {atol:.4g} ({tol:.3g} of the largest){states} "
              f"[{time.time() - t0:.1f} s] [{card}]")
        if diff > atol:
            raise AssertionError(f"resnet18 {mode}: card logits != CPU "
                                 f"logits: max diff {diff} > {atol}")


def phase_resnet_path(batch: int, mode: str, want: dict, card: str):
    """ResNet-18 ``classify`` at 224 px, 1000 classes, under ``mode``'s
    path (w8a8 and w8: the all-xla plan; fp32: the generic auto forward):
    one classify with the counters set to 0 just before and read just
    after (they must equal ``want``, every counter named; no
    ``gemm_fused`` launch in the ragged form and no im2col copy: the stem
    runs conv_w8a8_rows), every conv_w8a8 and conv_w8a8_rows
    launch held to its plain version (w8a8), then throughput, latency and
    the device breakdown of the forward."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    want = {**dict.fromkeys(kernel_counters(), 0), **want}
    eng = _resnet_engine(batch, mode, calib=_resnet_calib(), seed=0)
    imgs = np.random.default_rng(9).integers(
        0, 256, (batch, 224, 224, 3)).astype(np.uint8)
    x = torch.as_tensor(imgs).cuda()
    tag = f"resnet18 {mode} b{batch}"
    reset_counts()
    with XlaTierIm2col() as im2col:
        logits = eng.classify(imgs)
        torch.cuda.synchronize()
    counts = read_counts()
    if logits.shape != (batch, 1000) or not np.isfinite(logits).all():
        raise AssertionError(f"{tag}: bad logits {logits.shape}")
    got = (counts, gm.gemm_fused.ragged_launches, im2col.calls,
           cv.conv2d_w8a8.im2col_launches, gm.gemm_f32.ragged_launches)
    if got != (want, 0, 0, 0, 0):
        raise AssertionError(f"{tag}: launches {counts}, ragged gemm_fused "
                             f"{got[1]}, im2col copies {got[2]}, im2col "
                             f"route {got[3]}, ragged gemm_f32 {got[4]}; "
                             f"want {want} and none of the others")
    if mode == "w8a8":
        with ConvCheck() as chk:
            eng.classify(imgs)
            torch.cuda.synchronize()
        chk.verify(tag, want["conv_w8a8"] + want["conv_w8a8_rows"],
                   want_u8=want["conv_w8a8_rows"])

    def fwd():
        return eng._fwd(x)
    if mode == "w8a8":
        stem_stage_is_one_launch(tag, eng, x, card)
    t = dict(tp=throughput_ms(fwd, 20), lat=latency_ms(fwd, 20))
    groups, ops = device_breakdown(fwd)
    busy = sum(groups.values())
    print(f"{tag} launches per classify {counts} (no ragged gemm_fused, "
          f"no im2col) [{card}]")
    print(f"{tag} device ms per forward (torch.profiler, 5 forwards): "
          + ", ".join(f"{g} {v:.4f}" for g, v in groups.items() if v)
          + f"; busy {busy:.4f} = {busy / t['tp']:.2f} of the back-to-back "
          f"forward [{card}]")
    print(f"{tag} device operations per forward: "
          + ", ".join(f"{g} {n:g}" for g, n in ops.items() if n)
          + f"; total {sum(ops.values()):g} [{card}]")
    print(f"{tag} back to back: forward {t['tp']:.3f} ms = "
          f"{batch * 1e3 / t['tp']:.1f} img/s; latency (median of 20, "
          f"synced) {t['lat']:.3f} ms [{card}]")
    return dict(counts=counts, busy=busy, tp=t["tp"], lat=t["lat"],
                groups=groups)


def stem_stage_is_one_launch(tag: str, eng, x, card: str):
    """ResNet-18's W8A8 stem stage (the plan's stage 0, an ``xla`` conv
    on the uint8 wire ``x``, its code table built by
    ``prepare_plan_params``) run once more: every PyTorch operation it
    dispatches is recorded
    (``TorchDispatchMode``), and it must be the output's allocation alone
    (no normalise, quantize, scale or upload pass), with one
    conv_w8a8_rows launch."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.runtime.plan import _run_stage

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.name())
            return func(*args, **(kwargs or {}))
    st, pp = eng._plan[0], eng._plan_params[0]
    if x.dtype != torch.uint8 or "entry_codes" not in pp:
        raise AssertionError(f"{tag}: the stem stage did not take the uint8 "
                             f"wire ({x.dtype}, {sorted(pp)})")
    torch.cuda.synchronize()
    before = cv.conv_w8a8_rows.launches
    with Ops() as ops:
        _run_stage(eng.model.layers, st, pp, x, None, 1, eng.act_scales)
    torch.cuda.synchronize()
    launched = cv.conv_w8a8_rows.launches - before
    if launched != 1 or ops.names != ["aten::empty.memory_format"]:
        raise AssertionError(f"{tag}: the stem stage launched "
                             f"conv_w8a8_rows {launched} times and "
                             f"dispatched {ops.names}; want 1 and the "
                             f"output's allocation alone")
    print(f"{tag}: the stem stage is one conv_w8a8_rows launch on the uint8 "
          f"wire; it dispatches nothing but its output's allocation [{card}]")


def phase_resnet_sweep(card: str):
    """``plan-sweep --model resnet18 --quick`` at b32 in w8a8 on the card:
    the sweep's own timing (auto-scaled loop counts, min of 3 reps), no
    crash, no parity rejection; every ResNet conv has the one candidate
    ``xla`` under --quick, so its whole_net_ms is the all-xla pin's."""
    from dnn_inference_engine_tpu_torch.runtime.plan_sweep import sweep
    t0 = time.time()
    art = sweep("resnet18", "w8a8", batch=32, input_size=224, quick=True,
                verbose=False)
    wall = time.time() - t0
    bad = {f"L{li} {c}": v for li, row in art["measurements"].items()
           for c, v in row.items() if isinstance(v, str)}
    if bad or art["crashed_candidates"]:
        raise AssertionError(f"resnet18 sweep recorded failures: {bad}")
    path = strategies_dir() / "resnet18_w8a8_b32.json"
    path.write_text(json.dumps(art))
    print(f"plan-sweep resnet18 w8a8 b32 @224 --quick: whole_net_ms "
          f"{art['whole_net_ms']} ({art['images_per_s']} img/s), strategy "
          f"{json.dumps(art['strategy'])}, {art['passes']} passes, wall "
          f"{wall:.1f} s [{card}]")
    return art


def phase_resnet18(card: str, ops_peak, bw):
    """Phase 11: the conv_w8a8 forms and the stem on conv_w8a8_rows, the
    card against the CPU, the classify paths at b32 and b1 in each mode,
    the sweep."""
    dev = torch.device("cuda")
    t0 = time.time()
    rows = phase_resnet_kernels(dev, ops_peak, bw)
    torch.cuda.empty_cache()
    t1 = time.time()
    phase_resnet_card_vs_cpu(card)
    t2 = time.time()
    # the stem on conv_w8a8_rows, the other 19 convs on conv_w8a8: no
    # im2col, no gemm_fused
    w8a8 = dict(conv_w8a8=19, conv_w8a8_rows=1)
    paths = {}
    for batch in (32, 1):
        paths[f"w8a8 b{batch}"] = phase_resnet_path(batch, "w8a8", w8a8,
                                                    card)
        paths[f"w8 b{batch}"] = phase_resnet_path(batch, "w8", {}, card)
        paths[f"fp32 b{batch}"] = phase_resnet_path(
            batch, "fp32", dict(gemm_f32=11), card)
    t3 = time.time()
    art = phase_resnet_sweep(card)
    print(f"resnet18 steps: kernels {t1 - t0:.1f} s, card vs CPU "
          f"{t2 - t1:.1f} s, classify paths {t3 - t2:.1f} s, sweep "
          f"{time.time() - t3:.1f} s")
    print(json.dumps({"resnet18": {
        k: {"busy_ms": v["busy"], "forward_ms": v["tp"],
            "latency_ms": v["lat"]} for k, v in paths.items()},
        "sweep_whole_net_ms": art["whole_net_ms"], "card": card}))
    return rows, paths["w8a8 b32"]["counts"]


# ---------------------------------------------------------------------------
# Phase 12: profiling (stage scopes, trace_attribution, stage_times, the CLI)
# ---------------------------------------------------------------------------

# the W8A8 paths whose stages are profiled: (model, batch, input size)
PROFILED = (("yolov2-tiny", 32, 416), ("yolov2-tiny", 1, 416),
            ("resnet18", 32, 224))
PROFILE_RUNS = 20                   # forwards a trace holds
BINDING_PCT_MAX = 105.0             # a stage above it: a miscount or bad timing
POST_SCOPES = ("post_decode", "nms_candidates", "nms_suppress", "nms_merge")


def scope_link_check(card: str):
    """One conv_w8a8 launch inside ``scope("stage0_xla_L0")``, traced: the
    kernel, launched through ctypes with no ATen op around it, must land
    in that scope, not in ``unattributed/``."""
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.runtime.profiling import (
        scope, trace_attribution)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randint(-127, 128, (2, 52, 52, 128), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 3, 128, 256), generator=g, device=dev,
                      dtype=torch.int8)
    s_w = torch.rand(256, generator=g, device=dev) * 1e-3
    b = torch.randn(256, generator=g, device=dev)

    def fn(xx):
        with scope("stage0_xla_L0"):
            return cv.conv2d_w8a8(xx, 0.05, w, s_w, b, act="leaky",
                                  s_out=0.05)
    art = trace_attribution(fn, x, runs=5)
    conv = [r for r in art["top_ops"] if r["group"] == "conv_w8a8"]
    if not conv or any(r["scope"] != "stage0_xla_L0" for r in conv):
        raise AssertionError(f"the conv_w8a8 launch is not attributed to "
                             f"its scope: {art['by_scope_us']}")
    print(f"scope link: conv_w8a8 {conv[0]['us']:.2f} us a launch in "
          f"stage0_xla_L0 ({conv[0]['op_name']}); by scope "
          f"{art['by_scope_us']} [{card}]")


def profile_path(model: str, batch: int, size: int, card: str) -> dict:
    """``stage_times_traced`` of the W8A8 plan of ``model`` at ``batch``:
    one line a stage (isolated ms, in-context trace ms, work, traffic,
    binding floor and its share of each time), the trace's module time
    beside ``device_breakdown``'s busy time of the same forward, and the
    trace ms by stage kind. Fails where a stage runs faster than its
    binding floor allows, above BINDING_PCT_MAX of it: in context
    (``trace_pct_of_binding``, device time, the share that exposes a
    miscount of work or bytes) or, where resolved, looped alone
    (``pct_of_binding``, which times the host's launches too). The
    trace's own checks: its rows within 2% of the module time, every
    kernel's count its launches."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    if model == "resnet18":
        eng = _resnet_engine(batch, "w8a8", calib=_resnet_calib(), seed=0)
    else:
        eng = Engine(EngineConfig(model=model, mode="w8a8", batch=batch,
                                  input_size=size)).load_weights(
            seed=0).prepare()
    tag = f"profile {model} w8a8 b{batch}"
    t0 = time.time()
    rep = eng.stage_times_traced(batch=batch, runs=PROFILE_RUNS)
    took = time.time() - t0
    x = eng._bench_input(batch)
    groups, _ = device_breakdown(lambda: eng._fwd(x))
    busy = sum(groups.values())
    print(f"{tag}: trace module {rep['module_ms']:.4f} ms device a forward "
          f"({rep['runs_traced']} forwards), device_breakdown busy "
          f"{busy:.4f} ({rep['module_ms'] / busy:.3f} of it); trace rows "
          f"{rep['trace_total_ms']:.4f}; isolated stages "
          f"{rep['total_stage_ms']:.4f}, in-context overhead "
          f"{rep['in_context_overhead_ms']:.4f} ms; {took:.1f} s [{card}]")
    by_kind = {}
    for r in rep["stages"]:
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0.0) + r["trace_ms"]
        if r["stage"] is None:
            print(f"  {'':>3s} {r['name']:40s} trace_ms {r['trace_ms']:.4f}")
            continue
        pct, tpct = r["pct_of_binding"], r["trace_pct_of_binding"]
        print(f"  {r['stage']:3d} {r['name']:20s} ms {r['ms']:.4f} trace_ms "
              f"{r['trace_ms']:.4f} gop_exec {r['gop_exec']:.3f} hbm_mb "
              f"{r['hbm_mb']:.2f} binding {r['binding']:>3s} bound_ms "
              f"{r['bound_ms']:.4f} pct_of_binding "
              + ("<res." if pct is None else f"{pct:.2f}")
              + " in context "
              + ("-" if tpct is None else f"{tpct:.2f}")
              + f" noise {r['noise_pct']:.1f}% iters {r['iters']}"
              + ("  SUSPECT" if r["suspect"] else ""))
    print(f"{tag} trace ms by stage kind: "
          + ", ".join(f"{k} {v:.4f}" for k, v in by_kind.items())
          + f" [{card}]")
    over = [r["name"] for r in rep["stages"] if r["stage"] is not None
            and any(r[k] is not None and r[k] > BINDING_PCT_MAX
                    for k in ("pct_of_binding", "trace_pct_of_binding"))]
    if over:
        raise AssertionError(f"{tag}: stages above {BINDING_PCT_MAX}% of "
                             f"their binding floor: {over}")
    return {"module_ms": rep["module_ms"], "busy_ms": busy,
            "total_stage_ms": rep["total_stage_ms"],
            "in_context_overhead_ms": rep["in_context_overhead_ms"],
            "trace_ms_by_kind": by_kind, "seconds": took}


def trace_detect_b1():
    """``cli trace --mode w8a8 --batch 1 --detect --runs 30`` in a
    process of its own, which must show the post_decode and nms_* scopes:
    (its output, the module device ms a detect it prints)."""
    text = _subprocess(["trace", "--mode", "w8a8", "--batch", "1",
                        "--detect", "--runs", "30"])
    missing = [s for s in POST_SCOPES if s not in text]
    if missing:
        raise AssertionError(f"cli trace --detect lacks {missing}:\n{text}")
    line = next(ln for ln in text.splitlines()
                if ln.startswith("# module device time"))
    return text, float(line.split()[4]) / 1e3


def phase_profiling(card: str) -> dict:
    """Phase 12: the scope link, ``stage_times_traced`` on PROFILED, and
    the CLI's ``trace --detect`` (``trace_detect_b1``; its module device
    time is ``["detect b1"]``) and ``layer-times`` in processes of their
    own."""
    scope_link_check(card)
    out = {f"{m} b{b}": profile_path(m, b, size, card)
           for m, b, size in PROFILED}
    torch.cuda.empty_cache()
    t0 = time.time()
    text, module_ms = trace_detect_b1()
    out["detect b1"] = {"module_ms": module_ms}
    print(f"cli trace --mode w8a8 --batch 1 --detect --runs 30 [{card}]:\n"
          + text.rstrip())
    text = _subprocess(["layer-times", "--mode", "fp32", "--batch", "1",
                        "--iters", "20,5"])
    print(f"cli layer-times --mode fp32 --batch 1 --iters 20,5 [{card}]:\n"
          + text.rstrip())
    print(f"profiling cli: {time.time() - t0:.1f} s")
    print(json.dumps({"profiling": out, "card": card}))
    return out


# ---------------------------------------------------------------------------
# Phase 14: the bench (bench.run_bench through the CLI, bench_all's configs)
# ---------------------------------------------------------------------------

# bench_all's configs in the whole script; ``python -m
# dnn_inference_engine_tpu_torch.bench_all`` runs all eleven on its own
BENCH_CONFIGS = ("3_yolov2_w8a8_b32", "6_stage_roofline",
                 "8_b1_detect_latency")
BENCH_AGREE = 0.05          # the bench's device ms against phase 12's


def _agree(tag: str, got: float, ref: float) -> None:
    if abs(got - ref) > BENCH_AGREE * ref:
        raise AssertionError(f"bench: {tag} {got:.4f} ms, phase 12 "
                             f"{ref:.4f} ms: more than "
                             f"{BENCH_AGREE:.0%} apart")


def bench_refs(card: str) -> dict:
    """Phase 12's two figures the bench is held to, measured alone (for
    ``--bench``): the v2 pin's b32 traced module ms and ``cli trace
    --detect``'s b1 module ms."""
    out = {"yolov2-tiny b32": profile_path("yolov2-tiny", 32, 416, card)}
    torch.cuda.empty_cache()
    out["detect b1"] = {"module_ms": trace_detect_b1()[1]}
    return out


def phase_bench(card: str, prof: dict) -> dict:
    """Phase 14: ``cli bench --mode w8a8 --batch 32`` in a process of its
    own, its one JSON line held to the JAX bench's keys, the card line,
    its ``single_image_device_ms`` (the trace's b1 detect) at most the
    wall p50 and within BENCH_AGREE of phase 12's traced b1 detect
    (``prof``); then ``bench_all`` over BENCH_CONFIGS, ``--out`` under
    ``chiprun_out/``: rc 0, no config's ``error``, config 8's detect
    device ms within BENCH_AGREE of the same, config 6's module ms within
    BENCH_AGREE of phase 12's v2 b32 module ms. Prints the phase's
    numbers as one JSON line."""
    t0 = time.time()
    ref_b1 = prof["detect b1"]["module_ms"]
    ref_b32 = prof["yolov2-tiny b32"]["module_ms"]
    text = _subprocess(["bench", "--mode", "w8a8", "--batch", "32"],
                       timeout=600)
    lines = text.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"cli bench printed {len(lines)} lines:\n"
                             + text)
    res = json.loads(lines[0])
    d = res["detail"]
    want = {"ms_per_batch", "p50_single_image_ms", "single_image_device_ms",
            "fp32_images_per_s", "fp32_precision", "kernel", "backend"}
    if set(res) != {"metric", "value", "unit", "vs_baseline", "detail"} \
            or not want <= set(d) or d["card"] != card \
            or d["backend"] != "cuda":
        raise AssertionError(f"cli bench's line breaks the contract: {res}")
    dev_ms = d["single_image_device_ms"]
    if not 0 < dev_ms <= d["p50_single_image_ms"]:
        raise AssertionError(f"bench: b1 device {dev_ms} ms against the "
                             f"wall p50 {d['p50_single_image_ms']} ms")
    _agree("cli bench's single_image_device_ms", dev_ms, ref_b1)
    print(f"cli bench --mode w8a8 --batch 32 [{card}]: {json.dumps(res)}")
    print(f"  b32 {res['value']} images/s ({d['ms_per_batch']} ms, spread "
          f"{d['ms_per_batch_spread_pct']}%), fp32 {d['fp32_images_per_s']} "
          f"({d['fp32_ms_per_batch']} ms), vs_baseline {res['vs_baseline']};"
          f" b1 detect wall p50 {d['p50_single_image_ms']} ms, device "
          f"{dev_ms} ms {d['single_image_split_device_ms']} (phase 12 "
          f"{ref_b1:.4f}); clocks {d['clocks_before']} -> "
          f"{d['clocks_after']}")
    out_path = Path(__file__).resolve().parent / "chiprun_out" / \
        "bench_all_smoke.json"
    r = subprocess.run(
        [sys.executable, "-m", "dnn_inference_engine_tpu_torch.bench_all",
         "--configs", ",".join(BENCH_CONFIGS), "--out", str(out_path)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=900)
    print(f"bench_all --configs {','.join(BENCH_CONFIGS)} [{card}]:\n"
          + r.stdout.rstrip())
    if r.returncode != 0:
        raise AssertionError(f"bench_all rc {r.returncode}:\n"
                             f"{r.stderr[-3000:]}")
    sweep = json.loads(out_path.read_text())["configs"]
    if list(sweep) != list(BENCH_CONFIGS) or any(
            "error" in c for c in sweep.values()):
        raise AssertionError(f"bench_all: {sweep}")
    c8 = sweep["8_b1_detect_latency"]
    c6 = sweep["6_stage_roofline"]
    _agree("config 8's detect_device_ms", c8["detect_device_ms"], ref_b1)
    _agree("config 6's module_ms", c6["module_ms"], ref_b32)
    print(f"  config 8 b1 detect device {c8['detect_device_ms']} ms "
          f"(forward {c8['forward_device_ms']}, decode "
          f"{c8['decode_device_ms']}, NMS {c8['nms_device_ms']}), wall p50 "
          f"{c8['p50_wall_ms']}; config 6 module {c6['module_ms']} ms "
          f"(phase 12 {ref_b32:.4f}), e2e_mfu {c6['e2e_mfu_pct']}%; config "
          f"3 {sweep['3_yolov2_w8a8_b32']['images_per_s']} images/s")
    out = {"cli_bench": res, "bench_all": {
        "3_yolov2_w8a8_b32": sweep["3_yolov2_w8a8_b32"],
        "6_stage_roofline": {k: c6[k] for k in ("module_ms", "e2e_mfu_pct",
                                                "total_stage_ms")},
        "8_b1_detect_latency": c8},
        "phase12_b1_detect_ms": ref_b1, "phase12_v2_b32_module_ms": ref_b32,
        "seconds": round(time.time() - t0, 1), "card": card}
    print(json.dumps({"bench": out}))
    return out


# ---------------------------------------------------------------------------
# Phase 10: the front door (weight files, calibration images, serving, eval)
# ---------------------------------------------------------------------------

def frontdoor_dir() -> Path:
    """build/frontdoor/ at the root of the checkout (gitignored)."""
    path = Path(__file__).resolve().parent / "build" / "frontdoor"
    path.mkdir(parents=True, exist_ok=True)
    return path


def write_darknet(model, path: Path, seed: int) -> Path:
    """A darknet ``.weights`` file for ``model`` from ``seed`` (major 0,
    minor 2: an int64 ``seen``): per conv ``beta, gamma, mean, var`` where
    it has BN, else a bias, then He-scaled (Cout, Cin, kh, kw) weights.
    The head's bias lifts each anchor's objectness and one class logit,
    so that boxes clear the serving threshold and the NMS has work."""
    rng = np.random.default_rng(seed)
    chans = model.out_channels()
    parts, prev = [], model.in_ch
    for li, layer in enumerate(model.layers):
        if type(layer).__name__ == "Conv":
            c, k = layer.out_ch, layer.ksize
            if layer.use_bn:
                parts += [rng.normal(0, 0.1, c), rng.uniform(0.5, 1.5, c),
                          rng.normal(0, 0.1, c), rng.uniform(0.5, 2.0, c)]
            else:
                bias = rng.normal(0, 0.01, c)
                e = 5 + 20
                for a in range(c // e):
                    bias[a * e + 4] += 2.0
                    bias[a * e + 5 + (7 * a) % 20] += 3.0
                parts.append(bias)
            parts.append(rng.normal(0, (2.0 / (k * k * prev)) ** 0.5,
                                    c * prev * k * k))
        prev = chans[li]
    with open(path, "wb") as f:
        f.write(np.asarray([0, 2, 0], np.int32).tobytes())
        f.write(np.asarray([0], np.int64).tobytes())
        f.write(np.concatenate(parts).astype(np.float32).tobytes())
    return path


def _same_detections(tag: str, a, b, box_atol: float = 1e-3):
    """Survivor counts and classes equal, boxes within ``box_atol`` px."""
    (ba, sa, ca), (bb, sb, cb) = a, b
    na, nb = (sa > 0).sum(axis=1), (sb > 0).sum(axis=1)
    diff = float(np.abs(ba - bb).max())
    if not (np.array_equal(na, nb) and np.array_equal(ca, cb)
            and diff <= box_atol):
        raise AssertionError(f"{tag}: survivors {na} vs {nb}, classes equal "
                             f"{np.array_equal(ca, cb)}, box diff {diff}")
    return na.tolist()


def _serve(eng, images, threads: int):
    """``images`` through a ``ContinuousBatcher`` on ``eng`` from
    ``threads`` client threads (each submits its share, then waits), with
    a copy of every shipped batch kept: a correctness run, not a timed
    one (``_timed_windows`` times the batcher). Returns (the padded
    batches shipped, the results by index)."""
    import threading
    from dnn_inference_engine_tpu_torch.runtime.serve import (
        ContinuousBatcher)
    shipped = []
    real = eng.detect_device

    def record(x):
        shipped.append(x.copy())
        return real(x)
    eng.detect_device = record
    results, errors = {}, []
    batcher = ContinuousBatcher(eng).start()
    try:
        def client(idx):
            try:
                futs = [(i, batcher.submit(images[i])) for i in idx]
                for i, f in futs:
                    results[i] = f.result(timeout=300)
            except Exception as e:          # noqa: BLE001 — raised below
                errors.append(e)
        ts = [threading.Thread(target=client,
                               args=(range(t, len(images), threads),))
              for t in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        if errors or any(t.is_alive() for t in ts):
            raise AssertionError(f"serving failed: {errors}")
    finally:
        batcher.stop()
        del eng.detect_device
    if len(results) != len(images):
        raise AssertionError(f"{len(results)} of {len(images)} served")
    return shipped, results


def _rows_equal_detect(eng, images, shipped, results) -> None:
    """Every served result equals, bit for bit, its image's row of
    ``eng.detect`` on the padded batch the batcher shipped."""
    rows = 0
    for x in shipped:
        ref = eng.detect(x)
        for r in range(x.shape[0]):
            for i in [i for i in range(len(images))
                      if np.array_equal(images[i], x[r])]:
                for got, want in zip(results[i], ref):
                    if not np.array_equal(got, want[r]):
                        raise AssertionError(
                            f"request {i}: served result != row {r} of "
                            "detect on its shipped batch")
                rows += 1
    if rows < len(images):
        raise AssertionError(f"{rows} rows matched for {len(images)}")


def _served_on_kernels(tag, eng, images, threads, want, dev):
    """``_serve`` with the launch counters (and the NMS's host reads) set
    to 0 just before the served run and read just after; on the card each
    kernel of the path must count its launches a batch times the batches,
    every other counter 0, with no im2col, no ragged GEMM and no host read
    in the NMS. Then each result is held to its row of detect."""
    from dnn_inference_engine_tpu_torch import postprocess as pp
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    reset_counts()
    pp._greedy_fixpoint.host_syncs = 0
    with XlaTierIm2col() as im2col:
        shipped, results = _serve(eng, images, threads)
    counts, syncs = read_counts(), pp._greedy_fixpoint.host_syncs
    batches = len(shipped)
    if dev.type == "cuda":
        expect = {**dict.fromkeys(kernel_counters(), 0),
                  **{k: v * batches for k, v in want.items()}}
        if counts != expect:
            raise AssertionError(f"{tag}: launches {counts} != {expect}")
        if (im2col.calls or cv.conv2d_w8a8.im2col_launches
                or gm.gemm_fused.ragged_launches):
            raise AssertionError(f"{tag}: {im2col.calls} im2col copies, "
                                 f"{gm.gemm_fused.ragged_launches} ragged "
                                 "GEMMs")
        if syncs:
            raise AssertionError(f"{tag}: {syncs} host reads in the NMS")
    _rows_equal_detect(eng, images, shipped, results)
    print(f"{tag}: {len(images)} requests from {threads} threads in "
          f"{batches} batches, each result equal to its row of detect; "
          f"launches over the served run {counts}; NMS host reads per "
          f"detect {syncs / batches:g}")
    return syncs / batches


def _window(batcher, images, outstanding: int, n: int) -> dict:
    """One timed window: a closed loop keeps ``outstanding`` requests in
    flight (each result submits the next of ``n``, the images taken in
    turn) from the first submit to the ``n``-th result."""
    import threading
    lat, errors = [0.0] * n, []
    lock, done = threading.Lock(), threading.Event()
    state = {"next": outstanding, "done": 0}
    before = batcher.stats()

    def launch(i):
        t0 = time.perf_counter()
        batcher.submit(images[i % len(images)]).add_done_callback(
            lambda f: finish(f, i, t0))

    def finish(f, i, t0):
        lat[i] = (time.perf_counter() - t0) * 1e3
        if f.exception() is not None:
            errors.append(f.exception())
        with lock:
            state["done"] += 1
            nxt = state["next"]
            state["next"] += 1
            if state["done"] == n:
                done.set()
        if nxt < n:
            launch(nxt)
    t0 = time.perf_counter()
    for i in range(min(outstanding, n)):
        launch(i)
    if not done.wait(timeout=600) or errors:
        raise AssertionError(f"timed window: {state}, errors {errors[:3]}")
    wall = time.perf_counter() - t0
    after = batcher.stats()
    return {"images_per_s": n / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "batch_fill": ((after["images"] - before["images"])
                           / (after["batches"] - before["batches"]))}


def _timed_windows(tag, eng, images, batches: int, windows: int = 3):
    """The batcher on ``eng`` timed with nothing of this script in its
    path: one warm-up batch, then ``windows`` windows of ``batches`` full
    batches each, 2 ``max_batch`` requests in flight (one batch on the
    card while the next assembles). Per window images/s, and p50/p99 of
    submit-to-result ms over all its requests (host clock)."""
    from dnn_inference_engine_tpu_torch.runtime.serve import (
        ContinuousBatcher)
    batcher = ContinuousBatcher(eng).start()
    mb = batcher.max_batch
    try:
        for f in [batcher.submit(images[i % len(images)])
                  for i in range(mb)]:
            f.result(timeout=300)
        runs = [_window(batcher, images, 2 * mb, batches * mb)
                for _ in range(windows)]
    finally:
        batcher.stop()
    print(f"{tag}: {windows} windows of {batches} batches ({batches * mb} "
          f"requests, {2 * mb} in flight): images/s "
          f"{[round(r['images_per_s'], 1) for r in runs]}, p50 ms "
          f"{[round(r['p50_ms'], 2) for r in runs]}, p99 ms "
          f"{[round(r['p99_ms'], 2) for r in runs]}, batch fill "
          f"{[round(r['batch_fill'], 2) for r in runs]}")
    return runs


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _nms_args(eng, x):
    """The ``device_nms_cols`` arguments of one detect of ``x``:
    ((boxes, scores), keywords)."""
    from dnn_inference_engine_tpu_torch.runtime import engine as em
    kept = []
    real = em.device_nms_cols

    def keep_args(*a, **kw):
        kept.append((a, kw))
        return real(*a, **kw)
    em.device_nms_cols = keep_args
    try:
        eng.detect(x)
    finally:
        em.device_nms_cols = real
    return kept[0]


def _host_ms(fn, dev, reps):
    """Median host ms of ``reps`` calls of ``fn``, each synced."""
    ts = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def _nms_reads_no_host(tag, boxes, scores, kw):
    """One NMS on the card under PyTorch's sync debug mode "error" (a
    call that synchronizes the host raises): one ``nms_suppress`` launch,
    no host read of the plain loop."""
    from dnn_inference_engine_tpu_torch import postprocess as pp
    torch.cuda.synchronize()
    before, pp._greedy_fixpoint.host_syncs = pp.nms_suppress.launches, 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        pp.device_nms_cols(boxes, scores, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if (pp.nms_suppress.launches != before + 1
            or pp._greedy_fixpoint.host_syncs):
        raise AssertionError(f"NMS {tag}: {pp.nms_suppress.launches - before}"
                             f" launches, {pp._greedy_fixpoint.host_syncs} "
                             "host reads")


def _nms_groups(tag, eng, x, dev, groups=(1, 2, 4, 8, 16), reps=20):
    """The NMS's host ms per detect (each call synced, median of
    ``reps``) on the engine's ``device_nms_cols`` inputs of one detect of
    ``x``: through the kernel (on the card, where it must read no host:
    ``_nms_reads_no_host``), then through the plain version (the IoU,
    dominance and loop as PyTorch ops) for each group of sweeps between
    host reads (``SWEEPS_PER_SYNC``), every output equal; through the
    kernel also its device span (``device_ms``: the host's launch work
    hidden); the sweeps to the fixpoint (the plain loop with group 1: one
    read a sweep)."""
    from dnn_inference_engine_tpu_torch import postprocess as pp
    (boxes, scores), kw = _nms_args(eng, x)
    nms = pp.device_nms_cols
    out = [t.cpu().numpy() for t in nms(boxes, scores, **kw)]
    kernel_ms = device_span = None
    if dev.type == "cuda":
        _nms_reads_no_host(tag, boxes, scores, kw)
        kernel_ms = _host_ms(lambda: nms(boxes, scores, **kw), dev, reps)
        device_span = device_ms(lambda: nms(boxes, scores, **kw), reps)
    saved, ms = (pp.SWEEPS_PER_SYNC, pp.nms_suppress), {}
    pp.nms_suppress = pp.nms_suppress_plain
    try:
        for g in groups:
            pp.SWEEPS_PER_SYNC = g
            pp._greedy_fixpoint.host_syncs = 0
            got = [t.cpu().numpy() for t in nms(boxes, scores, **kw)]
            if g == 1:
                sweeps = 1 + pp._greedy_fixpoint.host_syncs
            if not all(np.array_equal(a, b) for a, b in zip(got, out)):
                raise AssertionError(f"{tag}: group {g} changed the NMS")
            ms[g] = _host_ms(lambda: nms(boxes, scores, **kw), dev, reps)
    finally:
        pp.SWEEPS_PER_SYNC, pp.nms_suppress = saved
    k = min(kw["topk"], scores.shape[-1])
    print(f"NMS {tag}: (B, C, K) {(scores.shape[0], scores.shape[1], k)}, "
          f"{sweeps} sweeps to the fixpoint; host ms per NMS: the kernel "
          f"{kernel_ms} (its device span {device_span}), the plain version "
          f"by sweeps a read {ms}")
    return {"bck": [scores.shape[0], scores.shape[1], k], "sweeps": sweeps,
            "nms_ms_kernel": kernel_ms, "nms_device_ms_kernel": device_span,
            "nms_ms_by_group": ms}


# float32 operations of one IoU test in nms_suppress: 2 max, 2 min, 2
# subtractions and 2 clamps for the overlap, its product, the union's
# add, subtract and clamp, the division and the comparison
NMS_IOU_OPS = 14


def _nms_bound(xyxy, sk, oidx, score_thresh, bw, f32_ops):
    """(bound ms, by) of ``nms_suppress`` on these inputs: the bytes it
    must move (xyxy, sk and oidx read once, keep written once) at the
    card's bandwidth, against the IoU tests the valid candidates need at
    the float32 peak outside the tensor cores: a pair's IoU does not
    depend on the class, so each image tests once each pair of candidates
    valid together in at least one class (at most K (K - 1) / 2),
    ``NMS_IOU_OPS`` float32 operations each. The scan's n dependent steps
    a block are the floor neither counts."""
    b, c, k = sk.shape
    nbytes = 4 * xyxy.numel() + 4 * sk.numel() + 8 * oidx.numel() + b * c * k
    v = (sk > score_thresh).to(torch.float32)
    # together[b, i, j]: the classes in which i and j are both valid
    together = torch.bmm(v.transpose(1, 2), v) > 0
    pairs = (int(together.sum()) - int(together.diagonal(0, 1, 2).sum())) // 2
    ops = NMS_IOU_OPS * float(pairs)
    t_bytes, t_ops = nbytes / bw * 1e3, ops / f32_ops * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def nms_kernel_rows(cases, bw, f32_ops) -> dict:
    """``nms_suppress`` against its plain version at each of ``cases``
    ((tag, engine, images): the suppress stage's arguments of the engine's
    detect of the images, built as ``device_nms_cols`` builds them from
    its arguments, ``_nms_args``): keep masks equal bit for bit; the
    kernel's and the plain version's ms (``device_ms``; the plain loop's
    span includes its host reads' gaps) beside the bound
    (``_nms_bound``); the plain loop's sweeps to its fixpoint on the same
    candidates. The first case's numbers, with every case under
    ``sizes``."""
    from dnn_inference_engine_tpu_torch import postprocess as pp
    sizes = []
    for tag, eng, images in cases:
        (boxes, scores), kw = _nms_args(eng, images)
        oidx, bk, sk = pp._nms_candidates(
            boxes, scores, min(kw["topk"], scores.shape[-1]))
        xyxy = pp._xyxy_cols(bk)
        iou_thresh, score_thresh = kw["iou_thresh"], kw["score_thresh"]
        args = (xyxy, sk, oidx, iou_thresh, score_thresh)
        keep = pp.nms_suppress(*args)
        ref, sweeps = pp.nms_fixpoint_plain(
            pp._dominance(sk, oidx, pp._iou_hit(xyxy, iou_thresh)),
            sk > score_thresh, return_sweeps=True)
        err = max_abs_err(keep, ref)
        if err or not torch.equal(ref, pp.nms_suppress_plain(*args)):
            raise AssertionError(f"nms_suppress {tag}: kernel != plain")
        ms = device_ms(lambda: pp.nms_suppress(*args), 20)
        plain_ms = device_ms(lambda: pp.nms_suppress_plain(*args), 5)
        bound, by = _nms_bound(xyxy, sk, oidx, score_thresh, bw, f32_ops)
        b, c, k = sk.shape
        valid = sk > score_thresh
        form = pp.nms_suppress_form(b, c, k, torch.cuda.get_device_properties(
            0).multi_processor_count)
        row = dict(tag=tag, bck=[b, c, k], max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   library_ms=None, cluster=form["cluster"],
                   rows_in_smem=form["rows_in_smem"],
                   lists_in_smem=form["lists_in_smem"],
                   valid=int(valid.sum()),
                   valid_max=int(valid.sum(-1).max()), kept=int(keep.sum()),
                   sweeps_max=int(sweeps.max()),
                   sweeps_mean=float(sweeps.float().mean()))
        sizes.append(row)
        where = ("shared memory" if form["rows_in_smem"] else
                 "global" if form["lists_in_smem"] else
                 "global, the lists too")
        print(f"  nms_suppress {tag} (B, C, K) {(b, c, k)}, cluster "
              f"{form['cluster']}, rows in {where}: "
              f"masks equal to the plain version; ms={ms:.4f} plain_ms="
              f"{plain_ms:.3f} bound_ms={bound:.3g} ({by}); valid "
              f"{row['valid']} (at most {row['valid_max']} a class), kept "
              f"{row['kept']}; the plain loop's sweeps max "
              f"{row['sweeps_max']} mean {row['sweeps_mean']:.2f}")
    out = {k: sizes[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}
    out["max_abs_err"] = max(r["max_abs_err"] for r in sizes)
    out["sizes"] = sizes
    return out


def _sweep_device_ms(shapes, reps=20):
    """Device ms of one Jacobi sweep (``postprocess._sweep``) at each
    (B, C, K): its cost rests on the shapes alone (dense bit operations),
    so the dominance words and masks are random."""
    from dnn_inference_engine_tpu_torch import postprocess as pp
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for b, c, k in shapes:
        w = -(-k // 64)
        dom = torch.randint(-2 ** 62, 2 ** 62, (b, c, k, w), device="cuda",
                            dtype=torch.int64, generator=gen)
        valid = torch.rand((b, c, k), device="cuda", generator=gen) < 0.5
        out[f"{b}x{c}x{k}"] = device_ms(lambda: pp._sweep(dom, valid, valid),
                                        reps)
        del dom
    print(f"one NMS sweep, device ms by BxCxK: {out}")
    return out


def _http(base: str, path: str, body=None):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(base + path, data=body,
                                 method="POST" if body is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _npy_bytes(img) -> bytes:
    import io
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def _http_round_trip(eng, card_images, size):
    """``serve_http`` on port 0 in front of a batcher on ``eng``: 4 ``.npy``
    POSTs from 4 threads, each JSON equal to ``boxes_to_original`` of a
    direct detect of its image; /stats, /healthz, a bad body (400).
    Returns the round trips of 20 POSTs one after another, ms."""
    import threading
    from dnn_inference_engine_tpu_torch.config import VOC_CLASSES
    from dnn_inference_engine_tpu_torch.preprocess import (
        boxes_to_original, preprocess_image)
    from dnn_inference_engine_tpu_torch.runtime.serve import (
        ContinuousBatcher)
    batcher = ContinuousBatcher(eng).start()
    srv = batcher.serve_http(port=0, host="127.0.0.1")
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    replies = {}
    try:
        ts = [threading.Thread(target=lambda i=i: replies.__setitem__(
            i, _http(base, "/detect", _npy_bytes(card_images[i]))))
              for i in range(len(card_images))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        body, one_ms = _npy_bytes(card_images[0]), []
        for _ in range(20):
            t0 = time.perf_counter()
            code, _ = _http(base, "/detect", body)
            one_ms.append((time.perf_counter() - t0) * 1e3)
            if code != 200:
                raise AssertionError(f"POST /detect: {code}")
        stats = _http(base, "/stats")
        health = _http(base, "/healthz")
        bad = _http(base, "/detect", b"neither an image nor .npy")
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop()
    if (stats[0] != 200 or stats[1]["images"] != len(card_images) + 20
            or health != (200, {"ok": True}) or bad[0] != 400):
        raise AssertionError(f"/stats {stats}, /healthz {health}, bad body "
                             f"{bad}")
    for i, img in enumerate(card_images):
        x, meta = preprocess_image(img, size)
        wire = np.zeros((eng.config.serve_max_batch, size, size, 3),
                        np.uint8)
        wire[0] = np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)
        b, s, c = (t[0] for t in eng.detect(wire))
        keep = s > 0
        want = {"boxes": boxes_to_original(b[keep], meta).tolist(),
                "scores": s[keep].tolist(), "classes": c[keep].tolist(),
                "names": [VOC_CLASSES[k] for k in c[keep]]}
        if replies[i] != (200, want):
            raise AssertionError(f"POST {i}: {replies[i][0]}, JSON != the "
                                 "direct detect's")
    print(f"serve_http: {len(card_images)} .npy POSTs (images "
          f"{[im.shape[:2] for im in card_images]}) equal to "
          f"boxes_to_original of the direct detect; /stats, /healthz, a bad "
          f"body 400; 20 POSTs one after another, ms: "
          f"{[round(t, 2) for t in one_ms]}")
    return one_ms


def _subprocess(args, timeout=300, rc=0):
    r = subprocess.run([sys.executable, "-m",
                        "dnn_inference_engine_tpu_torch.cli", *args],
                       cwd=Path(__file__).resolve().parent,
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode != rc:
        raise AssertionError(f"cli {args[0]} rc {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    return r.stdout


def _pil_steps(eng_eval, cpu_eval, ckpt: Path, size: int, dev_args):
    """With PIL: evaluate_voc over a JPEG tree written here (card against
    CPU, equal mAP), then ``cli detect --image --out`` in a process of its
    own."""
    from PIL import Image
    from dnn_inference_engine_tpu_torch.eval.voc_dataset import evaluate_voc
    root = frontdoor_dir() / "voc"
    base = root / "VOC2007"
    for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(21)
    ids = []
    for i, (h, w) in enumerate([(375, 500), (333, 500), (500, 375),
                                (416, 416)]):
        name = f"{i:06d}"
        ids.append(name)
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
                        ).save(base / "JPEGImages" / f"{name}.jpg")
        objs = "".join(
            f"<object><name>{n}</name><difficult>{d}</difficult><bndbox>"
            f"<xmin>{x}</xmin><ymin>{y}</ymin><xmax>{x + 90}</xmax>"
            f"<ymax>{y + 120}</ymax></bndbox></object>"
            for n, d, x, y in (("dog", 0, 20 + i, 30), ("car", 1, 100, 60),
                               ("person", 0, 150, 90 + i)))
        (base / "Annotations" / f"{name}.xml").write_text(
            f"<annotation>{objs}</annotation>")
    (base / "ImageSets/Main/test.txt").write_text("\n".join(ids))
    t0 = time.time()
    got = evaluate_voc(eng_eval, str(root))
    want = evaluate_voc(cpu_eval, str(root))
    if got != want or not np.isfinite(got["mAP@0.5"]):
        raise AssertionError(f"evaluate_voc card {got['mAP@0.5']} != CPU "
                             f"{want['mAP@0.5']}")
    print(f"evaluate_voc over {got['images']} JPEGs: card == CPU, mAP@0.5 "
          f"{got['mAP@0.5']} [{time.time() - t0:.1f} s]")
    img = frontdoor_dir() / "img.png"
    Image.fromarray(rng.integers(0, 256, (375, 500, 3)).astype(np.uint8)
                    ).save(img)
    out = _subprocess(["detect", "--mode", "w8a8", "--weights", str(ckpt),
                       "--image", str(img), "--out",
                       str(frontdoor_dir() / "det.png"), *dev_args])
    if "detections in" not in out or not (frontdoor_dir()
                                          / "det.png").exists():
        raise AssertionError(f"cli detect printed {out[-500:]}")
    print(f"cli detect --image --out: {out.splitlines()[-2]}")


def _worst_rms(out: str) -> float:
    """The worst layer of ``check-goldens``' relative RMS report."""
    line = next(ln for ln in out.splitlines() if ", worst " in ln)
    return float(line.split(", worst ")[1].rstrip(":"))


def _golden_steps(ckpt: Path, darknet: Path, dev_args) -> dict:
    """``dump-goldens`` of the darknet file on a seeded input, on the CPU
    and on ``dev_args``' device: every layer of the device's dump within
    F32_REL_TOL of that layer's largest CPU value. Then ``check-goldens``
    in w8a8 from the checkpoint against the CPU dump at the CLI's own
    limit (0.15 relative RMS a layer) must pass, and against the dump of
    another seed's darknet file (a wrong forward) must fail. Each command
    in a process of its own."""
    from dnn_inference_engine_tpu_torch.eval.golden import load_goldens
    from dnn_inference_engine_tpu_torch.models import build_model
    d = frontdoor_dir()
    g_cpu, g_dev, g_other = d / "g_cpu.npz", d / "g_dev.npz", d / "g_other.npz"
    _subprocess(["dump-goldens", "--weights", str(darknet), "--out",
                 str(g_cpu), *dev_args, "--device", "cpu"])
    _subprocess(["dump-goldens", "--weights", str(darknet), "--out",
                 str(g_dev), *dev_args])
    cpu, dev = load_goldens(str(g_cpu)), load_goldens(str(g_dev))
    rel = {li: float(np.abs(dev[li] - cpu[li]).max()
                     / np.abs(cpu[li]).max()) for li in cpu}
    if max(rel.values()) > F32_REL_TOL:
        raise AssertionError(f"fp32 goldens device vs CPU, max diff over "
                             f"the layer's largest value: {rel}")
    q = _worst_rms(_subprocess(
        ["check-goldens", "--mode", "w8a8", "--weights", str(ckpt),
         "--goldens", str(g_cpu), *dev_args]))
    other = write_darknet(build_model("yolov2-tiny"), d / "v2_other.weights",
                          17)
    _subprocess(["dump-goldens", "--weights", str(other), "--out",
                 str(g_other), *dev_args])
    out = _subprocess(["check-goldens", "--mode", "w8a8", "--weights",
                       str(ckpt), "--goldens", str(g_other), *dev_args],
                      rc=1)
    if "# FAIL" not in out:
        raise AssertionError(f"check-goldens passed a wrong forward: {out}")
    control = _worst_rms(out)
    print(f"goldens: fp32 device dump vs CPU dump, worst layer "
          f"{max(rel.values()):.3g} of its largest value (limit "
          f"{F32_REL_TOL:.3g}); check-goldens w8a8 vs the CPU dump worst "
          f"layer {q:.4f} (limit 0.15), vs another seed's weights "
          f"{control:.4f} (fails, as it must)")
    return {"fp32_dev_vs_cpu_rel": max(rel.values()), "w8a8_worst_rms": q,
            "wrong_weights_worst_rms": control}


def phase_front_door(card: str, dev=None, size: int = 416):
    """The user's front door, from files, on the card (``dev="cpu"`` and
    ``size=64`` rehearse it on the CPU, without the launch counts):
    a seeded darknet file and an ``.npz`` of uint8 calibration images
    build the b32 W8A8 engine (the noise calibration refused); its
    checkpoint loads into a card and a CPU engine (heads identical,
    detections equal at b2); requests through ``ContinuousBatcher`` on the
    b32 pin and (``max_batch`` 1) the b1 pin, each equal to its row of the
    card's detect, through the path's kernels by the launch counters,
    then the batcher timed in windows with nothing of this script in its
    path; the NMS's host time through the kernel (reading no host) and
    through the plain loop for each group size on the pins' and the eval
    grade's inputs, its sweeps to the fixpoint, one plain sweep's device
    time at serving and eval-grade K, and the kernel against its plain
    version at K 256, 845, 2535 and 5415 (``nms_kernel_rows``);
    ``serve_http``; the eval-grade detect card against CPU; the goldens (device dump against a CPU dump,
    ``check-goldens`` in w8a8 at its own limit and against a wrong
    forward); with PIL, evaluate_voc and ``cli detect``; the native host
    library. Prints the phase's numbers as one JSON line."""
    from dnn_inference_engine_tpu_torch import preprocess as pre
    from dnn_inference_engine_tpu_torch.config import (
        SCORE_THRESH_EVAL, EngineConfig)
    from dnn_inference_engine_tpu_torch.models import build_model
    from dnn_inference_engine_tpu_torch.models.weights import (
        load_darknet_weights)
    from dnn_inference_engine_tpu_torch.runtime import native_bridge
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine

    dev = torch.device(dev or "cuda")
    dev_args = [] if dev.type == "cuda" else ["--device", "cpu"]
    d = frontdoor_dir()
    numbers = {}
    t_phase = time.time()

    def at() -> str:
        return f"[{time.time() - t_phase:.1f} s into the phase]"
    # 1. the files
    darknet = write_darknet(build_model("yolov2-tiny"), d / "v2.weights", 7)
    calib = d / "calib.npz"
    np.savez(calib, images=np.random.default_rng(8).integers(
        0, 256, (8, 375, 500, 3)).astype(np.uint8))
    loads = []
    for _ in range(3):
        t0 = time.perf_counter()
        load_darknet_weights(build_model("yolov2-tiny"), str(darknet))
        loads.append((time.perf_counter() - t0) * 1e3)
    numbers["darknet_load_ms"] = loads
    # 2. the b32 engine from the files; noise calibration refused
    kw = dict(mode="w8a8", batch=32, serve_max_batch=32,
              weights=str(darknet), input_size=size)
    try:
        Engine(EngineConfig(**kw), device=dev).load_weights().prepare()
    except ValueError as e:
        if "needs real calibration images" not in str(e):
            raise
    else:
        raise AssertionError("file weights took the noise calibration")
    t0 = time.perf_counter()
    eng = Engine(EngineConfig(**kw, calib=str(calib)),
                 device=dev).load_weights().prepare()
    numbers["engine_from_files_s"] = time.perf_counter() - t0
    # 3. its checkpoint into a card and a CPU engine, b2
    ckpt = d / "ckpt.npz"
    eng.save(str(ckpt))
    b2 = dict(mode="w8a8", batch=2, input_size=size, weights=str(ckpt))
    gpu2 = Engine(EngineConfig(**b2), device=dev).load_weights().prepare()
    cpu2 = Engine(EngineConfig(**b2), device="cpu").load_weights().prepare()
    # the checkpoint keeps the scales in float32, as the engine uses them
    if not np.array_equal(np.float32(gpu2.act_scales),
                          np.float32(eng.act_scales)):
        raise AssertionError("checkpoint scales != the engine's")
    imgs2 = np.random.default_rng(9).integers(
        0, 256, (2, size, size, 3)).astype(np.uint8)
    hg, hc = gpu2.classify(imgs2), cpu2.classify(imgs2)
    if not np.array_equal(hg, hc):
        raise AssertionError(f"checkpoint heads card != CPU: max diff "
                             f"{np.abs(hg - hc).max()}")
    surv = _same_detections("checkpoint b2", gpu2.detect(imgs2),
                            cpu2.detect(imgs2))
    print(f"front door: darknet file ({darknet.stat().st_size} bytes) and "
          f"calibration .npz -> W8A8 b32 engine; noise calibration "
          f"refused; its checkpoint: card == CPU heads at b2, survivors "
          f"{surv} {at()}")
    # 4-5. served on the b32 and the b1 pins: correct rows and launches,
    # then timed windows; the NMS's sweeps and group size on their inputs
    v2 = dict(conv_w8a8=7, gemm_fused=1, stem_fused_k2=1, nms_suppress=1)
    n32, n1 = (200, 400) if dev.type == "cuda" else (3, 6)
    rng = np.random.default_rng(10)
    reqs = rng.integers(0, 256, (96, size, size, 3)).astype(np.uint8)
    syncs = _served_on_kernels("served b32 pin", eng, reqs, 4,
                               dict(v2, shift_s2d2=1), dev)
    numbers["serve_b32"] = {"nms_host_reads": syncs, "windows":
                            _timed_windows("served b32 pin, timed", eng,
                                           reqs, n32)}
    b1 = Engine(EngineConfig(mode="w8a8", batch=1, serve_max_batch=1,
                             input_size=size, weights=str(ckpt)),
                device=dev).load_weights().prepare()
    syncs = _served_on_kernels("served b1 pin", b1, reqs[:16], 4, v2, dev)
    numbers["serve_b1"] = {"nms_host_reads": syncs, "windows":
                           _timed_windows("served b1 pin, timed", b1, reqs,
                                          n1)}
    print(f"served both pins {at()}")
    nms = {"b32": _nms_groups("b32 pin", eng, reqs[:32], dev),
           "b1": _nms_groups("b1 pin", b1, reqs[:1], dev)}
    # 6. HTTP
    shapes = [(375, 500), (416, 416), (333, 500), (500, 375)]
    card_images = [rng.integers(0, 256, (h * size // 416, w * size // 416,
                                         3)).astype(np.uint8)
                   for h, w in shapes]
    numbers["http_npy_ms"] = _http_round_trip(eng, card_images, size)
    # host preprocessing of one 375x500 uint8 image, native and numpy
    img = card_images[0] if size != 416 else rng.integers(
        0, 256, (375, 500, 3)).astype(np.uint8)
    if not native_bridge.native_available():
        raise AssertionError("the native host library is not in use")
    saved = pre.native_preprocess_u8, pre.native_resize
    times = {}
    for name in ("native", "numpy"):
        if name == "numpy":
            pre.native_preprocess_u8 = pre.native_resize = \
                lambda *a: None
        try:
            pre.preprocess_image(img, size)
            ts = []
            for _ in range(20):
                t0 = time.perf_counter()
                pre.preprocess_image(img, size)
                ts.append((time.perf_counter() - t0) * 1e3)
            times[name] = float(np.median(ts))
        finally:
            pre.native_preprocess_u8, pre.native_resize = saved
    numbers["preprocess_ms"] = times
    # 7. eval grade: score 0.005, the NMS pool uncapped; card vs CPU, b2
    ev = dict(b2, score_thresh=SCORE_THRESH_EVAL)
    gpu_ev = Engine(EngineConfig(**ev), device=dev).load_weights().prepare()
    cpu_ev = Engine(EngineConfig(**ev), device="cpu").load_weights(
    ).prepare()
    if gpu_ev.config.resolved_nms_topk() < 845:
        raise AssertionError("the eval-grade pool is capped")
    surv = _same_detections("eval grade b2", gpu_ev.detect(imgs2),
                            cpu_ev.detect(imgs2))
    print(f"eval-grade detect (score {SCORE_THRESH_EVAL}, pool uncapped): "
          f"card == CPU at b2, survivors {surv} {at()}")
    nms["eval_b2"] = _nms_groups("eval grade b2", gpu_ev, imgs2, dev)
    if dev.type == "cuda":
        nms["sweep_device_ms"] = _sweep_device_ms(
            [(32, 20, 256), (1, 20, 256), (2, 20, 845), (32, 20, 845),
             (2, 20, 2535), (16, 20, 2535)])
        # the kernel at five sizes: the pins' K 256, the eval grade's
        # uncapped K 845, YOLOv3-tiny's 2535 and, at 608 px, its 5415 (the
        # candidates' lists in global memory too)
        v3_ev, v3_608 = (Engine(EngineConfig(
            model="yolov3-tiny", mode="w8a8", batch=2, input_size=px,
            score_thresh=SCORE_THRESH_EVAL),
            device=dev).load_weights(seed=0).prepare() for px in (size, 608))
        if v3_ev.config.resolved_nms_topk() < 2535:
            raise AssertionError("the YOLOv3 eval-grade pool is capped")
        imgs608 = np.random.default_rng(19).integers(
            0, 256, (2, 608, 608, 3)).astype(np.uint8)
        numbers["nms_suppress"] = nms_kernel_rows(
            [("b32 K 256", eng, reqs[:32]), ("b1 K 256", b1, reqs[:1]),
             ("eval b2 K 845", gpu_ev, imgs2),
             ("v3 eval b2 K 2535", v3_ev, imgs2),
             ("v3 eval 608 px b2 K 5415", v3_608, imgs608)],
            peaks(torch.cuda.get_device_name(0))[1],
            f32_peak(torch.cuda.get_device_name(0)))
        del v3_ev, v3_608
    numbers["nms"] = nms
    cfg = d / "config.json"
    EngineConfig(input_size=size).to_json(str(cfg))
    dev_args = [*dev_args, "--config", str(cfg)]
    numbers["goldens"] = _golden_steps(ckpt, darknet, dev_args)
    try:
        import PIL  # noqa: F401
        pil = True
    except ImportError:
        pil = False
    print(json.dumps({"pil": pil}))
    if pil:
        _pil_steps(gpu_ev, cpu_ev, ckpt, size, dev_args)
    # 8. native host library
    print(f"{at()} native host library in use: "
          f"{native_bridge.native_available()} "
          f"({native_bridge.SO_PATH.relative_to(Path(__file__).resolve().parent)})")
    print(json.dumps({"front_door": numbers, "card": card}))
    return numbers


# ---------------------------------------------------------------------------
# Phase 13: multi-device (parallel/, runtime/serve_distributed.py)
# ---------------------------------------------------------------------------

# conv_w8a8's int32-accumulator form at the row-parallel convs: YOLOv2-tiny
# L13's Cin shards (mp 2 and 4) at the local batches of the (1, 2) and
# (2, 2) meshes, YOLOv3-tiny L12's (mp 2, b16) and ResNet-18 L3's (mp 2,
# b32): (tag, x shape, Cout); the first is the (1, 2) mesh's launch
ACC_SHAPES = [("v2 L13 Cin512 b32", (32, 13, 13, 512), 1024),
              ("v2 L13 Cin512 b16", (16, 13, 13, 512), 1024),
              ("v2 L13 Cin256 b32", (32, 13, 13, 256), 1024),
              ("v2 L13 Cin256 b16", (16, 13, 13, 256), 1024),
              ("v3 L12 Cin256 b16", (16, 13, 13, 256), 1024),
              ("r18 L3 Cin32 b32", (32, 56, 56, 32), 64)]
# the meshes of the sharded detect, and its global batch (416 px)
MD_MESHES = (((1, 2), "channel"), ((2, 1), "replicated"),
             ((2, 2), "channel"))
MD_BATCH = 32
MD_SCORE = 0.02                     # survivors to compare in every image
MD_TIMEOUT = 300                    # seconds a group of ranks may take


def acc_rows(g, dev, ops_peak, bw) -> dict:
    """conv2d_w8a8_acc (the conv_w8a8 kernel's raw int32 store) against
    conv_acc_plain at ACC_SHAPES, int32 for int32; each launch timed on
    prepared operands beside the plain version, ``torch._int_mm`` on the
    im2col'd A (the product only) and the bound (the int32 output is 4
    bytes a sum). The row of the (1, 2) mesh's shape, with every shape
    under ``shapes``."""
    from dnn_inference_engine_tpu_torch.ops import _build
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.ops import gemm as gm
    from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
        extract_patches)
    sms = _build.sm_count(dev)
    shapes = []
    for tag, xs, cout in ACC_SHAPES:
        x = torch.randint(-127, 128, xs, generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (3, 3, xs[3], cout), generator=g,
                          device=dev, dtype=torch.int8)
        form = cv.conv_w8a8_form(*xs, cout, 3, 3, quantized=False, raw=True,
                                 sms=sms)
        before = cv.conv2d_w8a8.acc_launches
        got = cv.conv2d_w8a8_acc(x, w)
        if cv.conv2d_w8a8.acc_launches != before + 1 or got.dtype != \
                torch.int32:
            raise AssertionError(f"conv_w8a8_acc {tag}: not the kernel")
        ref = cv.conv_acc_plain(x, w)
        bt = gm.kmajor_weights(w)
        n, h, wd, cin = xs
        m, kk = n * h * wd, 9 * cin

        def kernel(f=form):
            return cv.conv_w8a8_launch(x, bt, None, None, None, 3, h, wd, 0,
                                       "linear", f, raw=True)
        err = max(max_abs_err(got, ref), max_abs_err(kernel(), ref))
        ms = device_ms(kernel, 10)
        plain_ms = device_ms(lambda: cv.conv_acc_plain(x, w), 2)
        a = extract_patches(x, 3, 3, 1, "SAME").reshape(m, kk)
        lib_ms = device_ms(lambda: torch._int_mm(a, bt.t()), 10)
        bound, by = _bound(2.0 * m * kk * cout,
                           x.numel() + w.numel() + 4 * m * cout, ops_peak, bw)
        shapes.append(dict(tag=tag, x=list(xs), N=cout, M=m, K=kk,
                           max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bound, bound_by=by,
                           route=form.route, kb=form.kb, steps=form.steps,
                           grid=form.grid, sk_tiles=form.sk_tiles))
        print(f"  conv_w8a8_acc {tag} x={xs} Cout={cout} (M={m} K={kk}): "
              f"int32 err={err} ms={ms:.4f} int_mm_ms={lib_ms:.4f} "
              f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} ({by}); "
              f"{form.route} kb {form.kb}, {schedule_line(form)}")
        if err != 0:
            raise AssertionError(f"conv_w8a8_acc {tag}: kernel != plain")
        del x, a, ref, got
    row = {k: shapes[0][k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}
    row["max_abs_err"] = max(s["max_abs_err"] for s in shapes)
    row["shapes"] = shapes
    return row


def md_dir() -> Path:
    return Path(__file__).resolve().parent / "build" / "multidev"


def _md_inputs(d: Path, dev=None, size: int = 416) -> None:
    """The weights (seed 0, calibrated on seeded images on ``dev``, the
    card by default), the global batch and the single-device detect,
    heads and ``stage_times``/``layer_times`` row names the ranks are
    held to."""
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    calib = np.random.default_rng(21).uniform(
        0, 1, (8, size, size, 3)).astype(np.float32)
    eng = Engine(EngineConfig(mode="w8a8", batch=MD_BATCH, input_size=size,
                              score_thresh=MD_SCORE),
                 device=dev).load_weights(seed=0).prepare(calib)
    eng.save(str(d / "v2.npz"))
    imgs = np.random.default_rng(22).integers(
        0, 256, (MD_BATCH, size, size, 3)).astype(np.uint8)
    np.save(d / "images.npy", imgs)
    b, s, c = eng.detect(imgs)
    np.savez(d / "ref.npz", boxes=b, scores=s, classes=c,
             head=eng.classify(imgs))
    # the single-device rows the profiling ranks' names are held to
    names = {"stages": [r["name"] for r in eng.stage_times(iters=(3, 1))],
             "layers": [n for n, _ in eng.layer_times(iters=(3, 1))]}
    (d / "names.json").write_text(json.dumps(names))


def _md_spawn(groups) -> dict:
    """Start every rank of every group at once ([(role, world, extra)]),
    each a process of this script (``--md-rank``) writing its output to a
    file of its own in ``md_dir()``, and wait for all of them together;
    (role, rank) -> (rc, the rank's ``MD`` JSON or None, output tail). A
    rank past MD_TIMEOUT is killed. Files, not pipes: a rank whose pipe
    no one reads blocks once the pipe is full, and the ranks waiting on
    it in a collective block with it."""
    d = md_dir()
    procs, logs = {}, {}
    for gi, (role, world, extra) in enumerate(groups):
        init = f"file://{d}/pg{gi}"
        for r in range(world):
            spec = dict(role=role, rank=r, world=world, init=init,
                        dir=str(d), **extra)
            env = dict(os.environ, OMP_NUM_THREADS="2")
            if role == "nccl2":
                env["NCCL_DEBUG"] = "WARN"
            logs[(gi, role, r)] = log = d / f"g{gi}_{role}_rank{r}.log"
            with open(log, "w") as f:
                procs[(gi, role, r)] = subprocess.Popen(
                    [sys.executable, __file__, "--md-rank",
                     json.dumps(spec)], stdout=f, stderr=subprocess.STDOUT,
                    env=env, cwd=Path(__file__).resolve().parent)
    deadline = time.time() + MD_TIMEOUT
    rcs = {}
    try:
        for key, p in procs.items():
            try:
                rcs[key] = p.wait(timeout=max(1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                rcs[key] = None
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for key, log in logs.items():
        text = log.read_text()
        md = [json.loads(ln[3:]) for ln in text.splitlines()
              if ln.startswith("MD ")]
        out[key] = (rcs[key], md[-1] if md else None, text[-3000:])
    return out


def _md_counts(counts: dict, acc: int, want_acc: int, tag: str) -> None:
    """One rank's launch counts of a b32 detect on the pin: 7 conv_w8a8
    (the row-parallel conv's raw form among them, ``want_acc``), 1
    gemm_fused, 1 k2 stem, 1 shift_s2d2, 1 nms_suppress, no other
    kernel."""
    want = {**{k: 0 for k in counts}, "conv_w8a8": 7, "gemm_fused": 1,
            "stem_fused_k2": 1, "shift_s2d2": 1, "nms_suppress": 1}
    if counts != want or acc != want_acc:
        raise AssertionError(f"multi-device {tag}: launches {counts} acc "
                             f"{acc}, want {want} acc {want_acc}")


def phase_multi_device(card: str, ops_peak, bw):
    """Phase 13: conv_w8a8's int32 form against its plain version
    (``acc_rows``); then, in processes of this script that share the card
    over gloo with CUDA tensors: the YOLOv2-tiny W8A8 b32 pin at 416 px on
    the meshes MD_MESHES, every rank's detect and heads equal to the
    single-device card detect bit for bit, with its launch counts; a
    one-rank NCCL group's int32 all_reduce on the card; two NCCL ranks on
    the one card (NCCL refuses a device shared by two ranks: the outcome
    is printed); and ``DistributedBatcher`` with a leader and a follower
    on (1, 2): 64 submits and one ``POST /detect``, every row equal to the
    single-device detect, the follower out with rc 0 after ``stop``; and
    the profiling ranks on (1, 2) channel and (2, 1) (``_md_profiles``).
    Returns (the kernel row, the (1, 2) rank 0's counts)."""
    import shutil
    from dnn_inference_engine_tpu_torch.ops import _build
    _build.build_all()              # the ranks load what is built here
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    row = acc_rows(g, dev, ops_peak, bw)
    torch.cuda.empty_cache()
    d = md_dir()
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    _md_inputs(d)
    torch.cuda.empty_cache()
    groups = [("mesh", mesh[0] * mesh[1], dict(mesh=mesh, sharding=sh))
              for mesh, sh in MD_MESHES]
    groups += [("nccl1", 1, {}), ("nccl2", 2, {})]
    t0 = time.time()
    res = _md_spawn(groups)
    print(f"  multi-device ranks ({sum(w for _, w, _ in groups)} processes "
          f"on one card): {time.time() - t0:.1f} s")
    main_counts = None
    for (gi, role, r), (rc, md, tail) in sorted(res.items()):
        if role == "nccl2":
            print(f"  NCCL, two ranks on one card, rank {r}: rc {rc}, "
                  f"{md and md['outcome']}")
            continue
        if rc != 0 or md is None or not md.get("ok"):
            raise AssertionError(f"multi-device {role} group {gi} rank {r} "
                                 f"failed (rc {rc}):\n{tail}")
        if role == "nccl1":
            print(f"  NCCL one-rank int32 all_reduce on the card: {md}")
            continue
        mesh, sh = tuple(md["mesh"]), md["sharding"]
        tag = f"{mesh} {sh} rank {r}"
        _md_counts(md["counts"], md["acc_launches"],
                   int(sh == "channel" and mesh[1] > 1), tag)
        print(f"  sharded detect {tag}: heads and detections equal to the "
              f"single-device card detect; launches {md['counts']}, "
              f"int32 form {md['acc_launches']}; detect "
              f"{md['detect_ms']:.1f} ms wall (ranks share one card: "
              "contention, not scaling)")
        if mesh == (1, 2) and r == 0:
            main_counts = dict(md["counts"],
                               conv_w8a8_acc=md["acc_launches"])
    t0 = time.time()
    res = _md_spawn([("serve", 2, dict(mesh=(1, 2), sharding="channel"))])
    for (_, _, r), (rc, md, tail) in sorted(res.items()):
        if rc != 0 or md is None or not md.get("ok"):
            raise AssertionError(f"multi-device serve rank {r} failed "
                                 f"(rc {rc}):\n{tail}")
        print(f"  DistributedBatcher (1, 2) rank {r}: {md}")
    print(f"  multi-device serving: {time.time() - t0:.1f} s")
    t0 = time.time()
    profiled = _md_profiles([("profile", 2, dict(mesh=mesh, sharding=sh))
                             for mesh, sh in MD_MESHES[:2]], card)
    print(f"  multi-device profiling: {time.time() - t0:.1f} s")
    print(json.dumps({"multi_device": {
        "conv_w8a8_acc": {k: v for k, v in row.items() if k != "shapes"},
        "main_path_counts": main_counts, "profiled": profiled,
        "card": card}}))
    return row, main_counts


def _md_profiles(groups, card: str) -> dict:
    """The profiling ranks (``_md_profile``) of ``groups``: every rank ok,
    each group's ranks with one set of loop counts; a line a rank, and
    rank 0's ``cli trace --detect`` lines. Returns each rank's module ms
    and stage sum by mesh."""
    res = _md_spawn(groups)
    out = {}
    for (gi, _, r), (rc, md, tail) in sorted(res.items()):
        if rc != 0 or md is None or not md.get("ok"):
            raise AssertionError(f"multi-device profile group {gi} rank {r} "
                                 f"failed (rc {rc}):\n{tail}")
        tag = f"{tuple(md['mesh'])} {md['sharding']}"
        first = out.setdefault(tag, {"iters": md["iters"]})
        if md["iters"] != first["iters"]:
            raise AssertionError(f"profile {tag}: rank {r}'s loop counts "
                                 f"{md['iters']} != rank 0's {first['iters']}")
        stage_ms = sum(ms for _, ms, _ in md["stages"])
        first[f"rank{r}"] = {"module_ms": md["module_ms"],
                             "stage_ms": stage_ms,
                             "conv_us": sum(md["layers_us"])}
        print(f"  profile {tag} rank {r}: stage_times_traced module "
              f"{md['module_ms']} ms device, isolated stages {stage_ms:.4f}"
              f" ms, layer_times convs {sum(md['layers_us']):.1f} us, row "
              f"names the single-device engine's, loop counts rank 0's; "
              f"{md['seconds']:.1f} s (ranks share one card) [{card}]")
        if r == 0 and "trace" in md:
            print("    cli trace --detect on the mesh, rank 0:\n"
                  + "\n".join("      " + ln
                              for ln in md["trace"].splitlines()))
    return out


def _md_rank(spec: dict) -> int:
    """One rank of phase 13 (``--md-rank``): prints ``MD {...}``. The
    spec's optional ``device`` and ``input_size`` rehearse it on the CPU
    (``device="cpu"``, 64 px)."""
    import torch.distributed as dist
    role, rank, world = spec["role"], spec["rank"], spec["world"]
    if role == "nccl2":
        torch.cuda.set_device(0)
        try:
            dist.init_process_group("nccl", init_method=spec["init"],
                                    world_size=world, rank=rank)
            t = torch.ones(4, dtype=torch.int32, device="cuda")
            dist.all_reduce(t)
            torch.cuda.synchronize()
            outcome = f"ran: sum {t.tolist()}"
        except Exception as e:      # noqa: BLE001 — the outcome is the result
            outcome = f"refused: {type(e).__name__}: {str(e)[:300]}"
        print("MD " + json.dumps({"ok": True, "outcome": outcome}),
              flush=True)
        os._exit(0)                 # no teardown of a failed communicator
    from dnn_inference_engine_tpu_torch.parallel.mesh import (
        all_reduce_sum, init_distributed)
    if role == "nccl1":
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=spec["init"],
                                world_size=1, rank=0)
        t = torch.arange(-5, 1000, dtype=torch.int32, device="cuda") * 7919
        got = all_reduce_sum(t.clone(), dist.group.WORLD)
        torch.cuda.synchronize()
        print("MD " + json.dumps({"ok": bool(torch.equal(got, t)),
                                  "backend": dist.get_backend(),
                                  "numel": t.numel()}), flush=True)
        dist.destroy_process_group()
        return 0
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    d = Path(spec["dir"])
    init_distributed(spec["init"], world, rank, backend="gloo",
                     timeout_s=MD_TIMEOUT)
    mesh = tuple(spec["mesh"])
    if role == "profile":
        print("MD " + json.dumps(_md_profile(spec, d, mesh, rank)),
              flush=True)
        if dist.is_initialized():
            dist.destroy_process_group()
        return 0
    eng = Engine(EngineConfig(
        mode="w8a8", batch=MD_BATCH, serve_max_batch=MD_BATCH,
        input_size=spec.get("input_size", 416), score_thresh=MD_SCORE,
        mesh_shape=mesh,
        sharding=spec["sharding"], weights=str(d / "v2.npz")),
        device=spec.get("device")).load_weights().prepare()
    imgs = np.load(d / "images.npy")
    with np.load(d / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    if role == "mesh":
        eng.detect(imgs)            # warm
        _sync(eng.device)
        dist.barrier()
        reset_counts()
        t0 = time.perf_counter()
        det = eng.detect(imgs)
        _sync(eng.device)
        ms = (time.perf_counter() - t0) * 1e3
        counts, acc = read_counts(), cv.conv2d_w8a8.acc_launches
        head = eng.classify(imgs)
        ok = np.array_equal(head, ref["head"]) and all(
            np.array_equal(a, ref[k])
            for a, k in zip(det, ("boxes", "scores", "classes")))
        out = dict(ok=bool(ok), mesh=mesh, sharding=spec["sharding"],
                   counts=counts, acc_launches=acc, detect_ms=ms,
                   im2col=cv.conv2d_w8a8.im2col_launches)
    else:
        out = _md_serve(eng, rank, imgs, ref)
    dist.barrier()
    dist.destroy_process_group()
    print("MD " + json.dumps(out), flush=True)
    return 0


def _md_profile(spec: dict, d: Path, mesh, rank: int) -> dict:
    """Phase 13's profiling ranks (A15): this rank's
    ``stage_times_traced`` (auto-scaled loop counts: rank 0's on every
    rank) and ``layer_times`` on its shard, their row names held to the
    single-device engine's; then ``cli trace --detect --mesh`` in this
    process (rank 0's output kept), which takes the group down. On the
    CPU rehearsal ``stage_times`` at fixed counts and no trace. A line a
    step, flushed, so that a rank killed at MD_TIMEOUT shows its step."""
    import contextlib
    import io
    from dnn_inference_engine_tpu_torch import cli
    from dnn_inference_engine_tpu_torch.config import EngineConfig
    from dnn_inference_engine_tpu_torch.runtime.engine import Engine
    size = spec.get("input_size", 416)
    calib = np.random.default_rng(21).uniform(
        0, 1, (8, size, size, 3)).astype(np.float32)
    eng = Engine(EngineConfig(
        mode="w8a8", batch=MD_BATCH, input_size=size, score_thresh=MD_SCORE,
        mesh_shape=mesh, sharding=spec["sharding"]),
        device=spec.get("device")).load_weights(seed=0).prepare(calib)
    on_card = eng.device.type == "cuda"
    t0 = time.perf_counter()

    def step(what):
        print(f"md profile rank {rank}: {what} at "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    step("prepared")
    traced = eng.stage_times_traced(runs=5) if on_card else None
    rows = ([r for r in traced["stages"] if r["stage"] is not None]
            if on_card else eng.stage_times(iters=(4, 2)))
    step("stage times")
    layers = eng.layer_times(iters=(20, 5))
    step("layer times")
    secs = time.perf_counter() - t0
    names = json.loads((d / "names.json").read_text())
    same = ([r["name"] for r in rows] == names["stages"]
            and [n for n, _ in layers] == names["layers"])
    out = dict(ok=same, mesh=mesh, sharding=spec["sharding"],
               iters=[r["iters"] for r in rows],
               stages=[(r["name"], r["ms"], r.get("trace_ms")) for r in rows],
               module_ms=traced and traced["module_ms"],
               layers_us=[round(t * 1e6, 1) for _, t in layers],
               seconds=secs)
    if on_card:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([
                "trace", "--detect", "--mesh", f"{mesh[0]},{mesh[1]}",
                "--sharding", spec["sharding"], "--backend", "gloo",
                "--mode", "w8a8", "--batch", str(MD_BATCH), "--runs", "5",
                "--score-thresh", str(MD_SCORE),
                "--weights", str(d / "v2.npz")])
        text = buf.getvalue()
        step("trace")
        out["trace"] = text
        out["ok"] = same and rc == 0 and (rank != 0 or all(
            sc in text for sc in POST_SCOPES))
    return out


def _md_serve(eng, rank, imgs, ref) -> dict:
    """Phase 13's serving ranks: the leader submits the batch twice (64
    images) and POSTs one image over HTTP, each row held to the
    single-device detect; the follower mirrors until ``stop``."""
    from dnn_inference_engine_tpu_torch.runtime.serve_distributed import (
        DistributedBatcher, follower_loop)
    if rank != 0:
        served = follower_loop(eng, leader_timeout_s=120.0)
        return dict(ok=served >= 2, served=served)
    n = len(imgs)
    b = DistributedBatcher(eng, timeout_ms=50).start()
    try:
        t0 = time.perf_counter()
        futs = [b.submit(imgs[i % n]) for i in range(2 * n)]
        rows = [f.result(timeout=300) for f in futs]
        secs = time.perf_counter() - t0
        srv = b.serve_http(port=0, host="127.0.0.1")
        try:
            status, http = _http(f"http://127.0.0.1:{srv.server_address[1]}",
                                 "/detect", _npy_bytes(imgs[0]))
        finally:
            srv.shutdown()
            srv.server_close()
    finally:
        b.stop()
    ok = all(np.array_equal(a, ref[k][i % n])
             for i, row in enumerate(rows)
             for a, k in zip(row, ("boxes", "scores", "classes")))
    # an image at the input size is its own network frame: the reply's
    # boxes are the detect's
    keep = ref["scores"][0] > 0
    ok = ok and status == 200 \
        and http["scores"] == ref["scores"][0][keep].tolist() \
        and http["classes"] == ref["classes"][0][keep].tolist() \
        and http["boxes"] == ref["boxes"][0][keep].tolist()
    return dict(ok=bool(ok), images=len(rows), http_detections=len(
        http["scores"]), images_per_s_contended=len(rows) / secs)


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
    peaks_f32 = (tf32_peak(name), f32_peak(name))
    print(f"peaks used for bounds: {ops_peak / 1e12:.0f} int8 TOP/s, "
          f"{peaks_f32[0] / 1e12:.0f} TF32 TFLOP/s, {peaks_f32[1] / 1e12:.0f}"
          f" float32 TFLOP/s (no tensor cores), {bw / 1e12:.2f} TB/s")
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
    rows.update(timed("conv_w8a8 kernel", phase_conv_w8a8,
                      torch.device("cuda"), ops_peak, bw))
    torch.cuda.empty_cache()
    entry_rows = timed("conv_w8a8_rows kernel", phase_rows_kernel,
                       torch.device("cuda"), ops_peak, bw)
    torch.cuda.empty_cache()
    rows.update(timed("gemm_f32 kernel", phase_gemm_f32,
                      torch.device("cuda"), peaks_f32, bw))
    torch.cuda.empty_cache()
    rows.update(timed("strategy kernels", phase_strategy_kernels,
                      torch.device("cuda"), ops_peak, bw))
    torch.cuda.empty_cache()
    attic_rows, tail_launches = timed("attic kernels", phase_attic_kernels,
                                      torch.device("cuda"), ops_peak, bw)
    rows.update(attic_rows)
    torch.cuda.empty_cache()
    dma_rows, tools_launches = timed("dma kernels", phase_dma_kernels,
                                     torch.device("cuda"), ops_peak, bw)
    rows.update(dma_rows)
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
    # the 3x3 convs (and the k2 folds) on conv_w8a8, the 1x1 convs on
    # gemm_fused; S1 and S2's gemm-tier stages (gemm, and auto where
    # use_pallas says so) on gemm_fused in the folded order
    v2 = dict(conv_w8a8=7, gemm_fused=1, stem_fused_k2=1)
    v3 = dict(conv_w8a8=8, gemm_fused=4, stem_fused_dg=1, shift_s2d2=1)
    s1 = dict(conv_w8a8=3, gemm_fused=4, quant_space_to_depth4=1,
              gmax_shift_s2d2=1, conv3x3_rs=2)
    s2 = dict(conv_w8a8=4, gemm_fused=3, quant_space_to_depth4=1,
              conv3x3_rs=2)
    s3 = dict(stage0_fused=1, conv_w8a8=7, gemm_fused=1, shift_s2d2=1)
    f32_v2 = dict(gemm_f32=len(F32_B32_GEMMS))
    f32_v3 = dict(gemm_f32=len(F32_B16_V3_GEMMS))

    def main_paths():
        counts = {
            "yolov2-tiny": phase_main_path("yolov2-tiny", 32,
                                           dict(v2, shift_s2d2=1), card,
                                           gemms=B32_GEMMS),
            "yolov3-tiny": phase_main_path("yolov3-tiny", 16, v3, card,
                                           gemms=B16_V3_GEMMS),
        }
        phase_main_path("yolov2-tiny", 1, v2, card, gemms=B1_GEMMS)
        phase_main_path("yolov3-tiny", 1, v3, card)
        counts["S1"] = phase_main_path("yolov2-tiny", 32, s1, card, "S1")
        phase_main_path("yolov2-tiny", 1, s1, card, "S1")
        phase_main_path("yolov2-tiny", 32, s2, card, "S2")
        counts["S3"] = phase_main_path("yolov2-tiny", 32, s3, card, "S3")
        phase_main_path("yolov2-tiny", 1, s3, card, "S3")
        # EngineConfig() defaults: fp32, kernel auto (the generic forward,
        # gemm_f32 on the tier_report "pallas" layers)
        counts["fp32"] = phase_main_path("yolov2-tiny", 32, f32_v2, card,
                                         mode="fp32")
        phase_main_path("yolov2-tiny", 1, f32_v2, card, mode="fp32")
        phase_main_path("yolov3-tiny", 16, f32_v3, card, mode="fp32")
        phase_main_path("yolov3-tiny", 1, f32_v3, card, mode="fp32")
        # the w8 plans: bf16 convs on cuDNN, no port kernel
        phase_main_path("yolov2-tiny", 32, {}, card, mode="w8")
        phase_main_path("yolov2-tiny", 1, {}, card, mode="w8")
        phase_main_path("yolov3-tiny", 16, {}, card, mode="w8")
        phase_main_path("yolov3-tiny", 1, {}, card, mode="w8")
        return counts
    counts = timed("main paths", main_paths)
    timed("stage compare", phase_stage_compare, card)
    timed("sweep", phase_sweep, card)
    timed("modes card vs CPU", phase_modes_card_vs_cpu)
    timed("w8 pallas forward", phase_w8_pallas_forward, card)
    torch.cuda.empty_cache()
    resnet_rows, counts["resnet18"] = timed("resnet18", phase_resnet18, card,
                                            ops_peak, bw)
    rows["conv_w8a8"]["resnet18"] = {
        b: {k: v for k, v in r.items() if k != "stem"}
        for b, r in resnet_rows.items()}
    # the row's figures are the ResNet-18 stem's at b32, its main path's
    shapes = {**{f"resnet18 stem {b}": r["stem"]
                 for b, r in resnet_rows.items()}, **entry_rows}
    stem = shapes["resnet18 stem b32"]
    rows["conv_w8a8_rows"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in shapes.values()),
        **{k: stem[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "im2col_gemm_ms", "u8_ms",
                                "issue_bound_ms")},
        shapes=shapes)
    torch.cuda.empty_cache()
    prof = timed("profiling", phase_profiling, card)
    torch.cuda.empty_cache()
    timed("bench", phase_bench, card, prof)
    torch.cuda.empty_cache()
    rows["nms_suppress"] = timed("front door", phase_front_door,
                                 card)["nms_suppress"]
    torch.cuda.empty_cache()
    rows["conv_w8a8_acc"], counts["multi-device"] = timed(
        "multi-device", phase_multi_device, card, ops_peak, bw)
    print(f"total {time.time() - t0:.1f} s (phases: "
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items()) + ")")

    # each kernel's launches from the main path that runs it: the YOLOv2
    # b32 detect, the YOLOv3 b16 detect for the per-tap stem, the S1 b32
    # detect for the strategy plans' kernels, the S3 b32 detect for
    # stage0_fused, the b32 tail pass for conv3x3_bt (on no detect path),
    # the copy-engine tools' mains for conv_dma and tma_probe, and the
    # YOLOv2 b32 fp32 detect (EngineConfig()'s defaults) for gemm_f32, the
    # (1, 2) mesh's rank 0 b32 detect for conv_w8a8's int32 form, and the
    # ResNet-18 W8A8 b32 classify for the small-Cin form
    counts["tail"] = {"conv3x3_bt": tail_launches}
    counts["tools"] = tools_launches
    path_of = {"stem_fused_dg": "yolov3-tiny", "quant_space_to_depth4": "S1",
               "gmax_shift_s2d2": "S1", "conv3x3_rs": "S1",
               "stage0_fused": "S3", "conv3x3_bt": "tail",
               "conv_dma": "tools", "tma_probe": "tools",
               "gemm_f32": "fp32", "conv_w8a8_acc": "multi-device",
               "conv_w8a8_rows": "resnet18"}
    kernels = []
    for kname, meta in KERNELS.items():
        path = path_of.get(kname, "yolov2-tiny")
        row = dict(name=kname, **meta, launches=counts[path][kname])
        row.update(rows[kname])
        if path != "resnet18" and counts["resnet18"].get(kname):
            # the ResNet-18 W8A8 b32 classify's launches beside the row's
            # own path's
            row["resnet18_launches"] = counts["resnet18"][kname]
        kernels.append(row)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


_QS2D4_TURN = """
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
from dnn_inference_engine_tpu_torch.ops import fused_conv as fc
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(3)
xu = torch.randint(0, 256, (32, 416, 416, 3), generator=g, device=dev,
                   dtype=torch.uint8)
x1, xf, b = xu[:1].contiguous(), xu.float() / 255.0, (1, 7, 1, 7)
def ms(x, **kw):
    return cs.device_ms(lambda: fc.quant_space_to_depth4(
        x, 0.0078431377, pad_to=64, **kw), 20)
print("AB " + json.dumps({{"S1 b32": ms(xu, pad_hw=b), "S2 b32": ms(xu),
                          "f32 S1 b32": ms(xf, pad_hw=b),
                          "S1 b1": ms(x1, pad_hw=b)}}))
"""


def _ab(base: Path, turn: str, label: str, **fields) -> int:
    """``turn`` (a script for ``python -c`` that prints one line ``AB
    {case: ms}``, formatted with ``root``, its checkout, and ``fields``)
    run from another checkout (``base``, for example the
    parent commit unpacked by ``git archive`` into a directory that
    ``.gitignore`` lists) and from this one, in turns (base, this, this,
    base) on one card, each turn a process of its own from its checkout's
    root, which builds its own kernels; prints each turn and each case's
    means as ``label case: base ms this ms``."""
    here = Path(__file__).resolve().parent
    runs = {"base": [], "this": []}
    for name, root in (("base", base.resolve()), ("this", here),
                       ("this", here), ("base", base.resolve())):
        r = subprocess.run([sys.executable, "-c",
                            turn.format(root=str(root), **fields)],
                           cwd=root, capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"turn in {root} failed:\n{r.stdout[-3000:]}"
                               f"\n{r.stderr[-3000:]}")
        t = json.loads(next(x for x in r.stdout.splitlines()
                            if x.startswith("AB "))[3:])
        runs[name].append(t)
        print(f"{name}: " + "; ".join(f"{k} {v:.4f}" for k, v in t.items()),
              flush=True)
    card = card_line()
    for case in runs["this"][0]:
        mean = {n: sum(t[case] for t in ts) / len(ts)
                for n, ts in runs.items()}
        print(f"{label} {case}: base {mean['base']:.4f} this "
              f"{mean['this']:.4f} ms ({mean['this'] / mean['base']:.3f} of "
              f"base) [{card}]")
    return 0


def qs2d4_ab(base: Path) -> int:
    """quant_space_to_depth4 of ``base`` and of this checkout in turns
    (``_ab``): the S1 and S2 b32 entries (u8), S1 f32 and the S1 b1 entry,
    ms a launch (``device_ms``)."""
    return _ab(base, _QS2D4_TURN, "quant_space_to_depth4")


_ROWS_TURN = """
import json, sys, torch
sys.path.insert(0, {root!r})
from dnn_inference_engine_tpu_torch.ops import _build
from dnn_inference_engine_tpu_torch.ops import conv as cv
from dnn_inference_engine_tpu_torch.quant.quantize import f32_scalar
from dnn_inference_engine_tpu_torch.runtime.benchlib import device_ms
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(22)
out = {{}}
for tag, xs, k, stride, cout, act in {shapes!r}:
    x = torch.randint(-127, 128, xs, generator=g, device=dev,
                      dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, k, xs[3], cout), generator=g,
                       device=dev, dtype=torch.int8)
    s_w = (torch.rand(cout, generator=g, device=dev) + 0.5) * 1e-3
    b = torch.randn(cout, generator=g, device=dev)
    plan = cv.rows_plan(*xs, cout, k, stride, _build.sm_count(dev))
    tile = cv.rows_tile_matrix(wq)
    scale = f32_scalar(0.02, dev) * s_w
    def kernel():
        return cv.conv_w8a8_rows(x, tile, scale, b, 0.05, k, stride, act,
                                 plan)
    ref = cv.conv2d_w8a8_plain(x, 0.02, wq, s_w, b, act=act, stride=stride,
                               s_out=0.05)
    assert torch.equal(kernel(), ref), tag
    out[tag] = device_ms(kernel, 20)
print("AB " + json.dumps(out))
"""
# rows_conv_row's shapes: (tag, x shape, k, stride, Cout, act)
ROWS_AB_SHAPES = [("resnet18 stem b32", (32, 224, 224, 3), 7, 2, 64, "relu"),
                  ("resnet18 stem b1", (1, 224, 224, 3), 7, 2, 64, "relu"),
                  ("yolo entry conv b2", (2, 416, 416, 3), 3, 1, 16,
                   "leaky"),
                  ("yolo entry conv b8", (8, 416, 416, 3), 3, 1, 16,
                   "leaky")]


def rows_ab(base: Path) -> int:
    """conv_w8a8_rows of ``base`` and of this checkout in turns (``_ab``):
    ms a launch (``device_ms``) at rows_conv_row's shapes, each launch
    held to the plain version."""
    return _ab(base, _ROWS_TURN, "conv_w8a8_rows", shapes=ROWS_AB_SHAPES)


def rows_sweep() -> int:
    """conv_w8a8_rows at rows_conv_row's shapes (``ROWS_AB_SHAPES``) under
    every unit size of ROWS_UNIT_TILES and 1-3 blocks an SM, ms a launch
    (``device_ms``), each plan's output held to the plain version: the
    timing ROWS_UNIT_COST and ROWS_BLOCKS_PER_SM are fitted to
    (``--rows-sweep``)."""
    from dnn_inference_engine_tpu_torch.ops import _build
    from dnn_inference_engine_tpu_torch.ops import conv as cv
    from dnn_inference_engine_tpu_torch.quant.quantize import f32_scalar
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    dev = torch.device("cuda")
    sms = _build.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(22)
    tiles = cv.ROWS_UNIT_TILES
    for tag, xs, k, stride, cout, act in ROWS_AB_SHAPES:
        x = torch.randint(-127, 128, xs, generator=g, device=dev,
                          dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, k, xs[3], cout), generator=g,
                           device=dev, dtype=torch.int8)
        s_w = (torch.rand(cout, generator=g, device=dev) + 0.5) * 1e-3
        b = torch.randn(cout, generator=g, device=dev)
        tile = cv.rows_tile_matrix(wq)
        scale = f32_scalar(0.02, dev) * s_w
        ref = cv.conv2d_w8a8_plain(x, 0.02, wq, s_w, b, act=act,
                                   stride=stride, s_out=0.05)
        plans = {}
        try:
            for t in tiles:
                # rows_plan's own geometry with one unit size to choose from
                cv.ROWS_UNIT_TILES = (t,)
                plans[f"{cv.ROWS_TILE * t} px"] = cv.rows_plan.__wrapped__(
                    *xs, cout, k, stride, sms)
        finally:
            cv.ROWS_UNIT_TILES = tiles
        plan = cv.rows_plan(*xs, cout, k, stride, sms)
        for bps in (1, 2, 3):
            plans[f"{bps} blocks an SM"] = plan._replace(
                grid=min(plan.units, bps * sms))
        ms = {}
        for name, q in plans.items():
            def kernel(q=q):
                return cv.conv_w8a8_rows(x, tile, scale, b, 0.05, k, stride,
                                         act, q)
            if not torch.equal(kernel(), ref):
                raise AssertionError(f"{tag} {name}: differs from the plain "
                                     "version")
            ms[name] = round(device_ms(kernel, 20), 4)
        print(f"conv_w8a8_rows {tag}: the plan's {plan.upx} px a unit, grid "
              f"{plan.grid}; ms by plan {ms} [{card}]", flush=True)
    return 0


def profiling_only() -> int:
    """Phase 12 alone (``--profiling``): the kernels build at first use."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    t0 = time.time()
    phase_profiling(card)
    print(f"profiling: {time.time() - t0:.1f} s")
    return 0


def bench_only() -> int:
    """Phase 14 alone (``--bench``), with phase 12's two reference
    figures measured first (``bench_refs``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    t0 = time.time()
    phase_bench(card, bench_refs(card))
    print(f"bench: {time.time() - t0:.1f} s")
    return 0


def front_door_only() -> int:
    """Phase 10 alone (``--front-door``): the kernels build at first use."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    t0 = time.time()
    phase_front_door(card)
    print(f"front door: {time.time() - t0:.1f} s")
    return 0


def multi_device_only() -> int:
    """Phase 13 alone (``--multi-device``): the kernels build first."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    t0 = time.time()
    phase_multi_device(card, *peaks(torch.cuda.get_device_name(0)))
    print(f"multi-device: {time.time() - t0:.1f} s")
    return 0


def resnet18_only() -> int:
    """Phase 11 alone (``--resnet18``): the kernels build at first use."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    t0 = time.time()
    phase_resnet18(card, *peaks(torch.cuda.get_device_name(0)))
    print(f"resnet18: {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--qs2d4-ab":
        sys.exit(qs2d4_ab(Path(sys.argv[2])))
    if len(sys.argv) == 3 and sys.argv[1] == "--rows-ab":
        sys.exit(rows_ab(Path(sys.argv[2])))
    if sys.argv[1:] == ["--rows-sweep"]:
        sys.exit(rows_sweep())
    if sys.argv[1:] == ["--front-door"]:
        sys.exit(front_door_only())
    if sys.argv[1:] == ["--resnet18"]:
        sys.exit(resnet18_only())
    if sys.argv[1:] == ["--profiling"]:
        sys.exit(profiling_only())
    if sys.argv[1:] == ["--bench"]:
        sys.exit(bench_only())
    if sys.argv[1:] == ["--multi-device"]:
        sys.exit(multi_device_only())
    if len(sys.argv) == 3 and sys.argv[1] == "--md-rank":
        sys.exit(_md_rank(json.loads(sys.argv[2])))
    sys.exit(main())
