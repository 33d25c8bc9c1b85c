"""Convolutions, the xla tier: fp32, w8 (strict f32 and bf16) and W8A8.

Counterpart of ``dnn_inference_engine_tpu/ops/conv.py``. NHWC
activations, HWIO weights. The float convs are cuDNN's, as the JAX
package's are XLA's. PyTorch has no int8-in, int32-accumulate conv on
CUDA (and ``F.conv2d`` on int8 wraps around), so the JAX package's XLA
int8 conv is a kernel of the port: ``conv2d_w8a8`` launches
``csrc/conv_w8a8.cu`` (an implicit-GEMM conv on Hopper's ``wgmma`` that
reads the activation in place, with the conv-order epilogue and,
optionally, a fold stage's group-max) for every form that
``conv_w8a8_form`` gives it: the 3x3 SAME and shifted-fold 2x2 VALID
convs of the plans and of ``Model.forward``, int8 or (a linear conv, no
group-max) f32 out, and ResNet-18's stride-2 3x3 and 1x1 SAME convs. A
small Cin (Cin % 16 != 0, kw Cin <= 32: ResNet-18's 7x7/s2 stem and the
YOLO models' 3x3 entry conv, Cin 3) takes ``csrc/conv_w8a8_rows.cu``,
which reads the raw rows of the input into shared memory and each
kernel row of a patch from them as one run of K. A 1x1 stride-1 conv is
the fused int8 GEMM (ops/gemm.py) on a view of the activation; the forms
both kernels refuse (``conv_w8a8_form``'s "im2col": a group-max or the
int32 accumulator at such a Cin, kw Cin > 32, any other kernel size,
stride or padding) take an im2col and that GEMM. ``conv2d_w8a8_plain``
is the plain version of the whole function: ``conv_acc_plain``'s exact
int32 product, then ``conv_epilogue``.

``conv2d_w8a8_acc`` is the int32-accumulator form of the same conv (XLA's
int8 conv with ``preferred_element_type=int32``, no epilogue), which the
row-parallel conv of the channel-sharded forward sums across ranks
(parallel/shard_map_forward.py): the kernel's raw store on its forms,
else ``conv_lowering.conv2d_int8_acc``; ``conv_acc_plain`` is its plain
version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dnn_inference_engine_tpu_torch.ops import _build
from dnn_inference_engine_tpu_torch.ops.activations import (
    KERNEL_ACT_CODES, apply_activation)
from dnn_inference_engine_tpu_torch.ops.conv_lowering import (
    _same_pads, conv2d_int8_acc, extract_patches, gemm_weights)
from dnn_inference_engine_tpu_torch.ops.fused_conv import (
    group_max4, rs_tile_matrix)
from dnn_inference_engine_tpu_torch.ops.gemm import (
    H100_SMS, WG_BK, WG_BM, WG_BN, GemmForm, epilogue_plain, gemm_fused,
    int32_acc_plain, k_splits, kmajor_weights, ptr_or_none, split_buffers)
from dnn_inference_engine_tpu_torch.quant.quantize import (
    Scale, f32_scalar, f32_tensor, quantize_act)
from dnn_inference_engine_tpu_torch.runtime.profiling import launch_span


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int, padding,
               allow_tf32: bool = False) -> torch.Tensor:
    """NHWC f32 x HWIO f32 -> NHWC f32 with XLA's padding rules, on cuDNN
    on the card. The float32 matmul precision is "highest" throughout;
    ``allow_tf32`` only for operands that TF32 holds exactly
    (conv2d_w8_bf16)."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    n, h, wd, _ = x.shape
    if padding == "SAME":
        ph, pw = _same_pads(h, kh, stride), _same_pads(wd, kw, stride)
    elif padding == "VALID":
        ph = pw = (0, 0)
    else:
        ph, pw = padding
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.backends.cudnn.flags(enabled=True,
                                        allow_tf32=allow_tf32):
            y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    finally:
        torch.set_float32_matmul_precision(prev)
    return y.permute(0, 2, 3, 1)


def conv2d_fp32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                act: str = "leaky", stride: int = 1,
                padding="SAME") -> torch.Tensor:
    """FP32 reference conv (calibration's forward) in full float32: TF32
    is off for cuDNN and matmul, matching the JAX path's HIGHEST
    precision."""
    return apply_activation(_conv_nhwc(x, w, stride, padding) + b, act)


def conv2d_w8(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
              b: torch.Tensor, act: str = "leaky", stride: int = 1,
              padding="SAME") -> torch.Tensor:
    """INT8 weight-only conv, strict f32: f32 activations convolved with
    the int8 codes as f32 (TF32 off, as the JAX conv's HIGHEST), then the
    per-output-channel ``y * s_w + b`` and the activation."""
    y = _conv_nhwc(x, wq.to(torch.float32), stride, padding)
    return apply_activation(y * s_w + b, act)


def conv2d_w8_bf16(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                   b: torch.Tensor, act: str = "leaky", stride: int = 1,
                   padding="SAME") -> torch.Tensor:
    """The fast weight-only conv, with the JAX ``conv2d_w8_bf16``'s
    semantics: activations rounded to bf16, int8 codes (exact in bf16),
    products summed in f32, then ``y * s_w + b`` and the activation.

    ``F.conv2d`` on bf16 tensors would round its f32 sums to bf16 on the
    way out, which JAX (``preferred_element_type=float32``) does not. So
    x is rounded to bf16 and back, and the conv runs on f32 tensors with
    cuDNN's TF32 allowed: a bf16 value (8 significant bits) and an int8
    code (7) fit TF32's 11 exactly, so the tensor cores form the same
    products as an f32 conv and sum them in f32, at tensor-core speed.
    This is XLA's conv in the JAX package, not a Pallas kernel, so cuDNN
    carries it. On the CPU the flag does nothing: the conv is plain
    f32."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    y = _conv_nhwc(xb, wq.to(torch.float32), stride, padding,
                   allow_tf32=True)
    return apply_activation(y * s_w + b, act)


# The W8A8 conv kernel (csrc/conv_w8a8.cu): a PATCH tile is CONV_TR x
# CONV_TC output pixels of one image, a TAP tile 128 flat rows of the
# batch; both by 128 accumulator columns (32 channels of each pool group
# with the group-max).
CONV_TR, CONV_TC = 16, 8
TAP_KC = 128                    # bytes of Cin a tap step
TAP_MAX_W = 31                  # widest input conv_w8a8_form sends to TAP
# A straddled tile's fixup (each piece writes its 64 KB partial sum, the
# last reads the others back from L2 with a few loads in flight, then the
# epilogue, which a short piece's mainloop does not hide) costs about this
# many 128-byte stages of K a piece: fitted to the batch-1 tap layers on
# an H100 80GB HBM3 at 700 W (PERF.md), where stream-K over 4 and 6
# pieces a tile beat one tile a block at L12 and L13 and lost at L8 and
# L10 with 2 and 3
FIXUP_STAGES = 8


class ConvForm(NamedTuple):
    """How ``conv2d_w8a8`` runs a conv on the card. ``route``: "patch" or
    "tap" (the kernel, by its two ways of bringing A to wgmma), "rows"
    (the small-Cin kernel, ``rows_plan``), "gemm" (a 1x1 conv:
    ``gemm_fused`` on a view of the activation) or "im2col" (a form the
    kernels refuse: im2col + ``gemm_fused``).
    ``kb``: bytes of Cin a patch step (the boxes' inner extent); ``steps``
    a tile's K steps (patch: k tap rows x ceil(Cin/kb); tap: 9 taps x
    Cin/128 chunks); ``tiles`` block tiles, ``grid`` persistent blocks.

    The schedule (``conv_schedule``): the first ``sk_tiles`` tiles are
    summed stream-K, their ``sk_tiles * steps`` (tile, step) iterations
    cut into ``sk_blocks`` contiguous ranges as even as integers allow,
    block b < ``sk_blocks`` taking range b; a tile that straddles blocks
    is summed in a workspace of ``slots`` partial sums a tile. The other
    tiles go round robin, whole, tile ``sk_tiles + b + i*grid`` to block
    b."""
    route: str
    kb: int = 0
    steps: int = 0
    tiles: int = 0
    grid: int = 0
    sk_tiles: int = 0
    sk_blocks: int = 0
    slots: int = 1


class Work(NamedTuple):
    """One unit of a block: tile ``tile``, its K steps [sb, se); a piece
    of a straddled tile has ``parts`` > 1 pieces, this one in workspace
    slot ``slot``."""
    tile: int
    sb: int
    se: int
    slot: int = 0
    parts: int = 1


def conv_out_hw(h: int, w: int, k: int, padding="SAME",
                out_hw=None, stride: int = 1) -> Tuple[int, int]:
    """The (Ho, Wo) of a k x k conv with "SAME" or "VALID" ``padding`` at
    ``stride`` on an (h, w) input, trimmed to ``out_hw`` (the
    shifted-fold stages' real rows and columns, ``extract_patches``)."""
    if padding == "SAME":
        ho, wo = -(-h // stride), -(-w // stride)
    else:
        ho, wo = (h - k) // stride + 1, (w - k) // stride + 1
    if out_hw is not None:
        ho, wo = min(ho, out_hw[0]), min(wo, out_hw[1])
    return ho, wo


def _sk_span(f: ConvForm, b: int) -> Tuple[int, int]:
    """Block b's stream-K iterations [s0, s1) (empty past sk_blocks)."""
    if b >= f.sk_blocks:
        return 0, 0
    t = f.sk_tiles * f.steps
    return b * t // f.sk_blocks, (b + 1) * t // f.sk_blocks


def _sk_block_of(f: ConvForm, it: int) -> int:
    """The block whose stream-K range holds iteration ``it``."""
    return ((it + 1) * f.sk_blocks - 1) // (f.sk_tiles * f.steps)


def block_work(f: ConvForm, b: int) -> List[Work]:
    """Block b's units in the kernel's order (csrc/conv_w8a8.cu
    ``span``/``work``): its stream-K pieces, then its round-robin tiles.
    Consumer c takes units c, c + 2, ..."""
    out = []
    s0, s1 = _sk_span(f, b)
    if s1 > s0:
        for t in range(s0 // f.steps, (s1 - 1) // f.steps + 1):
            x0 = t * f.steps
            first = _sk_block_of(f, x0)
            last = _sk_block_of(f, x0 + f.steps - 1)
            out.append(Work(t, max(s0 - x0, 0), min(s1 - x0, f.steps),
                            b - first, last - first + 1))
    for t in range(f.sk_tiles + b, f.tiles, f.grid):
        out.append(Work(t, 0, f.steps))
    return out


def block_steps(f: ConvForm) -> List[int]:
    """K steps each block runs: its share of the layer's work."""
    return [sum(w.se - w.sb for w in block_work(f, b)) for b in range(f.grid)]


def conv_schedule(tiles: int, steps: int, step_bytes: int,
                  sms: int) -> Tuple[int, int, int, int]:
    """(grid, sk_tiles, sk_blocks, slots) for ``tiles`` block tiles of
    ``steps`` K steps of ``step_bytes`` bytes of K each on ``sms`` SMs,
    from the shape alone:

    - at least as many tiles as SMs: round robin, whole tiles. Stream-K of
      the last round's tiles over every block, which evens the blocks'
      steps out, measured slower at every batch-32 and batch-16 shape (L10
      at b32, 172 tiles of 18 steps: 0.0351 ms against 0.0247; H100 80GB
      HBM3, 700 W; PERF.md);
    - fewer: ``k_splits``' pieces a tile s, stream-K over tiles * s
      blocks (every block the same steps within one) where the tile's kt
      128-byte stages cost more than kt / s of them plus
      ``FIXUP_STAGES`` a further piece; else one tile a block.
    """
    if tiles >= sms:
        return sms, 0, 0, 1
    kt = -(-steps * step_bytes // WG_BK)
    splits = min(k_splits(tiles, kt, sms), steps)
    if splits <= 1 or kt / splits + FIXUP_STAGES * (splits - 1) >= kt:
        return tiles, 0, 0, 1
    grid = min(sms, tiles * splits)
    f = ConvForm("", steps=steps, tiles=tiles, grid=grid, sk_tiles=tiles,
                 sk_blocks=grid)
    return grid, tiles, grid, sk_slots(f)


def sk_slots(f: ConvForm) -> int:
    """The most blocks that share one stream-K tile of ``f``: the
    partial-sum slots a tile needs (1: no tile straddles blocks)."""
    return max([_sk_block_of(f, t * f.steps + f.steps - 1)
                - _sk_block_of(f, t * f.steps) + 1
                for t in range(f.sk_tiles)], default=1)


def conv_w8a8_form(n: int, h: int, w: int, cin: int, cout: int, kh: int,
                   kw: int, stride: int = 1, padding="SAME", out_hw=None,
                   quantized: bool = True, gmax: bool = False,
                   sms: int = H100_SMS, raw: bool = False) -> ConvForm:
    """The route ``conv2d_w8a8`` takes on the card for an (n, h, w, cin)
    int8 input and (kh, kw, cin, cout) weights, from the shape alone,
    before any launch:

    - kh = kw = 1, stride 1: "gemm" (the conv is the GEMM of a view);
    - "rows" (``csrc/conv_w8a8_rows.cu``, ``rows_plan``) for a small Cin:
      Cin % 16 != 0 with kw Cin <= 32, a square odd k up to 7, SAME
      padding, stride 1 or 2, Cout 16 or 64, int8 output in the conv
      order or f32 output, no group-max, no ``raw`` and no trim
      (ResNet-18's 7x7/s2 stem and the YOLO models' 3x3 entry conv, Cin
      3): ``kb`` the bytes of K a kernel row, ``steps`` its k32 steps,
      ``tiles`` its units, ``grid`` its blocks;
    - the kernel's forms, Cin % 16 == 0, int8 output in the conv order
      (``quantized``, an s_out), f32 or (``raw``) the int32 accumulator
      (neither with ``gmax``), and at stride 1 k =
      3 SAME or k = 2 VALID (with ``gmax`` also Cout % 4 == 0), at stride
      2 k = 3 or 1 SAME, no ``gmax``:
      - "tap" for stride 1, k = 3 SAME, Cin % 128 == 0, W <= 31,
        untrimmed: the batch folded into M, one im2col box of the copy
        engine a (tap, 128 channels) step (the kernel takes any width;
        PATCH keeps the 52 and 104 px layers, where TAP was not timed
        against it);
      - "patch" for the rest: 16 x 8 pixel tiles of the trimmed output,
        64-byte steps up to Cin 64, else 128 (at stride 2, a step's boxes
        land every other row and column of the input; the 1x1/s2
        projections of ResNet-18 too, which took 0.0419 ms at b32 where
        ``gemm_fused`` on one strided copy took 0.0473, PERF.md);
      each with ``conv_schedule``'s schedule;
    - anything else: "im2col" (ROADMAP B13b).

    ``raw`` (``conv2d_w8a8_acc``) takes the routes of the f32 output but
    "rows".
    """
    if raw and (gmax or quantized):
        raise ValueError("conv_w8a8_form: the int32 accumulator has no "
                         "codes and no group-max")
    if kh == kw == 1 and stride == 1 and not gmax:
        return ConvForm("gemm")
    if (not raw and not gmax and out_hw is None
            and rows_takes(cin, cout, kh, kw, stride, padding)):
        p = rows_plan(n, h, w, cin, cout, kh, stride, sms)
        return ConvForm("rows", p.run, p.ksteps, p.units, p.grid)
    if stride == 1:
        k_ok = (kh, kw, padding) in ((3, 3, "SAME"), (2, 2, "VALID"))
    else:
        k_ok = (stride == 2 and kh == kw and kh in (1, 3)
                and padding == "SAME" and not gmax)
    if (not k_ok or cin % 16 or (gmax and (cout % 4 or not quantized))):
        return ConvForm("im2col")
    ho, wo = conv_out_hw(h, w, kh, padding, out_hw, stride)
    n_tiles = (-(-(cout // 4) // (WG_BN // 4)) if gmax
               else -(-cout // WG_BN))
    if (kh == 3 and stride == 1 and cin % TAP_KC == 0 and w <= TAP_MAX_W
            and (ho, wo) == (h, w)):
        route, kb = "tap", 0
        tiles = -(-(n * h * w) // WG_BM) * n_tiles
        steps, step_bytes = 9 * (cin // TAP_KC), TAP_KC
    else:
        route, kb = "patch", 64 if cin <= 64 else 128
        tiles = n * -(-ho // CONV_TR) * -(-wo // CONV_TC) * n_tiles
        # a step is kw taps of kb bytes
        steps, step_bytes = kh * -(-cin // kb), kw * kb
    return ConvForm(route, kb, steps, tiles,
                    *conv_schedule(tiles, steps, step_bytes, sms))


# The small-Cin conv (csrc/conv_w8a8_rows.cu, the "rows" route): a unit is
# ROWS_TILE * t consecutive output pixels of one image, t from
# ROWS_UNIT_TILES; a block of 256 threads (two warpgroups) stages a
# unit's input rows, and each warpgroup runs every other 64-pixel tile.
ROWS_COUTS = (16, 64)           # one wgmma m64nNk32 n-tile
ROWS_MAX_RUN = 32               # most bytes of a kernel row, kw * Cin
ROWS_MAX_K = 7
ROWS_TILE = 64
ROWS_UNIT_TILES = (16, 8, 6, 4, 2)
# blocks an SM by Cout: the kernel's __launch_bounds__ (two accumulator
# sets a thread: 64 registers at Cout 64, 16 at Cout 16)
ROWS_BLOCKS_PER_SM = {16: 3, 64: 2}
# a unit's fixed cost (its stage, two block barriers, the first tile's
# wait), in tiles: weighs fewer, larger units against the last round's
# idle blocks (fitted to every unit size's time at the stem's and the
# entry conv's batches: ``chip_smoke.py --rows-sweep``, PERF.md section 6)
ROWS_UNIT_COST = 3


class RowsPlan(NamedTuple):
    """The geometry of one launch of the "rows" kernel, computed here and
    passed to it (and replayed by the CPU tests):

    - ``run``: bytes of K a kernel row, kw Cin rounded up to 4 (its last
      bytes meet zero rows of B); ``ksteps``: k32 steps over kh runs;
    - ``pt``, ``pl``: XLA's SAME pads before the rows and the columns
      (``_same_pads``: (2, 3) at 224 px for k7/s2);
    - a staged row is ``rb`` bytes: ``padb`` zero bytes (pl Cin rounded
      up to 16, so that an input row lands 16-byte aligned), the input
      row's W Cin bytes, then zeros past every byte a pixel reads;
      output pixel (oy, ox) of a unit staged from output row y0 reads
      kernel row i at staged row stride (oy - y0) + i, from byte
      ``stride ox Cin + padb - pl Cin`` (any phase mod 4);
    - ``upx``: output pixels a unit; ``nr``: the most staged rows a unit
      needs; ``units_img`` units an image, ``units`` in all; ``grid``
      persistent blocks, block b taking units b, b + grid, ..."""
    run: int
    ksteps: int
    pt: int
    pl: int
    ho: int
    wo: int
    padb: int
    rb: int
    upx: int
    nr: int
    units_img: int
    units: int
    grid: int


def rows_takes(cin: int, cout: int, kh: int, kw: int, stride: int,
               padding) -> bool:
    """The conv shapes the "rows" kernel takes (``conv_w8a8_form``)."""
    return (cin % 16 != 0 and kw * cin <= ROWS_MAX_RUN and kh == kw
            and kh % 2 == 1 and kh <= ROWS_MAX_K and stride in (1, 2)
            and padding == "SAME" and cout in ROWS_COUTS)


@functools.lru_cache(maxsize=256)
def rows_plan(n: int, h: int, w: int, cin: int, cout: int, k: int,
              stride: int, sms: int = H100_SMS) -> RowsPlan:
    """The "rows" kernel's geometry and schedule (``RowsPlan``) for an (n,
    h, w, cin) input and a k x k SAME conv at ``stride``. The unit size
    is the one of ROWS_UNIT_TILES whose rounds of ROWS_BLOCKS_PER_SM[cout]
    blocks an SM cost least, a round costing its tiles a block plus
    ROWS_UNIT_COST (the larger on a tie)."""
    run = -(-(k * cin) // 4) * 4
    ksteps = -(-(k * run) // 32)
    pt, _ = _same_pads(h, k, stride)
    pl, pr = _same_pads(w, k, stride)
    ho, wo = -(-h // stride), -(-w // stride)
    padb = -(-(pl * cin) // 16) * 16
    # the last pixel's run starts (w + pr - k) Cin bytes into the row and
    # a 4-byte group is read as two aligned words: up to run + 3 past it
    rb = -(-(padb + (w + pr - k) * cin + run + 4) // 16) * 16
    slots = ROWS_BLOCKS_PER_SM[cout] * sms
    best = None
    for t in ROWS_UNIT_TILES:
        upx = ROWS_TILE * t
        units_img = -(-(ho * wo) // upx)
        cost = -(-(n * units_img) // slots) * (t + ROWS_UNIT_COST)
        if best is None or cost < best[0]:
            best = (cost, upx, units_img)
    _, upx, units_img = best
    # a unit's pixels span at most this many output rows past its first
    dy = min(ho - 1, (upx - 1) // wo + 1)
    units = n * units_img
    return RowsPlan(run, ksteps, pt, pl, ho, wo, padb, rb, upx,
                    stride * dy + k, units_img, units, max(min(units, slots),
                                                           1))


def rows_tile_index(cin: int, cout: int, k: int) -> torch.Tensor:
    """(cout, k k cin) int64: where weight (o, i, dx, ci) (the HWIO
    reshape's column o, K index (i k + dx) cin + ci) lies in
    ``rows_tile_matrix``: K byte kk = i run + dx cin + ci, in K atom kk //
    128 (cout rows of 128 bytes each), row o, 16-byte chunk (kk % 128) //
    16 XOR o % 8 (wgmma's 128-byte swizzle)."""
    run = -(-(k * cin) // 4) * 4
    i = torch.arange(k).view(-1, 1)
    kk = (i * run + torch.arange(k * cin).view(1, -1)).reshape(1, -1)
    o = torch.arange(cout).view(-1, 1)
    c = kk % 128
    return ((kk // 128) * cout * 128 + o * 128
            + (((c // 16) ^ (o % 8)) * 16) + c % 16)


def rows_tile_bytes(cin: int, cout: int, k: int) -> int:
    """Bytes of ``rows_tile_matrix``: the K atoms of ksteps k32 steps."""
    run = -(-(k * cin) // 4) * 4
    return -(-(-(-(k * run) // 32) * 32) // 128) * cout * 128


def rows_tile_matrix(wq: torch.Tensor) -> torch.Tensor:
    """(k, k, Cin, Cout) int8 weights -> the B tile the "rows" kernel
    copies into shared memory once a block: the (Cout, K) K-major matrix
    with each kernel row's kw Cin bytes one run of ``run`` bytes (zeros
    after them and past the last run), in wgmma's 128-byte swizzled
    layout (``rows_tile_index``). Made once and cached on ``wq`` (until
    ``wq`` is written in place)."""
    cached = getattr(wq, "_rows_tile", None)
    if cached is not None and cached[0] == wq._version:
        return cached[1]
    k, _, cin, cout = (int(d) for d in wq.shape)
    out = wq.new_zeros(rows_tile_bytes(cin, cout, k))
    out[rows_tile_index(cin, cout, k).reshape(-1).to(wq.device)] = (
        wq.reshape(k * k * cin, cout).T.reshape(-1))
    wq._rows_tile = (wq._version, out)
    return out


@launch_span("conv_w8a8_rows")
def conv_w8a8_rows(x: torch.Tensor, tile: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, s_out: Optional[Scale], k: int,
                   stride: int, act: str, p: RowsPlan,
                   codes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of ``csrc/conv_w8a8_rows.cu`` on operands ``conv2d_w8a8``
    (or ``conv2d_w8a8_u8``) prepared: x (N, H, W, Cin) int8 on the card,
    or with ``codes`` (the (256,) int8 ``entry_code_table``) the uint8
    wire batch, each byte read as its code; ``tile`` the
    ``rows_tile_matrix`` of the (k, k, Cin, Cout) weights, scale =
    s_in*s_w and bias (Cout,) float32, the plan ``p`` (``rows_plan``).
    Returns (N, Ho, Wo, Cout) int8 codes in the conv order (requant.cuh
    MODE 0, or 4 for an s_out that is not a positive normal float), or
    with ``s_out`` None the float32 act(acc*scale + bias); counts in
    ``conv_w8a8_rows.launches``."""
    want = torch.int8 if codes is None else torch.uint8
    if x.dtype != want or tile.dtype != torch.int8:
        raise TypeError(f"conv_w8a8_rows takes {want} x and int8 weights, "
                        f"got {x.dtype} and {tile.dtype}")
    if codes is not None and (codes.dtype != torch.int8
                              or codes.shape != (256,)):
        raise ValueError(f"conv_w8a8_rows: codes must be (256,) int8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    if any(t is not None and (t.device.type != "cuda" or t.device != x.device)
           for t in (x, tile, scale, bias, codes)):
        raise ValueError("conv_w8a8_rows: all operands on one CUDA device")
    n, h, w, cin = (int(d) for d in x.shape)
    cout = int(scale.shape[0])
    if (cout not in ROWS_COUTS or tile.numel() != rows_tile_bytes(cin, cout, k)
            or not rows_takes(cin, cout, k, k, stride, "SAME")):
        raise ValueError(f"conv_w8a8_rows: x {tuple(x.shape)}, k {k}, "
                         f"stride {stride}, Cout {cout}: not the kernel's "
                         f"form")
    x = x.contiguous()
    tile, scale = tile.contiguous(), scale.contiguous()
    bias = bias.to(torch.float32).contiguous()
    out_kind = int(s_out is None)
    out = torch.empty((n, p.ho, p.wo, cout),
                      dtype=torch.float32 if out_kind else torch.int8,
                      device=x.device)
    if out.numel() == 0:
        return out
    ptr, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("conv_w8a8_rows", "conv_w8a8_rows",
                         [ptr, ptr, ptr, ptr, ptr, ctypes.c_float, ptr]
                         + [i] * 22 + [ptr])
    if codes is not None:
        codes = codes.contiguous()
    err = fn(x.data_ptr(), ptr_or_none(codes), tile.data_ptr(),
             scale.data_ptr(),
             bias.data_ptr(), float(s_out) if out_kind == 0 else 0.0,
             out.data_ptr(), n, h, w, cin, cout, k, stride, p.pt, p.pl,
             p.ho, p.wo, p.run, p.ksteps, p.padb, p.rb, p.upx, p.nr,
             p.units_img, p.grid, KERNEL_ACT_CODES[act], out_kind,
             int(x.data_ptr() % 16 == 0), _build.stream_ptr(x.device))
    conv_w8a8_rows.launches += 1
    _build.check(err, "conv_w8a8_rows")
    return out


conv_w8a8_rows.launches = 0


def entry_codes_plain(xu: torch.Tensor, s_in: Scale) -> torch.Tensor:
    """The int8 codes of a uint8 batch at input scale ``s_in``, as the
    plan's entry makes them: u / 255 in float32 (a division, as the JAX
    plan's op-by-op entry), then ``quantize_act``."""
    x = xu.to(torch.float32) / f32_scalar(255.0, xu.device)
    return quantize_act(x, s_in)


def entry_code_table(s_in: Scale, device) -> torch.Tensor:
    """(256,) int8: ``entry_codes_plain`` of every byte value, by the same
    PyTorch ops on ``device``, so a kernel that reads byte u as code[u]
    gives the plain path's codes bit for bit. code[0] is 0."""
    return entry_codes_plain(torch.arange(256, dtype=torch.uint8,
                                          device=device), s_in)


class EntryCodes(NamedTuple):
    """What ``conv2d_w8a8_u8`` needs of an input scale, made once:
    ``s_in`` (a Python float), ``codes`` its ``entry_code_table`` and
    ``scale`` = f32(s_in) * s_w, on the weights' device."""
    s_in: float
    codes: torch.Tensor
    scale: torch.Tensor


def entry_codes(s_in: float, s_w: torch.Tensor) -> EntryCodes:
    dev = s_w.device
    return EntryCodes(s_in, entry_code_table(s_in, dev),
                      f32_scalar(s_in, dev) * s_w)


def conv2d_w8a8_u8_plain(xu: torch.Tensor, s_in: Scale, wq: torch.Tensor,
                         s_w: torch.Tensor, b: torch.Tensor,
                         act: str = "leaky", stride: int = 1,
                         padding="SAME",
                         s_out: Optional[Scale] = None) -> torch.Tensor:
    """Plain PyTorch version of ``conv2d_w8a8_u8``: the uint8 batch's codes
    (``entry_codes_plain``), then ``conv2d_w8a8_plain``."""
    return conv2d_w8a8_plain(entry_codes_plain(xu, s_in), s_in, wq, s_w, b,
                             act, stride, padding, s_out)


def conv2d_w8a8_u8(xu: torch.Tensor, e: EntryCodes, wq: torch.Tensor,
                   s_w: torch.Tensor, b: torch.Tensor, act: str = "leaky",
                   stride: int = 1, padding="SAME",
                   s_out: Optional[Scale] = None) -> torch.Tensor:
    """A plan's entry conv on the uint8 wire batch ``xu``: ``conv2d_w8a8``
    of its codes at input scale ``e.s_in`` (``entry_codes_plain``: u / 255,
    then ``quantize_act``) for a conv the small-Cin kernel takes
    (``rows_takes``). On the card one ``conv_w8a8_rows`` launch reads the
    bytes and their codes from ``e.codes``, with ``e.scale``: no
    normalise, quantize or scale pass runs before it. On a CPU tensor
    ``conv2d_w8a8_plain`` on the codes read from the same table
    (``conv2d_w8a8_u8_plain``'s codes by construction)."""
    kh, kw, cin, cout = (int(d) for d in wq.shape)
    if (xu.dtype != torch.uint8 or xu.ndim != 4 or xu.shape[3] != cin
            or not rows_takes(cin, cout, kh, kw, stride, padding)):
        raise ValueError(f"conv2d_w8a8_u8: x {tuple(xu.shape)} {xu.dtype}, "
                         f"w {tuple(wq.shape)}, stride {stride}, {padding}: "
                         f"not the small-Cin kernel's uint8 form")
    if xu.device.type == "cpu":
        return conv2d_w8a8_plain(e.codes[xu.to(torch.long)], e.s_in, wq, s_w,
                                 b, act, stride, padding, s_out,
                                 scale=e.scale)
    n, h, w, _ = (int(d) for d in xu.shape)
    return conv_w8a8_rows(xu, rows_tile_matrix(wq), e.scale, b, s_out, kh,
                          stride, act,
                          rows_plan(n, h, w, cin, cout, kh, stride,
                                    _build.sm_count(xu.device)),
                          codes=e.codes)


def _patches(xq, kh, kw, stride, padding, out_hw):
    """im2col, none for a 1x1 conv: the GEMM reads the activation, at
    stride 2 its even rows and columns, which are what XLA's SAME and
    VALID pads leave a 1x1 window."""
    if (kh == kw == 1 and out_hw is None
            and padding in ("SAME", "VALID")):
        return xq[:, ::stride, ::stride]
    return extract_patches(xq, kh, kw, stride, padding, out_hw)


def _im2col_conv(xq, s_in, wq, s_w, b, act, stride, padding, s_out, wt,
                 out_hw, gmax, scale=None):
    """``_patches``, then ``gemm_fused`` in the conv order, then the
    group-max."""
    kh, kw, _, cout = wq.shape
    patches = _patches(xq, kh, kw, stride, padding, out_hw)
    n, ho, wo, k = patches.shape
    if wt is None:
        wt = gemm_weights(wq)
    if scale is None:
        scale = f32_tensor(s_in, xq.device) * s_w
    out = gemm_fused(patches.reshape(n * ho * wo, k), wt, scale, b, act=act,
                     s_out=s_out)
    out = out.reshape(n, ho, wo, cout)
    return group_max4(out) if gmax else out


def conv_acc_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                   padding="SAME", wt: Optional[torch.Tensor] = None,
                   out_hw=None) -> torch.Tensor:
    """The exact int32 accumulator of the int8 conv, (N, Ho, Wo, Cout):
    im2col and the product summed in float64 (``int32_acc_plain``). The
    plain version of ``conv2d_w8a8_acc``, and the first step of
    ``conv2d_w8a8_plain``."""
    kh, kw, _, cout = wq.shape
    patches = _patches(xq, kh, kw, stride, padding, out_hw)
    n, ho, wo, k = patches.shape
    if wt is None:
        wt = gemm_weights(wq)
    acc = int32_acc_plain(patches.reshape(n * ho * wo, k), wt)
    return acc.reshape(n, ho, wo, cout)


def conv_epilogue(acc: torch.Tensor, s_in: Scale, s_w: torch.Tensor,
                  b: torch.Tensor, act: str = "leaky",
                  s_out: Optional[Scale] = None,
                  folded: bool = False,
                  scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A W8A8 conv's epilogue on its int32 accumulator, in PyTorch
    passes: scale = s_in * s_w, y = act(acc*scale + b), then with
    ``s_out`` the codes in the conv order, ``clip(rint(y / s_out))``
    (``conv2d_w8a8``'s, requant.cuh MODE 0), or with ``folded`` in the
    gemm tier's folded order (``conv_lowering.conv2d_w8a8_gemm``: scale
    and b divided by s_out first); without ``s_out`` the f32 y.
    ``conv2d_w8a8_plain`` and the row-parallel conv both end in it, so a
    conv whose accumulator was summed across ranks rounds as the
    unsharded conv does. ``scale``: s_in * s_w made already (a prepared
    plan's)."""
    dev = acc.device
    if scale is None:
        scale = f32_tensor(s_in, dev) * s_w
    if folded and s_out is not None:
        inv = 1.0 / f32_tensor(s_out, dev)
        return epilogue_plain(acc, scale * inv, b * inv, act,
                              quantize_out=True)
    return epilogue_plain(acc, scale, b, act, s_out=s_out)


def conv2d_w8a8_plain(xq: torch.Tensor, s_in: Scale, wq: torch.Tensor,
                      s_w: torch.Tensor, b: torch.Tensor, act: str = "leaky",
                      stride: int = 1, padding="SAME",
                      s_out: Optional[Scale] = None,
                      wt: Optional[torch.Tensor] = None, out_hw=None,
                      gmax: bool = False,
                      scale: Optional[torch.Tensor] = None):
    """Plain PyTorch version of ``conv2d_w8a8`` (same arguments): the
    exact int32 product (``conv_acc_plain``), the epilogue in the conv
    order (``conv_epilogue``) and the group-max."""
    acc = conv_acc_plain(xq, wq, stride, padding, wt, out_hw)
    out = conv_epilogue(acc, s_in, s_w, b, act, s_out, scale=scale)
    return group_max4(out) if gmax else out


def conv2d_w8a8(xq: torch.Tensor, s_in: Scale, wq: torch.Tensor,
                s_w: torch.Tensor, b: torch.Tensor, act: str = "leaky",
                stride: int = 1, padding="SAME",
                s_out: Optional[Scale] = None,
                wt: Optional[torch.Tensor] = None, out_hw=None,
                gmax: bool = False,
                scale: Optional[torch.Tensor] = None):
    """Full W8A8 conv: int8 x int8 -> int32, then acc * (s_in * s_w) + b,
    the activation, and (with ``s_out``) requantization to int8 —
    otherwise the f32 output. ``wt`` is the precomputed
    ``gemm_weights(wq)``, ``scale`` the precomputed f32(s_in) * s_w on
    the data's device (a prepared plan's ``StageScales``; made here when
    None); ``out_hw`` trims the output (see
    extract_patches). ``gmax``: the pool-major group-max of the codes
    (the max over the four channel quarters), (N, Ho, Wo, Cout/4), for
    the four groups sharing their ``s_w`` and ``b`` (a fold stage repeats
    its layer's): the kernel requantizes the groups' extreme int32 sum
    once, which is their largest code because requantization is monotone.

    It takes the route ``conv_w8a8_form`` gives: the kernel
    (``csrc/conv_w8a8.cu``, counted in ``conv2d_w8a8.launches`` where it
    launches), the small-Cin kernel (``conv_w8a8_rows``, counted in
    ``conv_w8a8_rows.launches``), ``gemm_fused`` on a 1x1 conv's view, or
    an im2col and ``gemm_fused`` for the forms both kernels refuse
    (counted on the card in ``conv2d_w8a8.im2col_launches``). On a CPU
    tensor a kernel's route is the plain version (and ``gemm_fused`` its
    own); on a CUDA tensor the kernel launches or the wrapper raises."""
    kh, kw, cin, cout = (int(d) for d in wq.shape)
    if xq.ndim != 4 or xq.shape[3] != cin:
        raise ValueError(f"conv2d_w8a8: x {tuple(xq.shape)} against w "
                         f"{tuple(wq.shape)}")
    if gmax and cout % 4:
        raise ValueError(f"conv2d_w8a8: the group-max needs Cout % 4 == 0, "
                         f"got {cout}")
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv2d_w8a8: unsupported device {xq.device}")
    cpu = xq.device.type == "cpu"
    n, h, w, _ = (int(d) for d in xq.shape)
    f = conv_w8a8_form(n, h, w, cin, cout, kh, kw, stride, padding, out_hw,
                       quantized=s_out is not None, gmax=gmax,
                       sms=H100_SMS if cpu else _build.sm_count(xq.device))
    if f.route in ("gemm", "im2col"):
        if not cpu:
            conv2d_w8a8.im2col_launches += f.route == "im2col"
        return _im2col_conv(xq, s_in, wq, s_w, b, act, stride, padding,
                            s_out, wt, out_hw, gmax, scale)
    if cpu:
        return conv2d_w8a8_plain(xq, s_in, wq, s_w, b, act, stride, padding,
                                 s_out, wt, out_hw, gmax, scale)
    if scale is None:
        scale = f32_tensor(s_in, xq.device) * s_w
    if f.route == "rows":
        return conv_w8a8_rows(xq, rows_tile_matrix(wq), scale, b, s_out, kh,
                              stride, act,
                              rows_plan(n, h, w, cin, cout, kh, stride,
                                        _build.sm_count(xq.device)))
    go = cout // 4 if gmax else 0
    if go:
        bt = rs_tile_matrix(wq, go)       # made once, cached on wq
    else:
        bt = wt if wt is not None else kmajor_weights(wq)
    ho, wo = conv_out_hw(h, w, kh, padding, out_hw, stride)
    return conv_w8a8_launch(xq, bt, scale, b, s_out, kh, ho, wo, go, act, f,
                            stride)


def conv2d_w8a8_acc(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                    padding="SAME",
                    wt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int32-accumulator form of ``conv2d_w8a8``: int8 x int8 -> the
    (N, Ho, Wo, Cout) int32 sums themselves, no epilogue (XLA's int8 conv
    with ``preferred_element_type=int32``). The row-parallel conv of the
    channel-sharded forward sums them across ranks before its epilogue.

    It takes the route ``conv_w8a8_form(..., raw=True)`` gives: the
    kernel's raw store (counted in ``conv2d_w8a8.launches`` and
    ``conv2d_w8a8.acc_launches``), or ``conv_lowering.conv2d_int8_acc``
    (``gemm_fused``'s int32 accumulator) on a 1x1 conv's view or, for the
    forms the kernel refuses (Cin % 16 != 0), on an im2col (counted on the
    card in ``conv2d_w8a8.im2col_launches``). On a CPU tensor the
    kernel's route is the plain version, ``conv_acc_plain``; on a CUDA
    tensor the kernel launches or the wrapper raises. ``wt``: the
    precomputed ``gemm_weights(wq)``."""
    kh, kw, cin, cout = (int(d) for d in wq.shape)
    if xq.ndim != 4 or xq.shape[3] != cin:
        raise ValueError(f"conv2d_w8a8_acc: x {tuple(xq.shape)} against w "
                         f"{tuple(wq.shape)}")
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv2d_w8a8_acc: unsupported device {xq.device}")
    cpu = xq.device.type == "cpu"
    n, h, w, _ = (int(d) for d in xq.shape)
    f = conv_w8a8_form(n, h, w, cin, cout, kh, kw, stride, padding,
                       quantized=False, raw=True,
                       sms=H100_SMS if cpu else _build.sm_count(xq.device))
    if f.route in ("gemm", "im2col"):
        if not cpu:
            conv2d_w8a8.im2col_launches += f.route == "im2col"
        return conv2d_int8_acc(xq, wq, stride, padding, wt)
    if cpu:
        return conv_acc_plain(xq, wq, stride, padding, wt)
    bt = wt if wt is not None else kmajor_weights(wq)
    ho, wo = conv_out_hw(h, w, kh, padding, None, stride)
    return conv_w8a8_launch(xq, bt, None, None, None, kh, ho, wo, 0,
                            "linear", f, stride, raw=True)


@launch_span("conv_w8a8")
def conv_w8a8_launch(x: torch.Tensor, bt: torch.Tensor,
                     scale: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], s_out: Optional[Scale],
                     k: int, ho: int, wo: int, go: int, act: str,
                     f: ConvForm, stride: int = 1,
                     raw: bool = False) -> torch.Tensor:
    """One launch of ``csrc/conv_w8a8.cu`` on operands ``conv2d_w8a8``
    prepared: x (N, H, W, Cin) int8 on the card; bt the K-major weight
    matrix (``kmajor_weights(w)``, or with ``go`` > 0 channels a pool
    group ``rs_tile_matrix(w, go)``); scale = s_in*s_w and bias, (Cout,)
    float32; the k x k conv (stride 1: k 3 SAME, 2 VALID; stride 2: k 3
    or 1 SAME) trimmed to (ho, wo), in the form ``f`` of
    ``conv_w8a8_form`` (route "patch" or "tap", with its schedule).
    Returns (N, ho, wo, go or Cout) int8, or with ``s_out`` None the
    float32 act(acc*scale + bias), or with ``raw`` (no group-max, no
    ``s_out``; scale and bias unused, may be None) the (N, ho, wo, Cout)
    int32 accumulator; counts in ``conv2d_w8a8.launches``, the raw form
    also in ``conv2d_w8a8.acc_launches``."""
    routes = ("patch", "tap")
    if f.route not in routes:
        raise ValueError(f"conv_w8a8_launch: route {f.route!r} is not the "
                         f"kernel's")
    if x.dtype != torch.int8 or bt.dtype != torch.int8:
        raise TypeError(f"conv_w8a8_launch takes int8 x and weights, got "
                        f"{x.dtype} and {bt.dtype}")
    if raw and (go or s_out is not None):
        raise ValueError("conv_w8a8_launch: the int32 accumulator has no "
                         "codes and no group-max")
    if any(t is not None and (t.device.type != "cuda" or t.device != x.device)
           for t in (x, bt, scale, bias)):
        raise ValueError("conv_w8a8_launch: all operands on one CUDA device")
    n, h, w, cin = (int(d) for d in x.shape)
    x = x.contiguous()
    if x.data_ptr() % 16:                 # the tensor maps' base address
        x = x.clone()
    bt = bt.contiguous()
    if raw:
        cout = int(bt.shape[0])
        out_kind, dtype = 2, torch.int32
    else:
        cout = int(scale.shape[0])
        scale = scale.contiguous()
        bias = bias.to(torch.float32).contiguous()
        out_kind = int(s_out is None)
        dtype = torch.float32 if out_kind else torch.int8
    if out_kind == 1 and go:
        raise ValueError("conv_w8a8_launch: the group-max takes int8 codes "
                         "(an s_out)")
    out = torch.empty((n, ho, wo, go or cout), dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out
    # the straddled tiles' partial sums (slots a tile) and counters
    ws, cnt = split_buffers(x.device, GemmForm("wgmma", f.slots, f.sk_tiles,
                                               f.grid))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("conv_w8a8", "conv_w8a8",
                         [p, p, p, p, ctypes.c_float, p] + [i] * 19
                         + [p, p, p])
    err = fn(x.data_ptr(), bt.data_ptr(), ptr_or_none(scale),
             ptr_or_none(bias), float(s_out) if out_kind == 0 else 0.0,
             out.data_ptr(), n, h, w, cin,
             cout, k, stride, ho, wo, go, KERNEL_ACT_CODES[act], out_kind,
             routes.index(f.route), f.kb,
             f.steps, f.grid, f.sk_tiles, f.sk_blocks, f.slots,
             ptr_or_none(ws), ptr_or_none(cnt), _build.stream_ptr(x.device))
    conv2d_w8a8.launches += 1
    conv2d_w8a8.acc_launches += raw
    _build.check(err, "conv_w8a8")
    return out


conv2d_w8a8.launches = 0
# of those, the int32-accumulator form's (conv2d_w8a8_acc): the
# row-parallel conv of a channel-sharded forward
conv2d_w8a8.acc_launches = 0
# convs in a form both kernels refuse (conv_w8a8_form's "im2col" route):
# on no ported path (the plans, Model.forward, ResNet-18)
conv2d_w8a8.im2col_launches = 0
