"""The fused stage 0 of YOLOv2-tiny: quantize + conv1 3x3 (3->16) + 2x2/s2
maxpool + fold-2 emit, in one pass.

Counterpart of ``dnn_inference_engine_tpu/ops/attic/pallas_stage0.py``.
Its operand builders are copied here in numpy and give the same arrays
byte for byte. Its two Pallas kernels, ``stage0_fused`` (v1) and
``stage0_fused_v2``, compute one function and differ only in how they
feed the TPU's matrix unit (v1: sublane gathers into a band-rolled
operand; v2: transposed-LHS GEMMs over three lane shifts). Neither trick
means anything on Hopper, so both wrappers turn their own operand into
one dense-K matrix ``B`` (128, 256) by an index gather, lay that out once
as the kernel's shared-memory tile (``stage0_tile_matrix``) and launch
one kernel, ``csrc/stage0_fused.cu``: the persistent ``wgmma`` stem
mainloop of ``csrc/stem_common.cuh`` with its own K order (each 18-byte
patch row a 20-byte run of K) and the stems' schedule
(``fused_conv.stem_grid``, ``stem_k2_schedule``).

The function. With ``q = clip(round(x / s_in), +-127)`` (zero codes
outside the image, SAME), fold-2 output pixel (i, j) reads the 6x6x3
patch of q at raw rows 4i-1 .. 4i+4 and columns 4j-1 .. 4j+4, laid out as
``k = r6*18 + c6*3 + ch`` (108 true rows of ``B``; rows 108-127 are
zero). ``acc[n] = patch . B[:, n]`` with n = g*16 + co and the
pool-major group g = (u*2+v)*4 + (a*2+b) over the 16 conv positions
(2a+u, 2b+v) of the 4x4 block; the 2x2/s2 max is taken over (u, v) on
the int32 accumulator, leaving channel (a*2+b)*16 + co, the fold-2
(space-to-depth(2)) layout conv2's folded stage reads; then
``y = am*scale + bias`` (two roundings), the activation and
``clip(round(y))``.

A wrapper given a CPU tensor runs ``stage0_fused_plain``; given a CUDA
tensor it launches the kernel or raises. Both wrappers count their
launches on ``stage0_fused.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from dnn_inference_engine_tpu_torch.config import QMAX
from dnn_inference_engine_tpu_torch.ops import _build
from dnn_inference_engine_tpu_torch.ops.activations import (
    KERNEL_ACT_CODES, apply_activation)
from dnn_inference_engine_tpu_torch.ops.fused_conv import (
    _pad_hw, group_max4, stem_grid, stem_k2_row)
from dnn_inference_engine_tpu_torch.ops.gemm import int32_acc_plain
from dnn_inference_engine_tpu_torch.quant.quantize import f32_scalar

# v1's piece list: (s, m') pairs; piece p covers the flat column offset
# d = 12*s + m' = 3*jc + c for jc in {-1..4}, c in {0..2}
_PIECES: Tuple[Tuple[int, int], ...] = tuple(
    ((d // 12), (d % 12)) for d in range(-3, 15)
)
_N_PIECES = len(_PIECES)          # 18
_BAND = 8                         # nonzero rows per piece: o_r in {-1..4} + 2
K_TRUE = 108                      # 6 x 6 x 3 patch
K_PAD = 128                       # rows of the dense-K matrix B
RUN = 20                          # K lanes of one patch row in the tile
STAGE0_TILE_BYTES = 256 * 128     # the kernel's B: one 128-byte K atom


# ---------------------------------------------------------------------------
# Operand builders (numpy copies of the JAX package's)
# ---------------------------------------------------------------------------

def build_stage0_weights(wq: np.ndarray, s_w: np.ndarray, b: np.ndarray,
                         s_in: float, s_out: float):
    """(3,3,3,16) int8 conv1 params -> (Wk (144,256) int8, scale, bias).

    Wk[p*8 + (o_r+1), g*16 + co] = wq[o_r-r+1, jc-q+1, c, co] where the
    piece p encodes (jc, c) via d = 12*s + m' = 3*jc + c, and the output
    group g is pool-major over the 4x4 position block: (r, q) = (2a+u,
    2b+v), g = (u*2+v)*4 + (a*2+b)."""
    wq = np.asarray(wq)
    assert wq.shape == (3, 3, 3, 16), wq.shape
    cout = 16
    wk = np.zeros((_N_PIECES * _BAND, 256), np.int8)
    for p_idx, (s, m) in enumerate(_PIECES):
        d = 12 * s + m
        jc, c = divmod(d + 3, 3)
        jc -= 1
        for o_r in range(-1, 5):
            lane = p_idx * _BAND + (o_r + 1)
            for r in range(4):
                dh = o_r - r
                if dh not in (-1, 0, 1):
                    continue
                for q in range(4):
                    dw = jc - q
                    if dw not in (-1, 0, 1):
                        continue
                    a, u = r // 2, r % 2
                    bcol, v = q // 2, q % 2
                    g = (u * 2 + v) * 4 + (a * 2 + bcol)
                    wk[lane, g * cout:(g + 1) * cout] = wq[dh + 1, dw + 1, c]
    # per-column epilogue: groups all share the per-co scale/bias
    scale = np.tile(np.asarray(s_w, np.float32), 4) * (s_in / s_out)
    bias = np.tile(np.asarray(b, np.float32), 4) / s_out
    return wk, scale.astype(np.float32), bias.astype(np.float32)


def expand_stage0_weights(wk: np.ndarray, ht: int) -> np.ndarray:
    """Band-roll Wk into v1's operand Wb (18*rows, ht*256), rows = 4*ht+8:
    Wb[p*rows + 4*y + j, y*256 + n] = Wk[p*8 + j, n]."""
    rows = 4 * ht + 8
    wb = np.zeros((_N_PIECES * rows, ht * 256), np.int8)
    for y in range(ht):
        for p in range(_N_PIECES):
            wb[p * rows + 4 * y:p * rows + 4 * y + _BAND,
               y * 256:(y + 1) * 256] = wk[p * _BAND:(p + 1) * _BAND]
    return wb


def build_stage0_weights_v2(wq: np.ndarray, s_w: np.ndarray, b: np.ndarray,
                            s_in: float, s_out: float):
    """conv1 params -> (W (3,128,256) int8, scale (64,), bias (64,)):

      W[s, (o_r+1)*12 + 3*u + c, g*16 + co] = wq[dh+1, dw+1, c, co]
        with dh = o_r - r, dw = (4*(s-1) + u) - q, both in {-1,0,1};
        g pool-major: (r%2*2 + q%2)*4 + (r//2*2 + q//2)."""
    wq = np.asarray(wq)
    assert wq.shape == (3, 3, 3, 16), wq.shape
    cout = 16
    w = np.zeros((3, 128, 256), np.int8)
    for s in range(3):
        for o_r in range(-1, 5):
            for u in range(4):
                for c in range(3):
                    krow = (o_r + 1) * 12 + 3 * u + c
                    jc = 4 * (s - 1) + u
                    for r in range(4):
                        dh = o_r - r
                        if dh not in (-1, 0, 1):
                            continue
                        for q in range(4):
                            dw = jc - q
                            if dw not in (-1, 0, 1):
                                continue
                            g = ((r % 2) * 2 + q % 2) * 4 \
                                + (r // 2) * 2 + q // 2
                            w[s, krow, g * cout:(g + 1) * cout] = \
                                wq[dh + 1, dw + 1, c]
    scale = np.tile(np.asarray(s_w, np.float32), 4) * (s_in / s_out)
    bias = np.tile(np.asarray(b, np.float32), 4) / s_out
    return w, scale.astype(np.float32), bias.astype(np.float32)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _tensors(arrays, like):
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return tuple(torch.as_tensor(a, device=dev) for a in arrays)


def stage0_params(wq, s_w, b, s_in: float, s_out: float, ht: int = 4):
    """conv1 qparams -> v1's kernel operands (wb, scale, bias), as tensors
    on ``wq``'s device (the CPU for numpy input)."""
    wk, scale, bias = build_stage0_weights(_host(wq), _host(s_w), _host(b),
                                           s_in, s_out)
    return _tensors((expand_stage0_weights(wk, ht), scale, bias), wq)


def stage0_params_v2(wq, s_w, b, s_in: float, s_out: float):
    """conv1 qparams -> v2's kernel operands (w, scale, bias), as tensors
    on ``wq``'s device (the CPU for numpy input)."""
    return _tensors(build_stage0_weights_v2(_host(wq), _host(s_w), _host(b),
                                            s_in, s_out), wq)


# ---------------------------------------------------------------------------
# The dense-K operand: a pure index gather from either formulation's
# ---------------------------------------------------------------------------

def _patch_index():
    """(r6, c6, ch) of dense-K row k = r6*18 + c6*3 + ch, k < 108."""
    r6, c6, ch = np.meshgrid(np.arange(6), np.arange(6), np.arange(3),
                             indexing="ij")
    return r6.ravel(), c6.ravel(), ch.ravel()


def _v1_rows(ht: int) -> np.ndarray:
    """Rows of Wb (band y = 0) holding dense-K rows 0..107."""
    r6, c6, ch = _patch_index()
    return (3 * c6 + ch) * (4 * ht + 8) + r6


def _v2_rows() -> np.ndarray:
    """Rows of W.reshape(384, 256) holding dense-K rows 0..107: lane
    shift s and column-in-block u of patch column jc = c6 - 1."""
    r6, c6, ch = _patch_index()
    s, u = divmod(c6 + 3, 4)
    return s * 128 + r6 * 12 + 3 * u + ch


def _dense_k(op: torch.Tensor, flat: torch.Tensor, rows: np.ndarray,
             key) -> torch.Tensor:
    """B (128, 256) gathered from ``flat``'s ``rows``, as a view of its
    K-major copy (256, 128), which the kernel reads. Made once and cached
    on ``op`` (until ``op`` is written in place)."""
    cached = getattr(op, "_s0_bt", None)
    if cached is not None and cached[:2] == (op._version, key):
        return cached[2].t()
    bt = torch.zeros((256, K_PAD), dtype=torch.int8, device=op.device)
    idx = torch.as_tensor(rows, device=op.device)
    bt[:, :K_TRUE] = flat[idx, :256].t()
    op._s0_bt = (op._version, key, bt)
    return bt.t()


def dense_k_from_v1(wb: torch.Tensor, ht: int) -> torch.Tensor:
    """v1's band-rolled ``wb`` -> B: B[k] = Wk[(3*c6+ch)*8 + r6] with
    Wk[p*8 + j] = wb[p*(4*ht+8) + j] (band y = 0)."""
    return _dense_k(wb, wb, _v1_rows(ht), ("v1", ht))


def dense_k_from_v2(w: torch.Tensor) -> torch.Tensor:
    """v2's ``w`` (3, 128, 256) -> B: B[k] = w[s, r6*12 + 3*u + ch] with
    jc = c6 - 1, s = (jc+4)//4, u = (jc+4)%4. The other rows of ``w`` are
    zero when ``w`` comes from build_stage0_weights_v2."""
    return _dense_k(w, w.reshape(3 * 128, 256), _v2_rows(), ("v2",))


def stage0_tile_index() -> torch.Tensor:
    """(256, 108) int64: where byte (o, k) of B (output o, dense K index k
    = r6*18 + c6*3 + ch) lies in ``stage0_tile_matrix``: the kernel's K
    lane k' = RUN*r6 + c6*3 + ch (each 18-byte patch row a 20-byte run,
    whose last 2 lanes are zero, so that every 4-byte group of A is one
    aligned word of one staged input row), in row ``stem_k2_row(o)`` of
    the pool-major outputs, 16-byte chunk k' // 16 XOR row % 8 (wgmma's
    128-byte swizzle)."""
    row = stem_k2_row(torch.arange(256)).view(-1, 1)
    k = torch.arange(K_TRUE).view(1, -1)
    kk = RUN * (k // 18) + k % 18
    return row * 128 + ((kk // 16) ^ (row % 8)) * 16 + kk % 16


def stage0_tile_matrix(b: torch.Tensor) -> torch.Tensor:
    """B (128, 256) int8 -> the STAGE0_TILE_BYTES the kernel copies into
    shared memory once a block: B's 108 true rows laid out by
    ``stage0_tile_index``, zeros elsewhere. Made once and cached on the
    tensor that holds B's storage (the K-major copy ``dense_k_from_v1`` and
    ``_v2`` cache on their operand), until it is written in place."""
    root = b if b._base is None else b._base
    cached = getattr(root, "_s0_tile", None)
    if cached is not None and cached[0] == root._version:
        return cached[1]
    out = b.new_zeros(STAGE0_TILE_BYTES)
    out[stage0_tile_index().reshape(-1).to(b.device)] = \
        b[:K_TRUE].t().reshape(-1)
    root._s0_tile = (root._version, out)
    return out


# ---------------------------------------------------------------------------
# The plain version and the wrappers
# ---------------------------------------------------------------------------

def stage0_fused_plain(x, b, scale, bias, s_in, act="leaky"):
    """Plain PyTorch version of the stage-0 kernel: x (N,H,W,3) f32 and
    the dense-K matrix ``b`` (128, 256) -> (N, H/4, W/4, 64) int8."""
    n, h, wd, _ = x.shape
    h4, w4 = h // 4, wd // 4
    s = f32_scalar(s_in, x.device)
    q = torch.clamp(torch.round(x / s), -QMAX, QMAX).to(torch.int8)
    q = _pad_hw(q, 1, 1, 1, 1)             # zero codes outside (SAME)
    a = torch.cat([q[:, r6:r6 + 4 * h4:4, c6:c6 + 4 * w4:4]
                   for r6 in range(6) for c6 in range(6)], dim=-1)
    acc = group_max4(int32_acc_plain(a.reshape(-1, K_TRUE),
                                     b[:K_TRUE].t()))
    y = apply_activation(acc.to(torch.float32) * scale + bias, act)
    y = torch.clamp(torch.round(y), -QMAX, QMAX).to(torch.int8)
    return y.reshape(n, h4, w4, 64)


def _stage0(x, b, scale, bias, s_in, act, name):
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes f32 input, got {x.dtype}")
    for arg, v in (("scale", scale), ("bias", bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (64,):
            raise ValueError(f"{name}: {arg} must be float32 (64,)")
    if x.device.type == "cpu":
        return stage0_fused_plain(x, b, scale, bias, s_in, act)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if any(t.device != x.device for t in (b, scale, bias)):
        raise ValueError(f"{name}: all operands on one device")
    x = x.contiguous()
    if x.data_ptr() % 16:                 # read in 4-element vectors
        x = x.clone()
    tile = stage0_tile_matrix(b)          # cached beside B
    scale, bias = scale.contiguous(), bias.contiguous()
    n, h, wd, _ = x.shape
    out = torch.empty((n, h // 4, wd // 4, 64), dtype=torch.int8,
                      device=x.device)
    # f32 rows: at most 4 output rows a band fit in shared memory
    rows, grid = stem_grid(n, h // 4, wd // 4, _build.sm_count(x.device), 4)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("stage0_fused", "stage0_fused",
                         [p, p, p, p, ctypes.c_float, p, i, i, i, i, i, i,
                          p])
    err = fn(x.data_ptr(), tile.data_ptr(), scale.data_ptr(),
             bias.data_ptr(), float(s_in), out.data_ptr(), n, h, wd, rows,
             grid, KERNEL_ACT_CODES[act], _build.stream_ptr(x.device))
    stage0_fused.launches += 1
    _build.check(err, name)
    return out


def stage0_fused(x: torch.Tensor, wb: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, s_in, act: str = "leaky",
                 ht: int = 4) -> torch.Tensor:
    """Stage 0 from v1's operands: x (N, 416, 416, 3) f32, ``wb``
    (18*(4*ht+8), ht*256) int8 from ``stage0_params``, scale and bias
    (64,) f32 (already folding s_in/s_out and 1/s_out) -> (N, 104, 104,
    64) int8. ``ht`` says how ``wb`` was band-rolled; the TPU's
    ``interpret`` flag has no counterpart here."""
    if x.ndim != 4 or tuple(x.shape[1:]) != (416, 416, 3):
        raise ValueError(f"stage0_fused: x must be (N,416,416,3), got "
                         f"{tuple(x.shape)}")
    if wb.dtype != torch.int8 or tuple(wb.shape) != (
            _N_PIECES * (4 * ht + 8), ht * 256):
        raise ValueError(f"stage0_fused: wb must be int8 "
                         f"({_N_PIECES * (4 * ht + 8)}, {ht * 256}) for "
                         f"ht={ht}, got {wb.dtype} {tuple(wb.shape)}")
    return _stage0(x, dense_k_from_v1(wb, ht), scale, bias, s_in, act,
                   "stage0_fused")


def stage0_fused_v2(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, s_in,
                    act: str = "leaky") -> torch.Tensor:
    """Stage 0 from v2's operands: x (N, H, W, 3) f32 with H, W multiples
    of 8, ``w`` (3, 128, 256) int8 from ``stage0_params_v2``, scale and
    bias (64,) f32 -> (N, H/4, W/4, 64) int8. The TPU tiling arguments
    (``ht``, ``interpret``) have no counterpart here."""
    if x.ndim != 4 or x.shape[3] != 3 or x.shape[1] % 8 or x.shape[2] % 8:
        raise ValueError(f"stage0_fused_v2: x must be (N,H,W,3) with H, W "
                         f"multiples of 8, got {tuple(x.shape)}")
    if w.dtype != torch.int8 or tuple(w.shape) != (3, 128, 256):
        raise ValueError(f"stage0_fused_v2: w must be int8 (3,128,256), got "
                         f"{w.dtype} {tuple(w.shape)}")
    return _stage0(x, dense_k_from_v2(w), scale, bias, s_in, act,
                   "stage0_fused_v2")


stage0_fused.launches = 0
