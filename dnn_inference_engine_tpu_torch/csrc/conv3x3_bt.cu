// Batch-folded tap-shift 3x3/s1/SAME int8 conv for Hopper (sm_90a), with
// the fused epilogue and optional requant.
//
// Replaces: dnn_inference_engine_tpu/ops/attic/pallas_tail.py, conv3x3_bt
// (kernel body _bt_kernel; conv2d_w8a8_bt calls it). Same contract:
//   the N*H*W output pixels of the batch are one flat M axis (x viewed as
//   (M, Cin)); acc[m, o] = sum over the taps (dh, dw) and ci of
//   x_flat[m + dh*W + dw, ci] * w[dh+1, dw+1, ci, o], over the taps whose
//   source pixel lies in the same image, row range and column range;
//   y = act(acc*scale[o] + bias[o]); int8 out: clip(rint(y), +-127).
// Cin % 128 == 0 and W <= 31, as the TPU kernel asserts.
//
// What bounds it on an H100 (SXM data sheet at 700 W: 1,979 int8 TOP/s,
// 3.35 TB/s): the int8 tensor-core rate at every YOLOv2-tiny tail shape at
// batch 32 (L8-L13: 1.4-5.4 K operations per byte moved); at batch 1 the
// 1-9 MB of weights. What the TPU design is for -- the 9 taps as row
// shifts of one resident window, the batch folded into M so that 13x13 and
// 26x26 fill the tile -- carries over: a block tile is 128 flat output rows
// x 128 channels, and for each 32-channel chunk of Cin the block copies the
// window of flat rows [m0 - (W+1), m0 + 128 + (W+1)) into shared memory
// ONCE (cp.async, zero-filled outside [0, M)); the 9 taps are then row
// offsets dh*W + dw into that window. A (row, tap) that crosses an image or
// row edge reads a zero row instead (its shared address is redirected), so
// there is no masked accumulator and no reload per tap: 156 window rows per
// chunk at W = 13 and 182 at W = 26, where a per-tap gather (conv3x3_rs)
// loads 9 x 128 = 1,152. B is the (Cout, 9*Cin) K-major weight matrix the
// wrapper lays out once (rs_weight_matrix); its 9 tap slices of the chunk
// are copied beside the window, two stages deep. mma.sync m16n8k32 (s8 x s8
// -> s32) from 8 warps of 64 x 32; every epilogue rounding is explicit
// (mma_s8.cuh). wgmma, TMA and a persistent schedule are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_s8.cuh"

namespace {

using s8mma::cp_async16;
using s8mma::cp_async_commit;
using s8mma::cp_async_wait;
using s8mma::epilogue_f32;
using s8mma::mma_s8;
using s8mma::to_code;

constexpr int BM = 128;         // flat output rows per block
constexpr int BN = 128;         // output channels per block
constexpr int BK = 32;          // channels of Cin per stage
constexpr int LDS = BK + 16;    // shared row stride in bytes
constexpr int THREADS = 256;
constexpr int HALO_MAX = 32;    // W + 1 <= 32
constexpr int WROWS = BM + 2 * HALO_MAX;   // window rows at most
constexpr int ZROW = WROWS;     // an all-zero row after the window
constexpr int A_BYTES = (WROWS + 1) * LDS;
constexpr int STAGE_BYTES = A_BYTES + 9 * BN * LDS;

struct Conv {
  const int8_t* x;              // (M, Cin)
  const int8_t* wt;             // (Cout, 9*Cin) in (tap, ci) order
  const float* scale;
  const float* bias;
  void* out;                    // (M, Cout)
  int H, W, Cin, Cout, M, K, quantize, act;
};

__global__ void __launch_bounds__(THREADS) conv_bt_kernel(const Conv p) {
  extern __shared__ __align__(16) int8_t smem[];

  const int m0 = blockIdx.x * BM;
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;      // 2 warps along M, 64 rows each
  const int wn = warp % 4;      // 4 warps along N
  const int g = lane / 4;
  const int t = lane % 4;
  const int halo = p.W + 1;
  const int nwin = BM + 2 * halo;

  // the zero row of both stages; cp.async never writes it
  if (tid < 2 * (LDS / 16)) {
    int4* z = reinterpret_cast<int4*>(smem + (tid / (LDS / 16)) * STAGE_BYTES +
                                      ZROW * LDS) +
              tid % (LDS / 16);
    *z = make_int4(0, 0, 0, 0);
  }

  // This thread's 8 fragment rows (4 m16 tiles x rows g, g+8): their local
  // row and the taps whose source pixel lies inside the image.
  int lrow[8];
  unsigned taps[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = wm * 64 + (i / 2) * 16 + g + (i % 2) * 8;
    const int m = m0 + r;
    const int xc = m % p.W, yc = (m / p.W) % p.H;
    lrow[i] = r + halo;
    unsigned mask = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dh = tap / 3 - 1, dw = tap % 3 - 1;
      if (m < p.M && yc + dh >= 0 && yc + dh < p.H && xc + dw >= 0 &&
          xc + dw < p.W) {
        mask |= 1u << tap;
      }
    }
    taps[i] = mask;
  }

  auto load = [&](int stage, int c0) {
    int8_t* as = smem + stage * STAGE_BYTES;
    int8_t* bs = as + A_BYTES;
    for (int i = tid; i < nwin * (BK / 16); i += THREADS) {
      const int wr = i / (BK / 16), c = i % (BK / 16);
      const int fm = m0 - halo + wr;
      const bool v = fm >= 0 && fm < p.M;
      const int8_t* src =
          v ? p.x + static_cast<size_t>(fm) * p.Cin + c0 + c * 16 : p.x;
      cp_async16(as + wr * LDS + c * 16, src, v);
    }
    for (int i = tid; i < 9 * BN * (BK / 16); i += THREADS) {
      const int tap = i / (BN * (BK / 16)), rest = i % (BN * (BK / 16));
      const int row = rest / (BK / 16), c = rest % (BK / 16);
      const int o = j * BN + row;
      const bool v = o < p.Cout;
      const int8_t* src =
          v ? p.wt + static_cast<size_t>(o) * p.K + tap * p.Cin + c0 + c * 16
            : p.wt;
      cp_async16(bs + (tap * BN + row) * LDS + c * 16, src, v);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][n][r] = 0;

  const int kt_n = p.Cin / BK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < kt_n) load(s ^ 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int8_t* as = smem + s * STAGE_BYTES;
    const int8_t* bs = as + A_BYTES;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3 - 1) * p.W + (tap % 3 - 1);
      unsigned b[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* q = bs + (tap * BN + ni * 32 + wn * 8 + g) * LDS + t * 4;
        b[ni][0] = *reinterpret_cast<const unsigned*>(q);
        b[ni][1] = *reinterpret_cast<const unsigned*>(q + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int ra = (taps[2 * mi] >> tap) & 1 ? lrow[2 * mi] + off : ZROW;
        const int rb =
            (taps[2 * mi + 1] >> tap) & 1 ? lrow[2 * mi + 1] + off : ZROW;
        const int8_t* qa = as + ra * LDS + t * 4;
        const int8_t* qb = as + rb * LDS + t * 4;
        const unsigned a0 = *reinterpret_cast<const unsigned*>(qa);
        const unsigned a1 = *reinterpret_cast<const unsigned*>(qb);
        const unsigned a2 = *reinterpret_cast<const unsigned*>(qa + 16);
        const unsigned a3 = *reinterpret_cast<const unsigned*>(qb + 16);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], a0, a1, a2, a3, b[ni][0], b[ni][1]);
      }
    }
    __syncthreads();
  }

  // Epilogue. Fragment r of n8 tile ni: row g + 8*(r/2), column
  // ni*32 + wn*8 + 2t + r%2 of the block's 128.
  int8_t* out8 = static_cast<int8_t*>(p.out);
  float* outf = static_cast<float*>(p.out);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (m >= p.M) continue;
      const size_t row = static_cast<size_t>(m) * p.Cout;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = j * BN + ni * 32 + wn * 8 + t * 2 + e;
          if (o >= p.Cout) continue;
          const float y = epilogue_f32(acc[mi][ni][half * 2 + e], p.scale[o],
                                       p.bias[o], p.act);
          if (p.quantize) {
            out8[row + o] = to_code(y);
          } else {
            outf[row + o] = y;
          }
        }
      }
    }
  }
}

}  // namespace

// x 16-byte aligned, Cin % 32 == 0 (the wrapper asks 128), W + 1 <= 32;
// wt (Cout, 9*Cin) K-major, 16-byte aligned.
extern "C" int conv3x3_bt(const void* x, const void* wt, const void* scale,
                          const void* bias, void* out, int N, int H, int W,
                          int Cin, int Cout, int quantize, int act,
                          void* stream) {
  if (W + 1 > HALO_MAX || Cin % BK || Cin <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Conv p;
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(wt);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.M = N * H * W;
  p.K = 9 * Cin;
  p.quantize = quantize;
  p.act = act;
  if (p.M <= 0 || Cout <= 0) return static_cast<int>(cudaGetLastError());
  const int smem = 2 * STAGE_BYTES;
  const cudaError_t e = cudaFuncSetAttribute(
      conv_bt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((p.M + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv_bt_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
