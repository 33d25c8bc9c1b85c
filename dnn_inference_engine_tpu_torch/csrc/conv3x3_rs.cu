// Implicit-im2col int8 conv for Hopper (sm_90a): a k x k stride-1 conv of
// an NHWC int8 tensor (k = 3 SAME, or k = 2 VALID over a shifted fold),
// int32 accumulation, the folded epilogue, and optionally the pool-major
// group-max and a space-to-depth(2) output, in one pass.
//
// Replaces: dnn_inference_engine_tpu/ops/pallas_conv.py, conv3x3_rs (kernel
// body _conv_rs_kernel; conv2d_w8a8_rs calls it). Same contract for the
// forms the plan stages use:
//   acc[m, o] = sum over taps (dh, dw) and ci of
//               x[n, oy+dh-pad, ox+dw-pad, ci] * w[dh, dw, ci, o]
//   y = act(acc*scale[o] + bias[o]); int8 out: clip(rint(y), +-127)
//   go > 0 ('gmaxm'): out channel c < go is the max over the 4 pool groups
//     o = k*go + c. With int8 out the max is taken on the int32 accumulator
//     first, then the epilogue with scale[c], bias[c] (exact: the epilogue
//     is monotone); with f32 out on each group's y.
//   s2d: pixel (oy, ox) channel c is stored at
//     [n, oy/2, ox/2, ((oy%2)*2 + ox%2)*C + c]; an odd last column is
//     dropped.
// Every rounding is explicit (mma_s8.cuh). Only the real output width is
// computed; the TPU kernel's junk columns have no counterpart here.
//
// What bounds it on an H100 (SXM data sheet at 700 W: 1,979 int8 TOP/s,
// 3.35 TB/s): the int8 tensor-core rate, at every plan shape (2.0-2.3 K
// operations per byte moved, against the card's ~590). So the design feeds
// mma.sync m16n8k32 (s8 x s8 -> s32) as the GEMM kernel does: 128 pixels x
// 128 accumulator columns x 64 bytes of K per block tile, a two-stage
// cp.async pipeline, 8 warps of 64 x 32. What it removes is the im2col
// copy: A is read straight from the NHWC input, one 16-byte cp.async per
// (pixel, 16 channels of one tap) -- Cin % 16 == 0, so a chunk never
// straddles a tap -- with the SAME halo and the row/column edges
// zero-filled by bounds, not by a padded copy. B is the (Cout, k*k*Cin)
// K-major weight matrix the wrapper lays out once. For 'gmaxm' the block's
// 128 columns are 32 channels of each of the 4 pool groups, and warp wn's
// n8 tile ni holds group ni, channels wn*8..wn*8+7: the group-max is a max
// over the thread's own registers. wgmma, TMA and a persistent schedule
// are later work.

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

constexpr int BM = 128;         // output pixels per block
constexpr int BN = 128;         // accumulator columns per block
constexpr int GN = BN / 4;      // channels of each pool group per block
constexpr int BK = 64;          // bytes of K per stage
constexpr int LDS = BK + 16;    // shared row stride in bytes
constexpr int THREADS = 256;

struct Conv {
  const int8_t* x;              // (N, H, W, Cin)
  const int8_t* wt;             // (Cout, K), K = ks*ks*Cin in (dh, dw, ci)
  const float* scale;
  const float* bias;
  void* out;
  int N, H, W, Cin, Cout, ks, pad, Ho, Wo, K, M, go, quantize, act, s2d;
};

__global__ void __launch_bounds__(THREADS) conv_rs_kernel(const Conv p) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];

  const int m0 = blockIdx.x * BM;
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;      // 2 warps along M, 64 pixels each
  const int wn = warp % 4;      // 4 warps along N
  const int g = lane / 4;
  const int t = lane % 4;

  // The two A rows (pixels) and two B rows this thread loads, and its
  // 16-byte column of the K tile; fixed over the K loop.
  const int kc = (tid % 4) * 16;
  int a_y[2], a_x[2];
  bool a_ok[2], b_ok[2];
  const int8_t* a_img[2];
  const int8_t* b_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tid / 4 + i * 64;
    const int m = m0 + r;
    a_ok[i] = m < p.M;
    const int mm = a_ok[i] ? m : 0;
    const int ox = mm % p.Wo, rest = mm / p.Wo;
    const int oy = rest % p.Ho, n = rest / p.Ho;
    a_y[i] = oy - p.pad;
    a_x[i] = ox - p.pad;
    a_img[i] = p.x + static_cast<size_t>(n) * p.H * p.W * p.Cin;
    int o;
    if (p.go) {
      const int c = j * GN + r % GN;
      b_ok[i] = c < p.go;
      o = (r / GN) * p.go + c;
    } else {
      o = j * BN + r;
      b_ok[i] = o < p.Cout;
    }
    b_row[i] = p.wt + static_cast<size_t>(b_ok[i] ? o : 0) * p.K;
  }

  auto load = [&](int stage, int k0) {
    const int gk = k0 + kc;
    const int tap = gk / p.Cin;
    const int ci = gk - tap * p.Cin;
    const int dh = tap / p.ks, dw = tap - (tap / p.ks) * p.ks;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tid / 4 + i * 64;
      const int iy = a_y[i] + dh, ix = a_x[i] + dw;
      const bool va = a_ok[i] && gk < p.K && iy >= 0 && iy < p.H && ix >= 0 &&
                      ix < p.W;
      const int8_t* sa =
          va ? a_img[i] + (static_cast<size_t>(iy) * p.W + ix) * p.Cin + ci
             : p.x;
      cp_async16(As[stage] + r * LDS + kc, sa, va);
      const bool vb = b_ok[i] && gk < p.K;
      cp_async16(Bs[stage] + r * LDS + kc, vb ? b_row[i] + gk : p.wt, vb);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][n][r] = 0;

  const int kt_n = (p.K + BK - 1) / BK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < kt_n) load(s ^ 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int8_t* as = As[s];
    const int8_t* bs = Bs[s];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned b[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* q = bs + (ni * GN + wn * 8 + g) * LDS + kk + t * 4;
        b[ni][0] = *reinterpret_cast<const unsigned*>(q);
        b[ni][1] = *reinterpret_cast<const unsigned*>(q + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* q = as + (wm * 64 + mi * 16 + g) * LDS + kk + t * 4;
        unsigned a0 = *reinterpret_cast<const unsigned*>(q);
        unsigned a1 = *reinterpret_cast<const unsigned*>(q + 8 * LDS);
        unsigned a2 = *reinterpret_cast<const unsigned*>(q + 16);
        unsigned a3 = *reinterpret_cast<const unsigned*>(q + 8 * LDS + 16);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], a0, a1, a2, a3, b[ni][0], b[ni][1]);
      }
    }
    __syncthreads();
  }

  // Epilogue. Fragment r of n8 tile ni: pixel row g + 8*(r/2), column
  // ni*GN + wn*8 + 2t + r%2 of the block's 128.
  const int cg = p.go ? p.go : p.Cout;        // output channels
  int8_t* out8 = static_cast<int8_t*>(p.out);
  float* outf = static_cast<float*>(p.out);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (m >= p.M) continue;
      const int ox = m % p.Wo, rest = m / p.Wo;
      const int oy = rest % p.Ho, n = rest / p.Ho;
      size_t pix;
      if (p.s2d) {
        const int wo2 = p.Wo / 2;
        if (ox / 2 >= wo2) continue;          // odd last column: dropped
        pix = ((static_cast<size_t>(n) * (p.Ho / 2) + oy / 2) * wo2 + ox / 2) *
                  4 * cg +
              static_cast<size_t>(((oy & 1) * 2 + (ox & 1)) * cg);
      } else {
        pix = ((static_cast<size_t>(n) * p.Ho + oy) * p.Wo + ox) * cg;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = half * 2 + e;
        if (p.go) {
          const int c = j * GN + wn * 8 + t * 2 + e;
          if (c >= p.go) continue;
          if (p.quantize) {
            const int a = max(max(acc[mi][0][r], acc[mi][1][r]),
                              max(acc[mi][2][r], acc[mi][3][r]));
            out8[pix + c] =
                to_code(epilogue_f32(a, p.scale[c], p.bias[c], p.act));
          } else {
            float y[4];
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              const int o = ni * p.go + c;
              y[ni] = epilogue_f32(acc[mi][ni][r], p.scale[o], p.bias[o],
                                   p.act);
            }
            outf[pix + c] = fmaxf(fmaxf(y[0], y[1]), fmaxf(y[2], y[3]));
          }
        } else {
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int o = j * BN + ni * GN + wn * 8 + t * 2 + e;
            if (o >= p.Cout) continue;
            const float y =
                epilogue_f32(acc[mi][ni][r], p.scale[o], p.bias[o], p.act);
            if (p.quantize) {
              out8[pix + o] = to_code(y);
            } else {
              outf[pix + o] = y;
            }
          }
        }
      }
    }
  }
}

}  // namespace

// go > 0: the 'gmaxm' group-max with Cout == 4*go; go == 0: no pool.
// Needs Cin % 16 == 0 and a 16-byte aligned x (the wrapper checks).
extern "C" int conv3x3_rs(const void* x, const void* wt, const void* scale,
                          const void* bias, void* out, int N, int H, int W,
                          int Cin, int Cout, int ks, int go, int quantize,
                          int act, int s2d, void* stream) {
  Conv p;
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(wt);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.N = N;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.ks = ks;
  p.pad = ks == 3 ? 1 : 0;
  p.Ho = ks == 3 ? H : H - 1;
  p.Wo = ks == 3 ? W : W - 1;
  p.K = ks * ks * Cin;
  p.M = N * p.Ho * p.Wo;
  p.go = go;
  p.quantize = quantize;
  p.act = act;
  p.s2d = s2d;
  if (p.M <= 0 || Cout <= 0) return static_cast<int>(cudaGetLastError());
  const int ntiles = go ? (go + GN - 1) / GN : (Cout + BN - 1) / BN;
  dim3 grid((p.M + BM - 1) / BM, ntiles);
  conv_rs_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
