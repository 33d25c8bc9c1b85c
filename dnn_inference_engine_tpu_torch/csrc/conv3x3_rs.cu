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
// 3.35 TB/s): the int8 tensor-core rate at every b32 plan shape (2.0-2.3 K
// operations per byte moved, against the card's ~590); at batch 1 (M =
// 169 at L8) the weight bytes. So the design is the shared Hopper mainloop
// of wgmma_s8.cuh: 128 pixels x 128 accumulator columns a tile, K walked
// in 128-byte stages through a ring of 6, wgmma m64n128k32 from two
// consumer warpgroups that take the tiles in turn (one's epilogue under
// the other's mainloop), a persistent grid, and K split across blocks
// where the tiles alone leave SMs idle (batch 1).
//
// A is an implicit im2col: the producer warpgroup reads the NHWC input in
// place, one 16-byte cp.async per (pixel, 16 channels of one tap) -- Cin %
// 16 == 0, so a chunk never straddles a tap -- into the stage's swizzled
// layout, and each thread's copies complete on the stage's full barrier
// (cp.async.mbarrier.arrive.noinc: the producer never waits for its own
// copies, so it runs up to the ring's depth ahead). A thread owns one
// 16-byte column of the stage (its byte offset in K is fixed) and 8
// pixels (rows r, r + 16, ...); their base offsets are computed once a
// tile, and the tap and channel of its column advance by steps from one
// stage to the next, so the K loop has no division. The SAME halo and the
// row and column edges are zero-filled by bounds (a cp.async of source
// size 0), not by a padded copy. TMA's im2col mode would need a 4-D map
// per call and its own halo rules for the k = 2 VALID fold; the gather
// keeps both forms on one path. (Measured on an H100: with the gather's
// copies and address work left out, S1's two b32 stages ran 15-25%
// faster; the rest of the gap to the GEMM's mainloop is not measured.)
//
// B is the K-major weight matrix the wrapper lays out once
// (rs_tile_matrix), one 128-row block a tile, and comes by TMA in one box
// a stage (128-byte swizzle, rows past the matrix zero-filled). Without a
// pool it is (Cout, k*k*Cin). For 'gmaxm' block j holds channels
// 32j..32j+31 of each of the 4 pool groups, group k in rows 32k..32k+31.
// Under wgmma's accumulator layout (wgmma_s8.cuh) a thread holds columns
// 8i + 2t + e for every i, so it holds channel 8i' + 2t + e (i' < 4) of
// group k at i = i' + 4k: the same channel of all four groups, and the
// group-max is a max over the thread's own registers. (Four boxes of 32
// rows from the unpermuted matrix give the same stage, 10% slower.)

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "mma_s8.cuh"
#include "tma.cuh"
#include "wgmma_s8.cuh"

namespace {

using s8mma::cp_async16;
using s8mma::epilogue_f32;

constexpr int BN = wg::BN;      // accumulator columns a tile
constexpr int GN = BN / 4;      // channels of each pool group a tile
constexpr int STAGES = 6;

struct Conv {
  const int8_t* x;              // (N, H, W, Cin)
  const float* scale;
  const float* bias;
  void* out;
  int* ws;                      // split-K partial sums (splits > 1)
  int* counters;                // split-K arrival counters, zero
  int N, H, W, Cin, Cout, ks, pad, Ho, Wo, K, M, go, quantize, act, s2d;
  int n_tiles, splits, units, kt;
};

// Consumer c's tile (row block mt, column block j): acc[64q + 4i + 2h +
// e] is pixel 64q + 16w + g + 8h of the tile, column 8i + 2t + e of its
// 128. QUANT and ACT are template arguments so that a thread's codes are
// straight-line code.
template <bool QUANT, int ACT>
__device__ __forceinline__ void conv_epilogue(const int (&acc)[wg::NREG],
                                              const Conv& p, int mt, int j) {
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int cg = p.go ? p.go : p.Cout;          // output channels
  int8_t* out8 = static_cast<int8_t*>(p.out);
  float* outf = static_cast<float*>(p.out);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * wg::BM + 64 * q + 16 * w + g + 8 * h;
      if (m >= p.M) continue;
      const int ox = m % p.Wo, rest = m / p.Wo;
      const int oy = rest % p.Ho, n = rest / p.Ho;
      size_t pix;
      if (p.s2d) {
        const int wo2 = p.Wo / 2;
        if (ox / 2 >= wo2) continue;            // odd last column: dropped
        pix = ((static_cast<size_t>(n) * (p.Ho / 2) + oy / 2) * wo2 +
               ox / 2) * 4 * cg +
              static_cast<size_t>(((oy & 1) * 2 + (ox & 1)) * cg);
      } else {
        pix = ((static_cast<size_t>(n) * p.Ho + oy) * p.Wo + ox) * cg;
      }
      if (p.go) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ch = j * GN + 8 * i + 2 * t + e;
            if (ch >= p.go) continue;
            const int r = 64 * q + 4 * i + 2 * h + e;   // group k at r + 16k
            if (QUANT) {
              const int a = max(max(acc[r], acc[r + 16]),
                                max(acc[r + 32], acc[r + 48]));
              out8[pix + ch] = static_cast<int8_t>(wg::code_bits(
                  epilogue_f32(a, p.scale[ch], p.bias[ch], ACT)));
            } else {
              float y[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int o = k * p.go + ch;
                y[k] = epilogue_f32(acc[r + 16 * k], p.scale[o], p.bias[o],
                                    ACT);
              }
              outf[pix + ch] = fmaxf(fmaxf(y[0], y[1]), fmaxf(y[2], y[3]));
            }
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = j * BN + 8 * i + 2 * t + e;
            if (o >= p.Cout) continue;
            const float y = epilogue_f32(acc[64 * q + 4 * i + 2 * h + e],
                                         p.scale[o], p.bias[o], ACT);
            if (QUANT) {
              out8[pix + o] = static_cast<int8_t>(wg::code_bits(y));
            } else {
              outf[pix + o] = y;
            }
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(wg::THREADS, 1)
conv_rs_kernel(const __grid_constant__ CUtensorMap map_b, const Conv p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const wg::Ring<STAGES> ring(smem, 0);
  if (threadIdx.x == 0) {
    ring.init(128 + 1);         // each producer thread's copies + B's bytes
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // --- producer warpgroup: A gathered by cp.async, B by TMA ---
    wg::setmaxnreg_dec<96>();
    const int tid = threadIdx.x;
    const int kc = tid % 8;                     // 16-byte column of a stage
    const int rsub = tid / 8;                   // rows rsub + 16 i
    const int dst = rsub * wg::BK + ((kc ^ (rsub & 7)) * 16);
    wg::Pipe<STAGES> pipe;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const wg::Unit x = wg::unit(u, p.splits, p.n_tiles, p.kt);
      long long base[8];                        // pixel (oy-pad, ox-pad)
      int py[8], px[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = x.mt * wg::BM + rsub + 16 * i;
        if (m < p.M) {
          const int ox = m % p.Wo, rest = m / p.Wo;
          const int oy = rest % p.Ho, n = rest / p.Ho;
          py[i] = oy - p.pad;
          px[i] = ox - p.pad;
          base[i] = ((static_cast<long long>(n) * p.H + py[i]) * p.W +
                     px[i]) * p.Cin;
        } else {
          py[i] = -(1 << 20);                   // every tap out of bounds
          px[i] = 0;
          base[i] = 0;
        }
      }
      int gk = x.kb * wg::BK + kc * 16;         // this thread's K byte
      const int tap = gk / p.Cin;
      int ci = gk - tap * p.Cin;
      int dh = tap / p.ks, dw = tap - (tap / p.ks) * p.ks;
      for (int kt = x.kb; kt < x.ke; ++kt) {
        uint64_t* full = &ring.full[pipe.stage];
        wg::wait(&ring.empty[pipe.stage], pipe.phase ^ 1);
        uint8_t* sb = ring.b(pipe.stage);
        if (tid == 0) {
          tma::mbar_expect_tx(full, BN * wg::BK);
          wg::tma_load_2d(sb, &map_b, full, kt * wg::BK, x.nt * BN);
        }
        uint8_t* sa = ring.a(pipe.stage) + dst;
        const bool kin = gk < p.K;
        const int off = (dh * p.W + dw) * p.Cin + ci;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int iy = py[i] + dh, ix = px[i] + dw;
          const bool v = kin && static_cast<unsigned>(iy) < p.H &&
                         static_cast<unsigned>(ix) < p.W;
          const int8_t* src = v ? p.x + base[i] + off : p.x;
          cp_async16(sa + i * 16 * wg::BK, src, v);
        }
        wg::cp_async_arrive_noinc(full);
        gk += wg::BK;
        ci += wg::BK;
        while (ci >= p.Cin) {
          ci -= p.Cin;
          if (++dw == p.ks) {
            dw = 0;
            ++dh;
          }
        }
        pipe.advance();
      }
    }
  } else {
    // --- consumers: c takes the block's units 2k + c, whole tiles ---
    wg::setmaxnreg_inc<200>();
    const int c = threadIdx.x / 128 - 1;
    wg::Pipe<STAGES> pipe;
    int acc[wg::NREG];
    int i = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++i) {
      const wg::Unit x = wg::unit(u, p.splits, p.n_tiles, p.kt);
      if ((i & 1) != c) {
        pipe.skip(x.ke - x.kb);
        continue;
      }
      wg::mma_unit<STAGES, true>(acc, ring, pipe, x.ke - x.kb, c, i >> 1);
      if (p.splits > 1 &&
          !wg::splitk_fixup(acc, p.ws, p.counters, &ring.flags[c], c,
                            x.tile, x.s, p.splits,
                            p.M - x.mt * wg::BM)) {
        continue;
      }
      switch (p.quantize * 3 + p.act) {
        case 0: conv_epilogue<false, 0>(acc, p, x.mt, x.nt); break;
        case 1: conv_epilogue<false, 1>(acc, p, x.mt, x.nt); break;
        case 2: conv_epilogue<false, 2>(acc, p, x.mt, x.nt); break;
        case 3: conv_epilogue<true, 0>(acc, p, x.mt, x.nt); break;
        case 4: conv_epilogue<true, 1>(acc, p, x.mt, x.nt); break;
        default: conv_epilogue<true, 2>(acc, p, x.mt, x.nt); break;
      }
    }
  }
}

}  // namespace

// go > 0: the 'gmaxm' group-max with Cout == 4*go, wt the pool-major
// (ceil(go/32)*128, K) matrix; go == 0: no pool, wt (Cout, K).
// Needs Cin % 16 == 0 and a 16-byte aligned x and wt (the wrapper checks).
// `splits` K-splits over `grid` persistent blocks; ws holds tiles * splits
// * 128 * 128 int32 and counters `tiles` zeroed int32 when splits > 1.
// Returns a cudaError_t, or minus the CUresult of a failed tensor-map
// encode.
extern "C" int conv3x3_rs(const void* x, const void* wt, const void* scale,
                          const void* bias, void* out, int N, int H, int W,
                          int Cin, int Cout, int ks, int go, int quantize,
                          int act, int s2d, int splits, int grid, void* ws,
                          void* counters, void* stream) {
  Conv p;
  p.x = static_cast<const int8_t*>(x);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.ws = static_cast<int*>(ws);
  p.counters = static_cast<int*>(counters);
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
  p.n_tiles = go ? (go + GN - 1) / GN : (Cout + BN - 1) / BN;
  p.kt = (p.K + wg::BK - 1) / wg::BK;
  p.splits = splits;
  p.units = (p.M + wg::BM - 1) / wg::BM * p.n_tiles * splits;
  if (Cin % 16 != 0 || splits < 1 || splits > p.kt || grid < 1 ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap mb;
  const uint64_t dims[2] = {static_cast<uint64_t>(p.K),
                            static_cast<uint64_t>(go ? p.n_tiles * BN : Cout)};
  const uint64_t stride[1] = {static_cast<uint64_t>(p.K)};
  const uint32_t box[2] = {wg::BK, BN};
  const CUresult r = tma::encode_s8(&mb, wt, 2, dims, stride, box,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  constexpr int smem = wg::smem_bytes(STAGES, 0);
  static unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(done & (1u << (dev & 31)))) {
    err = cudaFuncSetAttribute(conv_rs_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) done |= 1u << (dev & 31);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_rs_kernel<<<grid, wg::THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(mb, p);
  return static_cast<int>(cudaGetLastError());
}
