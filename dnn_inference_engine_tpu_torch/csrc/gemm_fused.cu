// Fused int8 GEMM for Hopper (sm_90a): C = A(M,K) int8 x B(K,N) int8,
// accumulated in int32, then one per-column epilogue chosen per call.
//
// Replaces: dnn_inference_engine_tpu/ops/pallas_gemm.py, gemm_fused and
// int8_gemm_fused (the pl.pallas_call sites of the weights-resident and
// the 3-D tiled schedules). In the port it also carries the 1x1 convs of
// the xla tier (the conv is the GEMM: no im2col), the forms conv_w8a8.cu
// refuses (an im2col in PyTorch first), and the gemm tier's im2col convs.
//
// Epilogues (mode):
//   0  conv order, as conv2d_w8a8 and the fold stages compute it:
//      y = acc*scale + bias, activation, q = clip(rint(y / s_out), +-127)
//   1  folded order, as gemm_fused(quantize_out=True) computes it (the
//      caller folded 1/s_out into scale and bias): q = clip(rint(y))
//   2  f32 out, y after the activation (the linear detection head)
//   3  the raw int32 accumulator
// Every rounding is explicit (__fmul_rn, __fadd_rn, __fdiv_rn, rintf; the
// shared helpers are in mma_s8.cuh, the codes of modes 0, 1 and 4 in
// requant.cuh, which conv_w8a8.cu shares): nvcc would otherwise contract
// a*b+c into an FMA, and the int8 codes would drift by 1 LSB.
//
// What bounds it on an H100 (data-sheet rates of the SXM part at 700 W:
// 1,979 int8 TOP/s, 3.35 TB/s): bytes for L2-L8 and the L14 head, whose
// A matrix (K = 512..1152) feeds only N = 125..256 columns, 170 to 420
// operations a byte against the card's ~590; the int8 tensor-core rate for
// L10-L13 (K 2304..9216, N 512..1024); at batch 1 (M = 169..10,816) the
// weight bytes, read by too few tiles unless K is split.
//
// Two forms, chosen by the wrapper from the shape alone
// (ops/gemm.py:gemm_form):
//
// - wgmma (K % 16 == 0, A and B 16-byte aligned: every main-path shape).
//   The mainloop of wgmma_s8.cuh: a persistent grid of at most one block
//   an SM walks units (128 x 128 tile, K-split) in order; a producer
//   thread keeps up to 5 stages of A and B (128 x 128 bytes each) in
//   flight by TMA (2-D tiled maps, 128-byte swizzle, the M, N and K edges
//   zero-filled by the copy engine); two consumer warpgroups take the
//   units in turn and run wgmma m64n128k32 on them, one's epilogue under
//   the other's mainloop. K is split where the tiles alone would leave SMs
//   idle (see wgmma_s8.cuh for why that cannot move a code). Each tile's
//   scale and bias go to shared memory while its mainloop runs. The int8
//   epilogue stages the 128 x 128 codes in shared memory and stores them
//   16 bytes a thread; the f32 and int32 epilogues store straight from
//   the fragments, 8 bytes a thread.
// - ragged (anything else: K = 27 of the generic tier's first conv, a
//   misaligned view). 128x128x64 block tiles, operands loaded a byte at a
//   time into padded shared memory, mma.sync m16n8k32 (s8 x s8 -> s32)
//   from 8 warps of 64x32 each; the M, N and K edges masked in the kernel.

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "mma_s8.cuh"
#include "requant.cuh"
#include "tma.cuh"
#include "wgmma_s8.cuh"

namespace {

using s8mma::epilogue_f32;
using s8mma::mma_s8;
using s8mma::to_code;

// ---------------------------------------------------------------------------
// The wgmma form
// ---------------------------------------------------------------------------

constexpr int STAGES = 5;
constexpr int STAGING = wg::BM * wg::BN;        // a tile of int8 codes
// after the ring: each consumer's staged codes, then its tile's scale and
// bias (BN floats each)
constexpr int EXTRA = 2 * STAGING + 2 * 2 * wg::BN * 4;

struct GemmArgs {
  const float* scale;
  const float* bias;
  void* out;
  int* ws;                      // split-K partial sums (splits > 1)
  int* counters;                // split-K arrival counters, zero
  rq::Requant q;                // the conv order's division by s_out
  int M, N, K, mode, act;
  int n_tiles, splits, units, kt;
};

// A consumer's tile in the epilogue: its staging, its tile's scale and
// bias in shared memory, its first row and column, the consumer.
struct Tile {
  uint8_t* staging;
  const float* sc;
  const float* bi;
  int r0, n0, c;
};

// Modes 0, 1 and 4: consumer c's 128 x 128 codes through its swizzled
// staging (16-byte chunks XOR-ed with the row, so the 2-byte fragment
// writes are free of bank conflicts) to 16-byte stores, a warp covering
// four whole rows. MODE and ACT are template arguments so that the 128
// codes of a thread are straight-line code the compiler interleaves.
template <int MODE, int ACT>
__device__ __forceinline__ void store_codes(const int (&acc)[wg::NREG],
                                            const Tile& tl,
                                            const GemmArgs& p) {
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
#pragma unroll
  for (int j = 0; j < wg::BN / 8; ++j) {
    const int cl = 8 * j + 2 * t;
    const float2 sc = *reinterpret_cast<const float2*>(tl.sc + cl);
    const float2 bi = *reinterpret_cast<const float2*>(tl.bi + cl);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * q + 16 * w + g + 8 * h;
        const int i = 64 * q + 4 * j + 2 * h;
        const uint32_t q0 = rq::code<MODE>(acc[i], sc.x, bi.x, ACT, p.q);
        const uint32_t q1 = rq::code<MODE>(acc[i + 1], sc.y, bi.y, ACT, p.q);
        const int chunk = (cl >> 4) ^ (r & 7);
        *reinterpret_cast<uint16_t*>(tl.staging + r * wg::BN + chunk * 16 +
                                     (cl & 15)) =
            static_cast<uint16_t>(__byte_perm(q0, q1, 0x0040));
      }
    }
  }
  wg::warpgroup_sync(tl.c);
  int8_t* out = static_cast<int8_t*>(p.out);
#pragma unroll
  for (int k = 0; k < STAGING / 16 / 128; ++k) {
    const int ch = k * 128 + tid;
    const int r = ch / (wg::BN / 16), cc = ch % (wg::BN / 16);
    const int row = tl.r0 + r, col = tl.n0 + cc * 16;
    if (row >= p.M || col >= p.N) continue;
    const int4 v = *reinterpret_cast<const int4*>(
        tl.staging + r * wg::BN + ((cc ^ (r & 7)) * 16));
    int8_t* dst = out + static_cast<size_t>(row) * p.N + col;
    if ((p.N & 15) == 0) {
      *reinterpret_cast<int4*>(dst) = v;
    } else {
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
      for (int e = 0; e < 16 && col + e < p.N; ++e) dst[e] = b[e];
    }
  }
}

// Modes 2 (f32) and 3 (int32): straight from the fragments, 8 bytes a
// thread where N is even (the four threads of a quad cover a 32-byte
// sector).
template <int MODE, int ACT>
__device__ __forceinline__ void store_wide(const int (&acc)[wg::NREG],
                                           const Tile& tl,
                                           const GemmArgs& p) {
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const bool even = (p.N & 1) == 0;
#pragma unroll
  for (int j = 0; j < wg::BN / 8; ++j) {
    const int cl = 8 * j + 2 * t;
    const int col = tl.n0 + cl;
    const float2 sc = *reinterpret_cast<const float2*>(tl.sc + cl);
    const float2 bi = *reinterpret_cast<const float2*>(tl.bi + cl);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tl.r0 + 64 * q + 16 * w + g + 8 * h;
        if (row >= p.M || col >= p.N) continue;
        const int i = 64 * q + 4 * j + 2 * h;
        const size_t o = static_cast<size_t>(row) * p.N + col;
        const bool v1 = col + 1 < p.N;
        if (MODE == 3) {
          int* out = static_cast<int*>(p.out) + o;
          if (v1 && even) {
            *reinterpret_cast<int2*>(out) = make_int2(acc[i], acc[i + 1]);
          } else {
            out[0] = acc[i];
            if (v1) out[1] = acc[i + 1];
          }
        } else {
          float* out = static_cast<float*>(p.out) + o;
          const float y0 = epilogue_f32(acc[i], sc.x, bi.x, ACT);
          const float y1 = epilogue_f32(acc[i + 1], sc.y, bi.y, ACT);
          if (v1 && even) {
            *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
          } else {
            out[0] = y0;
            if (v1) out[1] = y1;
          }
        }
      }
    }
  }
  wg::warpgroup_sync(tl.c);        // scale and bias read before the next tile's
}

__global__ void __launch_bounds__(wg::THREADS, 1)
gemm_fused_kernel_wgmma(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        const GemmArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const wg::Ring<STAGES> ring(smem, EXTRA);
  if (threadIdx.x == 0) {
    ring.init(1);
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // --- producer: one thread issues every copy, in unit order ---
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      wg::Pipe<STAGES> pipe;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const wg::Unit x = wg::unit(u, p.splits, p.n_tiles, p.kt);
        for (int kt = x.kb; kt < x.ke; ++kt) {
          uint64_t* full = &ring.full[pipe.stage];
          wg::wait(&ring.empty[pipe.stage], pipe.phase ^ 1);
          tma::mbar_expect_tx(full, wg::STAGE_BYTES);
          wg::tma_load_2d(ring.a(pipe.stage), &map_a, full, kt * wg::BK,
                          x.mt * wg::BM);
          wg::tma_load_2d(ring.b(pipe.stage), &map_b, full, kt * wg::BK,
                          x.nt * wg::BN);
          pipe.advance();
        }
      }
    }
  } else {
    // --- consumers: c takes the block's units 2k + c, whole tiles ---
    wg::setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    uint8_t* staging = ring.extra + c * STAGING;
    float* sc_s = reinterpret_cast<float*>(ring.extra + 2 * STAGING) +
                  c * 2 * wg::BN;
    float* bi_s = sc_s + wg::BN;
    wg::Pipe<STAGES> pipe;
    int acc[wg::NREG];
    int i = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++i) {
      const wg::Unit x = wg::unit(u, p.splits, p.n_tiles, p.kt);
      if ((i & 1) != c) {
        pipe.skip(x.ke - x.kb);
        continue;
      }
      // the tile's scale and bias, for the epilogue; the previous tile's
      // were read before its last warpgroup_sync
      const int col = x.nt * wg::BN + tid;
      sc_s[tid] = col < p.N ? p.scale[col] : 0.f;
      bi_s[tid] = col < p.N ? p.bias[col] : 0.f;
      wg::mma_unit<STAGES, false>(acc, ring, pipe, x.ke - x.kb, c, i >> 1);
      if (p.splits > 1 &&
          !wg::splitk_fixup(acc, p.ws, p.counters, &ring.flags[c], c,
                            x.tile, x.s, p.splits,
                            p.M - x.mt * wg::BM)) {
        continue;
      }
      wg::warpgroup_sync(c);    // scale and bias written, staging free
      const Tile tl{staging, sc_s, bi_s, x.mt * wg::BM, x.nt * wg::BN, c};
      switch (p.mode * 3 + p.act) {
        case 0: store_codes<0, 0>(acc, tl, p); break;
        case 1: store_codes<0, 1>(acc, tl, p); break;
        case 2: store_codes<0, 2>(acc, tl, p); break;
        case 3: store_codes<1, 0>(acc, tl, p); break;
        case 4: store_codes<1, 1>(acc, tl, p); break;
        case 5: store_codes<1, 2>(acc, tl, p); break;
        case 6: store_wide<2, 0>(acc, tl, p); break;
        case 7: store_wide<2, 1>(acc, tl, p); break;
        case 8: store_wide<2, 2>(acc, tl, p); break;
        case 9:
        case 10:
        case 11: store_wide<3, 0>(acc, tl, p); break;
        case 12: store_codes<4, 0>(acc, tl, p); break;
        case 13: store_codes<4, 1>(acc, tl, p); break;
        default: store_codes<4, 2>(acc, tl, p); break;
      }
    }
  }
}

int launch_wgmma(const int8_t* A, const int8_t* B, const GemmArgs& p,
                 int grid, cudaStream_t st) {
  CUtensorMap ma, mb;
  const uint64_t da[2] = {static_cast<uint64_t>(p.K),
                          static_cast<uint64_t>(p.M)};
  const uint64_t db[2] = {static_cast<uint64_t>(p.K),
                          static_cast<uint64_t>(p.N)};
  const uint64_t stride[1] = {static_cast<uint64_t>(p.K)};
  const uint32_t ba[2] = {wg::BK, wg::BM};
  const uint32_t bb[2] = {wg::BK, wg::BN};
  CUresult r = tma::encode_s8(&ma, A, 2, da, stride, ba,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS) {
    r = tma::encode_s8(&mb, B, 2, db, stride, bb,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  constexpr int smem = wg::smem_bytes(STAGES, EXTRA);
  static unsigned done = 0;     // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(done & (1u << (dev & 31)))) {
    err = cudaFuncSetAttribute(gemm_fused_kernel_wgmma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) done |= 1u << (dev & 31);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_fused_kernel_wgmma<<<grid, wg::THREADS, smem, st>>>(ma, mb, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The ragged form
// ---------------------------------------------------------------------------

__device__ __forceinline__ int8_t ragged_code(int acc, float sc, float bi,
                                              int act, int mode,
                                              float s_out) {
  float y = epilogue_f32(acc, sc, bi, act);
  if (mode == 0) y = __fdiv_rn(y, s_out);
  return to_code(y);
}

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;          // bytes of K per stage
constexpr int LDS = BK + 16;    // shared row stride in bytes
constexpr int THREADS = 256;

// One (rows x BK) tile of a row-major (rows_total, K) int8 matrix into
// shared memory, a byte at a time, zeros outside the matrix.
__device__ __forceinline__ void load_tile(int8_t* sm, const int8_t* g,
                                          int row0, int rows_total, int k0,
                                          int K) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (BM * BK / 16) / THREADS; ++i) {
    int c = tid + i * THREADS;
    int r = c / (BK / 16);
    int kc = (c % (BK / 16)) * 16;
    int gr = row0 + r;
    int gk = k0 + kc;
    int8_t* dst = sm + r * LDS + kc;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      bool valid = gr < rows_total && gk + b < K;
      dst[b] = valid ? g[static_cast<size_t>(gr) * K + gk + b] : int8_t(0);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gemm_fused_kernel_ragged(const int8_t* __restrict__ A,
                         const int8_t* __restrict__ Bt,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, float s_out,
                         void* __restrict__ out, int M, int N, int K,
                         int mode, int act) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 4;      // 2 warps along M, 64 rows each
  const int wn = warp % 4;      // 4 warps along N, 32 columns each
  const int g = lane / 4;
  const int t = lane % 4;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile(As, A, m0, M, k0, K);
    load_tile(Bs, Bt, n0, N, k0, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned b[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = Bs + (wn * 32 + ni * 8 + g) * LDS + kk + t * 4;
        b[ni][0] = *reinterpret_cast<const unsigned*>(p);
        b[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = As + (wm * 64 + mi * 16 + g) * LDS + kk + t * 4;
        unsigned a0 = *reinterpret_cast<const unsigned*>(p);
        unsigned a1 = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        unsigned a2 = *reinterpret_cast<const unsigned*>(p + 16);
        unsigned a3 = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], a0, a1, a2, a3, b[ni][0], b[ni][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm * 64 + mi * 16 + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + ni * 8 + t * 2 + (r & 1);
        if (row >= M || col >= N) continue;
        const size_t o = static_cast<size_t>(row) * N + col;
        const int a = acc[mi][ni][r];
        if (mode == 3) {
          static_cast<int*>(out)[o] = a;
        } else if (mode == 2) {
          static_cast<float*>(out)[o] = epilogue_f32(a, scale[col], bias[col],
                                                     act);
        } else {
          static_cast<int8_t*>(out)[o] =
              ragged_code(a, scale[col], bias[col], act, mode, s_out);
        }
      }
    }
  }
}

}  // namespace

// form 1: the wgmma form, with `splits` K-splits over `grid` persistent
// blocks; ws holds tiles * splits * 128 * 128 int32 and counters `tiles`
// zeroed int32 when splits > 1. form 0: the ragged form (splits, grid, ws,
// counters unused). Returns a cudaError_t, or minus the CUresult of a
// failed tensor-map encode.
extern "C" int gemm_fused_s8(const void* a, const void* bt, const void* scale,
                             const void* bias, float s_out, void* out, int M,
                             int N, int K, int mode, int act, int form,
                             int splits, int grid, void* ws, void* counters,
                             void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const int8_t*>(a);
  const auto* B = static_cast<const int8_t*>(bt);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  if (form == 0) {
    dim3 g((M + BM - 1) / BM, (N + BN - 1) / BN);
    gemm_fused_kernel_ragged<<<g, THREADS, 0, st>>>(A, B, sc, bi, s_out, out,
                                                    M, N, K, mode, act);
    return static_cast<int>(cudaGetLastError());
  }
  GemmArgs p;
  p.scale = sc;
  p.bias = bi;
  p.out = out;
  p.ws = static_cast<int*>(ws);
  p.counters = static_cast<int*>(counters);
  // conv order: wg::div_rn where s_out is a positive normal float whose
  // reciprocal and 128 s_out are normal too, else the double product
  p.q = rq::requant(s_out, &mode);
  p.M = M;
  p.N = N;
  p.K = K;
  p.act = act;
  p.mode = mode;
  p.n_tiles = (N + wg::BN - 1) / wg::BN;
  p.kt = (K + wg::BK - 1) / wg::BK;
  p.splits = splits;
  p.units = (M + wg::BM - 1) / wg::BM * p.n_tiles * splits;
  if (K % 16 != 0 || splits < 1 || splits > p.kt || grid < 1 ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_wgmma(A, B, p, grid, st);
}
