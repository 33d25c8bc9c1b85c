// 3x3 SAME int8 conv with the pool-major group-max for Hopper (sm_90a),
// whose implicit-im2col matrix the copy engine (TMA) assembles.
//
// Replaces: tools/proto_conv_dma.py, conv_dma (kernel body _kernel), the
// JAX repo's experiment on whether the DMA engines rather than the vector
// unit can build the A matrix of conv3x3_rs. Same contract:
//   acc[m, o] = sum over taps (dh, dw) and ci of
//               x[n, oy+dh-1, ox+dw-1, ci] * w[dh, dw, ci, o]  (int32)
//   m[c] = max(acc[c], acc[go+c], acc[2go+c], acc[3go+c])      (int32)
//   y = leaky(m*scale[c] + bias[c]); out = clip(rint(y), +-127) int8
// which is conv3x3_rs with pool ('gmaxm', 2, go) and scale, bias tiled 4x.
// Every rounding is explicit (mma_s8.cuh).
//
// What bounds it on an H100 (SXM data sheet at 700 W: 1,979 int8 TOP/s,
// 3.35 TB/s): the int8 tensor-core rate. At (32,104,104,64) -> 128 it does
// 51.0 G operations on 33.3 MB, 1.5 K operations per byte against the
// card's ~590.
//
// Design. A block takes one image and a band of ht output rows (the TPU
// kernel's sequential grid axis becomes this loop), in steps of `rows`
// output rows. For a step, thread 0 arms one mbarrier with the nine tap
// boxes' bytes and issues nine cp.async.bulk.tensor copies of a 4-D map
// over x {Cin, W, H, N}: tap (dh, dw) is the box {lda, W, rows, 1} at
// (0, dw-1, y+dh-1, n). Each lands as one dense K-block of the step's A
// matrix -- the prototype's A_cat -- with no thread writing it. The SAME
// halo is the copy engine's zero fill of out-of-bounds coordinates (the
// TPU kernel's padded copy of x has no counterpart), and so is the row
// pad: the box is lda = Cin + 16 bytes wide where Cin % 32 == 0, so the
// 16 bytes past Cin land as zeros and the row stride in shared memory
// makes the m16n8k32 fragment loads free of bank conflicts (TMA cannot
// pad a row otherwise; no swizzle, so any Cin % 16 == 0 up to 256 takes
// the same path). Two stages of taps: the next step's copies are in
// flight while this step multiplies. At W 104, Cin 64 that is 1 row a
// step, 2 x 74,880 bytes of taps plus 75,776 of B: 225,552 bytes, one
// block per SM; the larger choice, 2 rows single-buffered, would leave the
// copies exposed. The wrapper picks rows (up to 128 pixels a step) and
// the layout, and checks the budget.
//
// B, the block's 128 accumulator columns of the (Cout, 9*Cin) K-major
// weight matrix (rs_weight_matrix), is resident: copied once per block
// with cp.async, tap blocks spaced kt = Cin rounded up to 32 bytes with
// zeros between, rows padded to ldb = 9*kt + 16 bytes. Nothing carries
// over between blocks (the TPU kernel's scratch zeroed at grid cell
// (0, 0) has no counterpart). The MMA is mma.sync m16n8k32 over 128-pixel
// chunks, 8 warps of 64 pixels x 32 columns, the columns grouped as in
// conv3x3_rs.cu: warp wn's n8 tile ni holds pool group ni, channels
// wn*8..wn*8+7, so the group-max is a max over a thread's own registers.
// A pixel row past the step reads the last real row (its result is not
// stored). wgmma and a deeper, warp-specialised pipeline are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_s8.cuh"
#include "tma.cuh"

namespace {

using s8mma::cp_async16;
using s8mma::cp_async_commit;
using s8mma::cp_async_wait;
using s8mma::epilogue_f32;
using s8mma::mma_s8;
using s8mma::to_code;

constexpr int BN = 128;         // accumulator columns per block
constexpr int GN = BN / 4;      // channels of each pool group per block
constexpr int BM = 128;         // pixels per MMA chunk
constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 232448;

struct Conv {
  const int8_t* wt;             // (4*go, 9*Cin), K in (dh, dw, ci)
  const float* scale;           // (go,)
  const float* bias;
  int8_t* out;                  // (N, H, W, go)
  int N, H, W, Cin, go, ht, bands;
  int rows;                     // output rows a step
  int lda;                      // bytes of a tap row in shared memory
  int kt;                       // bytes between tap blocks of a B row
  int ldb;                      // bytes of a B row
  int slot;                     // bytes between tap boxes (128-aligned)
};

// One thread: arms `bar` with a step's bytes and copies the step's nine
// tap boxes, tap (dh, dw) at (0, dw-1, y+dh-1, n), into `dst`.
__device__ __forceinline__ void issue_taps(const CUtensorMap* xmap,
                                           int8_t* dst, int slot,
                                           uint64_t* bar, uint32_t bytes,
                                           int n, int y) {
  tma::mbar_expect_tx(bar, bytes);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int c[4] = {0, tap % 3 - 1, y + tap / 3 - 1, n};
    tma::load(dst + tap * slot, xmap, bar, c, 4);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    conv_dma_kernel(const __grid_constant__ CUtensorMap xmap, const Conv p) {
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* taps = smem;                            // [2 stages][9][slot]
  int8_t* bs = smem + 18 * p.slot;                // [BN][ldb]
  uint64_t* bar = reinterpret_cast<uint64_t*>(bs + BN * p.ldb);  // [2]

  const int n = blockIdx.x / p.bands;
  const int y0 = (blockIdx.x % p.bands) * p.ht;
  const int y1 = min(y0 + p.ht, p.H);
  const int steps = (y1 - y0 + p.rows - 1) / p.rows;
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;      // 2 warps along the pixels, 64 each
  const int wn = warp % 4;      // 4 warps along the columns
  const int g = lane / 4;
  const int t = lane % 4;
  const int mstep = p.rows * p.W;
  // every box byte counts, its zero-filled ones too
  const uint32_t step_bytes = 9u * p.rows * p.W * p.lda;

  if (tid == 0) {
    tma::mbar_init(&bar[0], 1);
    tma::mbar_init(&bar[1], 1);
    tma::fence_barrier_init();
  }
  // B: column r is pool group r / GN, channel j*GN + r % GN
  const int tap_chunks = p.kt / 16;
  for (int i = tid; i < BN * 9 * tap_chunks; i += THREADS) {
    const int r = i / (9 * tap_chunks);
    const int q = i % (9 * tap_chunks);
    const int tap = q / tap_chunks;
    const int c16 = (q % tap_chunks) * 16;
    const int c = j * GN + r % GN;
    const bool v = c < p.go && c16 < p.Cin;
    const int8_t* src =
        v ? p.wt + (static_cast<size_t>((r / GN) * p.go + c) * 9 + tap) *
                       p.Cin + c16
          : p.wt;
    cp_async16(bs + r * p.ldb + tap * p.kt + c16, src, v);
  }
  cp_async_commit();
  __syncthreads();              // the barriers are initialised

  if (tid == 0) issue_taps(&xmap, taps, p.slot, bar, step_bytes, n, y0);
  cp_async_wait<0>();
  __syncthreads();              // B is resident

  for (int s = 0; s < steps; ++s) {
    const int stage = s & 1;
    if (tid == 0 && s + 1 < steps) {
      // the other stage was read in step s - 1, before the last barrier
      tma::fence_proxy_async();
      issue_taps(&xmap, taps + (stage ^ 1) * 9 * p.slot, p.slot,
                 &bar[stage ^ 1], step_bytes, n, y0 + (s + 1) * p.rows);
    }
    tma::mbar_wait(&bar[stage], (s >> 1) & 1, "conv_dma");
    const int8_t* a_taps = taps + stage * 9 * p.slot;
    const int y = y0 + s * p.rows;

    for (int mc = 0; mc < mstep; mc += BM) {
      int a_off[4][2];
      bool live[4];             // warp-uniform: the m16 tile has a pixel
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = mc + wm * 64 + mi * 16;
        live[mi] = m < mstep;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a_off[mi][h] = min(m + g + 8 * h, mstep - 1) * p.lda + t * 4;
      }
      int acc[4][4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

      for (int tap = 0; tap < 9; ++tap) {
        const int8_t* at = a_taps + tap * p.slot;
        const int8_t* bt = bs + tap * p.kt + (wn * 8 + g) * p.ldb + t * 4;
        // k past Cin (Cin % 32 == 16) meets zeros in B
        for (int kk = 0; kk < p.Cin; kk += 32) {
          unsigned b[4][2];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int8_t* q = bt + ni * GN * p.ldb + kk;
            b[ni][0] = *reinterpret_cast<const unsigned*>(q);
            b[ni][1] = *reinterpret_cast<const unsigned*>(q + 16);
          }
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            if (!live[mi]) continue;
            const int8_t* q0 = at + a_off[mi][0] + kk;
            const int8_t* q1 = at + a_off[mi][1] + kk;
            const unsigned a0 = *reinterpret_cast<const unsigned*>(q0);
            const unsigned a1 = *reinterpret_cast<const unsigned*>(q1);
            const unsigned a2 = *reinterpret_cast<const unsigned*>(q0 + 16);
            const unsigned a3 = *reinterpret_cast<const unsigned*>(q1 + 16);
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
              mma_s8(acc[mi][ni], a0, a1, a2, a3, b[ni][0], b[ni][1]);
          }
        }
      }

      // Fragment r of n8 tile ni: pixel row g + 8*(r/2), channel
      // j*GN + wn*8 + 2t + r%2 of pool group ni.
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mc + wm * 64 + mi * 16 + g + 8 * h;
          if (m >= mstep) continue;
          const int oy = y + m / p.W;
          const int ox = m % p.W;
          if (oy >= y1) continue;
          int8_t* o = p.out +
                      ((static_cast<size_t>(n) * p.H + oy) * p.W + ox) * p.go;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 2 * h + e;
            const int c = j * GN + wn * 8 + 2 * t + e;
            if (c >= p.go) continue;
            const int a = max(max(acc[mi][0][r], acc[mi][1][r]),
                              max(acc[mi][2][r], acc[mi][3][r]));
            o[c] = to_code(epilogue_f32(a, p.scale[c], p.bias[c], 1));
          }
        }
      }
    }
    __syncthreads();            // this stage is read; step s + 2 refills it
  }
}

}  // namespace

// x (N, H, W, Cin) int8, 16-byte aligned, Cin % 16 == 0; wt (4*go, 9*Cin);
// the layout (rows, lda, kt, ldb, slot, smem bytes) as the wrapper
// computes it. *cu_result gets the encode's CUresult; a refused encode
// launches nothing.
extern "C" int conv_dma(const void* x, const void* wt, const void* scale,
                        const void* bias, void* out, int N, int H, int W,
                        int Cin, int go, int ht, int rows, int lda, int kt,
                        int ldb, int slot, int smem, int* cu_result,
                        void* stream) {
  const uint64_t dims[4] = {static_cast<uint64_t>(Cin),
                            static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(N)};
  const uint64_t strides[3] = {static_cast<uint64_t>(Cin),
                               static_cast<uint64_t>(W) * Cin,
                               static_cast<uint64_t>(H) * W * Cin};
  const uint32_t box[4] = {static_cast<uint32_t>(lda),
                           static_cast<uint32_t>(W),
                           static_cast<uint32_t>(rows), 1};
  CUtensorMap xmap;
  const CUresult res = tma::encode_s8(&xmap, x, 4, dims, strides, box);
  *cu_result = static_cast<int>(res);
  if (res != CUDA_SUCCESS) return 0;
  if (smem > SMEM_LIMIT || slot % 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Conv p;
  p.wt = static_cast<const int8_t*>(wt);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<int8_t*>(out);
  p.N = N;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.go = go;
  p.ht = ht;
  p.bands = (H + ht - 1) / ht;
  p.rows = rows;
  p.lda = lda;
  p.kt = kt;
  p.ldb = ldb;
  p.slot = slot;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.N * p.bands, (p.go + GN - 1) / GN);
  conv_dma_kernel<<<grid, THREADS, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(xmap, p);
  return static_cast<int>(cudaGetLastError());
}
