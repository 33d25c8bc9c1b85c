// Fused float GEMM for Hopper (sm_90a): C = act(A @ B * scale[col] +
// bias[col]), A (M, K) float32, B K-major (N, K) float32 or int8 codes,
// accumulated in float32, float32 out.
//
// Replaces: dnn_inference_engine_tpu/ops/pallas_gemm.py, gemm_fused with
// float operands (both pl.pallas_call sites: the weights-resident and the
// 3-D tiled schedules, at Precision.HIGHEST). An int8 B is the weight-only
// (w8) form: the JAX kernel casts the codes to A's dtype in VMEM; here each
// code becomes an exact float32 as it is staged into shared memory. Its
// callers are conv_lowering.conv2d_fp32_pallas (the fp32 gemm tier) and
// conv2d_w8_pallas (w8 with kernel="pallas").
//
// What bounds it on an H100: float32 FMA throughput, 67 TFLOP/s on the SXM
// data sheet at 700 W. HIGHEST precision rules out the tensor cores: a TF32
// product keeps 10 mantissa bits and would be another result. Every shape
// of the YOLO fp32 tiers (K 1024..9216) is bound by operations, not bytes.
// The design is the plain SIMT one that is right first: 128x128 output
// tiles per block of 256 threads, each thread an 8x8 register tile (two 4x4
// quadrants 64 apart, so its shared-memory reads are float4 broadcasts
// free of bank conflicts); K in steps of 16 through a two-stage shared
// memory ring; float32 A and B tiles arrive by 4-byte cp.async, transposed
// to k-major on the way (src-size 0 zero-fills the ragged M, N and K
// edges), an int8 B through registers one step ahead, converted on store.
// The epilogue is fused, in _epilogue's order: y = acc*scale + bias
// (rounded twice: __fmul_rn, __fadd_rn; nvcc would contract it into an
// FMA), then the activation. Tensor cores (3xTF32), a deeper ring and
// split-K for the small-M batch-1 shapes are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int PAD = 4;          // keeps float4 rows 16-byte aligned
constexpr int LD = BM + PAD;    // shared row stride (floats), BM == BN
constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = THREADS / BK;   // 16 tile rows per load pass
constexpr int PASSES = BM / ROWS_PER_PASS;    // 8

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 4 : 0;        // src-size 0 zero-fills the 4 bytes
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// One (128 rows x BK) tile of a row-major (rows_total, K) float32 matrix,
// transposed into sm[k][row]. Thread t copies column t % BK of rows
// t / BK + 16 i: a warp reads two 64-byte row segments.
__device__ __forceinline__ void load_f32_tile(float* sm, const float* g,
                                              int row0, int rows_total,
                                              int k0, int K) {
  const int kk = threadIdx.x % BK;
  const int r = threadIdx.x / BK;
  const int k = k0 + kk;
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int row = r + i * ROWS_PER_PASS;
    const bool valid = (row0 + row < rows_total) && (k < K);
    const float* src =
        valid ? g + static_cast<size_t>(row0 + row) * K + k : g;
    cp_async4(sm + kk * LD + row, src, valid);
  }
}

// The int8 B tile, same mapping, into registers (zero outside).
__device__ __forceinline__ void load_s8_regs(float* v, const int8_t* g,
                                             int row0, int rows_total,
                                             int k0, int K) {
  const int kk = threadIdx.x % BK;
  const int r = threadIdx.x / BK;
  const int k = k0 + kk;
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int row = r + i * ROWS_PER_PASS;
    const bool valid = (row0 + row < rows_total) && (k < K);
    v[i] = valid ? static_cast<float>(
                       __ldg(g + static_cast<size_t>(row0 + row) * K + k))
                 : 0.f;
  }
}

__device__ __forceinline__ void store_regs(float* sm, const float* v) {
  const int kk = threadIdx.x % BK;
  const int r = threadIdx.x / BK;
#pragma unroll
  for (int i = 0; i < PASSES; ++i) sm[kk * LD + r + i * ROWS_PER_PASS] = v[i];
}

template <typename TB>
__global__ void __launch_bounds__(THREADS, 2)
gemm_f32_kernel(const float* __restrict__ A, const TB* __restrict__ B,
                const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ out,
                int M, int N, int K, int act) {
  constexpr bool kS8 = sizeof(TB) == 1;
  __shared__ __align__(16) float As[2][BK * LD];
  __shared__ __align__(16) float Bs[2][BK * LD];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16;   // output columns tx*4 and 64 + tx*4
  const int ty = threadIdx.x / 16;   // output rows ty*4 and 64 + ty*4
  const int nk = (K + BK - 1) / BK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float breg[PASSES];
  load_f32_tile(As[0], A, m0, M, 0, K);
  if constexpr (kS8) {
    load_s8_regs(breg, reinterpret_cast<const int8_t*>(B), n0, N, 0, K);
    store_regs(Bs[0], breg);
  } else {
    load_f32_tile(Bs[0], reinterpret_cast<const float*>(B), n0, N, 0, K);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    // the next step's tiles land in the other stage while this one runs;
    // every thread left that stage at the barrier closing the last step
    if (more) {
      const int k0 = (kt + 1) * BK;
      load_f32_tile(As[cur ^ 1], A, m0, M, k0, K);
      if constexpr (kS8) {
        load_s8_regs(breg, reinterpret_cast<const int8_t*>(B), n0, N, k0, K);
      } else {
        load_f32_tile(Bs[cur ^ 1], reinterpret_cast<const float*>(B), n0, N,
                      k0, K);
      }
    }
    cp_async_commit();

    const float* as = As[cur];
    const float* bs = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * LD + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * LD + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * LD + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * LD + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }

    if constexpr (kS8) {
      if (more) store_regs(Bs[cur ^ 1], breg);
    }
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
    float* o = out + static_cast<size_t>(row) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col >= N) continue;
      float y = __fadd_rn(__fmul_rn(acc[i][j], scale[col]), bias[col]);
      if (act == 1) {
        y = y > 0.f ? y : __fmul_rn(0.1f, y);
      } else if (act == 2) {
        y = fmaxf(y, 0.f);
      }
      o[col] = y;
    }
  }
}

}  // namespace

// b_int8: 0 when bt holds float32, 1 when it holds int8 codes.
extern "C" int gemm_f32(const void* a, const void* bt, const void* scale,
                        const void* bias, void* out, int M, int N, int K,
                        int act, int b_int8, void* stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const float*>(a);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  if (b_int8) {
    gemm_f32_kernel<int8_t><<<grid, THREADS, 0, st>>>(
        A, static_cast<const int8_t*>(bt), sc, bi, o, M, N, K, act);
  } else {
    gemm_f32_kernel<float><<<grid, THREADS, 0, st>>>(
        A, static_cast<const float*>(bt), sc, bi, o, M, N, K, act);
  }
  return static_cast<int>(cudaGetLastError());
}
