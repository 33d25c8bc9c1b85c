// Shared by the int8 GEMM (gemm_fused.cu, its ragged form) and the
// implicit-im2col conv (conv3x3_rs.cu): 16-byte cp.async, the m16n8k32
// s8 mma.sync; and by them, the attic tail conv (conv3x3_bt.cu) and the
// copy-engine conv (conv_dma.cu): the exactly rounded epilogue.
//
// Every epilogue rounding is explicit (__fmul_rn, __fadd_rn, rintf): nvcc
// would otherwise contract a*b+c into an FMA, which rounds once where XLA's
// op-by-op stages and PyTorch round twice, and int8 codes would drift by
// 1 LSB.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace s8mma {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;       // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// D += A (16x32 s8, row) * B (32x8 s8, col), s32 accumulate
__device__ __forceinline__ void mma_s8(int* c, unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// y = acc*scale + bias, then the activation (0 linear, 1 leaky, 2 relu)
__device__ __forceinline__ float epilogue_f32(int acc, float sc, float bi,
                                              int act) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), sc), bi);
  if (act == 1) {
    y = y > 0.f ? y : __fmul_rn(0.1f, y);
  } else if (act == 2) {
    y = fmaxf(y, 0.f);
  }
  return y;
}

// clip(round half to even(y), +-127)
__device__ __forceinline__ int8_t to_code(float y) {
  float q = fminf(fmaxf(rintf(y), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

}  // namespace s8mma
