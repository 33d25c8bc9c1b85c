// Shared by the two fused-stem kernels (stem_fused_k2.cu, stem_fused_dg.cu):
// the band's input staging, the A-fragment addressing, the mma.sync
// wrappers and the group-max epilogue. Both kernels compute the same
// function (see stem_fused_k2.cu for the contract); they differ in how
// the folded weights reach shared memory and how K is cut into mmas.
//
// One block per (image, band of `rows` output rows), 8 warps. Each block
// stages input rows 4*y0-1 .. 4*y0+4*rows+2 (with the halo), columns
// -1 .. W+2, as int8 codes: element e = 3*col + c of a row sits at staged
// byte e + 3. Folded input lane l = p*12 + q*3 + c of tap (dh, dw) at
// output (y, x) is the code at row 4*(y+dh)+p-1, column 4*(x+dw)+q-1, so
// the 4 lanes of 4-lane group j (tap j/12, p = (j%12)/3, lanes q*3+c from
// 4*(j%3)) are 4 contiguous, 4-aligned bytes of one staged row.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace stem {

constexpr int BM = 64;          // output pixels per tile
constexpr int NF = 256;         // folded outputs (4 pool groups of 64)
constexpr int GO = 64;          // outputs after the group-max
constexpr int THREADS = 256;

// bytes of one staged input row: columns -1 .. W+2, 3 codes each
__host__ __device__ inline int staged_row_bytes(int W) {
  return (3 * (W + 4) + 15) / 16 * 16;
}

inline size_t staged_bytes(int W, int rows) {
  return size_t(4 * rows + 4) * staged_row_bytes(W);
}

// D += A (16x32 s8, row) * B (32x8 s8, col), s32 accumulate
__device__ __forceinline__ void mma_k32(int* c, unsigned a0, unsigned a1,
                                        unsigned a2, unsigned a3,
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// D += A (16x16 s8, row) * B (16x8 s8, col), s32 accumulate
__device__ __forceinline__ void mma_k16(int* c, unsigned a0, unsigned a1,
                                        unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ int8_t to_code(float y) {
  float q = fminf(fmaxf(rintf(y), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <typename T>
__device__ __forceinline__ unsigned ld32g(const T* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

__device__ __forceinline__ unsigned pack4(int8_t a, int8_t b, int8_t c,
                                          int8_t d) {
  return unsigned(uint8_t(a)) | unsigned(uint8_t(b)) << 8 |
         unsigned(uint8_t(c)) << 16 | unsigned(uint8_t(d)) << 24;
}

// Staged offset of 4-lane group j (0..47 over the 4 taps) relative to a
// pixel's base (see the header comment).
__device__ __forceinline__ int group_offset(int j, int rb) {
  const int tap = j / 12, p = (j % 12) / 3;
  return (4 * (tap >> 1) + p) * rb + 12 * (tap & 1) + 4 * (j % 3);
}

// Stage the band's input rows into Xs, quantizing each element once.
// exact_u8: uint8 input, codes u - 128 (the int8 view of u XOR 0x80;
// padding pixels become -128 and the caller's bias fold cancels them);
// else f32 input, codes clip(rint(x / s_in)). A lane reads 4 elements at
// once (one 32-bit u8 word or one float4; 3*W is a multiple of 4, so a
// word is all inside the row or all padding), and keeps U such reads in
// flight before it stores their codes.
__device__ __forceinline__ void stage_rows(const void* __restrict__ x,
                                           int8_t* Xs, int n, int y0,
                                           int rows, int H, int W,
                                           float s_in, int exact_u8) {
  const int tid = threadIdx.x;
  const int rb = staged_row_bytes(W);
  const int words = 3 * W / 4 + 4;             // from element -4
  const int total = (4 * rows + 4) * words;
  const int row_codes = 3 * (W + 4);
  const unsigned pad = exact_u8 ? 0x80808080u : 0u;   // u = 0 or x = 0
  constexpr int U = 8;
  for (int e0 = 0; e0 < total; e0 += THREADS * U) {
    unsigned codes[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS + tid;
      const int r = e / words, i = e % words - 1;
      const int row = 4 * y0 - 1 + r;
      codes[u] = pad;
      if (e < total && row >= 0 && row < H && i >= 0 && i < 3 * W / 4) {
        const size_t off = (size_t(n) * H + row) * W * 3 + 4 * size_t(i);
        if (exact_u8) {
          codes[u] = ld32g(static_cast<const uint8_t*>(x) + off) ^ pad;
        } else {
          const float4 v = *reinterpret_cast<const float4*>(
              static_cast<const float*>(x) + off);
          codes[u] = pack4(to_code(__fdiv_rn(v.x, s_in)),
                           to_code(__fdiv_rn(v.y, s_in)),
                           to_code(__fdiv_rn(v.z, s_in)),
                           to_code(__fdiv_rn(v.w, s_in)));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS + tid;
      if (e >= total) continue;
      const int r = e / words, b0 = 4 * (e % words) - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (b0 + j >= 0 && b0 + j < row_codes) {
          Xs[r * rb + b0 + j] = static_cast<int8_t>(codes[u] >> (8 * j));
        }
      }
    }
  }
}

// One warp's tile: rows ma (fragment rows g) and mb = ma + 8 (rows g+8)
// of the band's pixels, and where they start in the staged rows.
struct Pixels {
  int ma, mb;
  bool va, vb;
  const int8_t* pa;
  const int8_t* pb;
};

__device__ __forceinline__ Pixels tile_pixels(const int8_t* Xs, int m0,
                                              int wm, int g, int rows,
                                              int y0, int hout, int wout,
                                              int rb) {
  const int band_px = rows * wout;
  Pixels px;
  px.ma = m0 + wm * 16 + g;
  px.mb = px.ma + 8;
  px.va = px.ma < band_px && y0 + px.ma / wout < hout;
  px.vb = px.mb < band_px && y0 + px.mb / wout < hout;
  const int ma = px.va ? px.ma : 0, mb = px.vb ? px.mb : 0;
  px.pa = Xs + 4 * (ma / wout) * rb + 12 * (ma % wout);
  px.pb = Xs + 4 * (mb / wout) * rb + 12 * (mb % wout);
  return px;
}

// Group-max over the 4 pool groups on the int32 accumulator, then
// y = acc*scale + bias, the activation and clip(rint(y)), with explicit
// roundings so the codes match XLA's. acc[pool group][n8 tile][fragment];
// the warp owns channels wn*32 .. wn*32+31.
__device__ __forceinline__ void store_tile(
    const int (&acc)[4][4][4], const Pixels& px, int wn, int t,
    const float* __restrict__ scale, const float* __restrict__ bias,
    int act, int8_t* __restrict__ out, int n, int y0, int hout, int wout) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool v = r >= 2 ? px.vb : px.va;
      if (!v) continue;
      const int m = r >= 2 ? px.mb : px.ma;
      const int ch = wn * 32 + ni * 8 + t * 2 + (r & 1);
      const int a = max(max(acc[0][ni][r], acc[1][ni][r]),
                        max(acc[2][ni][r], acc[3][ni][r]));
      float y = __fadd_rn(__fmul_rn(__int2float_rn(a), scale[ch]), bias[ch]);
      if (act == 1) {
        y = y > 0.f ? y : __fmul_rn(0.1f, y);
      } else if (act == 2) {
        y = fmaxf(y, 0.f);
      }
      const size_t pix = (size_t(n) * hout + y0 + m / wout) * wout + m % wout;
      out[pix * GO + ch] = to_code(y);
    }
  }
}

// Opt the kernel into `smem` bytes of dynamic shared memory; an error
// code if the card has less.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, int rows) {
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return e;
  if (rows < 1 || smem > size_t(smem_max)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(smem));
}

}  // namespace stem
