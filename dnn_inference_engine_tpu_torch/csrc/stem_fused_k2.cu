// Fused stem for Hopper (sm_90a): quantize + shifted space-to-depth(4) +
// 2x2 folded int8 conv + int32 pool-major group-max + epilogue, one pass.
//
// Replaces: dnn_inference_engine_tpu/ops/pallas_conv.py, stem_fused_k2
// (kernel body _stem_k2_kernel). Same contract:
//   x (N,H,W,3) uint8 or f32, zero-padded 1 top/left and 7 bottom/right;
//   codes: exact u8  v = u - 128 (the int8 view of u XOR 0x80; padding
//          pixels become -128 and the caller's bias fold cancels them),
//          f32       clip(rint(x / s_in));
//   folded input lane l = p*12 + q*3 + c of tap (dh, dw) at output (y, x)
//   is the code at row 4*(y+dh)+p-1, column 4*(x+dw)+q-1; lanes 48.. are
//   zero, so the product skips them (K = 4 taps x 48 = 192);
//   acc (int32) over the 256 pool-major folded outputs, max over the 4
//   groups of 64, then y = acc*scale + bias, activation, clip(rint(y)).
//   Output (N, H/4, W/4, 64) int8.
//
// What bounds it on an H100: 2*M*192*256 operations (M = N*H*W/16 output
// pixels) against 16.6 MB in and 22 MB out at batch 32 and 416 px; at the
// data-sheet rates of the SXM part at 700 W (1,979 int8 TOP/s, 3.35 TB/s)
// the operations bind, narrowly. The design keeps the TPU kernel's point:
// the folded input and the pre-max accumulator never reach device memory.
//
// One block per (image, band of `rows` output rows). It stages the band's
// 4*rows+4 input rows (with the halo) in shared memory, quantizing each
// input element once, and transposes the 48 KB of folded weights K-major
// into shared memory once; the staging reads 4 input elements per load,
// 8 loads in flight per thread. The shifted s2d(4) is then only an
// addressing rule: the 4 lanes (p, q..q+3 of a 12-lane p row) that an mma
// fragment register holds are 4 contiguous, 4-aligned bytes of one staged
// row, so the A fragments are 32-bit shared loads straight from the staged rows.
// mma.sync m16n8k32 from 8 warps: a warp owns 16 pixels x 32 output
// channels in all 4 pool groups, so the group-max is a register max. The
// host picks `rows` (4, 2 or 1) so that small batches still fill the SMs.
// Roundings are explicit (__fdiv_rn, __fmul_rn, __fadd_rn, rintf) so the
// codes match XLA's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;          // output pixels per tile
constexpr int KC = 192;         // 4 taps x 48 real lanes
constexpr int NF = 256;         // folded outputs (4 pool groups of 64)
constexpr int GO = 64;          // outputs after the group-max
constexpr int LDS = KC + 16;    // weight row stride in bytes
constexpr int THREADS = 256;

// bytes of one staged input row: columns -1 .. W+2, 3 codes each
__host__ __device__ inline int staged_row_bytes(int W) {
  return (3 * (W + 4) + 15) / 16 * 16;
}

size_t smem_bytes(int W, int rows) {
  return size_t(NF) * LDS + size_t(4 * rows + 4) * staged_row_bytes(W);
}

__device__ __forceinline__ void mma_s8(int* c, unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

// exact_u8: uint8 input, codes u - 128; else f32 input quantized by s_in
__global__ void __launch_bounds__(THREADS)
stem_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias,
            float s_in, int8_t* __restrict__ out, int H, int W, int cin,
            int rows, int exact_u8, int act) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* Bs = smem;                 // [NF][LDS], K-major weights
  int8_t* Xs = smem + NF * LDS;      // [4*rows+4][rb], staged input codes

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int hout = H / 4, wout = W / 4;
  const int bands = (hout + rows - 1) / rows;
  const int n = blockIdx.x / bands;
  const int y0 = (blockIdx.x % bands) * rows;
  const int rb = staged_row_bytes(W);

  // Folded weights (2,2,cin,256) -> Bs[o][tap*48 + l], lanes l < 48: a
  // lane loads a 4 (k) x 4 (o) byte block with 32-bit loads (each row of
  // 8 lanes reads 32 contiguous bytes) and transposes it in registers.
  constexpr int W_ITEMS = (KC / 16) * (NF / 32) / (THREADS / 32);
#pragma unroll 4
  for (int it = 0; it < W_ITEMS; ++it) {
    const int item = it * (THREADS / 32) + warp;
    const int kq = (item % (KC / 16)) * 4 + lane / 8;   // k = 4*kq .. +3
    const int o4 = ((item / (KC / 16)) * 8 + lane % 8) * 4;
    const int tap = (4 * kq) / 48, l = (4 * kq) % 48;
    const int8_t* src = w + (size_t(tap) * cin + l) * NF + o4;
    const unsigned r0 = ld32g(src), r1 = ld32g(src + NF);
    const unsigned r2 = ld32g(src + 2 * NF), r3 = ld32g(src + 3 * NF);
    const unsigned lo01 = __byte_perm(r0, r1, 0x5140);
    const unsigned hi01 = __byte_perm(r0, r1, 0x7362);
    const unsigned lo23 = __byte_perm(r2, r3, 0x5140);
    const unsigned hi23 = __byte_perm(r2, r3, 0x7362);
    unsigned* dst = reinterpret_cast<unsigned*>(Bs + o4 * LDS + 4 * kq);
    dst[0] = __byte_perm(lo01, lo23, 0x5410);
    dst[LDS / 4] = __byte_perm(lo01, lo23, 0x7632);
    dst[2 * LDS / 4] = __byte_perm(hi01, hi23, 0x5410);
    dst[3 * LDS / 4] = __byte_perm(hi01, hi23, 0x7632);
  }

  // Input rows 4*y0-1 .. 4*y0+4*rows+2, columns -1 .. W+2, quantized once;
  // element e of a row (e = 3*col + c) goes to staged byte e + 3. A lane
  // reads 4 elements at once (one 32-bit u8 word or one float4; 3*W is a
  // multiple of 4, so a word is all inside the row or all padding), and
  // keeps U such reads in flight before it stores their codes.
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
  __syncthreads();

  const int wm = warp / 2;      // 4 warps along pixels, 16 each
  const int wn = warp % 2;      // 2 warps along outputs, 32 each
  const int g = lane / 4, t = lane % 4;

  // Staged offset of the 4-lane group j = k/4 relative to a pixel's base:
  // tap (dh, dw) = j / 12, p = (j % 12) / 3, lanes q*3+c from 4*(j % 3).
  int koff[KC / 16];
#pragma unroll
  for (int i = 0; i < KC / 16; ++i) {
    const int j = (i / 2) * 8 + (i % 2) * 4 + t;
    const int tap = j / 12, p = (j % 12) / 3;
    koff[i] = (4 * (tap >> 1) + p) * rb + 12 * (tap & 1) + 4 * (j % 3);
  }

  const int band_px = rows * wout;
  for (int m0 = 0; m0 < band_px; m0 += BM) {
    int ma = m0 + wm * 16 + g, mb = ma + 8;
    const bool va = ma < band_px && y0 + ma / wout < hout;
    const bool vb = mb < band_px && y0 + mb / wout < hout;
    if (!va) ma = 0;
    if (!vb) mb = 0;
    const int8_t* pa = Xs + 4 * (ma / wout) * rb + 12 * (ma % wout);
    const int8_t* pb = Xs + 4 * (mb / wout) * rb + 12 * (mb % wout);

    int acc[4][4][4];           // [pool group][n8 tile][fragment]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
    for (int kc = 0; kc < KC / 32; ++kc) {
      const unsigned a0 = ld32(pa + koff[2 * kc]);
      const unsigned a1 = ld32(pb + koff[2 * kc]);
      const unsigned a2 = ld32(pa + koff[2 * kc + 1]);
      const unsigned a3 = ld32(pb + koff[2 * kc + 1]);
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int8_t* pw =
              Bs + (gi * GO + wn * 32 + ni * 8 + g) * LDS + kc * 32 + t * 4;
          mma_s8(acc[gi][ni], a0, a1, a2, a3, ld32(pw), ld32(pw + 16));
        }
      }
    }

#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool v = r >= 2 ? vb : va;
        if (!v) continue;
        const int m = r >= 2 ? mb : ma;
        const int ch = wn * 32 + ni * 8 + t * 2 + (r & 1);
        const int a = max(max(acc[0][ni][r], acc[1][ni][r]),
                          max(acc[2][ni][r], acc[3][ni][r]));
        float y = __fadd_rn(__fmul_rn(__int2float_rn(a), scale[ch]),
                            bias[ch]);
        if (act == 1) {
          y = y > 0.f ? y : __fmul_rn(0.1f, y);
        } else if (act == 2) {
          y = fmaxf(y, 0.f);
        }
        const size_t pix = (size_t(n) * hout + y0 + m / wout) * wout +
                           m % wout;
        out[pix * GO + ch] = to_code(y);
      }
    }
  }
}

}  // namespace

// rows: output rows per block (a band); the caller picks it.
extern "C" int stem_fused_k2(const void* x, const void* w, const void* scale,
                             const void* bias, float s_in, void* out, int N,
                             int H, int W, int cin, int rows, int exact_u8,
                             int act, void* stream) {
  const size_t smem = smem_bytes(W, rows);
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (rows < 1 || smem > size_t(smem_max)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  e = cudaFuncSetAttribute(stem_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int hout = H / 4;
  const int blocks = N * ((hout + rows - 1) / rows);
  if (blocks > 0 && W >= 4) {
    stem_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        x, static_cast<const int8_t*>(w), static_cast<const float*>(scale),
        static_cast<const float*>(bias), s_in, static_cast<int8_t*>(out), H,
        W, cin, rows, exact_u8, act);
  }
  return static_cast<int>(cudaGetLastError());
}
