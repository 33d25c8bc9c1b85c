// XLA's int8 conv at a small Cin for Hopper (sm_90a): the "rows" route
// of ops/conv.py conv2d_w8a8 (conv_w8a8_form), for Cin % 16 != 0 with kw
// Cin <= 32, a square odd k up to 7, SAME pads, stride 1 or 2, Cout 16
// or 64: ResNet-18's 7x7/s2 stem (Cin 3 -> 64, 224 px) and the YOLO
// models' 3x3 entry conv (Cin 3 -> 16, 416 px) of the generic forward.
//
// Replaces: dnn_inference_engine_tpu/ops/conv.py:110 conv2d_w8a8 (XLA's
// int8 conv, not a Pallas kernel) in these forms, where the port copied an
// im2col and ran gemm_fused's ragged mma.sync form. It computes
//   acc (int32) = the k x k conv of the int8 codes at `stride` with XLA's
//     SAME pads (pt, pl from ops/conv_lowering.py _same_pads: (2, 3) at
//     224 px for k7/s2, so column o reads 2o-2 .. 2o+4);
//   y = act(acc*scale + bias), then with an s_out the conv order's codes
//     clip(rint(y / s_out)) (requant.cuh MODE 0, or 4 for an s_out that
//     is not a positive normal float), else the f32 y.
//
// What bounds it on an H100 (SXM data sheet at 700 W: 3.35 TB/s, 1,979
// int8 TOP/s): the bytes. The stem at b32 reads 4.82 MB and writes 25.69
// MB of codes, 0.0091 ms; its product over the padded K = 192 is 9.9 G
// operations, 0.0050 ms. So each input byte comes from device memory once
// a unit (the halo rows again from L2) and each output byte is written
// once; neither the patches nor the int32 accumulator reach device
// memory.
//
// Design (the YOLO stems' register-A wgmma, csrc/stem_common.cuh, on a
// raw int8 band):
// - K: each kernel row of a patch is kw Cin contiguous bytes of one input
//   row (21 for 7x3, 9 for 3x3), laid as one run of `run` bytes of K (24,
//   12: a multiple of 4), the run's last bytes meeting zero rows of B; K =
//   kh runs in ksteps k32 steps (7 x 24 = 168 -> 6 steps, 3 x 12 = 36 ->
//   2). B (the weights, Cout rows of K, wgmma's 128-byte swizzle; at most
//   16 KB) is laid out once per weight tensor by the host
//   (ops/conv.py rows_tile_matrix) and copied into shared memory once a
//   block.
// - A: a unit is `upx` consecutive output pixels of one image (a multiple
//   of 64; rows_plan); the block stages the input rows they read (stride
//   (rows spanned - 1) + k, halo included) into a band buffer, each row
//   `rb` bytes: padb zero bytes, the row's W Cin bytes, zeros after. A
//   staged row lands 16-byte aligned, so where W Cin is a multiple of 16
//   (672 and 1248 bytes at 224 and 416 px) and x is 16-byte aligned the
//   rows come by 16-byte cp.async (rows outside the image zero-filled) and
//   the pads are zeroed once; else the block stages the band word by word
//   from device memory. Two band buffers: the next unit's rows load while
//   this one's tiles run.
// - Each 32-bit group of K that a register of wgmma's A fragment holds is
//   4 bytes of one staged row, at a byte offset stride ox Cin + padb - pl
//   Cin + kernel row offset: any phase mod 4 (at stride 2 and Cin 3, 6o -
//   6 is 2 mod 4 for even o). It is read as two aligned words and a
//   funnel shift, so A goes from the staged rows straight into registers,
//   with no layout pass.
// - Two warpgroups a block take the unit's 64-pixel tiles in turn and run
//   wgmma m64nNk32 s8 (N = Cout) over the ksteps, B from shared memory, A
//   from registers. The epilogue (out_value) rounds every step as
//   s8mma::epilogue_f32 and requant.cuh do, explicitly (nvcc would
//   contract a*b+c into an FMA), and converts the accumulator without a
//   conversion instruction. A warp writes its 16 pixels' outputs into its
//   own staging rows in shared memory, then stores them, which are
//   contiguous in the output, as 16-byte stores.
// - A persistent grid of two blocks an SM walks the units (block b takes
//   b, b + grid, ...).

#include <cstdint>
#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int THREADS = 256;          // two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int MAX_KSTEPS = 7;         // 7 runs of at most 32 bytes

struct Args {
  const int8_t* x;
  const int8_t* tile;                 // B: atoms x Cout rows x 128 bytes
  const float* scale;
  const float* bias;
  void* out;
  rq::Requant q;
  int H, W, cin, k, stride, pt, pl, ho, wo;
  int run, ksteps, padb, rb, upx, nr, units_img, units, atoms;
  int act;                            // 0 linear, 1 leaky, 2 relu
  int fast;                           // rows staged by 16-byte cp.async
  unsigned wo_magic;                  // floor(2^32 / wo) + 1, or 0
};

template <int N>
struct MmaRS;

// d (N/2 int32) += A (64 x 32 s8, registers a[4]) * B (32 x N s8,
// descriptor b); scale_d 0 overwrites d. The A fragment as wg::mma_rs.
template <>
struct MmaRS<16> {
  __device__ __forceinline__ static void run(int* d, const unsigned (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaRS<64> {
  __device__ __forceinline__ static void run(int* d, const unsigned (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <int R>
__device__ __forceinline__ void fence_acc(int (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

// 4 bytes of a staged row from `p` (a word-aligned address) on: the
// funnel shift of two aligned words by `sh` = 8 x (the phase mod 4).
__device__ __forceinline__ unsigned word_at(const int8_t* p, int sh) {
  const unsigned lo = *reinterpret_cast<const unsigned*>(p);
  const unsigned hi = *reinterpret_cast<const unsigned*>(p + 4);
  return __funnelshift_r(lo, hi, sh);
}

// Byte of the band where output pixel `pix` (of its image) of a unit
// staged from output row y0 starts its first kernel row. The row is
// pix / wo by a multiply-high where pix wo < 2^32 (wo_magic set: exact,
// as pix (wo_magic wo - 2^32) < 2^32), else by a division.
__device__ __forceinline__ int pixel_base(const Args& p, int pix, int y0) {
  const int oy = p.wo_magic ? static_cast<int>(__umulhi(pix, p.wo_magic))
                            : pix / p.wo;
  const int ox = pix - oy * p.wo;
  return p.stride * (oy - y0) * p.rb + p.stride * ox * p.cin + p.padb -
         p.pl * p.cin;
}

// The float of an accumulator, exactly for |acc| < 2^22 (here K <= 224,
// so |acc| <= 224 * 127^2 < 2^22): the bits of 1.5 * 2^23 + acc less 1.5
// * 2^23, an integer and a float add where __int2float_rn issues at 16
// a clock an SM, an eighth of the float rate.
__device__ __forceinline__ float acc_float(int acc) {
  return __fadd_rn(__int_as_float(0x4B400000 + acc), -12582912.0f);
}

// One output of an accumulator: y = act(acc*sc + bi), each step rounded
// as s8mma::epilogue_f32 rounds it; OUT 1 the f32 y, OUT 0 and 4 the value
// whose wg::code_bits is its code, as rq::code<OUT> gives it. The
// activation comes as (slope, relu): y <= 0 becomes slope y (leaky 0.1,
// linear 1: y itself) or, with relu, 0, by selects, so the epilogue's
// loop has no branch; as a template argument it tripled the kernel's
// instantiations and its build.
template <int OUT>
__device__ __forceinline__ float out_value(int acc, float sc, float bi,
                                           float slope, bool relu,
                                           const rq::Requant& q) {
  float y = __fadd_rn(__fmul_rn(acc_float(acc), sc), bi);
  if (!(y > 0.f)) y = relu ? 0.f : __fmul_rn(slope, y);
  if constexpr (OUT == 0) {
    y = wg::div_rn(fminf(fmaxf(y, -q.lim), q.lim), q.s_out, q.rs_out);
  } else if constexpr (OUT == 4) {
    y = __double2float_rn(__dmul_rn(static_cast<double>(y), q.rd_out));
  }
  return y;
}

// The whole block: unit u's staged rows into `band` (ops/conv.py RowsPlan):
// by 16-byte cp.async into the zeroed row buffers, or a word at a time
// from device memory with the zeros written.
__device__ __forceinline__ void stage(const Args& p, int8_t* band, int u) {
  const int n = u / p.units_img;
  const int px0 = (u - n * p.units_img) * p.upx;
  const int npx = min(p.upx, p.ho * p.wo - px0);
  const int y0 = px0 / p.wo, y1 = (px0 + npx - 1) / p.wo;
  const int nr = p.stride * (y1 - y0) + p.k;
  const int row0 = p.stride * y0 - p.pt;
  const int rowb = p.W * p.cin;
  const int8_t* img = p.x + static_cast<size_t>(n) * p.H * rowb;
  if (p.fast) {
    const int ch = rowb / 16;
    for (int i = threadIdx.x; i < nr * ch; i += THREADS) {
      const int r = i / ch, c = i - r * ch, row = row0 + r;
      const bool in = row >= 0 && row < p.H;
      s8mma::cp_async16(band + r * p.rb + p.padb + 16 * c,
                        in ? img + static_cast<size_t>(row) * rowb + 16 * c
                           : p.x,
                        in);
    }
  } else {
    const int words = p.rb / 4;
    uint32_t* dst = reinterpret_cast<uint32_t*>(band);
    for (int i = threadIdx.x; i < nr * words; i += THREADS) {
      const int r = i / words, row = row0 + r;
      const int e0 = 4 * (i - r * words) - p.padb;
      uint32_t v = 0;
      if (row >= 0 && row < p.H) {
        const int8_t* src = img + static_cast<size_t>(row) * rowb;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int e = e0 + b;
          if (e >= 0 && e < rowb) {
            v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + e)))
                 << (8 * b);
          }
        }
      }
      dst[i] = v;
    }
  }
}

// N: Cout; OUT: 0 or 4 the int8 codes (requant.cuh MODE), 1 f32.
template <int N, int OUT>
__global__ void __launch_bounds__(THREADS, 2) conv_rows_kernel(const Args p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr int ES = OUT == 1 ? 4 : 1;          // bytes of an output
  constexpr int SROW = N * ES + 16;             // a staging row, padded
  constexpr int C16 = N * ES / 16;              // 16-byte stores a pixel
  const uint32_t a0 = tma::smem_addr(smem);
  uint8_t* base = smem + ((1024 - (a0 & 1023)) & 1023);
  int8_t* Bs = reinterpret_cast<int8_t*>(base);
  const int tile_bytes = p.atoms * N * 128;
  float* sc_s = reinterpret_cast<float*>(base + tile_bytes);
  float* bi_s = sc_s + N;
  int8_t* band0 = reinterpret_cast<int8_t*>(bi_s + N);
  const int band_bytes = p.nr * p.rb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint8_t* stg = reinterpret_cast<uint8_t*>(band0 + 2 * band_bytes) +
                 warp * 16 * SROW;

  // B, scale and bias, and the band buffers zeroed (their pads stay zero
  // under the cp.async rows); B is written by the generic proxy and read
  // by wgmma's async proxy
  {
    const int4* src = reinterpret_cast<const int4*>(p.tile);
    int4* dst = reinterpret_cast<int4*>(Bs);
    for (int i = threadIdx.x; i < tile_bytes / 16; i += THREADS) {
      dst[i] = __ldg(src + i);
    }
    int4* bz = reinterpret_cast<int4*>(band0);
    for (int i = threadIdx.x; i < 2 * band_bytes / 16; i += THREADS) {
      bz[i] = make_int4(0, 0, 0, 0);
    }
    if (threadIdx.x < N) {
      sc_s[threadIdx.x] = p.scale[threadIdx.x];
      bi_s[threadIdx.x] = p.bias[threadIdx.x];
    }
    tma::fence_proxy_async();
    __syncthreads();
  }

  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  // a[kc][0]/[1] hold 4-byte group 8kc + t of K, a[kc][2]/[3] group 8kc +
  // 4 + t (the A fragment of rows g and g + 8): kernel row j / (run/4),
  // bytes 4 (j % (run/4)) into its run; groups past the last run meet
  // zero rows of B and read the pixel's first word
  const int gpr = p.run / 4;
  int koff[2 * MAX_KSTEPS];
#pragma unroll
  for (int kk = 0; kk < 2 * MAX_KSTEPS; ++kk) {
    const int j = (kk / 2) * 8 + (kk % 2) * 4 + t;
    const int i = j / gpr;
    koff[kk] = i < p.k ? i * p.rb + 4 * (j - i * gpr) : 0;
  }
  // K atom 0 and 1 (7 k32 steps at most: 224 bytes)
  const uint64_t db[2] = {wg::desc_sw128(Bs), wg::desc_sw128(Bs + N * 128)};
  const int P = p.ho * p.wo;
  const float slope = p.act == 1 ? 0.1f : 1.0f;
  const bool relu = p.act == 2;

  int u = blockIdx.x;
  if (u < p.units) stage(p, band0, u);
  s8mma::cp_async_commit();
  for (int it = 0; u < p.units; u += gridDim.x, ++it) {
    const int un = u + gridDim.x;
    if (un < p.units) stage(p, band0 + ((it + 1) & 1) * band_bytes, un);
    s8mma::cp_async_commit();
    s8mma::cp_async_wait<1>();          // unit u's rows have landed
    __syncthreads();
    const int8_t* band = band0 + (it & 1) * band_bytes;
    const int n = u / p.units_img;
    const int px0 = (u - n * p.units_img) * p.upx;
    const int npx = min(p.upx, P - px0);
    const int y0 = px0 / p.wo;
    for (int m0 = 64 * wgi; m0 < npx; m0 += 128) {
      const int ma = m0 + 16 * w + g, mb = ma + 8;
      const int ba = pixel_base(p, px0 + min(ma, npx - 1), y0);
      const int bb = pixel_base(p, px0 + min(mb, npx - 1), y0);
      const int8_t* pa = band + (ba & ~3);
      const int8_t* pb = band + (bb & ~3);
      const int sa = 8 * (ba & 3), sb = 8 * (bb & 3);
      unsigned a[MAX_KSTEPS][4];
#pragma unroll
      for (int kc = 0; kc < MAX_KSTEPS; ++kc) {
        if (kc < p.ksteps) {
          a[kc][0] = word_at(pa + koff[2 * kc], sa);
          a[kc][1] = word_at(pb + koff[2 * kc], sb);
          a[kc][2] = word_at(pa + koff[2 * kc + 1], sa);
          a[kc][3] = word_at(pb + koff[2 * kc + 1], sb);
        }
      }
      int acc[N / 2];
      fence_acc(acc);
      wg::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < MAX_KSTEPS; ++kc) {
        if (kc < p.ksteps) {
          MmaRS<N>::run(acc, a[kc], db[kc / 4] + 2 * (kc % 4), kc != 0);
        }
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      fence_acc(acc);
      // lane 4g + t holds rows g and g + 8 of the warp's 16, columns 8j +
      // 2t and 8j + 2t + 1
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 8 * j + 2 * t;
          uint8_t* s = stg + (g + 8 * h) * SROW;
          const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          const float y0 =
              out_value<OUT>(v0, sc_s[col], bi_s[col], slope, relu, p.q);
          const float y1 = out_value<OUT>(v1, sc_s[col + 1], bi_s[col + 1],
                                          slope, relu, p.q);
          if constexpr (OUT == 1) {
            *reinterpret_cast<float2*>(s + 4 * col) = make_float2(y0, y1);
          } else {
            *reinterpret_cast<uint16_t*>(s + col) =
                static_cast<uint16_t>((wg::code_bits(y0) & 0xFFu) |
                                      ((wg::code_bits(y1) & 0xFFu) << 8));
          }
        }
      }
      __syncwarp();
      // the warp's 16 pixels are contiguous in the output
      const int mw = m0 + 16 * w;
      uint8_t* dst = static_cast<uint8_t*>(p.out) +
                     (static_cast<size_t>(n) * P + px0 + mw) * (N * ES);
      for (int e = lane; e < 16 * C16; e += 32) {
        const int r = e / C16, c = e - r * C16;
        if (mw + r < npx) {
          *reinterpret_cast<int4*>(dst + r * (N * ES) + 16 * c) =
              *reinterpret_cast<const int4*>(stg + r * SROW + 16 * c);
        }
      }
      __syncwarp();
    }
    __syncthreads();                    // the band is free for unit u + 2g
  }
  s8mma::cp_async_wait<0>();
}

template <int N, int OUT>
int start(const Args& p, int grid, size_t smem, cudaStream_t st) {
  auto kernel = conv_rows_kernel<N, OUT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, THREADS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int by_out(const Args& p, int grid, size_t smem, int out_kind, int mode,
           cudaStream_t st) {
  if (out_kind == 1) return start<N, 1>(p, grid, smem, st);
  return mode == 0 ? start<N, 0>(p, grid, smem, st)
                   : start<N, 4>(p, grid, smem, st);
}

}  // namespace

// x (N, H, W, Cin) int8; tile the B tile (rows_tile_matrix, 16-byte
// aligned); scale, bias (Cout,) f32; out (N, ho, wo, Cout) int8 codes
// (out_kind 0, s_out) or f32 (out_kind 1); the geometry as ops/conv.py
// rows_plan computes it; aligned: x is 16-byte aligned.
extern "C" int conv_w8a8_rows(const void* x, const void* tile,
                              const void* scale, const void* bias,
                              float s_out, void* out, int n_img, int H,
                              int W, int cin, int cout, int k, int stride,
                              int pt, int pl, int ho, int wo, int run,
                              int ksteps, int padb, int rb, int upx, int nr,
                              int units_img, int grid, int act, int out_kind,
                              int aligned, void* stream) {
  const bool ok = (cout == 16 || cout == 64) && k % 2 == 1 &&
                  k <= 7 && (stride == 1 || stride == 2) && run % 4 == 0 &&
                  run <= 32 && run >= k * cin && ksteps >= 1 &&
                  ksteps <= MAX_KSTEPS && 32 * ksteps >= k * run &&
                  padb % 16 == 0 && padb >= pl * cin && rb % 16 == 0 &&
                  upx % 64 == 0 && nr >= k && units_img >= 1 && grid >= 1 &&
                  act >= 0 && act <= 2 && (out_kind == 0 || out_kind == 1) &&
                  reinterpret_cast<uintptr_t>(tile) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.x = static_cast<const int8_t*>(x);
  p.tile = static_cast<const int8_t*>(tile);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  int mode = 0;
  p.q = rq::requant(out_kind == 0 ? s_out : 1.0f, &mode);
  p.H = H;
  p.W = W;
  p.cin = cin;
  p.k = k;
  p.stride = stride;
  p.pt = pt;
  p.pl = pl;
  p.ho = ho;
  p.wo = wo;
  p.run = run;
  p.ksteps = ksteps;
  p.padb = padb;
  p.rb = rb;
  p.upx = upx;
  p.nr = nr;
  p.units_img = units_img;
  p.units = n_img * units_img;
  p.atoms = (32 * ksteps + 127) / 128;
  p.act = act;
  p.fast = aligned && (W * cin) % 16 == 0;
  p.wo_magic = wo > 1 && uint64_t(ho) * wo * wo < (uint64_t(1) << 32)
                   ? static_cast<unsigned>((uint64_t(1) << 32) / wo + 1)
                   : 0u;
  const int es = out_kind == 1 ? 4 : 1;
  const size_t smem = 1024 + size_t(p.atoms) * cout * 128 + 8 * cout +
                      2 * size_t(nr) * rb + WARPS * 16 * (cout * es + 16);
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > size_t(smem_max)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.units == 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 16: return by_out<16>(p, grid, smem, out_kind, mode, st);
    default: return by_out<64>(p, grid, smem, out_kind, mode, st);
  }
}
