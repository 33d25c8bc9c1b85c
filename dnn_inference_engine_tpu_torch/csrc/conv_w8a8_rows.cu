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
// Given a code table (`codes`), x is the uint8 wire batch and each byte u
// stands for the code codes[u]: the table is what the port's plain path
// gives byte u (ops/conv.py entry_code_table: u / 255 in float32, then
// quantize_act), so the normalise-and-quantize passes in front of the
// conv go into this one launch.
//
// What bounds it on an H100 (SXM data sheet at 700 W: 3.35 TB/s, 1,979
// int8 TOP/s): the stem at b32 reads 4.82 MB and writes 25.69 MB of
// codes, 0.0091 ms; its product over the padded K = 192 is 9.9 G
// operations, 0.0050 ms. Above both sits the epilogue's issue: each of
// the 25.69 M outputs costs 14 issued instructions under relu, 16 under
// leaky (the float of the accumulator, the scale and bias, the
// activation, the clamp, the division's multiply and four FMAs, the code
// and its packing; counted in cuobjdump -sass by chip_smoke.py), 0.011 ms
// at 132 SMs x 128 lanes x 1.98 GHz, and each tile's A fragments about
// 3.4 more an output (PERF.md section 6).
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
//   this one's tiles run. A uint8 band is translated through the table in
//   shared memory once, after it lands: 32 copies of the table, one a
//   lane, so that a warp's lookups do not meet in one bank (codes[0] is
//   0, so the zero pads stay zero).
// - Each 32-bit group of K that a register of wgmma's A fragment holds is
//   4 bytes of one staged row, at a byte offset stride ox Cin + padb - pl
//   Cin + kernel row offset: any phase mod 4 (at stride 2 and Cin 3, 6o -
//   6 is 2 mod 4 for even o). It is read as two aligned words and a
//   funnel shift, so A goes from the staged rows straight into registers,
//   with no layout pass. The kernel row offsets of a thread's groups come
//   from a table in shared memory, not from registers.
// - Two warpgroups a block take the unit's 64-pixel tiles in turn and run
//   wgmma m64nNk32 s8 (N = Cout) over the ksteps, B from shared memory, A
//   from registers. A warpgroup keeps two accumulator sets: it issues
//   its next tile's product before it runs this tile's epilogue. The
//   steps are a template argument (the main paths' 6 and 2, else 7 with
//   zeros past the launch's) and nothing branches while a product is in
//   flight: ptxas waits for a wgmma before any branch, so a kernel with
//   a branch around each step runs its steps one after another.
// - The epilogue (out_value) rounds every step as s8mma::epilogue_f32 and
//   requant.cuh do, explicitly (nvcc would contract a*b+c into an FMA),
//   converts the accumulator without a conversion instruction, takes its
//   activation as a template argument, and clamps y once, to +-RN(127
//   s_out), which leaves every code as it was and drops code_bits' second
//   clamp (relu's max is the lower bound). A warp writes its 16 pixels'
//   outputs into one of its two staging buffers in shared memory (64-byte
//   pixels in the copy engine's 64-byte swizzle, so the writes meet in no
//   bank), and one lane hands them to the copy engine as one tensor store
//   (pixels past the image's last are clipped by the tensor map): the
//   stores leave the warps' instruction stream.
// - A persistent grid walks the units (block b takes b, b + grid, ...):
//   two blocks an SM at Cout 64 (two accumulator sets of 32 registers a
//   thread), three at Cout 16.

#include <cstdint>
#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int THREADS = 256;          // two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int MAX_KSTEPS = 7;         // 7 runs of at most 32 bytes
constexpr int KOFFS = 2 * MAX_KSTEPS * 4;   // (group pair, t) offsets
constexpr int TAB_BYTES = 256 * 32;   // the code table, a copy a lane

struct Args {
  const int8_t* x;                    // int8 codes, or uint8 with codes
  const int8_t* codes;                // 256 codes of the uint8 wire, or null
  const int8_t* tile;                 // B: atoms x Cout rows x 128 bytes
  const float* scale;
  const float* bias;
  rq::Requant q;
  float clip;                         // RN(127 s_out)
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

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma reads or writes across its issue and its wait.
template <int R>
__device__ __forceinline__ void fence_regs(int (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int KS>
__device__ __forceinline__ void fence_a(unsigned (&a)[KS][4]) {
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kc][i])::"memory");
  }
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
// as s8mma::epilogue_f32 rounds it; OUT 1 the f32 y, OUT 0 and 4 the code
// in the low byte of the result's bits, as rq::code<OUT> gives it. ACT
// (0 linear, 1 leaky, 2 relu) is a template argument of the codes' main
// form (OUT 0), which runs with no select it does not need; -1 (the f32
// and mode-4 forms) takes the launch's activation as (slope, relu): y <=
// 0 becomes slope y (leaky 0.1, linear 1: y itself) or, with relu, 0.
//
// OUT 0 clamps y to +-clip = RN(127 s_out) where requant.cuh clamps it to
// +-128 s_out and the quotient to +-127: the quotient of +-clip is within
// 2^-17 of +-127, so a y past it still gives +-127, a y inside it meets
// neither clamp, and the quotient never leaves +-127.5; a NaN gives -127
// either way (0 after relu's max, as relu's select gives). Relu's max with
// 0 is also the clamp's lower bound. Adding 1.5 * 2^23 then rounds the
// quotient to the integer in the low bits, as wg::code_bits does after
// its clamp.
template <int OUT, int ACT>
__device__ __forceinline__ float out_value(int acc, float sc, float bi,
                                           float slope, bool relu,
                                           const Args& p) {
  float y = __fadd_rn(__fmul_rn(acc_float(acc), sc), bi);
  if constexpr (ACT == 2) {
    y = fminf(fmaxf(y, 0.f), p.clip);
  } else if constexpr (ACT >= 0) {
    if constexpr (ACT == 1) y = y > 0.f ? y : __fmul_rn(0.1f, y);
    y = fminf(fmaxf(y, -p.clip), p.clip);
  } else if (!(y > 0.f)) {
    y = relu ? 0.f : __fmul_rn(slope, y);
  }
  if constexpr (OUT == 0) {
    static_assert(ACT >= 0, "the codes' main form has its activation");
    y = __fadd_rn(wg::div_rn(y, p.q.s_out, p.q.rs_out), 12582912.f);
  } else if constexpr (OUT == 4) {
    y = __uint_as_float(wg::code_bits(__double2float_rn(
        __dmul_rn(static_cast<double>(y), p.q.rd_out))));
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

// The whole block: the first `bytes` of a landed uint8 band to their
// codes, in place; lane l reads copy l of the table (byte 32 u + l).
__device__ __forceinline__ void translate(int8_t* band, int bytes,
                                          const uint8_t* tab) {
  uint32_t* w = reinterpret_cast<uint32_t*>(band);
  const uint8_t* tl = tab + threadIdx.x % 32;
  for (int i = threadIdx.x; i < bytes / 4; i += THREADS) {
    const uint32_t v = w[i];
    w[i] = static_cast<uint32_t>(tl[32 * (v & 0xFFu)]) |
           (static_cast<uint32_t>(tl[32 * ((v >> 8) & 0xFFu)]) << 8) |
           (static_cast<uint32_t>(tl[32 * ((v >> 16) & 0xFFu)]) << 16) |
           (static_cast<uint32_t>(tl[32 * (v >> 24)]) << 24);
  }
}

// A thread's A fragment of the 64-pixel tile whose rows g and g + 8 (of
// its warp's 16) are pixels m and m + 8 of the unit: a[kc][0]/[1] hold
// 4-byte group 8kc + t of K, a[kc][2]/[3] group 8kc + 4 + t, from the
// offsets koff[(2kc + h) 4 + t] (kernel row j / (run/4), bytes 4 (j %
// (run/4)) into its run; groups past the last run meet zero rows of B and
// read the pixel's first word). Pixels past the unit's last read its
// last.
template <int KS>
__device__ __forceinline__ void load_a(const Args& p, const int* koff,
                                       const int8_t* band, int px0, int npx,
                                       int y0, int m, int t,
                                       unsigned (&a)[KS][4]) {
  const int ba = pixel_base(p, px0 + min(m, npx - 1), y0);
  const int bb = pixel_base(p, px0 + min(m + 8, npx - 1), y0);
  const int8_t* pa = band + (ba & ~3);
  const int8_t* pb = band + (bb & ~3);
  const int sa = 8 * (ba & 3), sb = 8 * (bb & 3);
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) {
    // a step past the launch's multiplies zeros (B there is not the
    // weights')
    const bool on = KS < MAX_KSTEPS || kc < p.ksteps;
    const int o0 = koff[8 * kc + t], o1 = koff[8 * kc + 4 + t];
    a[kc][0] = on ? word_at(pa + o0, sa) : 0u;
    a[kc][1] = on ? word_at(pb + o0, sb) : 0u;
    a[kc][2] = on ? word_at(pa + o1, sa) : 0u;
    a[kc][3] = on ? word_at(pb + o1, sb) : 0u;
  }
}

// The warpgroup's product of one tile into acc, issued and committed as
// one wgmma group of KS steps in straight-line code (a branch between two
// wgmma makes ptxas wait for each before the next); B's K atoms 0 and 1
// (7 k32 steps at most: 224 bytes).
template <int N, int KS>
__device__ __forceinline__ void issue(int (&acc)[N / 2],
                                      const unsigned (&a)[KS][4],
                                      uint64_t db0, uint64_t db1) {
  fence_regs(acc);
  wg::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) {
    MmaRS<N>::run(acc, a[kc], (kc < 4 ? db0 : db1) + 2 * (kc % 4), kc != 0);
  }
  wg::wgmma_commit();
}

// Where `on`: the copy engine's tensor store of a warp's 16 staged pixels
// at (0, pixel, image), as a bulk group of its own. Predicated, not
// branched: a branch while a wgmma is in flight makes ptxas wait for it.
__device__ __forceinline__ void store_pixels(const CUtensorMap* map,
                                             const void* src, int pix,
                                             int img, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      "@p cp.async.bulk.commit_group;\n}\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(tma::smem_addr(src)),
         "r"(0), "r"(pix), "r"(img), "r"(static_cast<int>(on))
      : "memory");
}

// Where `on`: until at most N of the thread's bulk groups still read
// shared memory (predicated, as store_pixels).
template <int N>
__device__ __forceinline__ void stores_read(bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p cp.async.bulk.wait_group.read %1;\n}\n"
      :: "r"(static_cast<int>(on)), "n"(N) : "memory");
}

// A tile's epilogue: the warp's 16 pixels (unit pixels mw ..) from acc
// into staging buffer `sb`, then one tensor store. Lane 4g + t holds rows
// g and g + 8 of the warp's 16, columns 8j + 2t and 8j + 2t + 1. A
// 64-byte pixel lies in the 64-byte swizzle: its 16-byte chunk c at c ^
// ((row / 2) % 4), `xr` the lane's (row / 2) % 4 << 4.
template <int N, int OUT, int ACT>
__device__ __forceinline__ void epilogue(const Args& p,
                                         const CUtensorMap* map,
                                         const int (&acc)[N / 2],
                                         const float* sc_s,
                                         const float* bi_s, uint8_t* sb,
                                         int g, int t, int xr, float slope,
                                         bool relu, int mw, int npx, int pix0,
                                         int img) {
  constexpr int ES = OUT == 1 ? 4 : 1;          // bytes of an output
  constexpr int RB = N * ES;                    // bytes of a pixel
  constexpr bool SW64 = RB == 64;
  const int lane = threadIdx.x % 32;
  stores_read<1>(lane == 0);          // the buffer's store of 2 tiles ago
  __syncwarp();
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 sc = *reinterpret_cast<const float2*>(sc_s + col);
    const float2 bi = *reinterpret_cast<const float2*>(bi_s + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = ES * col;
      const int cs = SW64 ? (((c & ~15) ^ xr) | (c & 15)) : c;
      uint8_t* s = sb + (g + 8 * h) * RB + cs;
      const float y0 = out_value<OUT, ACT>(acc[4 * j + 2 * h], sc.x, bi.x,
                                           slope, relu, p);
      const float y1 = out_value<OUT, ACT>(acc[4 * j + 2 * h + 1], sc.y,
                                           bi.y, slope, relu, p);
      if constexpr (OUT == 1) {
        *reinterpret_cast<float2*>(s) = make_float2(y0, y1);
      } else {
        *reinterpret_cast<uint16_t*>(s) = static_cast<uint16_t>(
            __byte_perm(__float_as_uint(y0), __float_as_uint(y1), 0x40));
      }
    }
  }
  tma::fence_proxy_async();           // the writes, before the copy engine's
  __syncwarp();
  store_pixels(map, sb, pix0 + mw, img, lane == 0 && mw < npx);
  __syncwarp();
}

// N: Cout; OUT: 0 or 4 the int8 codes (requant.cuh MODE), 1 f32; KS: the
// k32 steps a tile issues (the launch's, or MAX_KSTEPS with the steps past
// the launch's multiplying zeros); ACT: the activation, or -1 the
// launch's.
template <int N, int OUT, int KS, int ACT>
__global__ void __launch_bounds__(THREADS, N == 16 ? 3 : 2)
    conv_rows_kernel(const __grid_constant__ CUtensorMap map_o,
                     const Args p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr int ES = OUT == 1 ? 4 : 1;
  constexpr int SB = 16 * N * ES;               // a warp's staging buffer
  constexpr bool SW64 = N * ES == 64;
  const uint32_t a0 = tma::smem_addr(smem);
  uint8_t* base = smem + ((1024 - (a0 & 1023)) & 1023);
  int8_t* Bs = reinterpret_cast<int8_t*>(base);
  const int tile_bytes = p.atoms * N * 128;     // a multiple of 1024
  uint8_t* stg0 = base + tile_bytes;            // WARPS x 2 buffers
  float* sc_s = reinterpret_cast<float*>(stg0 + WARPS * 2 * SB);
  float* bi_s = sc_s + N;
  int* koff = reinterpret_cast<int*>(bi_s + N);
  uint8_t* tab = reinterpret_cast<uint8_t*>(koff + KOFFS);
  int8_t* band0 = reinterpret_cast<int8_t*>(tab) +
                  (p.codes != nullptr ? TAB_BYTES : 0);
  const int band_bytes = p.nr * p.rb;
  const int warp = threadIdx.x / 32;

  // B, scale and bias, the K offsets, the code table's copies, and the
  // band buffers zeroed (their pads stay zero under the cp.async rows); B
  // is written by the generic proxy and read by wgmma's async proxy
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
    const int gpr = p.run / 4;
    if (threadIdx.x < KOFFS) {
      const int kk = threadIdx.x / 4, t = threadIdx.x % 4;
      const int j = (kk / 2) * 8 + (kk % 2) * 4 + t;
      const int i = j / gpr;
      koff[threadIdx.x] = i < p.k ? i * p.rb + 4 * (j - i * gpr) : 0;
    }
    if (p.codes != nullptr) {
      uint32_t* tw = reinterpret_cast<uint32_t*>(tab);
      for (int i = threadIdx.x; i < TAB_BYTES / 4; i += THREADS) {
        tw[i] = static_cast<uint32_t>(static_cast<uint8_t>(
                    __ldg(p.codes + i / 8))) * 0x01010101u;
      }
    }
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&map_o)) : "memory");
    }
    tma::fence_proxy_async();
    __syncthreads();
  }

  // the warpgroup from lane 0, so that ptxas sees it uniform in the warp
  // and every branch on it (the tiles) as no divergence
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const uint64_t db0 = wg::desc_sw128(Bs);
  const uint64_t db1 = wg::desc_sw128(Bs + N * 128);
  const int P = p.ho * p.wo;
  const float slope = p.act == 1 ? 0.1f : 1.0f;
  const bool relu = p.act == 2;
  const int xr = SW64 ? ((g >> 1) & 3) << 4 : 0;
  uint8_t* stg = stg0 + warp * 2 * SB;
  int sbuf = 0;

  int u = blockIdx.x;
  if (u < p.units) stage(p, band0, u);
  s8mma::cp_async_commit();
  for (int it = 0; u < p.units; u += gridDim.x, ++it) {
    const int un = u + gridDim.x;
    if (un < p.units) stage(p, band0 + ((it + 1) & 1) * band_bytes, un);
    s8mma::cp_async_commit();
    s8mma::cp_async_wait<1>();          // unit u's rows have landed
    __syncthreads();
    int8_t* band = band0 + (it & 1) * band_bytes;
    const int n = u / p.units_img;
    const int px0 = (u - n * p.units_img) * p.upx;
    const int npx = min(p.upx, P - px0);
    const int y0 = px0 / p.wo;
    if (p.codes != nullptr) {
      translate(band, (p.stride * ((px0 + npx - 1) / p.wo - y0) + p.k) * p.rb,
                tab);
      __syncthreads();
    }
    // this warpgroup's tiles: unit pixels 64 wgi + 128 i ..; tile i + 1's
    // product runs while tile i's epilogue does
    const int tiles = (npx - 64 * wgi + 127) / 128;
    const int m0 = 64 * wgi + 16 * w;
    if (tiles > 0) {
      unsigned a[KS][4];
      int acc0[N / 2], acc1[N / 2];
      load_a<KS>(p, koff, band, px0, npx, y0, m0 + g, t, a);
      issue<N, KS>(acc0, a, db0, db1);
      for (int i = 0; i < tiles; i += 2) {
        wg::wgmma_wait<0>();
        fence_regs(acc0);
        fence_a(a);
        if (i + 1 < tiles) {
          load_a<KS>(p, koff, band, px0, npx, y0, m0 + 128 * (i + 1) + g, t,
                     a);
          issue<N, KS>(acc1, a, db0, db1);
        }
        epilogue<N, OUT, ACT>(p, &map_o, acc0, sc_s, bi_s, stg + sbuf * SB,
                              g, t, xr, slope, relu, m0 + 128 * i, npx, px0,
                              n);
        sbuf ^= 1;
        if (i + 1 >= tiles) break;
        wg::wgmma_wait<0>();
        fence_regs(acc1);
        fence_a(a);
        if (i + 2 < tiles) {
          load_a<KS>(p, koff, band, px0, npx, y0, m0 + 128 * (i + 2) + g, t,
                     a);
          issue<N, KS>(acc0, a, db0, db1);
        }
        epilogue<N, OUT, ACT>(p, &map_o, acc1, sc_s, bi_s, stg + sbuf * SB,
                              g, t, xr, slope, relu, m0 + 128 * (i + 1), npx,
                              px0, n);
        sbuf ^= 1;
      }
    }
    __syncthreads();                    // the band is free for unit u + 2g
  }
  s8mma::cp_async_wait<0>();
  if (threadIdx.x % 32 == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

template <int N, int OUT, int KS, int ACT>
int start(const CUtensorMap& map, const Args& p, int grid, size_t smem,
          cudaStream_t st) {
  auto kernel = conv_rows_kernel<N, OUT, KS, ACT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, THREADS, smem, st>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int KS>
int by_act(const CUtensorMap& map, const Args& p, int grid, size_t smem,
           cudaStream_t st) {
  switch (p.act) {
    case 0: return start<N, 0, KS, 0>(map, p, grid, smem, st);
    case 1: return start<N, 0, KS, 1>(map, p, grid, smem, st);
    default: return start<N, 0, KS, 2>(map, p, grid, smem, st);
  }
}

// The codes' main form: the step count of Cout's main path (ResNet-18's
// stem 6, the entry conv 2) or MAX_KSTEPS, and its activation; the f32
// and mode-4 forms: MAX_KSTEPS and the launch's activation.
template <int N>
int by_form(const CUtensorMap& map, const Args& p, int grid, size_t smem,
            int out_kind, int mode, cudaStream_t st) {
  constexpr int KM = N == 64 ? 6 : 2;
  if (out_kind == 1) {
    return start<N, 1, MAX_KSTEPS, -1>(map, p, grid, smem, st);
  }
  if (mode != 0) return start<N, 4, MAX_KSTEPS, -1>(map, p, grid, smem, st);
  return p.ksteps == KM ? by_act<N, KM>(map, p, grid, smem, st)
                        : by_act<N, MAX_KSTEPS>(map, p, grid, smem, st);
}

}  // namespace

// x (N, H, W, Cin) int8, or with `codes` (256 int8, the code of each
// byte) the uint8 wire batch; tile the B tile (rows_tile_matrix, 16-byte
// aligned); scale, bias (Cout,) f32; out (N, ho, wo, Cout) int8 codes
// (out_kind 0, s_out) or f32 (out_kind 1), 16-byte aligned; the geometry
// as ops/conv.py rows_plan computes it; aligned: x is 16-byte aligned.
extern "C" int conv_w8a8_rows(const void* x, const void* codes,
                              const void* tile, const void* scale,
                              const void* bias, float s_out, void* out,
                              int n_img, int H, int W, int cin, int cout,
                              int k, int stride, int pt, int pl, int ho,
                              int wo, int run, int ksteps, int padb, int rb,
                              int upx, int nr, int units_img, int grid,
                              int act, int out_kind, int aligned,
                              void* stream) {
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
  p.codes = static_cast<const int8_t*>(codes);
  p.tile = static_cast<const int8_t*>(tile);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  int mode = 0;
  p.q = rq::requant(out_kind == 0 ? s_out : 1.0f, &mode);
  p.clip = 127.0f * p.q.s_out;
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
  const size_t smem = 1024 + size_t(p.atoms) * cout * 128 +
                      WARPS * 2 * 16 * size_t(cout) * es + 8 * cout +
                      KOFFS * 4 + (codes != nullptr ? TAB_BYTES : 0) +
                      2 * size_t(nr) * rb;
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > size_t(smem_max)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.units == 0) return static_cast<int>(cudaSuccess);
  // the output as (image, pixel, bytes of a pixel); a box is a warp's 16
  // pixels, clipped at the image's last
  CUtensorMap map;
  const uint64_t pix_bytes = uint64_t(cout) * es;
  const uint64_t dims[3] = {pix_bytes, uint64_t(ho) * wo, uint64_t(n_img)};
  const uint64_t strides[2] = {pix_bytes, uint64_t(ho) * wo * pix_bytes};
  const uint32_t box[3] = {static_cast<uint32_t>(pix_bytes), 16, 1};
  const CUresult r = tma::encode_s8(
      &map, out, 3, dims, strides, box,
      pix_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  auto st = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 16: return by_form<16>(map, p, grid, smem, out_kind, mode, st);
    default: return by_form<64>(map, p, grid, smem, out_kind, mode, st);
  }
}
