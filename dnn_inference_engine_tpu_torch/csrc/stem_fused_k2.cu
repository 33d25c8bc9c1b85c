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
// the operations bind, narrowly (0.0172 against 0.0116 ms). The int8
// tensor rate is reached only through wgmma, and only if the weights stay
// in shared memory and the staging of the input runs under the math. The
// design keeps the TPU kernel's point: the folded input and the pre-max
// accumulator never reach device memory.
//
// A persistent grid of at most one block an SM walks units (image, band
// of `rows` output rows, rows from the host: ops/fused_conv.py
// _stem_k2_rows) in order, block b taking units b, b + grid, ...
// - The folded weights come once per block, by bulk copies (the TMA
//   unit's), from a copy laid out on the device once per weight tensor
//   (ops/fused_conv.py stem_tile_matrix): wgmma's canonical K-major form
//   with the 128-byte swizzle, 256 rows of two 128-byte K atoms (K
//   0..127, 128..191 and 64 bytes of zeros), 64 KB. Rows 0..127 hold
//   channels 0..31 of the four pool groups (group g's channel c at row 32
//   g + c), rows 128..255 channels 32..63: each half is one n128 tile.
// - Warpgroup 0 is the producer. Thread 0 copies the next unit's input
//   rows inside the image (4*rows+4 with the halo) raw into shared memory
//   by one bulk copy; the warpgroup then converts them into the other of
//   two band buffers in stem_common.cuh's staged layout (codes, element e
//   of a row at byte e + 3: a funnel shift of two raw words for uint8,
//   the exact quotient for f32), while the consumers run the current one.
//   Where a band's raw rows do not fit or are not whole 16-byte multiples
//   it stages from device memory directly (stage_band). Full and empty
//   barriers (mbarriers) hand the band buffers over.
// - Warpgroups 1 and 2 are consumers: consumer c takes tiles c, c + 2, ...
//   of 64 pixels of the band (the last one ragged, masked at the store)
//   and runs wgmma m64n128k32 s8 on each half of it: B from shared
//   memory, A from registers. A is never laid out: the shifted s2d(4) is
//   an addressing rule, and each of the 4 lanes an A register holds are 4
//   contiguous, 4-aligned bytes of one staged row (stem_common.cuh's
//   group_offset), loaded 32 bits at a time; K is 6 x k32 over the 4 taps
//   x 48 lanes. The halves are two commit groups, so half 0's epilogue
//   runs under half 1's products.
// - Under wgmma's accumulator layout a thread holds columns 8j + 2t + e
//   for every j < 16 of a half, so channel c of all four pool groups
//   (columns 8j + 2t + e for j = jj, jj + 4, jj + 8, jj + 12) sits in one
//   thread: the group-max is a register max. The epilogue rounds each
//   step explicitly (__fmul_rn, __fadd_rn; codes by adding 1.5 * 2^23 to
//   the clamped value, as rintf rounds) so the codes match XLA's, then
//   the four threads of a quad swap their codes (three shuffles) so that
//   each stores 16 contiguous bytes of a pixel's 64.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "stem_common.cuh"
#include "tma.cuh"
#include "wgmma_s8.cuh"

namespace {

using namespace stem;

constexpr int K2_THREADS = 384;   // producer warpgroup + 2 consumers
constexpr int KSTEPS = 6;         // k32 steps: 4 taps x 48 lanes
constexpr int B_ATOM = NF * 128;  // one 128-byte K atom of the 256 rows
constexpr int B_BYTES = 2 * B_ATOM;
constexpr int NACC = NF / 4;      // accumulator registers of a half
constexpr int BULK = 16384;       // bytes of one bulk copy of the weights

// Bytes of a band's raw input rows of `esize`-byte elements (copied in
// one bulk copy; esize 0 where the input is not copied raw).
__host__ __device__ inline int raw_bytes(int W, int rows, int esize) {
  return ((4 * rows + 4) * 3 * W * esize + 15) / 16 * 16;
}

// B, the two band buffers, the raw rows, scale and bias (GO floats each),
// the barriers (full[2], empty[2], weights, raw), 1024 bytes of slack to
// align the base.
size_t smem_bytes(int W, int rows, int esize) {
  return 1024 + B_BYTES + 2 * staged_bytes(W, rows) +
         raw_bytes(W, rows, esize) + 2 * GO * 4 + 6 * 8;
}

// d (64 int32) += A (64 x 32 s8, registers a[4]) * B (32 x 128 s8,
// descriptor b); scale_d 0 overwrites d.
__device__ __forceinline__ void mma_rs(int* d, const unsigned (&a)[4],
                                       uint64_t b, int scale_d) {
  asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
}

__device__ __forceinline__ void fence_acc(int (&acc)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

// The codes of channels 32 hf + 8 jj + 2t + {0, 1} of accumulator row 8h
// + g of half hf (after the group-max) in the low 16 bits. ACT is a
// template argument: as a runtime value it cost a three-way branch a code.
template <int ACT>
__device__ __forceinline__ uint32_t code_pair(const int (&acc)[NACC], int hf,
                                              int jj, int h, int t,
                                              const float* sc,
                                              const float* bi) {
  uint32_t r = 0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = 4 * jj + 2 * h + e;   // group 0; groups 1-3 at +16 each
    const int a = max(max(acc[i], acc[i + 16]), max(acc[i + 32], acc[i + 48]));
    const int ch = 32 * hf + 8 * jj + 2 * t + e;
    float y = __fadd_rn(__fmul_rn(__int2float_rn(a), sc[ch]), bi[ch]);
    if (ACT == 1) {
      y = y > 0.f ? y : __fmul_rn(0.1f, y);
    } else if (ACT == 2) {
      y = fmaxf(y, 0.f);
    }
    r |= (wg::code_bits(y) & 0xFFu) << (8 * e);
  }
  return r;
}

// Half hf's codes of rows g (w[2 hf + ...][0]) and g + 8 ([1]): word
// w[2 hf + s] holds the pairs jj = 2s, 2s + 1, channels 32 hf + 16 s +
// {2t, 2t + 1, 8 + 2t, 9 + 2t}, which thread 2 hf + s of the quad stores.
template <int ACT>
__device__ __forceinline__ void half_codes(const int (&acc)[NACC], int hf,
                                           int t, const float* sc,
                                           const float* bi,
                                           uint32_t (&w)[4][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      w[2 * hf + s][h] = code_pair<ACT>(acc, hf, 2 * s, h, t, sc, bi) |
                         code_pair<ACT>(acc, hf, 2 * s + 1, h, t, sc, bi)
                             << 16;
    }
  }
}

// Row 8h + g of a consumer warp's 16 rows: thread t holds w[d][h] for
// thread d of the quad; the quad swaps words so that thread t stores
// channels 16t .. 16t + 15 of the pixel (if `valid`) as one 16-byte store.
__device__ __forceinline__ void store_row(const uint32_t (&w)[4][2], int h,
                                          int t, int8_t* dst, bool valid) {
  const int lane = threadIdx.x % 32;
  // r_s: thread s's word for this thread (k = 0: its own), selected
  // rather than indexed so that nothing lands in local memory
  uint32_t r0 = 0, r1 = 0, r2 = 0, r3 = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = (t + k) & 3, s = (t - k) & 3;
    const uint32_t send = d == 0   ? w[0][h]
                          : d == 1 ? w[1][h]
                          : d == 2 ? w[2][h]
                                   : w[3][h];
    const uint32_t got =
        k == 0 ? send : __shfl_sync(0xffffffffu, send, (lane & ~3) | s);
    r0 = s == 0 ? got : r0;
    r1 = s == 1 ? got : r1;
    r2 = s == 2 ? got : r2;
    r3 = s == 3 ? got : r3;
  }
  // r_s bytes: channels 16t + 2s, +1, 16t + 8 + 2s, +1
  if (valid) {
    *reinterpret_cast<int4*>(dst + 16 * t) =
        make_int4(static_cast<int>(__byte_perm(r0, r1, 0x5410)),
                  static_cast<int>(__byte_perm(r2, r3, 0x5410)),
                  static_cast<int>(__byte_perm(r0, r1, 0x7632)),
                  static_cast<int>(__byte_perm(r2, r3, 0x7632)));
  }
}

// The f32 input's quantizer: the code of x is clip(rint(x / s)), the
// quotient rounded once. Where s, 1/s and 128 s are positive normal
// floats the quotient is wg::div_rn's (two FMA corrections of x * RN(1/s),
// no slow path; x clamped to +-128 s first, which moves no code), else
// __fdiv_rn.
struct Quant {
  float s, rs, lim;
  int fast;
};

__device__ __forceinline__ int8_t quant(float x, const Quant& qz) {
  if (qz.fast) {
    return to_code(
        wg::div_rn(fminf(fmaxf(x, -qz.lim), qz.lim), qz.s, qz.rs));
  }
  return to_code(__fdiv_rn(x, qz.s));
}

// The codes of input elements off .. off+3 of x, in one word: exact u8:
// u XOR 0x80 (u - 128); f32: quant.
template <bool U8>
__device__ __forceinline__ uint32_t code_word(const void* x, size_t off,
                                              const Quant& qz) {
  if (U8) return ld32g(static_cast<const uint8_t*>(x) + off) ^ 0x80808080u;
  const float4 v =
      *reinterpret_cast<const float4*>(static_cast<const float*>(x) + off);
  return pack4(quant(v.x, qz), quant(v.y, qz), quant(v.z, qz),
               quant(v.w, qz));
}

// The producer warpgroup stages a band into Xs in stem_common.cuh's
// layout (input rows 4*y0-1 .. 4*y0+4*rows+2; element e = 3*col + c of a
// row at byte e + 3), one aligned 32-bit store a staged word: staged word
// k holds elements 4k-3 .. 4k, the top three codes of input word k-1 and
// the first of word k (a funnel shift; a lane gets word k-1 from the lane
// before it). Padding (rows outside the image, columns past the row) is
// u = 0 (code -128) or x = 0 (code 0). R rows' loads are in flight at
// once; no division by a runtime width.
template <bool U8>
__device__ __forceinline__ void stage_band(const void* __restrict__ x,
                                           int8_t* Xs, int n, int y0,
                                           int rows, int H, int W,
                                           const Quant& qz, int tid) {
  constexpr int R = 8;
  const int rbw = staged_row_bytes(W) / 4;      // staged words a row
  const int iw = 3 * W / 4;                     // input words a row
  const int nr = 4 * rows + 4;
  const uint32_t pad = U8 ? 0x80808080u : 0u;
  const int lane = tid % 32;
  uint32_t* dst = reinterpret_cast<uint32_t*>(Xs);
  for (int k0 = 0; k0 < rbw; k0 += 128) {
    const int k = k0 + tid;
    for (int r0 = 0; r0 < nr; r0 += R) {
      uint32_t cur[R], prev[R];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int row = 4 * y0 - 1 + r0 + u;
        const bool in = r0 + u < nr && row >= 0 && row < H;
        const size_t base = (size_t(n) * H + row) * W * 3;
        cur[u] = in && k < iw ? code_word<U8>(x, base + 4 * size_t(k), qz)
                              : pad;
        prev[u] = lane == 0 && in && k >= 1 && k - 1 < iw
                      ? code_word<U8>(x, base + 4 * size_t(k - 1), qz)
                      : pad;
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const uint32_t before = __shfl_up_sync(0xffffffffu, cur[u], 1);
        const uint32_t lo = lane == 0 ? prev[u] : before;
        if (k < rbw && r0 + u < nr) {
          dst[(r0 + u) * rbw + k] = __funnelshift_r(lo, cur[u], 8);
        }
      }
    }
  }
}

// The band from its raw rows in shared memory (one bulk copy of the
// band's rows inside the image, raw row r at 3W elements r on). Staged
// word k of row r holds elements 4k-3 .. 4k: exact u8, the funnel shift
// of raw words k-1 and k, XOR 0x80 a byte; f32, the codes of the last
// three floats of raw float4 k-1 and the first of float4 k. Rows and
// elements outside the image are u = 0 (code -128) or x = 0 (code 0).
// Staged from device memory a lane at a time, the band kept the producer
// waiting on load latency longer than the consumers took for its tiles.
template <bool U8>
__device__ __forceinline__ void convert_band(const uint8_t* raw, int8_t* Xs,
                                             int y0, int rows, int H, int W,
                                             const Quant& qz, int tid) {
  const int rbw = staged_row_bytes(W) / 4;      // staged words a row
  const int iw = 3 * W / 4;                     // input words a row
  uint32_t* dst = reinterpret_cast<uint32_t*>(Xs);
  for (int r = 0; r < 4 * rows + 4; ++r) {
    const int row = 4 * y0 - 1 + r;
    const bool in = row >= 0 && row < H;
    for (int k = tid; k < rbw; k += 128) {
      const bool vc = in && k < iw, vp = in && k >= 1 && k - 1 < iw;
      uint32_t word;
      if (U8) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(raw) + r * iw;
        const uint32_t cur = vc ? src[k] : 0u;
        const uint32_t prev = vp ? src[k - 1] : 0u;
        word = __funnelshift_r(prev, cur, 8) ^ 0x80808080u;
      } else {
        const float4* src = reinterpret_cast<const float4*>(raw) + r * iw;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 cur = vc ? src[k] : zero;
        const float4 prev = vp ? src[k - 1] : zero;
        word = pack4(quant(prev.y, qz), quant(prev.z, qz), quant(prev.w, qz),
                     quant(cur.x, qz));
      }
      dst[r * rbw + k] = word;
    }
  }
}

struct Args {
  const void* x;
  const int8_t* w;              // stem_tile_matrix: B_BYTES
  const float* scale;
  const float* bias;
  int8_t* out;
  Quant qz;
  int H, W, rows, bands, units;
  int esize;                    // bytes of an input element copied raw,
                                // 0 where the band is staged from global
};

// One thread: the bulk copy of unit (n, y0)'s input rows inside the image
// into `raw`, completing on `bar`.
__device__ __forceinline__ void copy_band(const Args& p, uint8_t* raw,
                                          uint64_t* bar, int n, int y0) {
  const int lo = max(4 * y0 - 1, 0);
  const int hi = min(4 * y0 + 4 * p.rows + 2, p.H - 1);
  const int row_bytes = 3 * p.W * p.esize;
  const uint32_t bytes = static_cast<uint32_t>(hi - lo + 1) * row_bytes;
  tma::fence_proxy_async();     // the last band's reads before the copy
  tma::mbar_expect_tx(bar, bytes);
  tma::bulk_load(raw + (lo - (4 * y0 - 1)) * row_bytes,
                 static_cast<const uint8_t*>(p.x) +
                     (static_cast<size_t>(n) * p.H + lo) * row_bytes,
                 bytes, bar);
}

// U8: exact-u8 input (else f32); ACT: the activation code.
template <bool U8, int ACT>
__global__ void __launch_bounds__(K2_THREADS, 1)
stem_k2_kernel(const Args p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base_addr = tma::smem_addr(smem);
  uint8_t* base = smem + ((1024 - (base_addr & 1023)) & 1023);
  int8_t* Bs = reinterpret_cast<int8_t*>(base);
  const int bb = (4 * p.rows + 4) * staged_row_bytes(p.W);  // staged_bytes
  int8_t* band0 = Bs + B_BYTES;         // band b at band0 + b * bb
  uint8_t* raw = reinterpret_cast<uint8_t*>(Bs + B_BYTES + 2 * bb);
  float* sc_s =
      reinterpret_cast<float*>(raw + raw_bytes(p.W, p.rows, p.esize));
  float* bi_s = sc_s + GO;
  uint64_t* full = reinterpret_cast<uint64_t*>(bi_s + GO);
  uint64_t* empty = full + 2;
  uint64_t* wbar = empty + 2;
  uint64_t* rawbar = wbar + 1;

  if (threadIdx.x == 0) {
    tma::mbar_init(&full[0], 128);      // the producer's threads
    tma::mbar_init(&full[1], 128);
    tma::mbar_init(&empty[0], 256);     // the consumers' threads
    tma::mbar_init(&empty[1], 256);
    tma::mbar_init(wbar, 1);
    tma::mbar_init(rawbar, 1);
    tma::fence_barrier_init();
  }
  __syncthreads();

  const int hout = p.H / 4, wout = p.W / 4;
  if (threadIdx.x < 128) {
    // --- producer: the weights once, then every unit's band ---
    wg::setmaxnreg_dec<56>();
    const int tid = threadIdx.x;
    if (tid == 0) {
      tma::mbar_expect_tx(wbar, B_BYTES);
      for (int o = 0; o < B_BYTES; o += BULK) {
        tma::bulk_load(Bs + o, p.w + o, BULK, wbar);
      }
    }
    int i = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++i) {
      const int b = i & 1;
      const int n = u / p.bands, y0 = (u - n * p.bands) * p.rows;
      if (p.esize) {
        // the raw rows of unit i arrive while unit i-1 converts
        if (tid == 0 && i == 0) copy_band(p, raw, rawbar, n, y0);
        wg::wait(rawbar, i & 1);
        wg::wait(&empty[b], ((i >> 1) & 1) ^ 1);
        convert_band<U8>(raw, band0 + b * bb, y0, p.rows, p.H, p.W, p.qz,
                         tid);
        asm volatile("bar.sync 2, 128;\n" ::: "memory");   // raw read
        const int un = u + gridDim.x;
        if (tid == 0 && un < p.units) {
          const int nn = un / p.bands;
          copy_band(p, raw, rawbar, nn, (un - nn * p.bands) * p.rows);
        }
      } else {
        wg::wait(&empty[b], ((i >> 1) & 1) ^ 1);
        stage_band<U8>(p.x, band0 + b * bb, n, y0, p.rows, p.H, p.W, p.qz,
                       tid);
      }
      wg::mbar_arrive(&full[b]);
    }
  } else {
    // --- consumers: c takes tiles c, c + 2, ... of every unit's band ---
    wg::setmaxnreg_inc<224>();
    const int ct = threadIdx.x - 128;
    const int c = ct / 128, tid = ct % 128;
    const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
    if (ct < GO) {
      sc_s[ct] = p.scale[ct];
      bi_s[ct] = p.bias[ct];
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int rb = staged_row_bytes(p.W);
    // a[0]/a[1] of k-step kc read 4-lane group 8kc + t, a[2]/a[3] group
    // 8kc + 4 + t (the A fragment of rows g and g + 8, bytes 4t and 16 +
    // 4t of the k32 slice)
    int koff[2 * KSTEPS];
#pragma unroll
    for (int k = 0; k < 2 * KSTEPS; ++k) {
      koff[k] = group_offset((k / 2) * 8 + (k % 2) * 4 + t, rb);
    }
    // [K atom][half]: a half's 128 rows start 16 KB into the atom
    const uint64_t db[2][2] = {
        {wg::desc_sw128(Bs), wg::desc_sw128(Bs + B_ATOM / 2)},
        {wg::desc_sw128(Bs + B_ATOM), wg::desc_sw128(Bs + 3 * B_ATOM / 2)}};
    wg::wait(wbar, 0);
    int acc0[NACC], acc1[NACC];
    int i = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++i) {
      const int b = i & 1;
      wg::wait(&full[b], (i >> 1) & 1);
      const int n = u / p.bands, y0 = (u - n * p.bands) * p.rows;
      const int band_px = min(p.rows, hout - y0) * wout;
      const int8_t* Xs = band0 + b * bb;
      for (int m0 = 64 * c; m0 < band_px; m0 += 128) {
        const int ma = m0 + 16 * w + g, mb = ma + 8;
        const bool va = ma < band_px, vb = mb < band_px;
        const int8_t* pa =
            Xs + 4 * ((va ? ma : 0) / wout) * rb + 12 * ((va ? ma : 0) % wout);
        const int8_t* pb =
            Xs + 4 * ((vb ? mb : 0) / wout) * rb + 12 * ((vb ? mb : 0) % wout);
        unsigned a[KSTEPS][4];
#pragma unroll
        for (int kc = 0; kc < KSTEPS; ++kc) {
          a[kc][0] = ld32(pa + koff[2 * kc]);
          a[kc][1] = ld32(pb + koff[2 * kc]);
          a[kc][2] = ld32(pa + koff[2 * kc + 1]);
          a[kc][3] = ld32(pb + koff[2 * kc + 1]);
        }
        // both halves from the same A registers, each its own group, so
        // half 0's epilogue runs under half 1's products
        fence_acc(acc0);
        fence_acc(acc1);
        wg::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < KSTEPS; ++kc) {
          mma_rs(acc0, a[kc], db[kc / 4][0] + 2 * (kc % 4), kc != 0);
        }
        wg::wgmma_commit();
#pragma unroll
        for (int kc = 0; kc < KSTEPS; ++kc) {
          mma_rs(acc1, a[kc], db[kc / 4][1] + 2 * (kc % 4), kc != 0);
        }
        wg::wgmma_commit();
        uint32_t words[4][2];
        wg::wgmma_wait<1>();
        fence_acc(acc0);
        half_codes<ACT>(acc0, 0, t, sc_s, bi_s, words);
        wg::wgmma_wait<0>();
        fence_acc(acc1);
        half_codes<ACT>(acc1, 1, t, sc_s, bi_s, words);
        const size_t row0 = static_cast<size_t>(n) * hout + y0;
        store_row(words, 0, t,
                  p.out + ((row0 + ma / wout) * wout + ma % wout) * GO, va);
        store_row(words, 1, t,
                  p.out + ((row0 + mb / wout) * wout + mb % wout) * GO, vb);
      }
      wg::mbar_arrive(&empty[b]);
    }
  }
}

template <bool U8, int ACT>
int launch(Args p, int grid, cudaStream_t st) {
  // bands copied raw where the rows are whole 16-byte multiples, x is
  // 16-byte aligned and the raw rows fit beside the rest
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int esize = U8 ? 1 : 4;
  p.esize = (3 * p.W * esize) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                    smem_bytes(p.W, p.rows, esize) <= size_t(smem_max)
                ? esize
                : 0;
  const size_t smem = smem_bytes(p.W, p.rows, p.esize);
  e = allow_smem(stem_k2_kernel<U8, ACT>, smem, p.rows);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.units > 0 && p.W >= 4) {
    stem_k2_kernel<U8, ACT><<<grid, K2_THREADS, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows: output rows a unit (a band); grid: persistent blocks; w: the
// weights as stem_tile_matrix lays them out (B_BYTES, 16-byte aligned).
extern "C" int stem_fused_k2(const void* x, const void* w, const void* scale,
                             const void* bias, float s_in, void* out, int N,
                             int H, int W, int rows, int grid, int exact_u8,
                             int act, void* stream) {
  Args p;
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<int8_t*>(out);
  p.qz.s = s_in;
  p.qz.rs = 1.0f / s_in;
  p.qz.lim = 128.0f * s_in;
  p.qz.fast = std::isnormal(s_in) && s_in > 0.f &&
              std::isnormal(p.qz.rs) && std::isnormal(p.qz.lim);
  p.H = H;
  p.W = W;
  p.rows = rows;
  p.bands = rows > 0 ? (H / 4 + rows - 1) / rows : 0;
  p.units = N * p.bands;
  if (grid < 1 || rows < 1 || act < 0 || act > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch ((exact_u8 != 0) * 3 + act) {
    case 0: return launch<false, 0>(p, grid, st);
    case 1: return launch<false, 1>(p, grid, st);
    case 2: return launch<false, 2>(p, grid, st);
    case 3: return launch<true, 0>(p, grid, st);
    case 4: return launch<true, 1>(p, grid, st);
    default: return launch<true, 2>(p, grid, st);
  }
}
