// The persistent wgmma stem mainloop for Hopper (sm_90a), shared by the
// three fused-stem kernels: stem_fused_k2.cu and stem_fused_dg.cu (one
// function, the folded 2x2 conv over the shifted space-to-depth(4) input)
// and stage0_fused.cu (the 3x3 conv on the raw 6x6 patch). Each computes
//   codes (exact u8: u - 128, the int8 view of u XOR 0x80; f32:
//     clip(rint(x / s_in))) of a band of input rows;
//   acc (int32) = A . B over the 256 pool-major outputs (group o / 64,
//     channel o % 64), A a pixel's row of codes, B the kernel's weights;
//   the max over the 4 groups, y = acc*scale + bias, the activation,
//   clip(rint(y)) -> (N, H/4, W/4, 64) int8.
// The kernels differ in two things only, each a template argument of run:
// the A-addressing policy (how K is laid over the staged rows: K2Addr,
// Stage0Addr) and how B reaches shared memory (a ready tile by bulk copy,
// or dg's per-tap slabs laid out in the block).
//
// A persistent grid of at most one block an SM walks units (image, band
// of `rows` output rows; rows from the host, ops/fused_conv.py
// stem_grid) in order, block b taking units b, b + grid, ...
// - B: 256 rows (the outputs in stem_row order) of b_bytes<Addr>() /
//   B_ATOM 128-byte K atoms in wgmma's canonical K-major form with the
//   128-byte swizzle
//   (16-byte chunk c of row r at chunk c ^ r % 8); rows 0..127 hold
//   channels 0..31 of the four pool groups (group g's channel c at row 32
//   g + c), rows 128..255 channels 32..63: each half is one n128 tile. It
//   comes once a block: by bulk copies of the copy the host laid out once
//   per weight tensor (ops/fused_conv.py stem_tile_matrix,
//   ops/attic/stage0.py stage0_tile_matrix), or, for SLABS, from dg's
//   (4, 256, 48) slabs by the whole block, 16 bytes a store.
// - Warpgroup 0 is the producer. Thread 0 copies the next unit's input
//   rows inside the image (4*rows + HALO with the halo, from row 4*y0-1)
//   raw into shared memory by one bulk copy; the warpgroup then converts
//   them into the other of two band buffers in the staged layout (element
//   e = 3*col + c of a row at byte e + 3, columns -1 .. W+2; a funnel
//   shift of two raw words for uint8, the exact quotient for f32), while
//   the consumers run the current one. Where a band's raw rows do not fit
//   or are not whole 16-byte multiples it stages from device memory
//   directly (stage_band). Full and empty barriers (mbarriers) hand the
//   band buffers over.
// - Warpgroups 1 and 2 are consumers: consumer c takes tiles c, c + 2, ...
//   of 64 pixels of the band (the last one ragged, masked at the store)
//   and runs wgmma m64n128k32 s8 on each half of B: B from shared memory,
//   A from registers. A is never laid out: each 4-byte group of K that an
//   A register holds is one aligned word of one staged row, at
//   Addr::offset(group, rb) from the pixel's base (staged row 4*(pixel's
//   output row in the band), byte 12*(its column)), loaded 32 bits at a
//   time; K is Addr::KSTEPS k32 steps. The halves are two commit groups,
//   so half 0's epilogue runs under half 1's products.
// - Under wgmma's accumulator layout a thread holds columns 8j + 2t + e
//   for every j < 16 of a half, so channel c of all four pool groups
//   (columns 8j + 2t + e for j = jj, jj + 4, jj + 8, jj + 12) sits in one
//   thread: the group-max is a register max. The epilogue rounds each
//   step explicitly (__fmul_rn, __fadd_rn; codes by adding 1.5 * 2^23 to
//   the clamped value, as rintf rounds) so the codes match XLA's, then
//   the four threads of a quad swap their codes (three shuffles) so that
//   each stores 16 contiguous bytes of a pixel's 64.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "tma.cuh"
#include "wgmma_s8.cuh"

namespace stem {

constexpr int NF = 256;         // outputs before the group-max (4 x 64)
constexpr int GO = 64;          // outputs after the group-max
constexpr int THREADS = 384;    // producer warpgroup + 2 consumers
constexpr int NACC = NF / 4;    // accumulator registers of a half
constexpr int B_ATOM = NF * 128;  // one 128-byte K atom of the 256 rows
constexpr int BULK = 16384;     // bytes of one bulk copy of the weights

// The folded 2x2 conv (stem_fused_k2, stem_fused_dg): folded input lane
// l = p*12 + q*3 + c of tap (dh, dw) at output (y, x) is the code at row
// 4*(y+dh)+p-1, column 4*(x+dw)+q-1, so the 4 lanes of 4-lane group j (tap
// j/12, p = (j%12)/3, lanes q*3+c from 4*(j%3)) are 4 contiguous,
// 4-aligned bytes of one staged row. K = 4 taps x 48 lanes, 6 x k32
// (lanes 48.. of a tap are zero and skipped).
struct K2Addr {
  static constexpr int KSTEPS = 6;
  static constexpr int HALO = 4;      // staged rows beyond 4 per output row
  __device__ __forceinline__ static int offset(int j, int rb) {
    const int tap = j / 12, p = (j % 12) / 3;
    return (4 * (tap >> 1) + p) * rb + 12 * (tap & 1) + 4 * (j % 3);
  }
};

// stage0_fused: output (i, j) reads the 6x6x3 patch at raw rows 4i-1 ..
// 4i+4, columns 4j-1 .. 4j+4. Patch row r6 is one 18-byte run of staged
// row 4i + r6 from byte 12j; K lays each run as 20 bytes (the 18, then 2
// bytes that meet zero rows of B: columns 4j+5, inside the staged row), so
// run r6 is 4-byte groups 5 r6 .. 5 r6 + 4, each one aligned word; K = 120
// of 128, 4 x k32; groups 30, 31 meet zero rows of B and read the pixel's
// first word. The dense order r6*18 + c6*3 + ch broke the 4-byte groups
// (18-byte runs): the kernel it replaced gathered A into shared memory in
// halfwords first.
struct Stage0Addr {
  static constexpr int KSTEPS = 4;
  static constexpr int HALO = 2;
  __device__ __forceinline__ static int offset(int j, int rb) {
    return j < 30 ? (j / 5) * rb + 4 * (j % 5) : 0;
  }
};

// bytes of one staged input row: columns -1 .. W+2, 3 codes each
__host__ __device__ inline int staged_row_bytes(int W) {
  return (3 * (W + 4) + 15) / 16 * 16;
}

// Bytes of a band's raw input rows of `esize`-byte elements (copied in
// one bulk copy; esize 0 where the input is not copied raw).
__host__ __device__ inline int raw_bytes(int W, int nr, int esize) {
  return (nr * 3 * W * esize + 15) / 16 * 16;
}

template <class Addr>
__host__ __device__ constexpr int b_bytes() {
  return (Addr::KSTEPS * 32 + 127) / 128 * B_ATOM;
}

// B, the two band buffers of nr staged rows, the raw rows, scale and
// bias (GO floats each), the barriers (full[2], empty[2], weights, raw),
// 1024 bytes of slack to align the base.
template <class Addr>
size_t smem_bytes(int W, int rows, int esize) {
  const int nr = 4 * rows + Addr::HALO;
  return 1024 + b_bytes<Addr>() + 2 * size_t(nr) * staged_row_bytes(W) +
         raw_bytes(W, nr, esize) + 2 * GO * 4 + 6 * 8;
}

// The shared-memory row of pool-major output o: half o % 64 / 32, then
// group o / 64, then channel o % 32 (ops/fused_conv.py stem_k2_row).
__device__ __forceinline__ int stem_row(int o) {
  return (o % 64) / 32 * 128 + (o / 64) * 32 + o % 32;
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <typename T>
__device__ __forceinline__ unsigned ld32g(const T* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

// The low bytes of a, b, c, d as bytes 0..3 of one word.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
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
// quotient rounded once, in the low byte (wg::code_bits: no conversion
// instruction; two a code kept the producer behind the consumers). Where
// s, 1/s and 128 s are positive normal floats the quotient is wg::div_rn's
// (two FMA corrections of x * RN(1/s), no slow path; x clamped to +-128 s
// first, which moves no code), else __fdiv_rn.
struct Quant {
  float s, rs, lim;
  int fast;
};

__device__ __forceinline__ uint32_t quant(float x, const Quant& qz) {
  if (qz.fast) {
    return wg::code_bits(
        wg::div_rn(fminf(fmaxf(x, -qz.lim), qz.lim), qz.s, qz.rs));
  }
  return wg::code_bits(__fdiv_rn(x, qz.s));
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

// The producer warpgroup stages a band's nr rows into Xs (input rows
// 4*y0-1 .. 4*y0-2+nr) from device memory, one aligned 32-bit store a
// staged word: staged word k holds elements 4k-3 .. 4k, the top three
// codes of input word k-1 and the first of word k (a funnel shift; a
// lane gets word k-1 from the lane before it). Padding (rows outside the
// image, columns past the row) is u = 0 (code -128) or x = 0 (code 0). R
// rows' loads are in flight at once; no division by a runtime width.
template <bool U8>
__device__ __forceinline__ void stage_band(const void* __restrict__ x,
                                           int8_t* Xs, int n, int y0,
                                           int nr, int H, int W,
                                           const Quant& qz, int tid) {
  constexpr int R = 8;
  const int rbw = staged_row_bytes(W) / 4;      // staged words a row
  const int iw = 3 * W / 4;                     // input words a row
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
// waiting on load latency longer than the consumers took for its tiles. A
// thread walks the rows of its words, unrolled, so that several rows'
// loads and quotients are in flight: row by row (2-3 words a thread) the
// f32 conversion ran at load and FMA latency and held the stage-0 kernel
// back.
template <bool U8>
__device__ __forceinline__ void convert_band(const uint8_t* raw, int8_t* Xs,
                                             int y0, int nr, int H, int W,
                                             const Quant& qz, int tid) {
  const int rbw = staged_row_bytes(W) / 4;      // staged words a row
  const int iw = 3 * W / 4;                     // input words a row
  uint32_t* dst = reinterpret_cast<uint32_t*>(Xs);
  for (int k = tid; k < rbw; k += 128) {
#pragma unroll 4
    for (int r = 0; r < nr; ++r) {
      const int row = 4 * y0 - 1 + r;
      const bool in = row >= 0 && row < H;
      const bool vc = in && k < iw, vp = in && k >= 1 && k - 1 < iw;
      uint32_t word;
      if (U8) {
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(raw) + r * iw;
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
  const int8_t* w;              // the B tile (b_bytes), or dg's slabs
  const float* scale;
  const float* bias;
  int8_t* out;
  Quant qz;
  int H, W, rows, bands, units;
  int esize;                    // bytes of an input element copied raw,
                                // 0 where the band is staged from global
};

// The arguments of one call; esize is set by launch.
inline Args make_args(const void* x, const void* w, const void* scale,
                      const void* bias, float s_in, void* out, int N, int H,
                      int W, int rows) {
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
  p.esize = 0;
  return p;
}

// One thread: the bulk copy of unit (n, y0)'s input rows inside the image
// (of rows 4*y0-1 .. 4*y0-2+nr) into `raw`, completing on `bar`.
__device__ __forceinline__ void copy_band(const Args& p, int nr, uint8_t* raw,
                                          uint64_t* bar, int n, int y0) {
  const int lo = max(4 * y0 - 1, 0);
  const int hi = min(4 * y0 - 2 + nr, p.H - 1);
  const int row_bytes = 3 * p.W * p.esize;
  const uint32_t bytes = static_cast<uint32_t>(hi - lo + 1) * row_bytes;
  tma::fence_proxy_async();     // the last band's reads before the copy
  tma::mbar_expect_tx(bar, bytes);
  tma::bulk_load(raw + (lo - (4 * y0 - 1)) * row_bytes,
                 static_cast<const uint8_t*>(p.x) +
                     (static_cast<size_t>(n) * p.H + lo) * row_bytes,
                 bytes, bar);
}

// The block lays dg's slabs (4, 256, 48), slab row (tap, o) = lanes
// 0..47 of tap (2 dh + dw) for output o, into the B tile: its 16-byte
// chunk c is K bytes 48 tap + 16 c of row stem_row(o), one whole chunk of
// the swizzled tile (48 is a multiple of 16). K bytes 192.. are never read
// (6 k32 steps) and stay unwritten. All THREADS threads take part, each
// with all of its 8 loads in flight, before the roles split (the consumers
// would only wait). The writes are the generic proxy's and wgmma reads
// through the async proxy: each thread fences before the block's barrier.
__device__ __forceinline__ void lay_slabs(const int8_t* __restrict__ slabs,
                                          int8_t* Bs) {
  const int4* src = reinterpret_cast<const int4*>(slabs);
  constexpr int CHUNKS = 4 * NF * 3;
  static_assert(CHUNKS % THREADS == 0, "chunks a thread");
  int4 v[CHUNKS / THREADS];
#pragma unroll
  for (int j = 0; j < CHUNKS / THREADS; ++j) {
    v[j] = __ldg(src + threadIdx.x + j * THREADS);
  }
#pragma unroll
  for (int j = 0; j < CHUNKS / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int tap = i / (NF * 3), o = (i / 3) % NF, c = i % 3;
    const int k = 48 * tap + 16 * c, row = stem_row(o);
    *reinterpret_cast<int4*>(Bs + (k / 128) * B_ATOM + row * 128 +
                             ((((k % 128) / 16) ^ (row % 8)) * 16)) = v[j];
  }
  tma::fence_proxy_async();
  __syncthreads();
}

// The kernel body: Addr the A-addressing policy, SLABS whether p.w holds
// dg's slabs (else the B tile), U8 exact-u8 input (else f32), ACT the
// activation code. `smem` is the dynamic shared memory (1024-aligned
// inside).
template <class Addr, bool SLABS, bool U8, int ACT>
__device__ __forceinline__ void run(const Args& p, uint8_t* smem) {
  constexpr int KSTEPS = Addr::KSTEPS;
  constexpr int B_BYTES = b_bytes<Addr>();
  const uint32_t base_addr = tma::smem_addr(smem);
  uint8_t* base = smem + ((1024 - (base_addr & 1023)) & 1023);
  int8_t* Bs = reinterpret_cast<int8_t*>(base);
  const int nr = 4 * p.rows + Addr::HALO;           // staged rows a band
  const int bb = nr * staged_row_bytes(p.W);        // bytes of a band
  int8_t* band0 = Bs + B_BYTES;         // band b at band0 + b * bb
  uint8_t* raw = reinterpret_cast<uint8_t*>(Bs + B_BYTES + 2 * bb);
  float* sc_s = reinterpret_cast<float*>(raw + raw_bytes(p.W, nr, p.esize));
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

  // the first unit's raw rows and the weights, in flight together
  if (threadIdx.x == 0) {
    if (p.esize && static_cast<int>(blockIdx.x) < p.units) {
      const int n = blockIdx.x / p.bands;
      copy_band(p, nr, raw, rawbar, n, (blockIdx.x - n * p.bands) * p.rows);
    }
    if (!SLABS) {
      tma::mbar_expect_tx(wbar, B_BYTES);
      for (int o = 0; o < B_BYTES; o += BULK) {
        tma::bulk_load(Bs + o, p.w + o, BULK, wbar);
      }
    }
  }
  if constexpr (SLABS) lay_slabs(p.w, Bs);

  const int hout = p.H / 4, wout = p.W / 4;
  if (threadIdx.x < 128) {
    // --- producer: every unit's band ---
    wg::setmaxnreg_dec<56>();
    const int tid = threadIdx.x;
    int i = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++i) {
      const int b = i & 1;
      const int n = u / p.bands, y0 = (u - n * p.bands) * p.rows;
      if (p.esize) {
        // the raw rows of unit i arrive while unit i-1 converts
        wg::wait(rawbar, i & 1);
        wg::wait(&empty[b], ((i >> 1) & 1) ^ 1);
        convert_band<U8>(raw, band0 + b * bb, y0, nr, p.H, p.W, p.qz, tid);
        asm volatile("bar.sync 2, 128;\n" ::: "memory");   // raw read
        const int un = u + gridDim.x;
        if (tid == 0 && un < p.units) {
          const int nn = un / p.bands;
          copy_band(p, nr, raw, rawbar, nn, (un - nn * p.bands) * p.rows);
        }
      } else {
        wg::wait(&empty[b], ((i >> 1) & 1) ^ 1);
        stage_band<U8>(p.x, band0 + b * bb, n, y0, nr, p.H, p.W, p.qz, tid);
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
      koff[k] = Addr::offset((k / 2) * 8 + (k % 2) * 4 + t, rb);
    }
    // [K atom][half]: a half's 128 rows start 16 KB into the atom
    const uint64_t db[2][2] = {
        {wg::desc_sw128(Bs), wg::desc_sw128(Bs + B_ATOM / 2)},
        {wg::desc_sw128(Bs + B_ATOM), wg::desc_sw128(Bs + 3 * B_ATOM / 2)}};
    if (!SLABS) wg::wait(wbar, 0);
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
          wg::mma_rs(acc0, a[kc], db[kc / 4][0] + 2 * (kc % 4), kc != 0);
        }
        wg::wgmma_commit();
#pragma unroll
        for (int kc = 0; kc < KSTEPS; ++kc) {
          wg::mma_rs(acc1, a[kc], db[kc / 4][1] + 2 * (kc % 4), kc != 0);
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

// Launches `kernel` (a run<Addr, ...> instantiation) on a grid of `grid`
// blocks. The bands are copied raw where the rows are whole 16-byte
// multiples, x is 16-byte aligned and the raw rows fit beside the rest;
// else staged from device memory.
template <class Addr, typename Kernel>
int launch(Kernel kernel, Args p, int esize, int grid, cudaStream_t st) {
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (grid < 1 || p.rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  p.esize = (3 * p.W * esize) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                    smem_bytes<Addr>(p.W, p.rows, esize) <= size_t(smem_max)
                ? esize
                : 0;
  const size_t smem = smem_bytes<Addr>(p.W, p.rows, p.esize);
  if (smem > size_t(smem_max)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.units > 0 && p.W >= 4) {
    kernel<<<grid, THREADS, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stem
