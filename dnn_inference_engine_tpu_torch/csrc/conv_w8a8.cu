// The W8A8 conv of the xla tier for Hopper (sm_90a): an implicit-GEMM int8
// conv that reads the NHWC activation in place (no im2col), accumulates in
// int32 on wgmma, and applies the conv-order epilogue, optionally followed
// by the pool-major group-max of a fold stage, in one pass.
//
// Replaces: XLA's own int8 conv of the JAX package, which is not a Pallas
// kernel: dnn_inference_engine_tpu/ops/conv.py:110 conv2d_w8a8
// (lax.conv_general_dilated with an int32 accumulator), as the fold_xla,
// fold_xla_k2, fold_xla_s2 and xla stages of runtime/plan.py run it
// (:847, :902, :927). Same function:
//   acc[n, oy, ox, o] = sum over taps (dh, dw) and ci of
//       x[n, s*oy+dh-pad_h, s*ox+dw-pad_w, ci] * w[dh, dw, ci, o]  (int32)
//   y = act(acc*scale[o] + bias[o]); q = clip(rint(y / s_out), +-127)
// (scale = s_in*s_w), the conv order of requant.cuh (mode 0, or mode 4
// where s_out is not a positive normal float), or with f32out the float32
// y itself, each step rounded (__fmul_rn, __fadd_rn) as XLA's op-by-op
// acc.astype(f32) * (s_in*s_w) + b; stride s = 1 with k = 3 SAME (pad 1)
// or k = 2 VALID (pad 0, the shifted fold), or s = 2 with k = 3 or 1 SAME
// (XLA's pads: pad_h = the smaller half of (ceil(H/2)-1)*2 + k - H, so
// none at the top of an even H: output row i reads rows 2i .. 2i+2), the
// output trimmed to (Ho, Wo). With go > 0 (Cout = 4 go) the output
// channel c < go is the max over the pool groups k of the codes
// q[k*go + c]: the group-max of the
// requantized int8 tensor that the fold stages take. The groups share
// their scale and bias (a fold stage repeats its layer's), so the kernel
// takes the code of the groups' largest accumulator (the smallest where
// scale and s_out differ in sign): requantization is monotone in the
// accumulator, so that is the largest code, exactly. (A code for each of
// the four groups, then their max, took 0.0987 ms at L2 against 0.0688,
// H100 80GB HBM3, 700.00 W.)
//
// ResNet-18's forms (224 px): f32out for its linear 3x3 convs (PATCH at
// 56 px, TAP at 28, 14 and 7), stride 2 for its 3x3/s2 convs (PATCH) and,
// k = 1, its 1x1/s2 projections (PATCH, f32out).
//
// The raw form (out_kind 2) stores acc itself, int32, with no epilogue:
// XLA's int8 conv with preferred_element_type=int32, which the
// row-parallel conv of the channel-sharded forward sums across ranks
// before its epilogue (dnn_inference_engine_tpu/parallel/
// shard_map_forward.py:96-97). Its shapes there: YOLOv2-tiny's L13 and
// YOLOv3-tiny's L12 at 13 px with Cin split over the ranks (TAP), and
// ResNet-18's L3 at 56 px, Cin 32 or 16 (PATCH).
//
// What bounds it on an H100 (SXM data sheet at 700 W: 1,979 int8 TOP/s,
// 3.35 TB/s): the int8 tensor-core rate at every b32 main-path shape
// (L2: 51.0 G operations on 33 MB; L13: 102.1 G on 12 MB); at batch 1 the
// weight bytes of the tail (1-9 MB).
//
// Design: the Hopper mainloop of wgmma_s8.cuh (a persistent grid; a
// producer warpgroup whose one thread issues every copy; two consumer
// warpgroups that take the block's units in turn, one's epilogue under
// the other's wgmma) with A brought to wgmma by one of two routes, a
// kernel chosen by the wrapper from the shape alone (ops/conv.py
// conv_w8a8_form); both read A and B by descriptor:
//
// - PATCH (conv_dma.cu's): a tile is TR x TC = 16 x 8 output pixels of one
//   image (a tile row is one 8-row core matrix of the wgmma operand) by
//   128 accumulator columns. A step is one tap row dh and KB bytes of Cin
//   (KB 64 up to Cin 64, else 128): one box {KB, TC+2, TR, 1} of a 4-D
//   tensor map over x {Cin, W, H, N} at (c0, x0-pad, y0+dh-pad, n) lands
//   in the KB-byte swizzle, and the k taps (dh, dw) of the row read it by
//   descriptor as row shifts (the patch from column dw, the next core
//   matrix TC+2 rows on). The copy engine's zero fill of out-of-range
//   coordinates is the SAME halo, the rows and columns past the input,
//   and the K padding past Cin. The swizzle follows the absolute shared
//   address, so a descriptor a row into the swizzle atom needs no base
//   offset. At stride 2 a step lands two boxes of the tap row, both with
//   the map's traversal strides 2 along W and H (every other column of
//   every other row): the even columns, TC + (k-1)/2 of them, and (k = 3)
//   the odd ones, TC; tap column dw reads the even box from column dw/2
//   (dw 0, 2) or the odd box (dw 1), the next core matrix a box row on.
//   Where one tap row is one step (Cin <= KB), a column block of
//   B (k*k taps x 128 rows x KB bytes) is resident, copied once a column
//   block, else it streams with the patches, a box a tap. M runs over the
//   trimmed (Ho, Wo) output only: L4's shifted fold of H/2+1 valid rows
//   and its zero rows up to a multiple of 8 is read where a tile needs it,
//   and no tile starts past the trimmed output.
// - TAP: k = 3 SAME with Cin % 128 == 0, untrimmed (ops/conv.py takes it
//   up to W = 31, PATCH past that), the batch folded into a flat M of
//   N*H*W rows, 128 a tile. A step is one tap (dh, dw) of one 128-byte
//   chunk of Cin: the copy engine's im2col mode (a tensor map of
//   cuTensorMapEncodeIm2col over x {Cin, W, H, N} whose bounding box is
//   the output grid) walks the tile's 128 flat pixels from the first
//   one's top-left tap, across rows and images, each pixel sampled at the
//   tap's offset, zero where that leaves its image, into a 128 x 128-byte
//   A tile in the 128-byte swizzle; B's (tap, chunk) box lands beside it,
//   and wgmma reads both by descriptor (gemm_fused's mainloop,
//   wg::mma_unit). A crosses L2 once a tap, 16 KB a step as B does. A
//   window route (conv3x3_bt.cu's resident window of flat rows, A into
//   registers by ldmatrix, each lane redirecting its row to a zero row
//   where a tap leaves the image) moves about half those bytes but was
//   slower at every shape measured: L13 at b32 0.1274 ms against 0.0816
//   (H100 80GB HBM3, 700.00 W; PERF.md).
//
// The schedule (shared; ops/conv.py conv_schedule works it out from the
// shape): tiles are walked in (column block, pixel tile) order (PATCH) or
// (row tile, column block) order (TAP), each of `steps` K steps. The
// first sk_tiles tiles are summed stream-K: their sk_tiles * steps (tile,
// step) iterations are cut into sk_blocks ranges as even as integers
// allow, block b < sk_blocks taking the b-th, a piece a tile it touches;
// the rest go round robin, whole. A block runs its pieces, then its whole
// tiles, its consumers taking them in turn. A tile whose pieces lie on
// several blocks is summed by wg::splitk_fixup: each piece writes its
// partial sum to its slot (the block's place among the tile's blocks),
// and the last to arrive adds the others and runs the epilogue.
//
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "mma_s8.cuh"
#include "requant.cuh"
#include "tma.cuh"
#include "wgmma_s8.cuh"

namespace {

constexpr int BM = wg::BM;      // output pixels a tile
constexpr int BN = wg::BN;      // accumulator columns a tile
constexpr int GN = BN / 4;      // channels of each pool group a tile
constexpr int NREG = wg::NREG;
constexpr int STAGING = BM * BN;          // a consumer's tile of codes
constexpr int SCB = 2 * BN * 4;           // a consumer's scale and bias

// PATCH: a tile's output rows and columns, a stride-1 patch row's columns
// (the halo's)
constexpr int TR = 16;
constexpr int TC = 8;
constexpr int PC = TC + 2;

// TAP: bytes of Cin a chunk, the ring's stages
constexpr int KC = 128;
constexpr int TSTAGES = 5;

struct Conv {
  const float* scale;           // (Cout,)
  const float* bias;
  int8_t* out;                  // (N, Ho, Wo, go ? go : Cout)
  float* outf;                  // f32out: (N, Ho, Wo, Cout)
  int* outi;                    // raw: (N, Ho, Wo, Cout) int32
  int* ws;                      // straddled tiles' partial sums
  int* counters;                // their arrival counters, zero
  int H, W, Cin, Ho, Wo, Cout;
  int go;                       // channels a pool group, 0: no group-max
  int ks, pad_h, pad_w, act, mode, f32out, raw;
  rq::Requant q;
  int n_tiles;                  // column blocks
  // the schedule: tiles of `steps` K steps; the first sk_tiles stream-K
  // over sk_blocks blocks, `slots` partial sums a tile
  int tiles, steps, sk_tiles, sk_blocks, slots;
  // PATCH
  int kc;                       // steps a tap row: ceil(Cin / KB)
  int rtiles, ctiles, ptiles;   // row tiles, column tiles an image; tiles
  // TAP
  int M;                        // N H W
};

// ---------------------------------------------------------------------------
// The schedule
// ---------------------------------------------------------------------------

// A block's stream-K iterations [s0, s1) and its count of units: its
// pieces (n_sk), then its round-robin tiles.
struct Span {
  long long s0, s1;
  int n_sk, n;
};

// A unit: tile `tile`, K steps [sb, se); a piece of a tile on `parts` > 1
// blocks, in partial-sum slot `slot`.
struct Work {
  int tile, sb, se, slot, parts;
};

__host__ __device__ inline int sk_block_of(long long it, int sk_blocks,
                                           long long total) {
  return static_cast<int>(((it + 1) * sk_blocks - 1) / total);
}

__device__ __forceinline__ Span span(const Conv& p) {
  const int b = blockIdx.x;
  Span s{0, 0, 0, 0};
  if (b < p.sk_blocks) {
    const long long total = static_cast<long long>(p.sk_tiles) * p.steps;
    s.s0 = b * total / p.sk_blocks;
    s.s1 = (b + 1) * total / p.sk_blocks;
    s.n_sk = static_cast<int>((s.s1 - 1) / p.steps - s.s0 / p.steps + 1);
  }
  const int dp = p.tiles - p.sk_tiles - b;     // whole tiles from block b
  s.n = s.n_sk + (dp > 0 ? (dp - 1) / static_cast<int>(gridDim.x) + 1 : 0);
  return s;
}

__device__ __forceinline__ Work work(const Conv& p, const Span& s, int i) {
  Work w;
  if (i < s.n_sk) {
    const long long total = static_cast<long long>(p.sk_tiles) * p.steps;
    w.tile = static_cast<int>(s.s0 / p.steps) + i;
    const long long x0 = static_cast<long long>(w.tile) * p.steps;
    w.sb = static_cast<int>(s.s0 > x0 ? s.s0 - x0 : 0);
    w.se = static_cast<int>(s.s1 - x0 < p.steps ? s.s1 - x0 : p.steps);
    const int first = sk_block_of(x0, p.sk_blocks, total);
    w.slot = static_cast<int>(blockIdx.x) - first;
    w.parts = sk_block_of(x0 + p.steps - 1, p.sk_blocks, total) - first + 1;
  } else {
    w.tile = p.sk_tiles + static_cast<int>(blockIdx.x) +
             (i - s.n_sk) * static_cast<int>(gridDim.x);
    w.sb = 0;
    w.se = p.steps;
    w.slot = 0;
    w.parts = 1;
  }
  return w;
}

// ---------------------------------------------------------------------------
// The epilogue
// ---------------------------------------------------------------------------

// The output pixel of tile row r (n, oy, ox flattened over (N, Ho, Wo)),
// or -1 where the row lies past the output. PATCH: tile t is TR x TC
// pixels of one image; TAP: tile t is flat rows 128 t ...
template <bool PATCH_ROUTE>
__device__ __forceinline__ long long out_pixel(const Conv& p, int t, int r) {
  if (PATCH_ROUTE) {
    const int n = t / (p.rtiles * p.ctiles);
    const int rest = t - n * p.rtiles * p.ctiles;
    const int oy = rest / p.ctiles * TR + r / TC;
    const int ox = rest % p.ctiles * TC + r % TC;
    if (oy >= p.Ho || ox >= p.Wo) return -1;
    return (static_cast<long long>(n) * p.Ho + oy) * p.Wo + ox;
  }
  const int m = t * BM + r;
  return m < p.M ? m : -1;
}

// Consumer thread tid's column of the tile's scale and bias: column cl of
// column block nt is channel nt*128 + cl, or with the group-max channel
// k*go + nt*32 + i of pool group k = cl / 32, i = cl % 32 (zeros past the
// output).
__device__ __forceinline__ void load_scb(float* sc_s, float* bi_s,
                                         const Conv& p, int nt, int cl) {
  if (p.raw) return;            // no epilogue: scale and bias unused
  int col;
  bool ok;
  if (p.go) {
    const int ch = nt * GN + cl % GN;
    ok = ch < p.go;
    col = cl / GN * p.go + ch;
  } else {
    col = nt * BN + cl;
    ok = col < p.Cout;
  }
  sc_s[cl] = ok ? p.scale[col] : 0.f;
  bi_s[cl] = ok ? p.bias[col] : 0.f;
}

// The accumulator whose code is the largest of four groups' codes under
// one scale and bias: the code is monotone in the accumulator (every step
// rounds monotonically), rising where scale and s_out have one sign,
// falling where they differ.
__device__ __forceinline__ int pick(int a0, int a1, int a2, int a3, float sc,
                                    const Conv& p) {
  return (sc >= 0.f) == (p.q.s_out >= 0.f)
             ? max(max(a0, a1), max(a2, a3))
             : min(min(a0, a1), min(a2, a3));
}

// A fast-path quotient this close to a half-integer (or nearer) takes
// div_rn: 2^-14, more than twice the farthest that q0 = RN(y rs) and
// RN(y / s) lie apart where a code is decided (|y / s| < 128: q0 within
// 2^-16 of y/s, RN(y/s) within 2^-18).
constexpr float NEAR = 0.5f - 0x1p-14f;

// Accumulator k of a group of 8 codes: (m64 half q, row half h, column e)
// = (k / 4, (k / 2) % 2, k % 2) at register 64q + 4j + 2h + e of group j
// (group j holds columns 8j + 2t + e); with the group-max, the extreme of
// the four pool groups' registers 16 apart (group k of channel 8j + 2t +
// e is register 4j + 2h + e + 16k of the half).
template <bool GMAX>
__device__ __forceinline__ int group_acc(const int (&acc)[NREG], int j,
                                         int k, float sc, const Conv& p) {
  const int i = 64 * (k / 4) + 4 * j + 2 * ((k / 2) % 2) + k % 2;
  return GMAX ? pick(acc[i], acc[i + 16], acc[i + 32], acc[i + 48], sc, p)
              : acc[i];
}

// Stages the 8 codes of group j (rows 64q + 16w + g + 8h, columns cl and
// cl + 1), two to a 16-bit store.
template <bool GMAX>
__device__ __forceinline__ void stage8(uint8_t* staging, const uint32_t (&q)[8],
                                       int cl, int w, int g) {
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    const int r = 64 * (k / 4) + 16 * w + g + 8 * ((k / 2) % 2);
    const uint16_t v =
        static_cast<uint16_t>(__byte_perm(q[k], q[k + 1], 0x0040));
    if (GMAX) {
      *reinterpret_cast<uint16_t*>(staging + r * GN + cl) = v;
    } else {
      const int chunk = (cl >> 4) ^ (r & 7);
      *reinterpret_cast<uint16_t*>(staging + r * BN + chunk * 16 +
                                   (cl & 15)) = v;
    }
  }
}

// Consumer c's codes of tile t, column block nt: acc[64q + 4j + 2h + e]
// is tile row 64q + 16w + g + 8h, column 8j + 2t + e. Without the
// group-max the 128 x 128 codes go through the swizzled staging (16-byte
// chunks XOR-ed with the row) as gemm_fused.cu stores them; with it the
// max over the four groups of each of the thread's 8 channels a row, 32
// bytes a row, one code a channel from the groups' extreme accumulator
// (pick). Then each staged row goes to its output pixel, 16 bytes a
// thread. MODE, ACT (-1: the launch's p.act) and GMAX are template
// arguments so that a thread's 128 codes are straight-line code the
// compiler interleaves: with the activation a branch in every code, the
// codes ran one after another.
//
// With the group-max, mode 0 takes less arithmetic, bit for bit
// (rq::code's conv order): the code is rint(clip(q0, +-127)) for q0 =
// RN(y rs) (code_bits), without div_rn's two corrections. Where no
// half-integer within NEAR of clip(q0) lies between q0 and RN(y/s) (they
// lie within 2^-15), rint of both is one integer, so that is the code.
// Only a group of 8 codes where some lane of the warp has a quotient that
// near is redone, with the clamp and div_rn: a uniform branch a group,
// taken about once in 30. Clipping before rint moves no code: every
// quotient past +-126.5 gives +-127 either way, and an overflowing q0
// (+-inf) clips to +-127 as RN(y / s) past +-128 s does. Measured (H100
// 80GB HBM3, 700.00 W; PERF.md): L2 0.0625 ms against 0.0724 with the
// corrections in every code, L4 0.0412 against 0.0463. Without the
// group-max a thread has 16 groups, and the vote a group cost more than
// the corrections saved (L6 0.0451 against 0.0434); holding the
// accumulators for a second pass over the marked groups spilled (L6
// 0.0544): that epilogue stays the straight-line conv order. So does
// requant.cuh's, which gemm_fused.cu shares: its codes have no group-max.
template <int MODE, int ACT, bool GMAX, bool PATCH_ROUTE>
__device__ __forceinline__ void store(const int (&acc)[NREG],
                                      uint8_t* staging, const float* sc_s,
                                      const float* bi_s, const Conv& p,
                                      int t_pix, int nt, int c) {
  constexpr bool FAST = MODE == 0 && GMAX;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int act = ACT >= 0 ? ACT : p.act;
#pragma unroll
  for (int j = 0; j < (GMAX ? 4 : BN / 8); ++j) {
    const int cl = 8 * j + 2 * t;
    const float2 sc = *reinterpret_cast<const float2*>(sc_s + cl);
    const float2 bi = *reinterpret_cast<const float2*>(bi_s + cl);
    uint32_t q[8];
    bool near = false;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float s = k & 1 ? sc.y : sc.x, b = k & 1 ? bi.y : bi.x;
      const int a = group_acc<GMAX>(acc, j, k, s, p);
      if (FAST) {
        const float y = s8mma::epilogue_f32(a, s, b, act);
        const float q0 = fminf(fmaxf(__fmul_rn(y, p.q.rs_out), -127.f),
                               127.f);
        const float r = __fadd_rn(q0, 12582912.f);  // rint(q0) + 1.5 2^23
        const float f = __fsub_rn(q0, __fsub_rn(r, 12582912.f));
        near |= fabsf(f) >= NEAR;
        q[k] = static_cast<uint32_t>(__float_as_int(r));
      } else {
        q[k] = rq::code<MODE>(a, s, b, act, p.q);
      }
    }
    if (FAST && __any_sync(0xffffffffu, near)) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float s = k & 1 ? sc.y : sc.x, b = k & 1 ? bi.y : bi.x;
        q[k] = rq::code<0>(group_acc<GMAX>(acc, j, k, s, p), s, b, act,
                           p.q);
      }
    }
    stage8<GMAX>(staging, q, cl, w, g);
  }
  wg::warpgroup_sync(c);
  constexpr int ROW = GMAX ? GN : BN;       // staged bytes a row
  constexpr int CPR = ROW / 16;             // 16-byte chunks a row
  const int oc = GMAX ? p.go : p.Cout;      // output channels a pixel
  const int col0 = nt * ROW;
#pragma unroll
  for (int k = 0; k < BM * CPR / 128; ++k) {
    const int ch = k * 128 + tid;
    const int r = ch / CPR, cc = ch % CPR;
    const int col = col0 + cc * 16;
    const long long pix = out_pixel<PATCH_ROUTE>(p, t_pix, r);
    if (pix < 0 || col >= oc) continue;
    const int4 v = *reinterpret_cast<const int4*>(
        staging + r * ROW + (GMAX ? cc : (cc ^ (r & 7))) * 16);
    int8_t* dst = p.out + pix * oc + col;
    if ((oc & 15) == 0) {
      *reinterpret_cast<int4*>(dst) = v;
    } else {
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
      for (int e = 0; e < 16 && col + e < oc; ++e) dst[e] = b[e];
    }
  }
}

// The f32 output (f32out): each of the thread's accumulator pairs (tile
// row 64q + 16w + g + 8h, columns 8j + 2t and + 1) as y = act(acc*scale
// + bias), rounded step by step, straight to its output pixel, 8 bytes a
// store (32 contiguous bytes a row of a warp's store). The warpgroup then
// syncs: the next unit's load_scb rewrites the scale and bias read here.
template <bool PATCH_ROUTE>
__device__ __forceinline__ void store_f32(const int (&acc)[NREG],
                                          const float* sc_s,
                                          const float* bi_s, const Conv& p,
                                          int t_pix, int nt, int c) {
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  long long pix[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    pix[r] = out_pixel<PATCH_ROUTE>(p, t_pix, 64 * (r / 2) + 16 * w + g +
                                                  8 * (r % 2));
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cl = 8 * j + 2 * t;
    const int col = nt * BN + cl;
    if (col >= p.Cout) continue;
    const float2 sc = *reinterpret_cast<const float2*>(sc_s + cl);
    const float2 bi = *reinterpret_cast<const float2*>(bi_s + cl);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (pix[r] < 0) continue;
      const int i = 64 * (r / 2) + 4 * j + 2 * (r % 2);
      float2 y;
      y.x = s8mma::epilogue_f32(acc[i], sc.x, bi.x, p.act);
      y.y = s8mma::epilogue_f32(acc[i + 1], sc.y, bi.y, p.act);
      float* dst = p.outf + pix[r] * p.Cout + col;
      if ((p.Cout & 1) == 0) {
        *reinterpret_cast<float2*>(dst) = y;
      } else {
        dst[0] = y.x;
        if (col + 1 < p.Cout) dst[1] = y.y;
      }
    }
  }
  wg::warpgroup_sync(c);
}

// The int32 accumulator (raw): each of the thread's accumulator pairs,
// as store_f32 walks them, straight to its output pixel, 8 bytes a store.
// A tile of sums is 64 KB, four times its int8 codes, more than the 16 KB
// staging a consumer has: the store takes no staging, so the shared
// memory of every form stays as it was.
template <bool PATCH_ROUTE>
__device__ __forceinline__ void store_i32(const int (&acc)[NREG],
                                          const Conv& p, int t_pix, int nt) {
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  long long pix[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    pix[r] = out_pixel<PATCH_ROUTE>(p, t_pix, 64 * (r / 2) + 16 * w + g +
                                                  8 * (r % 2));
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = nt * BN + 8 * j + 2 * t;
    if (col >= p.Cout) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (pix[r] < 0) continue;
      const int i = 64 * (r / 2) + 4 * j + 2 * (r % 2);
      int* dst = p.outi + pix[r] * p.Cout + col;
      if ((p.Cout & 1) == 0) {
        *reinterpret_cast<int2*>(dst) = make_int2(acc[i], acc[i + 1]);
      } else {
        dst[0] = acc[i];
        if (col + 1 < p.Cout) dst[1] = acc[i + 1];
      }
    }
  }
}

// The main paths' variant (conv order, leaky) in straight-line code; the
// other activations and mode 4, which no pin reaches, read p.act; the f32
// output of a linear conv (ResNet-18) its own store. GROUPS false leaves
// out the group-max variants (the stride-2 forms have none), which keeps
// the file's build time down.
template <bool PATCH_ROUTE, bool GROUPS = true>
__device__ __forceinline__ void epilogue(const int (&acc)[NREG],
                                         uint8_t* staging, const float* sc_s,
                                         const float* bi_s, const Conv& p,
                                         int t_pix, int nt, int c) {
  if (p.raw) {
    store_i32<PATCH_ROUTE>(acc, p, t_pix, nt);
    return;
  }
  if (p.f32out) {
    store_f32<PATCH_ROUTE>(acc, sc_s, bi_s, p, t_pix, nt, c);
    return;
  }
  const bool leaky = p.mode == 0 && p.act == 1;
  switch ((p.mode == 4) * 4 + leaky * 2 + (GROUPS && p.go != 0)) {
    case 0: store<0, -1, false, PATCH_ROUTE>(acc, staging, sc_s, bi_s, p,
                                             t_pix, nt, c); break;
    case 1:
      if constexpr (GROUPS) {
        store<0, -1, true, PATCH_ROUTE>(acc, staging, sc_s, bi_s, p, t_pix,
                                        nt, c);
      }
      break;
    case 2: store<0, 1, false, PATCH_ROUTE>(acc, staging, sc_s, bi_s, p,
                                            t_pix, nt, c); break;
    case 3:
      if constexpr (GROUPS) {
        store<0, 1, true, PATCH_ROUTE>(acc, staging, sc_s, bi_s, p, t_pix,
                                       nt, c);
      }
      break;
    case 4: store<4, -1, false, PATCH_ROUTE>(acc, staging, sc_s, bi_s, p,
                                             t_pix, nt, c); break;
    default:
      if constexpr (GROUPS) {
        store<4, -1, true, PATCH_ROUTE>(acc, staging, sc_s, bi_s, p, t_pix,
                                        nt, c);
      }
      break;
  }
}

// The split tile's sum: true when this piece completed it (acc holds the
// whole sum) or the unit is a whole tile; false when another piece will.
__device__ __forceinline__ bool summed(int (&acc)[NREG], const Conv& p,
                                       const Work& x, int* flag, int c,
                                       int rows) {
  return x.parts == 1 ||
         wg::splitk_fixup(acc, p.ws, p.counters, flag, c, x.tile, x.slot,
                          p.slots, rows, x.parts);
}

// ---------------------------------------------------------------------------
// PATCH
// ---------------------------------------------------------------------------

// A step's A: at stride 1 one box of PE = PC columns (TC + 2 whatever
// KS, as the map is encoded); at stride 2 the even columns (PE) and the
// odd ones (PO, none for KS 1), TR rows each. Every box is a multiple of
// 1024 bytes, so each lands on the swizzle's period.
template <int KB, bool RES, int KS, int ST>
struct Patch {
  static_assert(RES || KB == 128, "B streams only in 128-byte steps");
  static_assert(ST == 1 || (ST == 2 && (KS == 1 || KS == 3)),
                "stride 2 takes k = 1 and k = 3");
  static constexpr int PE = ST == 1 ? PC : TC + (KS - 1) / 2;
  static constexpr int PO = ST == 1 || KS == 1 ? 0 : TC + (KS - 2) / 2;
  static constexpr int E_BYTES = TR * PE * KB;
  static constexpr int A_BYTES = TR * (PE + PO) * KB;
  static constexpr int B_TAP = BN * KB;       // one tap's B of a step
  static constexpr int STAGE_BYTES = RES ? A_BYTES : A_BYTES + KS * B_TAP;
  static constexpr int STAGES =
      KB == 64 ? (ST == 2 && KS == 3 ? 6 : 8) : (KS == 1 ? 4 : 2);
  // dynamic shared memory: alignment slack, the resident B (ks*ks taps),
  // the ring, the staging and scale/bias of both consumers, the barriers
  // (full, empty, B full, B empty, two turns) and a flag per consumer
  static constexpr int smem(int kc) {
    return 1024 + (RES ? KS * KS * kc * B_TAP : 0) + STAGES * STAGE_BYTES +
           2 * STAGING + 2 * SCB + (2 * STAGES + 4) * 8 + 16;
  }
};

template <int KB>
__device__ __forceinline__ uint64_t desc_b(const void* p) {
  return KB == 64 ? wg::desc_sw64(p) : wg::desc_sw128(p);
}

// The descriptor of tap column dw's A in a box of `cols` columns: core
// matrix j (tile row j, 8 pixels) is box row j from the tap's column, so
// KB-byte rows from p (the box + that column * KB), the next core matrix
// a box row (cols rows) on; the KB-byte swizzle, base offset 0.
template <int KB>
__device__ __forceinline__ uint64_t desc_patch(const void* p, int cols) {
  const uint64_t a = tma::smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(cols * KB >> 4) << 32) | (uint64_t(KB == 64 ? 2 : 1) << 62);
}

// A patch tile: column block nt (outermost, so that a block walks one
// column block's resident B as long as it can), pixel tile pt.
__device__ __forceinline__ void patch_tile(const Conv& p, int tile, int& nt,
                                           int& pt) {
  nt = tile / p.ptiles;
  pt = tile - nt * p.ptiles;
}

// KS (the kernel size) is a template argument: with the taps of a step a
// runtime loop, ptxas fenced the wgmma (warpgroup.arrive injected, C7519).
// ST is the stride; at 2 map_x lands the even columns, map_o the odd.
template <int KB, bool RES, int KS, int ST>
__global__ void __launch_bounds__(wg::THREADS, 1)
conv_patch_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_o,
                  const __grid_constant__ CUtensorMap map_b, const Conv p) {
  using C = Patch<KB, RES, KS, ST>;
  constexpr int STAGES = C::STAGES;
  constexpr int B_TAP = C::B_TAP;
  constexpr int taps = KS * KS;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sa = tma::smem_addr(smem);
  uint8_t* bres = smem + ((1024 - (sa & 1023)) & 1023);
  uint8_t* ring = bres + (RES ? taps * p.kc * B_TAP : 0);
  uint8_t* staging_all = ring + STAGES * C::STAGE_BYTES;
  float* scb = reinterpret_cast<float*>(staging_all + 2 * STAGING);
  uint64_t* full = reinterpret_cast<uint64_t*>(scb + 2 * 2 * BN);
  uint64_t* empty = full + STAGES;
  uint64_t* bfull = empty + STAGES;
  uint64_t* bempty = bfull + 1;
  uint64_t* turn = bempty + 1;
  int* flags = reinterpret_cast<int*>(turn + 2);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      tma::mbar_init(&full[i], 1);
      tma::mbar_init(&empty[i], 4);       // the owning consumer's warps
    }
    tma::mbar_init(bfull, 1);
    tma::mbar_init(bempty, 8);            // both consumers' warps
    tma::mbar_init(&turn[0], 1);
    tma::mbar_init(&turn[1], 1);
    tma::fence_barrier_init();
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_x)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
    if (C::PO) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&map_o)) : "memory");
    }
  }
  __syncthreads();

  const Span sp = span(p);
  if (threadIdx.x < 128) {
    // --- producer: one thread issues every box ---
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    wg::Pipe<STAGES> pipe;
    int cur = -1;                          // the resident column block
    uint32_t gen = 0;                      // resident B copies so far
    for (int i = 0; i < sp.n; ++i) {
      const Work x = work(p, sp, i);
      int nt, pt;
      patch_tile(p, x.tile, nt, pt);
      const int n = pt / (p.rtiles * p.ctiles);
      const int rest = pt - n * p.rtiles * p.ctiles;
      const int y0 = rest / p.ctiles * TR, x0 = rest % p.ctiles * TC;
      if (RES && nt != cur) {
        // B of tap b / kc, Cin chunk b % kc at bres + b B_TAP
        if (gen > 0) wg::wait(bempty, (gen - 1) & 1);
        tma::mbar_expect_tx(bfull, taps * p.kc * B_TAP);
        for (int b = 0; b < taps * p.kc; ++b) {
          const int tap = b / p.kc, c0 = (b - tap * p.kc) * KB;
          wg::tma_load_2d(bres + b * B_TAP, &map_b, bfull, tap * p.Cin + c0,
                          nt * BN);
        }
        cur = nt;
        ++gen;
      }
      for (int s = x.sb; s < x.se; ++s) {
        // step s: tap row dh = s / kc, Cin chunk s % kc: the patch of rows
        // ST*y0+dh-pad_h + ST*j, columns ST*x0-pad_w + ST*i (+1: odd box)
        const int dh = s / p.kc, c0 = (s - dh * p.kc) * KB;
        const int iy = ST * y0 + dh - p.pad_h, ix = ST * x0 - p.pad_w;
        uint8_t* st = ring + pipe.stage * C::STAGE_BYTES;
        wg::wait(&empty[pipe.stage], pipe.phase ^ 1);
        tma::mbar_expect_tx(&full[pipe.stage],
                            C::A_BYTES + (RES ? 0 : KS * B_TAP));
        wg::tma_load_4d(st, &map_x, &full[pipe.stage], c0, ix, iy, n);
        if (C::PO) {
          wg::tma_load_4d(st + C::E_BYTES, &map_o, &full[pipe.stage], c0,
                          ix + 1, iy, n);
        }
        if (!RES) {
          for (int dw = 0; dw < KS; ++dw) {
            wg::tma_load_2d(st + C::A_BYTES + dw * B_TAP, &map_b,
                            &full[pipe.stage], (KS * dh + dw) * p.Cin + c0,
                            nt * BN);
          }
        }
        pipe.advance();
      }
    }
    return;
  }

  // --- consumers: c takes the block's units 2k + c ---
  wg::setmaxnreg_inc<232>();
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const bool lead = threadIdx.x % 32 == 0;
  uint8_t* staging = staging_all + c * STAGING;
  float* sc_s = scb + c * 2 * BN;
  float* bi_s = sc_s + BN;
  wg::Pipe<STAGES> pipe;
  int acc[NREG];
  int cur = -1;
  uint32_t gen = 0;
  bool have_b = !RES;
  int k = 0;
  for (int i = 0; i < sp.n; ++i) {
    const Work x = work(p, sp, i);
    int nt, pt;
    patch_tile(p, x.tile, nt, pt);
    if (RES && nt != cur) {
      // This consumer is done with the last column block's B (its wgmma
      // retired at the end of its last unit). It arrives once a copy, and
      // not before the other consumer matched its arrival for the copy
      // before: a consumer that owns no unit of a column block must not
      // count twice in one phase of the barrier.
      if (gen > 0) {
        if (gen > 1) wg::wait(bempty, (gen - 2) & 1);
        if (lead) wg::mbar_arrive(bempty);
      }
      cur = nt;
      ++gen;
      have_b = false;
    }
    if ((i & 1) != c) {
      pipe.skip(x.se - x.sb);
      continue;
    }
    // the tile's scale and bias, for the epilogue; the previous tile's
    // were read before its epilogue's middle warpgroup_sync
    load_scb(sc_s, bi_s, p, nt, tid);
    wg::take_turn(turn, c, k++);
    if (!have_b) {
      // Waited after the turn (conv_dma.cu): the block's previous unit,
      // the other consumer's, waited for its own copy, and the producer
      // issues no later copy before this consumer releases this one, so
      // bfull is at most one phase behind and the parity wait is exact.
      wg::wait(bfull, (gen - 1) & 1);
      have_b = true;
    }
    int prev = -1;
    for (int s = x.sb; s < x.se; ++s) {
      wg::wait(&full[pipe.stage], pipe.phase);
      const int dh = s / p.kc, kq = s - dh * p.kc;
      const uint8_t* st = ring + pipe.stage * C::STAGE_BYTES;
      wg::fence_acc(acc);
      wg::wgmma_fence();
#pragma unroll
      for (int dw = 0; dw < KS; ++dw) {
        // tap (dh, dw): the patch from column dw (stride 2: the even box
        // from column dw/2, or the odd box); tile rows 8.. (the second m64
        // half) start 8 box rows on
        const bool odd = ST == 2 && (dw & 1);
        const int cols = odd ? C::PO : C::PE;
        const uint64_t da = desc_patch<KB>(
            st + (odd ? C::E_BYTES : 0) + (ST == 1 ? dw : dw / 2) * KB, cols);
        const uint64_t db = desc_b<KB>(
            RES ? bres + ((KS * dh + dw) * p.kc + kq) * B_TAP
                : st + C::A_BYTES + dw * B_TAP);
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk) {
          const int on = (s != x.sb) | dw | kk;
          wg::Mma<BN>::run(acc, da + 2 * kk, db + 2 * kk, on);
          wg::Mma<BN>::run(acc + 64, da + (8 * cols * KB >> 4) + 2 * kk,
                           db + 2 * kk, on);
        }
      }
      wg::wgmma_commit();
      wg::fence_acc(acc);
      if (prev >= 0) {
        wg::wgmma_wait<1>();
        if (lead) wg::mbar_arrive(&empty[prev]);
      }
      prev = pipe.stage;
      pipe.advance();
    }
    if (tid == 0) wg::mbar_arrive(&turn[1 - c]);
    wg::wgmma_wait<0>();
    wg::fence_acc(acc);
    if (lead) wg::mbar_arrive(&empty[prev]);
    if (!summed(acc, p, x, &flags[c], c, BM)) continue;
    wg::warpgroup_sync(c);      // scale and bias written, staging free
    epilogue<true, ST == 1>(acc, staging, sc_s, bi_s, p, pt, nt, c);
  }
}

// ---------------------------------------------------------------------------
// TAP
// ---------------------------------------------------------------------------

constexpr int TAP_SMEM = wg::smem_bytes(TSTAGES, 2 * STAGING + 2 * SCB);

// A flat tile: row tile mt (outermost), column block nt.
__device__ __forceinline__ void flat_tile(const Conv& p, int tile, int& mt,
                                          int& nt) {
  mt = tile / p.n_tiles;
  nt = tile - mt * p.n_tiles;
}

// One thread: the im2col box of a 4-D map (128 pixels x 128 channels from
// channel c0) walking the map's bounding box from pixel (w, h, n), each
// pixel sampled at offset (ow, oh), into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_im2col(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c0, int w,
                                                int h, int n, uint16_t ow,
                                                uint16_t oh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n"
      :: "r"(tma::smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(tma::smem_addr(bar)), "r"(c0), "r"(w), "r"(h), "r"(n),
         "h"(ow), "h"(oh)
      : "memory");
}

__global__ void __launch_bounds__(wg::THREADS, 1)
conv_tap_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_b, const Conv p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const wg::Ring<TSTAGES> ring(smem, 2 * STAGING + 2 * SCB);
  uint8_t* staging_all = ring.extra;
  float* scb = reinterpret_cast<float*>(staging_all + 2 * STAGING);
  if (threadIdx.x == 0) {
    ring.init(1);
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_x)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
  }
  __syncthreads();
  const Span sp = span(p);

  if (threadIdx.x < 128) {
    // --- producer: one thread issues every box ---
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    wg::Pipe<TSTAGES> pipe;
    for (int i = 0; i < sp.n; ++i) {
      const Work x = work(p, sp, i);
      int mt, nt;
      flat_tile(p, x.tile, mt, nt);
      // the tile's first output pixel; the walk starts at its top-left tap
      const int m0 = mt * BM;
      const int n = m0 / (p.H * p.W), r = m0 - n * p.H * p.W;
      const int oy = r / p.W, ox = r - oy * p.W;
      for (int s = x.sb; s < x.se; ++s) {
        // step s: chunk s / 9, tap (dh, dw) = ((s % 9) / 3, (s % 9) % 3)
        const int ch = s / 9, tap = s - 9 * ch;
        wg::wait(&ring.empty[pipe.stage], pipe.phase ^ 1);
        tma::mbar_expect_tx(&ring.full[pipe.stage], wg::STAGE_BYTES);
        tma_load_im2col(ring.a(pipe.stage), &map_x, &ring.full[pipe.stage],
                        ch * KC, ox - 1, oy - 1, n,
                        static_cast<uint16_t>(tap % 3),
                        static_cast<uint16_t>(tap / 3));
        wg::tma_load_2d(ring.b(pipe.stage), &map_b, &ring.full[pipe.stage],
                        tap * p.Cin + ch * KC, nt * BN);
        pipe.advance();
      }
    }
    return;
  }

  // --- consumers: c takes the block's units 2k + c ---
  wg::setmaxnreg_inc<232>();
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  uint8_t* staging = staging_all + c * STAGING;
  float* sc_s = scb + c * 2 * BN;
  float* bi_s = sc_s + BN;
  wg::Pipe<TSTAGES> pipe;
  int acc[NREG];
  int k = 0;
  for (int i = 0; i < sp.n; ++i) {
    const Work x = work(p, sp, i);
    if ((i & 1) != c) {
      pipe.skip(x.se - x.sb);
      continue;
    }
    int mt, nt;
    flat_tile(p, x.tile, mt, nt);
    // the tile's scale and bias, for the epilogue; the previous tile's
    // were read before its epilogue's middle warpgroup_sync
    load_scb(sc_s, bi_s, p, nt, tid);
    wg::mma_unit<TSTAGES, false>(acc, ring, pipe, x.se - x.sb, c, k++);
    if (!summed(acc, p, x, &ring.flags[c], c, p.M - mt * BM)) continue;
    wg::warpgroup_sync(c);      // scale and bias written, staging free
    epilogue<false>(acc, staging, sc_s, bi_s, p, mt, nt, c);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Sets a kernel's dynamic shared memory limit once per device.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, unsigned* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(*done & (1u << (dev & 31)))) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err == cudaSuccess) *done |= 1u << (dev & 31);
  }
  return err;
}

template <int KB, bool RES, int KS, int ST>
int launch_patch(const CUtensorMap& mx, const CUtensorMap& mo,
                 const CUtensorMap& mb, const Conv& p, int grid,
                 cudaStream_t st) {
  using C = Patch<KB, RES, KS, ST>;
  static unsigned done = 0;
  // the attribute once, at the most this instantiation takes (kc 1
  // where B is resident: the only kc a resident launch has)
  const cudaError_t err = allow_smem(conv_patch_kernel<KB, RES, KS, ST>,
                                     C::smem(RES ? 1 : 0), &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_patch_kernel<KB, RES, KS, ST><<<grid, wg::THREADS, C::smem(p.kc),
                                       st>>>(mx, mo, mb, p);
  return static_cast<int>(cudaGetLastError());
}

// B is resident where one tap row is one step (kc 1) and it fits beside
// the ring: not for the stride-2 k3 form at 128-byte steps (9 taps of 16
// KB and two 34 KB stages pass the 227 KB a block can have).
template <int KS, int ST>
int launch_patch_ks(const CUtensorMap& mx, const CUtensorMap& mo,
                    const CUtensorMap& mb, const Conv& p, int kb, int grid,
                    cudaStream_t st) {
  if (kb == 64) return launch_patch<64, true, KS, ST>(mx, mo, mb, p, grid, st);
  if constexpr (ST == 1 || KS == 1) {
    if (p.kc == 1) {
      return launch_patch<128, true, KS, ST>(mx, mo, mb, p, grid, st);
    }
  }
  return launch_patch<128, false, KS, ST>(mx, mo, mb, p, grid, st);
}

// The most blocks that share one stream-K tile: the partial-sum slots a
// tile needs.
int sk_slots(const Conv& p) {
  const long long total = static_cast<long long>(p.sk_tiles) * p.steps;
  int most = 1;
  for (int t = 0; t < p.sk_tiles; ++t) {
    const long long x0 = static_cast<long long>(t) * p.steps;
    const int parts = sk_block_of(x0 + p.steps - 1, p.sk_blocks, total) -
                      sk_block_of(x0, p.sk_blocks, total) + 1;
    most = parts > most ? parts : most;
  }
  return most;
}

// XLA's SAME padding before the input along one dimension of n: the
// smaller half of the total a k-wide window at stride s needs.
int same_lo(int n, int k, int s) {
  const int total = ((n + s - 1) / s - 1) * s + k - n;
  return total > 0 ? total / 2 : 0;
}

}  // namespace

// route 0 (PATCH) or 1 (TAP), as ops/conv.py conv_w8a8_form chooses: x
// (N, H, W, Cin) int8, 16-byte aligned, Cin % 16 == 0 (TAP: % 128, ks 3,
// stride 1, Ho == H, Wo == W); wt the (rows, ks*ks*Cin)
// K-major weight matrix (go 0: (Cout, K); go > 0: rs_tile_matrix's
// pool-major (ceil(go/32)*128, K) with Cout == 4 go), 16-byte aligned; ks
// 3 (SAME) or 2 (VALID) at stride 1, ks 3 or 1 (SAME, PATCH, no group-max)
// at stride 2, the output trimmed to (Ho, Wo); kb 64 or 128
// bytes of Cin a PATCH step (64 iff Cin <= 64); `steps` a tile's K steps
// (PATCH: ks*ceil(Cin/kb); TAP: 9*Cin/128), checked; the schedule
// (`grid` persistent blocks, the first sk_tiles tiles stream-K over
// sk_blocks blocks, ops/conv.py conv_schedule); ws holds sk_tiles * slots
// * 128 * 128 int32 and counters sk_tiles zeroed int32 where a tile lies
// on more than one block (slots, at least the most blocks on one tile, >
// 1). out by out_kind: 0 (N, Ho, Wo, go ? go : Cout) int8 codes; 1 (no
// group-max) (N, Ho, Wo, Cout) float32 y, s_out unused; 2 (no group-max)
// (N, Ho, Wo, Cout) int32 accumulators, scale, bias, s_out and act unused
// (scale and bias may be null). Returns a cudaError_t, or minus the
// CUresult of a failed tensor-map encode.
extern "C" int conv_w8a8(const void* x, const void* wt, const void* scale,
                         const void* bias, float s_out, void* out, int N,
                         int H, int W, int Cin, int Cout, int ks, int stride,
                         int Ho, int Wo, int go, int act, int out_kind,
                         int route, int kb, int steps, int grid,
                         int sk_tiles, int sk_blocks, int slots, void* ws,
                         void* counters, void* stream) {
  Conv p;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out_kind == 0 ? static_cast<int8_t*>(out) : nullptr;
  p.outf = out_kind == 1 ? static_cast<float*>(out) : nullptr;
  p.outi = out_kind == 2 ? static_cast<int*>(out) : nullptr;
  p.ws = static_cast<int*>(ws);
  p.counters = static_cast<int*>(counters);
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Ho = Ho;
  p.Wo = Wo;
  p.Cout = Cout;
  p.go = go;
  p.ks = ks;
  p.pad_h = ks == 2 ? 0 : same_lo(H, ks, stride);
  p.pad_w = ks == 2 ? 0 : same_lo(W, ks, stride);
  p.act = act;
  p.f32out = out_kind == 1;
  p.raw = out_kind == 2;
  p.mode = 0;
  p.q = rq::requant(s_out, &p.mode);
  p.sk_tiles = sk_tiles;
  p.sk_blocks = sk_blocks;
  p.slots = slots;
  const int K = ks * ks * Cin;
  const bool s1 = stride == 1 && (ks == 2 || ks == 3) &&
                  Ho <= H - (ks == 2) && Wo <= W - (ks == 2);
  const bool s2 = stride == 2 && (ks == 1 || ks == 3) && route == 0 &&
                  go == 0 && Ho <= (H + 1) / 2 && Wo <= (W + 1) / 2;
  const bool bad =
      N < 1 || H < 1 || W < 1 || Cin < 16 || Cin % 16 || Cout < 1 ||
      !(s1 || s2) || Ho < 1 || Wo < 1 ||
      out_kind < 0 || out_kind > 2 ||
      (go != 0 && (go < 1 || 4 * go != Cout || out_kind != 0)) ||
      grid < 1 || route < 0 || route > 1;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  p.n_tiles = go ? (go + GN - 1) / GN : (Cout + BN - 1) / BN;
  const uint64_t b_rows = go ? static_cast<uint64_t>(p.n_tiles) * BN
                             : static_cast<uint64_t>(Cout);
  if (route == 0) {
    if ((kb != 64 && kb != 128) || (kb == 64) != (Cin <= 64)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.kc = (Cin + kb - 1) / kb;
    p.steps = ks * p.kc;
    p.rtiles = (Ho + TR - 1) / TR;
    p.ctiles = (Wo + TC - 1) / TC;
    p.ptiles = N * p.rtiles * p.ctiles;
    p.tiles = p.ptiles * p.n_tiles;
  } else {
    if (ks != 3 || stride != 1 || Cin % KC || Ho != H || Wo != W) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.M = N * H * W;
    p.steps = 9 * (Cin / KC);
    p.tiles = (p.M + BM - 1) / BM * p.n_tiles;
  }
  // the schedule: the stream-K tiles and blocks within the launch, every
  // stream-K block with a step, the workspace as large as the tiles need
  if (steps != p.steps || sk_tiles < 0 || sk_tiles > p.tiles ||
      (sk_tiles > 0) != (sk_blocks > 0) || sk_blocks > grid ||
      static_cast<long long>(sk_tiles) * p.steps < sk_blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int need = sk_slots(p);
  if (slots < need || (need > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap mx, mo, mb;
  const uint64_t xdims[4] = {static_cast<uint64_t>(Cin),
                             static_cast<uint64_t>(W),
                             static_cast<uint64_t>(H),
                             static_cast<uint64_t>(N)};
  const uint64_t xstrides[3] = {static_cast<uint64_t>(Cin),
                                static_cast<uint64_t>(W) * Cin,
                                static_cast<uint64_t>(H) * W * Cin};
  const uint64_t bdims[2] = {static_cast<uint64_t>(K), b_rows};
  const uint64_t bstride[1] = {static_cast<uint64_t>(K)};
  if (route == 0) {
    const CUtensorMapSwizzle sw =
        kb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    const uint32_t ukb = static_cast<uint32_t>(kb);
    CUresult r;
    if (stride == 1) {
      const uint32_t xbox[4] = {ukb, PC, TR, 1};
      r = tma::encode_s8(&mx, x, 4, xdims, xstrides, xbox, sw);
      mo = mx;
    } else {
      // every other column and row: a box of 2n elements lands n
      const uint32_t every2[4] = {1, 2, 2, 1};
      const uint32_t pe = TC + (ks - 1) / 2;
      const uint32_t ebox[4] = {ukb, 2 * pe, 2 * TR, 1};
      r = tma::encode_s8(&mx, x, 4, xdims, xstrides, ebox, sw, every2);
      mo = mx;
      if (r == CUDA_SUCCESS && ks == 3) {
        const uint32_t obox[4] = {ukb, 2 * TC, 2 * TR, 1};
        r = tma::encode_s8(&mo, x, 4, xdims, xstrides, obox, sw, every2);
      }
    }
    if (r == CUDA_SUCCESS) {
      const uint32_t bbox[2] = {ukb, BN};
      r = tma::encode_s8(&mb, wt, 2, bdims, bstride, bbox, sw);
    }
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
    if (stride == 2) {
      return ks == 3 ? launch_patch_ks<3, 2>(mx, mo, mb, p, kb, grid, st)
                     : launch_patch_ks<1, 2>(mx, mo, mb, p, kb, grid, st);
    }
    return ks == 3 ? launch_patch_ks<3, 1>(mx, mo, mb, p, kb, grid, st)
                   : launch_patch_ks<2, 1>(mx, mo, mb, p, kb, grid, st);
  }
  // the bounding box of a tap's top-left corner: columns -1 .. W-2, rows
  // -1 .. H-2 (the output grid, one pixel up and left)
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  CUresult r = tma::encode_im2col_s8(&mx, x, 4, xdims, xstrides, lower,
                                     upper, KC, BM,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS) {
    const uint32_t bbox[2] = {KC, BN};
    r = tma::encode_s8(&mb, wt, 2, bdims, bstride, bbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  static unsigned done = 0;
  const cudaError_t err = allow_smem(conv_tap_kernel, TAP_SMEM, &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_tap_kernel<<<grid, wg::THREADS, TAP_SMEM, st>>>(mx, mb, p);
  return static_cast<int>(cudaGetLastError());
}
