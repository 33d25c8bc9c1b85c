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
//       x[n, oy+dh-pad, ox+dw-pad, ci] * w[dh, dw, ci, o]       (int32)
//   y = act(acc*scale[o] + bias[o]); q = clip(rint(y / s_out), +-127)
// (scale = s_in*s_w), the conv order of requant.cuh (mode 0, or mode 4
// where s_out is not a positive normal float); k = 3 SAME (pad 1) or k = 2
// VALID (pad 0, the shifted fold), stride 1, the output trimmed to (Ho,
// Wo). With go > 0 (Cout = 4 go) the output channel c < go is the max
// over the pool groups k of the codes q[k*go + c]: the group-max of the
// requantized int8 tensor that the fold stages take. The groups share
// their scale and bias (a fold stage repeats its layer's), so the kernel
// takes the code of the groups' largest accumulator (the smallest where
// scale and s_out differ in sign): requantization is monotone in the
// accumulator, so that is the largest code, exactly. (A code for each of
// the four groups, then their max, took 0.0987 ms at L2 against 0.0688,
// H100 80GB HBM3, 700.00 W.)
//
// What bounds it on an H100 (SXM data sheet at 700 W: 1,979 int8 TOP/s,
// 3.35 TB/s): the int8 tensor-core rate at every b32 main-path shape
// (L2: 51.0 G operations on 33 MB; L13: 102.1 G on 12 MB); at batch 1 the
// weight bytes of the tail (1-9 MB).
//
// Design: the Hopper mainloop of wgmma_s8.cuh (a persistent grid; a
// producer warpgroup whose one thread issues every copy; two consumer
// warpgroups that take the block's units in turn, one's epilogue under
// the other's wgmma; split-K across blocks, the fixup before the
// epilogue) with A brought to wgmma by one of two routes, a template
// parameter chosen by the wrapper from the shape alone (ops/conv.py
// conv_w8a8_form):
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
//   offset. Where one tap row is one step (Cin <= KB), a column block of
//   B (k*k taps x 128 rows x KB bytes) is resident, copied once a column
//   block, else it streams with the patches, a box a tap. M runs over the
//   trimmed (Ho, Wo) output only: L4's shifted fold of H/2+1 valid rows
//   and its zero rows up to a multiple of 8 is read where a tile needs it,
//   and no tile starts past the trimmed output.
// - WINDOW (conv3x3_bt.cu's): k = 3 SAME with Cin % 128 == 0 and W <= 31,
//   the batch folded into a flat M of N*H*W rows, 128 a tile. For each
//   128-byte chunk of Cin one TMA box copies the tile's window of flat
//   rows [m0 - (W+1), m0 + 128 + W+1) (zeros outside [0, M)) in the
//   128-byte swizzle; a consumer loads A from it by ldmatrix into
//   registers (wgmma's register-A form), each lane addressing its row at
//   the tap's row shift, or a zero row where the tap leaves the pixel's
//   image: a descriptor addresses rows affinely and could not redirect
//   them. B comes a (chunk, tap) box at a time through a ring of 8. A
//   step's A fragments are loaded a k32 group at a time, 8 registers, under
//   the 3 groups before it (double-buffered whole steps made ptxas
//   serialise the wgmma).
//
// The epilogue (shared): each tile's scale and bias go to shared memory
// while its mainloop runs; the codes (requant.cuh, every rounding
// explicit) are staged in shared memory and stored 16 bytes a thread, a
// row at a time to the row's output pixel. With the group-max a thread
// holds the same channel of all four groups (B is rs_tile_matrix's
// pool-major tile matrix: block j holds channels 32j..32j+31 of each
// group, so column 8i + 2t + e of group k is register column i + 4k), and
// takes the extreme over its own registers. The epilogue's arithmetic is
// what the short-K PATCH layers wait on (PERF.md).

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

// PATCH: a tile's output rows and columns, a patch row's columns (the
// halo's), a step's patch box rows
constexpr int TR = 16;
constexpr int TC = 8;
constexpr int PC = TC + 2;
constexpr int PATCH = TR * PC;

// WINDOW: bytes of Cin a chunk, the largest halo (W + 1), the window
// buffers and the B ring
constexpr int KC = 128;
constexpr int HALO_MAX = 32;
constexpr int WIN_BYTES = (BM + 2 * HALO_MAX) * KC;
constexpr int WSTAGES = 2;
constexpr int BSTAGES = 8;

struct Conv {
  const float* scale;           // (Cout,)
  const float* bias;
  int8_t* out;                  // (N, Ho, Wo, go ? go : Cout)
  int* ws;                      // split-K partial sums (splits > 1)
  int* counters;                // split-K arrival counters, zero
  int H, W, Cin, Ho, Wo, Cout;
  int go;                       // channels a pool group, 0: no group-max
  int ks, pad, act, mode;
  rq::Requant q;
  int n_tiles;                  // column blocks
  int splits, units;
  // PATCH
  int kc;                       // steps a tap row: ceil(Cin / KB)
  int steps;                    // ks kc
  int rtiles, ctiles, ptiles;   // row tiles, column tiles an image; tiles
  // WINDOW
  int M;                        // N H W
  int halo;                     // W + 1
  int win_rows;                 // BM + 2 halo
  int chunks;                   // Cin / KC
};

// The output pixel of tile row r (n, oy, ox flattened over (N, Ho, Wo)),
// or -1 where the row lies past the output. PATCH: tile t is TR x TC
// pixels of one image; WINDOW: tile t is flat rows 128 t ...
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
template <int MODE, int ACT, bool GMAX, bool PATCH_ROUTE>
__device__ __forceinline__ void store(const int (&acc)[NREG],
                                      uint8_t* staging, const float* sc_s,
                                      const float* bi_s, const Conv& p,
                                      int t_pix, int nt, int c) {
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int act = ACT >= 0 ? ACT : p.act;
  if (!GMAX) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cl = 8 * j + 2 * t;
      const float2 sc = *reinterpret_cast<const float2*>(sc_s + cl);
      const float2 bi = *reinterpret_cast<const float2*>(bi_s + cl);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * q + 16 * w + g + 8 * h;
          const int i = 64 * q + 4 * j + 2 * h;
          const uint32_t q0 = rq::code<MODE>(acc[i], sc.x, bi.x, act, p.q);
          const uint32_t q1 =
              rq::code<MODE>(acc[i + 1], sc.y, bi.y, act, p.q);
          const int chunk = (cl >> 4) ^ (r & 7);
          *reinterpret_cast<uint16_t*>(staging + r * BN + chunk * 16 +
                                       (cl & 15)) =
              static_cast<uint16_t>(__byte_perm(q0, q1, 0x0040));
        }
      }
    }
  } else {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * q + 16 * w + g + 8 * h;
          // group k of channel 8ii + 2t + e is register i + e + 16k; the
          // groups share group 0's scale and bias
          const int cl = 8 * ii + 2 * t;
          const int i = 64 * q + 4 * ii + 2 * h;
          const float2 sc = *reinterpret_cast<const float2*>(sc_s + cl);
          const float2 bi = *reinterpret_cast<const float2*>(bi_s + cl);
          const uint32_t q0 = rq::code<MODE>(
              pick(acc[i], acc[i + 16], acc[i + 32], acc[i + 48], sc.x, p),
              sc.x, bi.x, act, p.q);
          const uint32_t q1 = rq::code<MODE>(
              pick(acc[i + 1], acc[i + 17], acc[i + 33], acc[i + 49], sc.y,
                   p), sc.y, bi.y, act, p.q);
          *reinterpret_cast<uint16_t*>(staging + r * GN + 8 * ii + 2 * t) =
              static_cast<uint16_t>(__byte_perm(q0, q1, 0x0040));
        }
      }
    }
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

// The main paths' variant (conv order, leaky) in straight-line code; the
// other activations and mode 4, which no pin reaches, read p.act.
template <bool PATCH_ROUTE>
__device__ __forceinline__ void epilogue(const int (&acc)[NREG],
                                         uint8_t* staging, const float* sc_s,
                                         const float* bi_s, const Conv& p,
                                         int t_pix, int nt, int c) {
  const bool leaky = p.mode == 0 && p.act == 1;
  switch ((p.mode == 4) * 4 + leaky * 2 + (p.go != 0)) {
    case 0: store<0, -1, false, PATCH_ROUTE>(acc, staging, sc_s, bi_s, p,
                                             t_pix, nt, c); break;
    case 1: store<0, -1, true, PATCH_ROUTE>(acc, staging, sc_s, bi_s, p,
                                            t_pix, nt, c); break;
    case 2: store<0, 1, false, PATCH_ROUTE>(acc, staging, sc_s, bi_s, p,
                                            t_pix, nt, c); break;
    case 3: store<0, 1, true, PATCH_ROUTE>(acc, staging, sc_s, bi_s, p,
                                           t_pix, nt, c); break;
    case 4: store<4, -1, false, PATCH_ROUTE>(acc, staging, sc_s, bi_s, p,
                                             t_pix, nt, c); break;
    default: store<4, -1, true, PATCH_ROUTE>(acc, staging, sc_s, bi_s, p,
                                             t_pix, nt, c); break;
  }
}

// ---------------------------------------------------------------------------
// PATCH
// ---------------------------------------------------------------------------

template <int KB, bool RES>
struct Patch {
  static_assert(RES || KB == 128, "B streams only in 128-byte steps");
  static constexpr int A_BYTES = PATCH * KB;
  static constexpr int B_TAP = BN * KB;       // one tap's B of a step
  static constexpr int STAGE_BYTES = RES ? A_BYTES : A_BYTES + 3 * B_TAP;
  static constexpr int STAGES = KB == 64 ? 8 : 2;
  // dynamic shared memory: alignment slack, the resident B (ks*ks taps),
  // the ring, the staging and scale/bias of both consumers, the barriers
  // (full, empty, B full, B empty, two turns) and a flag per consumer
  static constexpr int smem(int ks, int kc) {
    return 1024 + (RES ? ks * ks * kc * B_TAP : 0) + STAGES * STAGE_BYTES +
           2 * STAGING + 2 * SCB + (2 * STAGES + 4) * 8 + 16;
  }
};

template <int KB>
__device__ __forceinline__ uint64_t desc_b(const void* p) {
  return KB == 64 ? wg::desc_sw64(p) : wg::desc_sw128(p);
}

// The descriptor of tap column dw's A in a patch: core matrix j (tile row
// j, 8 pixels) is patch row j from column dw, so KB-byte rows from p =
// patch + dw*KB, the next core matrix a patch row (PC rows) on; the
// KB-byte swizzle, base offset 0.
template <int KB>
__device__ __forceinline__ uint64_t desc_patch(const void* p) {
  const uint64_t a = tma::smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(PC * KB >> 4) << 32) | (uint64_t(KB == 64 ? 2 : 1) << 62);
}

// Unit u of the patch route: column block nt (outermost, so that a block
// walks one column block's resident B as long as it can), pixel tile pt,
// K-split s over the steps [sb, se).
struct PUnit {
  int nt, pt, s, sb, se;
};

__device__ __forceinline__ PUnit patch_unit(const Conv& p, int u) {
  PUnit x;
  const int per = p.ptiles * p.splits;
  x.nt = u / per;
  const int r = u - x.nt * per;
  x.pt = r / p.splits;
  x.s = r - x.pt * p.splits;
  x.sb = x.s * p.steps / p.splits;
  x.se = (x.s + 1) * p.steps / p.splits;
  return x;
}

// KS (the kernel size) is a template argument: with the taps of a step a
// runtime loop, ptxas fenced the wgmma (warpgroup.arrive injected, C7519).
template <int KB, bool RES, int KS>
__global__ void __launch_bounds__(wg::THREADS, 1)
conv_patch_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_b, const Conv p) {
  using C = Patch<KB, RES>;
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
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // --- producer: one thread issues every box ---
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    wg::Pipe<STAGES> pipe;
    int cur = -1;                          // the resident column block
    uint32_t gen = 0;                      // resident B copies so far
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const PUnit x = patch_unit(p, u);
      const int n = x.pt / (p.rtiles * p.ctiles);
      const int rest = x.pt - n * p.rtiles * p.ctiles;
      const int y0 = rest / p.ctiles * TR, x0 = rest % p.ctiles * TC;
      if (RES && x.nt != cur) {
        // B of tap b / kc, Cin chunk b % kc at bres + b B_TAP
        if (gen > 0) wg::wait(bempty, (gen - 1) & 1);
        tma::mbar_expect_tx(bfull, taps * p.kc * B_TAP);
        for (int b = 0; b < taps * p.kc; ++b) {
          const int tap = b / p.kc, c0 = (b - tap * p.kc) * KB;
          wg::tma_load_2d(bres + b * B_TAP, &map_b, bfull, tap * p.Cin + c0,
                          x.nt * BN);
        }
        cur = x.nt;
        ++gen;
      }
      for (int s = x.sb; s < x.se; ++s) {
        // step s: tap row dh = s / kc, Cin chunk s % kc: the patch of rows
        // y0+dh-pad .., columns x0-pad .. x0-pad+PC-1
        const int dh = s / p.kc, c0 = (s - dh * p.kc) * KB;
        uint8_t* st = ring + pipe.stage * C::STAGE_BYTES;
        wg::wait(&empty[pipe.stage], pipe.phase ^ 1);
        tma::mbar_expect_tx(&full[pipe.stage],
                            C::A_BYTES + (RES ? 0 : KS * B_TAP));
        wg::tma_load_4d(st, &map_x, &full[pipe.stage], c0, x0 - p.pad,
                        y0 + dh - p.pad, n);
        if (!RES) {
          for (int dw = 0; dw < KS; ++dw) {
            wg::tma_load_2d(st + C::A_BYTES + dw * B_TAP, &map_b,
                            &full[pipe.stage], (KS * dh + dw) * p.Cin + c0,
                            x.nt * BN);
          }
        }
        pipe.advance();
      }
    }
    return;
  }

  // --- consumers: c takes the block's units 2k + c, whole tiles ---
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
  int k = 0, i = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++i) {
    const PUnit x = patch_unit(p, u);
    if (RES && x.nt != cur) {
      // This consumer is done with the last column block's B (its wgmma
      // retired at the end of its last unit). It arrives once a copy, and
      // not before the other consumer matched its arrival for the copy
      // before: a consumer that owns no unit of a column block must not
      // count twice in one phase of the barrier.
      if (gen > 0) {
        if (gen > 1) wg::wait(bempty, (gen - 2) & 1);
        if (lead) wg::mbar_arrive(bempty);
      }
      cur = x.nt;
      ++gen;
      have_b = false;
    }
    if ((i & 1) != c) {
      pipe.skip(x.se - x.sb);
      continue;
    }
    // the tile's scale and bias, for the epilogue; the previous tile's
    // were read before its epilogue's middle warpgroup_sync
    load_scb(sc_s, bi_s, p, x.nt, tid);
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
        // tap (dh, dw): the patch from column dw; tile rows 8.. (the second
        // m64 half) start 8 patch rows on
        const uint64_t da = desc_patch<KB>(st + dw * KB);
        const uint64_t db = desc_b<KB>(
            RES ? bres + ((KS * dh + dw) * p.kc + kq) * B_TAP
                : st + C::A_BYTES + dw * B_TAP);
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk) {
          const int on = (s != x.sb) | dw | kk;
          wg::Mma<BN>::run(acc, da + 2 * kk, db + 2 * kk, on);
          wg::Mma<BN>::run(acc + 64, da + (8 * PC * KB >> 4) + 2 * kk,
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
    if (p.splits > 1 &&
        !wg::splitk_fixup(acc, p.ws, p.counters, &flags[c], c,
                          x.nt * p.ptiles + x.pt, x.s, p.splits, BM)) {
      continue;
    }
    wg::warpgroup_sync(c);      // scale and bias written, staging free
    epilogue<true>(acc, staging, sc_s, bi_s, p, x.pt, x.nt, c);
  }
}

// ---------------------------------------------------------------------------
// WINDOW
// ---------------------------------------------------------------------------

constexpr int WINDOW_SMEM = 1024 + WSTAGES * WIN_BYTES + BSTAGES * BN * KC +
                            2 * STAGING + 2 * SCB + KC +
                            (2 * WSTAGES + 2 * BSTAGES + 2) * 8 + 16;

// Keeps the A registers a wgmma group reads asynchronously live until the
// wait that retires the group (see wg::fence_acc).
__device__ __forceinline__ void keep(uint32_t (&a)[2][4]) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[k][j])::"memory");
}

// a = four 8 x 16-byte matrices of shared memory, lanes 8i..8i+7 giving
// the row addresses of matrix i: lane 4g + t receives bytes 4t..4t+3 of
// row g of each, which is wgmma's m64k32 A fragment (wg::mma_rs) when the
// matrices are rows g and g + 8 of the warp's 16, each at bytes 0 and 16
// of a k32 step.
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__global__ void __launch_bounds__(wg::THREADS, 1)
conv_window_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_b, const Conv p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sa = tma::smem_addr(smem);
  uint8_t* win_all = smem + ((1024 - (sa & 1023)) & 1023);
  uint8_t* b_all = win_all + WSTAGES * WIN_BYTES;
  uint8_t* staging_all = b_all + BSTAGES * BN * KC;
  float* scb = reinterpret_cast<float*>(staging_all + 2 * STAGING);
  uint8_t* zero_row = reinterpret_cast<uint8_t*>(scb + 2 * 2 * BN);
  uint64_t* wfull = reinterpret_cast<uint64_t*>(zero_row + KC);
  uint64_t* wempty = wfull + WSTAGES;
  uint64_t* bfull = wempty + WSTAGES;
  uint64_t* bempty = bfull + BSTAGES;
  uint64_t* turn = bempty + BSTAGES;
  int* flags = reinterpret_cast<int*>(turn + 2);

  if (threadIdx.x == 0) {
    for (int i = 0; i < WSTAGES; ++i) {
      tma::mbar_init(&wfull[i], 1);
      tma::mbar_init(&wempty[i], 4);    // the owning consumer's warps
    }
    for (int i = 0; i < BSTAGES; ++i) {
      tma::mbar_init(&bfull[i], 1);
      tma::mbar_init(&bempty[i], 4);
    }
    tma::mbar_init(&turn[0], 1);
    tma::mbar_init(&turn[1], 1);
    tma::fence_barrier_init();
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_x)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
  }
  if (threadIdx.x < KC / 16) {
    reinterpret_cast<int4*>(zero_row)[threadIdx.x] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // --- producer: one thread issues every window and B box ---
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    wg::Pipe<WSTAGES> wp;
    wg::Pipe<BSTAGES> bp;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const wg::Unit x = wg::unit(u, p.splits, p.n_tiles, p.chunks);
      for (int ch = x.kb; ch < x.ke; ++ch) {
        wg::wait(&wempty[wp.stage], wp.phase ^ 1);
        tma::mbar_expect_tx(&wfull[wp.stage], p.win_rows * KC);
        wg::tma_load_2d(win_all + wp.stage * WIN_BYTES, &map_x,
                        &wfull[wp.stage], ch * KC, x.mt * BM - p.halo);
        wp.advance();
        for (int tap = 0; tap < 9; ++tap) {
          wg::wait(&bempty[bp.stage], bp.phase ^ 1);
          tma::mbar_expect_tx(&bfull[bp.stage], BN * KC);
          wg::tma_load_2d(b_all + bp.stage * BN * KC, &map_b,
                          &bfull[bp.stage], tap * p.Cin + ch * KC,
                          x.nt * BN);
          bp.advance();
        }
      }
    }
    return;
  }

  // --- consumers: c takes the block's units 2k + c, whole tiles ---
  wg::setmaxnreg_inc<232>();
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, lane = tid % 32;
  const int cs = lane >> 4;     // the 16-byte chunk of a k32 step it addresses
  const bool lead = lane == 0;
  const uint32_t zero = tma::smem_addr(zero_row);
  uint8_t* staging = staging_all + c * STAGING;
  float* sc_s = scb + c * 2 * BN;
  float* bi_s = sc_s + BN;
  wg::Pipe<WSTAGES> wp;
  wg::Pipe<BSTAGES> bp;
  int acc[NREG];
  // A registers of the 4 wgmma groups of a step: group kk is k32 step kk
  // of both m64 halves; [kk][half][fragment]
  uint32_t a[4][2][4];
  int k = 0;                    // this consumer's units so far
  int i = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++i) {
    const wg::Unit x = wg::unit(u, p.splits, p.n_tiles, p.chunks);
    const int nch = x.ke - x.kb;
    if ((i & 1) != c) {
      wp.skip(nch);
      bp.skip(9 * nch);
      continue;
    }
    load_scb(sc_s, bi_s, p, x.nt, tid);
    // The row this lane addresses in each m64 half q for ldmatrix: row
    // 64q + 16w + (lane % 8) + 8 ((lane / 8) % 2) of the tile, its 16-byte
    // chunk (lane / 16) of each k32 step; its window row at tap (0, 0) and
    // the taps whose source pixel lies in the pixel's image.
    int lrow[2];
    unsigned taps[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = 64 * q + 16 * w + (lane & 7) + 8 * ((lane >> 3) & 1);
      const int m = x.mt * BM + row;
      const int xc = m % p.W, yc = (m / p.W) % p.H;
      lrow[q] = row + p.halo;
      unsigned mask = 0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dh = tap / 3 - 1, dw = tap % 3 - 1;
        if (m < p.M && yc + dh >= 0 && yc + dh < p.H && xc + dw >= 0 &&
            xc + dw < p.W) {
          mask |= 1u << tap;
        }
      }
      taps[q] = mask;
    }
    wg::take_turn(turn, c, k);

    // A step is one (chunk, tap): 4 wgmma groups, one a k32 step, each of
    // both m64 halves, each group's A fragments loaded from the window
    // (one ldmatrix a half) while the 3 groups before it run, into
    // registers whose last group the wait just before retired.
    uint32_t win = 0;
    int tap = 0, prev = -1;
    const int n = 9 * nch;
    for (int st = 0; st < n; ++st) {
      if (tap == 0) {
        wg::wait(&wfull[wp.stage], wp.phase);
        win = tma::smem_addr(win_all + wp.stage * WIN_BYTES);
      }
      wg::wait(&bfull[bp.stage], bp.phase);
      const int off = (tap / 3 - 1) * p.W + (tap % 3 - 1);
      // the addressed row's window row for this tap (or the zero row where
      // the tap leaves the pixel's image) and its swizzle phase
      uint32_t base[2];
      int sw[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int ra = lrow[q] + off;
        const bool v = (taps[q] >> tap) & 1;
        base[q] = v ? win + ra * KC : zero;
        sw[q] = v ? ra & 7 : 0;
      }
      const uint64_t db = wg::desc_sw128(b_all + bp.stage * BN * KC);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg::wgmma_wait<3>();
        keep(a[kk]);
        // the last step's last group retired: its B stage is free
        if (kk == 3 && prev >= 0 && lead) wg::mbar_arrive(&bempty[prev]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          ldsm_x4(a[kk][q], base[q] + (((2 * kk + cs) ^ sw[q]) << 4));
        }
        wg::fence_acc(acc);
        wg::wgmma_fence();
        wg::mma_rs(acc, a[kk][0], db + 2 * kk, (st | kk) != 0);
        wg::mma_rs(acc + 64, a[kk][1], db + 2 * kk, (st | kk) != 0);
        wg::wgmma_commit();
        wg::fence_acc(acc);
      }
      if (++tap == 9) {
        // the chunk's last A words are loaded: its window is free (the
        // copy engine refills it after these generic-proxy reads)
        tap = 0;
        wg::fence_proxy_async();
        if (lead) wg::mbar_arrive(&wempty[wp.stage]);
        wp.advance();
      }
      prev = bp.stage;
      bp.advance();
    }
    if (tid == 0) wg::mbar_arrive(&turn[1 - c]);
    wg::wgmma_wait<0>();
    wg::fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) keep(a[kk]);
    if (lead) wg::mbar_arrive(&bempty[prev]);
    ++k;

    if (p.splits > 1 &&
        !wg::splitk_fixup(acc, p.ws, p.counters, &flags[c], c, x.tile, x.s,
                          p.splits, p.M - x.mt * BM)) {
      continue;
    }
    wg::warpgroup_sync(c);      // scale and bias written, staging free
    epilogue<false>(acc, staging, sc_s, bi_s, p, x.mt, x.nt, c);
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

template <int KB, bool RES, int KS>
int launch_patch(const CUtensorMap& mx, const CUtensorMap& mb, const Conv& p,
                 int grid, cudaStream_t st) {
  using C = Patch<KB, RES>;
  static unsigned done = 0;
  const cudaError_t err = allow_smem(conv_patch_kernel<KB, RES, KS>,
                                     C::smem(KS, RES ? 1 : 0), &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_patch_kernel<KB, RES, KS><<<grid, wg::THREADS, C::smem(KS, p.kc),
                                   st>>>(mx, mb, p);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch_patch_ks(const CUtensorMap& mx, const CUtensorMap& mb,
                    const Conv& p, int kb, int grid, cudaStream_t st) {
  if (kb == 64) return launch_patch<64, true, KS>(mx, mb, p, grid, st);
  return p.kc == 1 ? launch_patch<128, true, KS>(mx, mb, p, grid, st)
                   : launch_patch<128, false, KS>(mx, mb, p, grid, st);
}

}  // namespace

// route 0 (PATCH) or 1 (WINDOW), as ops/conv.py conv_w8a8_form chooses:
// x (N, H, W, Cin) int8, 16-byte aligned, Cin % 16 == 0 (WINDOW: % 128,
// W <= 31, ks 3, Ho == H, Wo == W); wt the (rows, ks*ks*Cin) K-major
// weight matrix (go 0: (Cout, K); go > 0: rs_tile_matrix's pool-major
// (ceil(go/32)*128, K) with Cout == 4 go), 16-byte aligned; ks 3 (SAME)
// or 2 (VALID), the output trimmed to (Ho, Wo); kb 64 or 128 bytes of
// Cin a PATCH step (64 iff Cin <= 64); `splits` K-splits (PATCH: of its
// ks*ceil(Cin/kb) steps; WINDOW: of its Cin/128 chunks) over `grid`
// persistent blocks; ws holds tiles * splits * 128 * 128 int32 and
// counters `tiles` zeroed int32 when splits > 1. out (N, Ho, Wo, go ? go
// : Cout) int8. Returns a cudaError_t, or minus the CUresult of a failed
// tensor-map encode.
extern "C" int conv_w8a8(const void* x, const void* wt, const void* scale,
                         const void* bias, float s_out, void* out, int N,
                         int H, int W, int Cin, int Cout, int ks, int Ho,
                         int Wo, int go, int act, int route, int kb,
                         int splits, int grid, void* ws, void* counters,
                         void* stream) {
  Conv p;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<int8_t*>(out);
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
  p.pad = ks == 3 ? 1 : 0;
  p.act = act;
  p.mode = 0;
  p.q = rq::requant(s_out, &p.mode);
  p.splits = splits;
  const int K = ks * ks * Cin;
  const bool bad =
      N < 1 || H < 1 || W < 1 || Cin < 16 || Cin % 16 || Cout < 1 ||
      (ks != 2 && ks != 3) || Ho < 1 || Wo < 1 ||
      Ho > H - (ks == 2) || Wo > W - (ks == 2) ||
      (go != 0 && (go < 1 || 4 * go != Cout)) || splits < 1 || grid < 1 ||
      (splits > 1 && (ws == nullptr || counters == nullptr));
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  p.n_tiles = go ? (go + GN - 1) / GN : (Cout + BN - 1) / BN;
  const uint64_t b_rows = go ? static_cast<uint64_t>(p.n_tiles) * BN
                             : static_cast<uint64_t>(Cout);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap mx, mb;
  if (route == 0) {
    if ((kb != 64 && kb != 128) || (kb == 64) != (Cin <= 64)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.kc = (Cin + kb - 1) / kb;
    p.steps = ks * p.kc;
    p.rtiles = (Ho + TR - 1) / TR;
    p.ctiles = (Wo + TC - 1) / TC;
    p.ptiles = N * p.rtiles * p.ctiles;
    p.units = p.ptiles * p.n_tiles * splits;
    if (splits > p.steps) return static_cast<int>(cudaErrorInvalidValue);
    const CUtensorMapSwizzle sw =
        kb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    const uint64_t xdims[4] = {static_cast<uint64_t>(Cin),
                               static_cast<uint64_t>(W),
                               static_cast<uint64_t>(H),
                               static_cast<uint64_t>(N)};
    const uint64_t xstrides[3] = {static_cast<uint64_t>(Cin),
                                  static_cast<uint64_t>(W) * Cin,
                                  static_cast<uint64_t>(H) * W * Cin};
    const uint32_t xbox[4] = {static_cast<uint32_t>(kb), PC, TR, 1};
    CUresult r = tma::encode_s8(&mx, x, 4, xdims, xstrides, xbox, sw);
    if (r == CUDA_SUCCESS) {
      const uint64_t bdims[2] = {static_cast<uint64_t>(K), b_rows};
      const uint64_t bstride[1] = {static_cast<uint64_t>(K)};
      const uint32_t bbox[2] = {static_cast<uint32_t>(kb), BN};
      r = tma::encode_s8(&mb, wt, 2, bdims, bstride, bbox, sw);
    }
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
    return ks == 3 ? launch_patch_ks<3>(mx, mb, p, kb, grid, st)
                   : launch_patch_ks<2>(mx, mb, p, kb, grid, st);
  }
  if (route != 1 || ks != 3 || Cin % KC || W + 1 > HALO_MAX || Ho != H ||
      Wo != W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.M = N * H * W;
  p.halo = W + 1;
  p.win_rows = BM + 2 * p.halo;
  p.chunks = Cin / KC;
  p.units = (p.M + BM - 1) / BM * p.n_tiles * splits;
  if (splits > p.chunks) return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t xdims[2] = {static_cast<uint64_t>(Cin),
                             static_cast<uint64_t>(p.M)};
  const uint64_t xstride[1] = {static_cast<uint64_t>(Cin)};
  const uint32_t xbox[2] = {KC, static_cast<uint32_t>(p.win_rows)};
  CUresult r = tma::encode_s8(&mx, x, 2, xdims, xstride, xbox,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS) {
    const uint64_t bdims[2] = {static_cast<uint64_t>(K), b_rows};
    const uint64_t bstride[1] = {static_cast<uint64_t>(K)};
    const uint32_t bbox[2] = {KC, BN};
    r = tma::encode_s8(&mb, wt, 2, bdims, bstride, bbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  static unsigned done = 0;
  const cudaError_t err = allow_smem(conv_window_kernel, WINDOW_SMEM, &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_window_kernel<<<grid, wg::THREADS, WINDOW_SMEM, st>>>(mx, mb, p);
  return static_cast<int>(cudaGetLastError());
}
