// 3x3 SAME int8 conv with the pool-major group-max for Hopper (sm_90a),
// whose implicit-im2col matrix the copy engine (TMA) assembles.
//
// Replaces: tools/proto_conv_dma.py, conv_dma (kernel body _kernel), the
// JAX repo's experiment on whether the DMA engines rather than the vector
// unit can build the A matrix of conv3x3_rs. Same contract:
//   acc[m, o] = sum over taps (dh, dw) and ci of
//               x[n, oy+dh-1, ox+dw-1, ci] * w[dh, dw, ci, o]  (int32)
//   m[c] = max(acc[c], acc[go+c], acc[2go+c], acc[3go+c])      (int32)
//   y = leaky(m*scale[c] + bias[c]); out = clip(rint(y), +-127) int8
// which is conv3x3_rs with pool ('gmaxm', 2, go) and scale, bias tiled 4x.
//
// What bounds it on an H100 (SXM data sheet at 700 W: 1,979 int8 TOP/s,
// 3.35 TB/s): the int8 tensor-core rate. At (32,104,104,64) -> 128 it does
// 51.0 G operations on 33.3 MB, 1.5 K operations per byte against the
// card's ~590.
//
// Design: the Hopper mainloop of wgmma_s8.cuh (a persistent grid, a
// producer warpgroup, two consumer warpgroups that take the block's tiles
// in turn, wgmma m64n128k32 from shared memory) with A built by the copy
// engine alone. A tile is 16 x 8 output pixels of one image (8 pixels of
// a tile row are one 8-row core matrix of the wgmma operand; 8 tile rows
// are an m64 half) by 128 accumulator columns. Each step is one tap row
// dh and KB bytes of Cin (KB = 64 for Cin <= 64, else 128; one step a tap
// row up to Cin 128): one box {KB, 10, 16, 1} of a 4-D tensor map over x
// {Cin, W, H, N} at (c0, x0-1, y0+dh-1, n) -- the tile's rows with the
// halo columns on both sides, 160 pixel rows of KB bytes -- landed in
// the KB-byte swizzle (64 or 128), which no thread touches. The three
// taps (dh, dw) of the step read it by descriptor: core matrix j (tile
// row j) is patch row j from column dw, that is KB-byte rows from patch
// + dw*KB, the next core matrix 10 rows on (stride byte offset 10*KB).
// The swizzle follows the absolute shared address, as the copy engine
// wrote it, so a start a row into the swizzle atom needs no base offset
// (on an H100 the codes were wrong with the descriptor's base offset set
// from the start, exact without it). The copy engine's zero fill of
// out-of-range coordinates is the SAME halo, and its fill past Cin the K
// padding (so Cin 16, 48 or 80 multiply zeros against whatever weights
// the box meets). With a box per tap (9 boxes of a tile's 117-128 pixel
// rows) the copy engine's rate of box rows bound the kernel; the patch
// needs 480 rows a tile for the same taps.
//
// `ht`, the JAX tool's band of rows, does not shape the tiles: every ht
// launches the same kernel and gives the same codes.
//
// B is conv3x3_rs's pool-major tile matrix (rs_tile_matrix: block j holds
// channels 32j..32j+31 of each pool group, group k in rows 32k..32k+31),
// by TMA with the same swizzle. Where a column block's 9 x 128 x KB bytes
// fit beside the ring (Cin <= 128: 72 KB at Cin 64) it is resident:
// copied once, and again only when a block's walk reaches another column
// block, after both consumers released it. Else (Cin > 128) it streams
// with the patches, a box for each of a step's three taps. Under wgmma's
// accumulator layout a thread holds columns 8i + 2t + e for every i, so
// it holds channel 8i' + 2t + e (i' < 4) of group k at i = i' + 4k: the
// group-max is a max over the thread's own registers (conv3x3_rs.cu).
// Every rounding is explicit (mma_s8.cuh, wg::code_bits).

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "mma_s8.cuh"
#include "tma.cuh"
#include "wgmma_s8.cuh"

namespace {

using s8mma::epilogue_f32;

constexpr int BN = wg::BN;      // accumulator columns a tile
constexpr int GN = BN / 4;      // channels of each pool group a tile
constexpr int NREG = wg::NREG;
constexpr int TR = 16;          // output rows of a tile (8 a m64 half)
constexpr int TC = 8;           // output columns of a tile: a core matrix
constexpr int PC = TC + 2;      // columns of a patch row (the halo's)
constexpr int PATCH = TR * PC;  // rows of a step's patch box

// A ring depth for a step of KB bytes: the patch alone (B resident) or
// the patch and the step's three taps of B. B streams only past Cin 128,
// so only in 128-byte steps.
template <int KB, bool RES>
struct Cfg {
  static_assert(RES || KB == 128, "B streams only in 128-byte steps");
  static constexpr int A_BYTES = PATCH * KB;
  static constexpr int B_TAP = BN * KB;       // one tap's B of a step
  static constexpr int STAGE_BYTES = RES ? A_BYTES : A_BYTES + 3 * B_TAP;
  static constexpr int STAGES = KB == 64 ? 12 : 3;
};

struct Conv {
  const float* scale;           // (go,)
  const float* bias;
  int8_t* out;                  // (N, H, W, go)
  int H, W, Cin, go;
  int kc;                       // steps of a tap row: ceil(Cin / KB)
  int steps;                    // 3 kc
  int rtiles, ctiles, ptiles;   // row tiles, column tiles an image; tiles
  int units;                    // ptiles x column blocks
};

// Bytes of dynamic shared memory: 1024 of alignment slack, the resident
// B (9 kc taps), the ring, the barriers (full, empty, B full, B empty,
// two turns).
template <int KB, bool RES>
constexpr int smem_bytes(int kc) {
  using C = Cfg<KB, RES>;
  return 1024 + (RES ? 9 * kc * C::B_TAP : 0) + C::STAGES * C::STAGE_BYTES +
         (2 * C::STAGES + 4) * 8;
}

template <int KB>
__device__ __forceinline__ uint64_t desc(const void* p) {
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

// Consumer c's tile (pixel tile pt, column block nt): acc[64q + 4i + 2h +
// e] is tile pixel 64q + 16w + g + 8h (row / 8, column % 8), column 8i +
// 2t + e. A thread's 8
// channels are the same in all its rows, so their scale and bias are
// loaded once a tile.
__device__ __forceinline__ void dma_epilogue(const int (&acc)[NREG],
                                             const Conv& p, int pt, int nt) {
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int n = pt / (p.rtiles * p.ctiles);
  const int rest = pt - n * p.rtiles * p.ctiles;
  const int y0 = rest / p.ctiles * TR, x0 = rest % p.ctiles * TC;
  const bool pairs = (p.go & 1) == 0;
  float sc[4][2], bi[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = min(nt * GN + 8 * i + 2 * t + e, p.go - 1);
      sc[i][e] = p.scale[cc];
      bi[i][e] = p.bias[cc];
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 64 * q + 16 * w + g + 8 * h;
      const int oy = y0 + m / TC, ox = x0 + m % TC;
      if (oy >= p.H || ox >= p.W) continue;
      int8_t* o = p.out +
                  ((static_cast<size_t>(n) * p.H + oy) * p.W + ox) * p.go;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ch = nt * GN + 8 * i + 2 * t;
        if (ch >= p.go) continue;
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 64 * q + 4 * i + 2 * h + e;   // group k at r + 16k
          const int a = max(max(acc[r], acc[r + 16]),
                            max(acc[r + 32], acc[r + 48]));
          v |= (wg::code_bits(epilogue_f32(a, sc[i][e], bi[i][e], 1)) &
                0xFFu) << (8 * e);
        }
        if (pairs) {
          *reinterpret_cast<uint16_t*>(o + ch) = static_cast<uint16_t>(v);
        } else {
          o[ch] = static_cast<int8_t>(v);
          if (ch + 1 < p.go) o[ch + 1] = static_cast<int8_t>(v >> 8);
        }
      }
    }
  }
}

template <int KB, bool RES>
__global__ void __launch_bounds__(wg::THREADS, 1)
conv_dma_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_b, const Conv p) {
  using C = Cfg<KB, RES>;
  constexpr int STAGES = C::STAGES;
  constexpr int B_TAP = C::B_TAP;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sa = tma::smem_addr(smem);
  uint8_t* bres = smem + ((1024 - (sa & 1023)) & 1023);
  uint8_t* ring = bres + (RES ? 9 * p.kc * B_TAP : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* bfull = empty + STAGES;
  uint64_t* bempty = bfull + 1;
  uint64_t* turn = bempty + 1;

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
      const int nt = u / p.ptiles, pt = u - nt * p.ptiles;
      const int n = pt / (p.rtiles * p.ctiles);
      const int rest = pt - n * p.rtiles * p.ctiles;
      const int y0 = rest / p.ctiles * TR, x0 = rest % p.ctiles * TC;
      if (RES && nt != cur) {
        // B of tap t, Cin chunk k at bres + (t kc + k) B_TAP
        if (gen > 0) wg::wait(bempty, (gen - 1) & 1);
        tma::mbar_expect_tx(bfull, 9 * p.kc * B_TAP);
        for (int b = 0; b < 9 * p.kc; ++b) {
          const int tap = b / p.kc, c0 = (b - tap * p.kc) * KB;
          wg::tma_load_2d(bres + b * B_TAP, &map_b, bfull, tap * p.Cin + c0,
                          nt * BN);
        }
        cur = nt;
        ++gen;
      }
      for (int s = 0; s < p.steps; ++s) {
        // step s: tap row dh = s / kc, Cin chunk s % kc: the patch of
        // rows y0+dh-1 .., columns x0-1 .. x0+TC
        const int dh = s / p.kc, c0 = (s - dh * p.kc) * KB;
        uint8_t* st = ring + pipe.stage * C::STAGE_BYTES;
        wg::wait(&empty[pipe.stage], pipe.phase ^ 1);
        tma::mbar_expect_tx(&full[pipe.stage],
                            C::A_BYTES + (RES ? 0 : 3 * B_TAP));
        wg::tma_load_4d(st, &map_x, &full[pipe.stage], c0, x0 - 1,
                        y0 + dh - 1, n);
        if (!RES) {
          for (int dw = 0; dw < 3; ++dw) {
            wg::tma_load_2d(st + C::A_BYTES + dw * B_TAP, &map_b,
                            &full[pipe.stage], (3 * dh + dw) * p.Cin + c0,
                            nt * BN);
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
  const bool lead = threadIdx.x % 32 == 0;
  wg::Pipe<STAGES> pipe;
  int acc[NREG];
  int cur = -1;
  uint32_t gen = 0;
  bool have_b = !RES;
  int k = 0, i = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++i) {
    const int nt = u / p.ptiles, pt = u - nt * p.ptiles;
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
      pipe.skip(p.steps);
      continue;
    }
    wg::take_turn(turn, c, k++);
    if (!have_b) {
      // Waited after the turn: the block's previous unit, the other
      // consumer's, waited for its own copy (this unit's or the one
      // before), and the producer issues no later copy before this
      // consumer releases this one, so bfull is at most one phase behind
      // and the parity wait is exact. Before the turn, a consumer whose
      // last unit was column blocks ago could find bfull two phases
      // behind and pass at once, onto the wrong weights.
      wg::wait(bfull, (gen - 1) & 1);
      have_b = true;
    }
    int prev = -1;
    for (int s = 0; s < p.steps; ++s) {
      wg::wait(&full[pipe.stage], pipe.phase);
      const int dh = s / p.kc, kq = s - dh * p.kc;
      const uint8_t* st = ring + pipe.stage * C::STAGE_BYTES;
      wg::fence_acc(acc);
      wg::wgmma_fence();
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        // tap (dh, dw): the patch from column dw; rows 64.. (tile rows 8..)
        // start 8 patch rows on
        const uint64_t da = desc_patch<KB>(st + dw * KB);
        const uint64_t db = desc<KB>(
            RES ? bres + ((3 * dh + dw) * p.kc + kq) * B_TAP
                : st + C::A_BYTES + dw * B_TAP);
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk) {
          const int on = (s | dw | kk) != 0;
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
    if (threadIdx.x % 128 == 0) wg::mbar_arrive(&turn[1 - c]);
    wg::wgmma_wait<0>();
    wg::fence_acc(acc);
    if (lead) wg::mbar_arrive(&empty[prev]);
    dma_epilogue(acc, p, pt, nt);
  }
}

template <int KB, bool RES>
int launch(const CUtensorMap& mx, const CUtensorMap& mb, const Conv& p,
           int grid, cudaStream_t st) {
  const int smem = smem_bytes<KB, RES>(p.kc);
  const cudaError_t e = cudaFuncSetAttribute(
      conv_dma_kernel<KB, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  conv_dma_kernel<KB, RES><<<grid, wg::THREADS, smem, st>>>(mx, mb, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, H, W, Cin) int8, 16-byte aligned, Cin % 16 == 0 up to 256; wt the
// pool-major (ceil(go/32)*128, 9*Cin) tile matrix (rs_tile_matrix); kb 64
// (Cin <= 64) or 128 bytes of Cin a step, B resident where a tap row is
// one step (Cin <= kb), `grid` persistent blocks: the wrapper's
// conv_dma_form. Returns a cudaError_t; *cu_result gets the first failed
// encode's CUresult (0 if both encodes succeed), and a refused encode
// launches nothing.
extern "C" int conv_dma(const void* x, const void* wt, const void* scale,
                        const void* bias, void* out, int N, int H, int W,
                        int Cin, int go, int kb, int grid,
                        int* cu_result, void* stream) {
  *cu_result = 0;
  if (N < 1 || H < 1 || W < 1 || Cin < 16 || Cin % 16 || Cin > 256 ||
      go < 1 || (kb != 64 && kb != 128) || (kb == 64) != (Cin <= 64) ||
      grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Conv p;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<int8_t*>(out);
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.go = go;
  p.kc = (Cin + kb - 1) / kb;
  p.steps = 3 * p.kc;
  p.rtiles = (H + TR - 1) / TR;
  p.ctiles = (W + TC - 1) / TC;
  p.ptiles = N * p.rtiles * p.ctiles;
  const int n_tiles = (go + GN - 1) / GN;
  p.units = p.ptiles * n_tiles;
  const CUtensorMapSwizzle sw =
      kb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap mx, mb;
  const uint64_t xdims[4] = {static_cast<uint64_t>(Cin),
                             static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                             static_cast<uint64_t>(N)};
  const uint64_t xstrides[3] = {static_cast<uint64_t>(Cin),
                                static_cast<uint64_t>(W) * Cin,
                                static_cast<uint64_t>(H) * W * Cin};
  const uint32_t xbox[4] = {static_cast<uint32_t>(kb), PC, TR, 1};
  CUresult r = tma::encode_s8(&mx, x, 4, xdims, xstrides, xbox, sw);
  if (r == CUDA_SUCCESS) {
    const uint64_t bdims[2] = {static_cast<uint64_t>(9) * Cin,
                               static_cast<uint64_t>(n_tiles) * BN};
    const uint64_t bstride[1] = {static_cast<uint64_t>(9) * Cin};
    const uint32_t bbox[2] = {static_cast<uint32_t>(kb), BN};
    r = tma::encode_s8(&mb, wt, 2, bdims, bstride, bbox, sw);
  }
  *cu_result = static_cast<int>(r);
  if (r != CUDA_SUCCESS) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kb == 64) return launch<64, true>(mx, mb, p, grid, st);
  return p.kc == 1 ? launch<128, true>(mx, mb, p, grid, st)
                   : launch<128, false>(mx, mb, p, grid, st);
}
