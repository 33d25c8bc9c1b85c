// Batch-folded tap-shift 3x3/s1/SAME int8 conv for Hopper (sm_90a), with
// the fused epilogue and optional requant.
//
// Replaces: dnn_inference_engine_tpu/ops/attic/pallas_tail.py, conv3x3_bt
// (kernel body _bt_kernel; conv2d_w8a8_bt calls it). Same contract:
//   the N*H*W output pixels of the batch are one flat M axis (x viewed as
//   (M, Cin)); acc[m, o] = sum over the taps (dh, dw) and ci of
//   x_flat[m + dh*W + dw, ci] * w[dh+1, dw+1, ci, o], over the taps whose
//   source pixel lies in the same image, row range and column range;
//   y = act(acc*scale[o] + bias[o]); int8 out: clip(rint(y), +-127).
// Cin % 128 == 0 and W <= 31, as the TPU kernel asserts.
//
// What bounds it on an H100 (SXM data sheet at 700 W: 1,979 int8 TOP/s,
// 3.35 TB/s): the int8 tensor-core rate at every YOLOv2-tiny tail shape at
// batch 32 (L8-L13: 1.4-5.4 K operations per byte moved); at batch 1 the
// 1-9 MB of weights.
//
// Design. The TPU design -- the 9 taps as row shifts of one resident
// window, the batch folded into M so that 13x13 and 26x26 fill a tile --
// on the shared Hopper mainloop (wgmma_s8.cuh): 128 flat output rows x
// 128 channels a tile, a persistent grid, a producer warpgroup and two
// consumer warpgroups that take the block's units in turn (one's epilogue
// under the other's wgmma), K split across blocks (in whole chunks of
// Cin) where the tiles alone leave SMs idle (batch 1: M = 169).
// - The window. For each 128-byte chunk of Cin the producer copies the
//   tile's window of flat rows [m0 - (W+1), m0 + 128 + (W+1)) -- at most
//   192 rows, one 2-D TMA box over x viewed as (M, Cin) -- into one of two
//   window buffers; rows outside [0, M) arrive as zeros (the copy engine's
//   fill, where the kernel it replaces zero-filled by 16-byte copies).
//   The box lands in the 128-byte swizzle (16-byte chunk c of window row r
//   at chunk c ^ r % 8): unswizzled, the 8 rows that a fragment's lanes
//   read would share one bank group.
// - A from registers. A wgmma shared-memory descriptor addresses rows
//   affinely and cannot send a (row, tap) that crosses an image or row
//   edge to zeros; that redirect is what makes the kernel exact without a
//   padded copy. The m64k32 register fragment of wgmma has the row and K
//   layout of the m16n8k32 warp MMA's A (wg::mma_rs), which is what
//   ldmatrix x4 delivers from four 8 x 16-byte matrices whose rows the
//   lanes address one each. So the redirect carries over row for row: for tap
//   (dh, dw) a lane addresses row lrow + dh*W + dw of the window -- or a
//   zero row where the tap leaves its pixel's image -- at the swizzled
//   place of its 16-byte chunk; one ldmatrix gives an m64 half's fragment
//   of a k32 step. (Read 32 bits a thread at a time, 32 loads a step,
//   the loads and their address work held the wgmma back: on an H100 a
//   build with stand-in registers ran markedly faster.) A step is
//   4 wgmma groups (a k32 step of both m64 halves, so that no wgmma waits
//   on the one before it for its accumulator) with 8 A registers apiece,
//   each loaded while the 3 groups before it run, into registers kept
//   live until the wait that retires their last group (with a whole
//   step's 32 registers double-buffered, 64 beside the 128 of the
//   accumulator, ptxas serialised the wgmma for want of registers).
// - B, the (Cout, 9*Cin) K-major weight matrix the wrapper lays out once
//   (rs_weight_matrix), comes by TMA through a ring of 8 stages: one
//   128-row x 128-byte box per (chunk, tap), 128-byte swizzle, rows past
//   Cout zero-filled. K is walked chunk-major, tap-minor, so one window
//   serves 9 x 4 k32 steps: 156 window rows per chunk at W = 13 and 182 at
//   W = 26, where the im2col of a per-tap gather (conv3x3_rs) moves 9 x
//   128 = 1,152.
// - The epilogue rounds each step explicitly (mma_s8.cuh, wg::code_bits)
//   from the tile's scale and bias in shared memory, and stores int8 codes
//   through a staging tile, 16 bytes a thread, as gemm_fused.cu does:
//   stored straight from the fragments, 2 bytes a thread after 256 loads
//   of scale and bias, it took longer than a tile's mainloop at every b32
//   shape (a build without it, on an H100), so one consumer's epilogue no
//   longer hid under the other's wgmma. Cout and M may be ragged.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "mma_s8.cuh"
#include "tma.cuh"
#include "wgmma_s8.cuh"

namespace {

using s8mma::epilogue_f32;

constexpr int BM = wg::BM;      // flat output rows a tile
constexpr int BN = wg::BN;      // output channels a tile
constexpr int KC = 128;         // bytes of Cin a window chunk
constexpr int HALO_MAX = 32;    // W + 1 <= 32
constexpr int WIN_BYTES = (BM + 2 * HALO_MAX) * KC;
constexpr int B_BYTES = BN * KC;
constexpr int WSTAGES = 2;
constexpr int BSTAGES = 8;
constexpr int NREG = wg::NREG;
constexpr int STAGING = BM * BN;  // a consumer's tile of int8 codes
constexpr int SMEM = 1024 + WSTAGES * WIN_BYTES + BSTAGES * B_BYTES +
                     2 * STAGING + 2 * 2 * BN * 4 + KC +
                     (2 * WSTAGES + 2 * BSTAGES + 2) * 8 + 16;

struct Conv {
  const float* scale;
  const float* bias;
  void* out;                    // (M, Cout)
  int* ws;                      // split-K partial sums (splits > 1)
  int* counters;                // split-K arrival counters, zero
  int H, W, M, Cin, Cout, quantize, act;
  int halo;                     // W + 1
  int win_rows;                 // BM + 2 halo: the window box's rows
  int chunks;                   // Cin / KC
  int n_tiles, splits, units;
};

// The block's shared memory: two windows, the B ring, each consumer's
// staging of codes and its tile's scale and bias, a zero row, the
// barriers (window and B full/empty, the consumers' turns) and a flag per
// consumer for split-K.
struct Smem {
  uint8_t* win;
  uint8_t* b;
  uint8_t* staging;             // [consumer][STAGING]
  float* scb;                   // [consumer][scale 128, bias 128]
  const uint8_t* zero;
  uint64_t* wfull;
  uint64_t* wempty;
  uint64_t* bfull;
  uint64_t* bempty;
  uint64_t* turn;
  int* flags;

  __device__ explicit Smem(uint8_t* raw) {
    const uint32_t a = tma::smem_addr(raw);
    win = raw + ((1024 - (a & 1023)) & 1023);
    b = win + WSTAGES * WIN_BYTES;
    staging = b + BSTAGES * B_BYTES;
    scb = reinterpret_cast<float*>(staging + 2 * STAGING);
    zero = reinterpret_cast<const uint8_t*>(scb + 2 * 2 * BN);
    wfull = reinterpret_cast<uint64_t*>(const_cast<uint8_t*>(zero) + KC);
    wempty = wfull + WSTAGES;
    bfull = wempty + WSTAGES;
    bempty = bfull + BSTAGES;
    turn = bempty + BSTAGES;
    flags = reinterpret_cast<int*>(turn + 2);
  }
};

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

// The int8 codes of consumer c's tile (row block mt, column block nt):
// acc[64q + 4j + 2h + e] is flat row 64q + 16w + g + 8h of the tile,
// channel 8j + 2t + e of its 128. Through the consumer's staging (16-byte
// chunks XOR-ed with the row, so the 2-byte fragment writes are free of
// bank conflicts) to 16-byte stores, a warp covering four whole rows, as
// gemm_fused.cu stores its codes. ACT is a template argument so that a
// thread's 128 codes are straight-line code.
template <int ACT>
__device__ __forceinline__ void store_codes(const int (&acc)[NREG],
                                            uint8_t* staging,
                                            const float* sc_s,
                                            const float* bi_s, const Conv& p,
                                            int mt, int nt, int c) {
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
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
        const uint32_t q0 =
            wg::code_bits(epilogue_f32(acc[i], sc.x, bi.x, ACT));
        const uint32_t q1 =
            wg::code_bits(epilogue_f32(acc[i + 1], sc.y, bi.y, ACT));
        const int chunk = (cl >> 4) ^ (r & 7);
        *reinterpret_cast<uint16_t*>(staging + r * BN + chunk * 16 +
                                     (cl & 15)) =
            static_cast<uint16_t>(__byte_perm(q0, q1, 0x0040));
      }
    }
  }
  wg::warpgroup_sync(c);
  int8_t* out = static_cast<int8_t*>(p.out);
#pragma unroll
  for (int k = 0; k < STAGING / 16 / 128; ++k) {
    const int ch = k * 128 + tid;
    const int r = ch / (BN / 16), cc = ch % (BN / 16);
    const int row = mt * BM + r, col = nt * BN + cc * 16;
    if (row >= p.M || col >= p.Cout) continue;
    const int4 v = *reinterpret_cast<const int4*>(staging + r * BN +
                                                  ((cc ^ (r & 7)) * 16));
    int8_t* dst = out + static_cast<size_t>(row) * p.Cout + col;
    if ((p.Cout & 15) == 0) {
      *reinterpret_cast<int4*>(dst) = v;
    } else {
      const int8_t* bb = reinterpret_cast<const int8_t*>(&v);
      for (int e = 0; e < 16 && col + e < p.Cout; ++e) dst[e] = bb[e];
    }
  }
}

// The f32 outputs of consumer c's tile, straight from the fragments, 8
// bytes a thread where Cout is even (a quad covers a 32-byte sector).
template <int ACT>
__device__ __forceinline__ void store_f32(const int (&acc)[NREG],
                                          const float* sc_s,
                                          const float* bi_s, const Conv& p,
                                          int mt, int nt, int c) {
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const bool even = (p.Cout & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cl = 8 * j + 2 * t;
    const int col = nt * BN + cl;
    const float2 sc = *reinterpret_cast<const float2*>(sc_s + cl);
    const float2 bi = *reinterpret_cast<const float2*>(bi_s + cl);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * BM + 64 * q + 16 * w + g + 8 * h;
        if (row >= p.M || col >= p.Cout) continue;
        const int i = 64 * q + 4 * j + 2 * h;
        float* out = static_cast<float*>(p.out) +
                     static_cast<size_t>(row) * p.Cout + col;
        const float y0 = epilogue_f32(acc[i], sc.x, bi.x, ACT);
        const float y1 = epilogue_f32(acc[i + 1], sc.y, bi.y, ACT);
        if (col + 1 < p.Cout && even) {
          *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
        } else {
          out[0] = y0;
          if (col + 1 < p.Cout) out[1] = y1;
        }
      }
    }
  }
  wg::warpgroup_sync(c);        // scale and bias read before the next tile's
}

__global__ void __launch_bounds__(wg::THREADS, 1)
conv_bt_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w, const Conv p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const Smem s(smem);
  if (threadIdx.x == 0) {
    for (int i = 0; i < WSTAGES; ++i) {
      tma::mbar_init(&s.wfull[i], 1);
      tma::mbar_init(&s.wempty[i], 4);    // the owning consumer's warps
    }
    for (int i = 0; i < BSTAGES; ++i) {
      tma::mbar_init(&s.bfull[i], 1);
      tma::mbar_init(&s.bempty[i], 4);
    }
    tma::mbar_init(&s.turn[0], 1);
    tma::mbar_init(&s.turn[1], 1);
    tma::fence_barrier_init();
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_x)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_w)) : "memory");
  }
  if (threadIdx.x < KC / 16) {
    reinterpret_cast<int4*>(const_cast<uint8_t*>(s.zero))[threadIdx.x] =
        make_int4(0, 0, 0, 0);
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
        wg::wait(&s.wempty[wp.stage], wp.phase ^ 1);
        tma::mbar_expect_tx(&s.wfull[wp.stage], p.win_rows * KC);
        wg::tma_load_2d(s.win + wp.stage * WIN_BYTES, &map_x,
                        &s.wfull[wp.stage], ch * KC, x.mt * BM - p.halo);
        wp.advance();
        for (int tap = 0; tap < 9; ++tap) {
          wg::wait(&s.bempty[bp.stage], bp.phase ^ 1);
          tma::mbar_expect_tx(&s.bfull[bp.stage], B_BYTES);
          wg::tma_load_2d(s.b + bp.stage * B_BYTES, &map_w,
                          &s.bfull[bp.stage], tap * p.Cin + ch * KC,
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
  const uint32_t zero = tma::smem_addr(s.zero);
  uint8_t* staging = s.staging + c * STAGING;
  float* sc_s = s.scb + c * 2 * BN;
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
    // the tile's scale and bias, for the epilogue; the previous tile's
    // were read before its epilogue's last warpgroup_sync
    const int col = x.nt * BN + tid;
    sc_s[tid] = col < p.Cout ? p.scale[col] : 0.f;
    bi_s[tid] = col < p.Cout ? p.bias[col] : 0.f;
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
    wg::take_turn(s.turn, c, k);

    // A step is one (chunk, tap): 4 wgmma groups, one a k32 step, each
    // of both m64 halves (so that no wgmma waits on the one before it for
    // its accumulator), each group's A fragments loaded from the window
    // (one ldmatrix a half) while the 3 groups before it run, into
    // registers whose last group the wait just before retired.
    uint32_t win = 0;
    int tap = 0, prev = -1;
    const int n = 9 * nch;
    for (int st = 0; st < n; ++st) {
      if (tap == 0) {
        wg::wait(&s.wfull[wp.stage], wp.phase);
        win = tma::smem_addr(s.win + wp.stage * WIN_BYTES);
      }
      wg::wait(&s.bfull[bp.stage], bp.phase);
      const int off = (tap / 3 - 1) * p.W + (tap % 3 - 1);
      // the addressed row's window row for this tap (or the zero row
      // where the tap leaves the pixel's image) and its swizzle phase
      uint32_t base[2];
      int sw[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int ra = lrow[q] + off;
        const bool v = (taps[q] >> tap) & 1;
        base[q] = v ? win + ra * KC : zero;
        sw[q] = v ? ra & 7 : 0;
      }
      const uint64_t db = wg::desc_sw128(s.b + bp.stage * B_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg::wgmma_wait<3>();
        keep(a[kk]);
        // the last step's last group retired: its B stage is free
        if (kk == 3 && prev >= 0 && lead) wg::mbar_arrive(&s.bempty[prev]);
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
        if (lead) wg::mbar_arrive(&s.wempty[wp.stage]);
        wp.advance();
      }
      prev = bp.stage;
      bp.advance();
    }
    if (tid == 0) wg::mbar_arrive(&s.turn[1 - c]);
    wg::wgmma_wait<0>();
    wg::fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) keep(a[kk]);
    if (lead) wg::mbar_arrive(&s.bempty[prev]);
    ++k;

    if (p.splits > 1 &&
        !wg::splitk_fixup(acc, p.ws, p.counters, &s.flags[c], c, x.tile,
                          x.s, p.splits, p.M - x.mt * BM)) {
      continue;
    }
    wg::warpgroup_sync(c);      // scale and bias written, staging free
    switch (p.quantize * 3 + p.act) {
      case 0: store_f32<0>(acc, sc_s, bi_s, p, x.mt, x.nt, c); break;
      case 1: store_f32<1>(acc, sc_s, bi_s, p, x.mt, x.nt, c); break;
      case 2: store_f32<2>(acc, sc_s, bi_s, p, x.mt, x.nt, c); break;
      case 3: store_codes<0>(acc, staging, sc_s, bi_s, p, x.mt, x.nt, c);
        break;
      case 4: store_codes<1>(acc, staging, sc_s, bi_s, p, x.mt, x.nt, c);
        break;
      default: store_codes<2>(acc, staging, sc_s, bi_s, p, x.mt, x.nt, c);
        break;
    }
  }
}

}  // namespace

// x (N, H, W, Cin) int8, 16-byte aligned, Cin % 128 == 0, W + 1 <= 32;
// wt (Cout, 9*Cin) K-major, 16-byte aligned. `splits` K-splits (in chunks
// of 128 channels, at most Cin / 128) over `grid` persistent blocks; ws
// holds tiles * splits * 128 * 128 int32 and counters `tiles` zeroed int32
// when splits > 1. Returns a cudaError_t, or minus the CUresult of a
// failed tensor-map encode.
extern "C" int conv3x3_bt(const void* x, const void* wt, const void* scale,
                          const void* bias, void* out, int N, int H, int W,
                          int Cin, int Cout, int quantize, int act,
                          int splits, int grid, void* ws, void* counters,
                          void* stream) {
  Conv p;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.ws = static_cast<int*>(ws);
  p.counters = static_cast<int*>(counters);
  p.H = H;
  p.W = W;
  p.M = N * H * W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.quantize = quantize;
  p.act = act;
  p.halo = W + 1;
  p.win_rows = BM + 2 * p.halo;
  p.chunks = Cin / KC;
  p.n_tiles = (Cout + BN - 1) / BN;
  p.splits = splits;
  p.units = (p.M + BM - 1) / BM * p.n_tiles * splits;
  if (W < 1 || W + 1 > HALO_MAX || Cin <= 0 || Cin % KC || splits < 1 ||
      splits > p.chunks || grid < 1 ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.M <= 0 || Cout <= 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap mx, mw;
  const uint64_t xdims[2] = {static_cast<uint64_t>(Cin),
                             static_cast<uint64_t>(p.M)};
  const uint64_t xstride[1] = {static_cast<uint64_t>(Cin)};
  const uint32_t xbox[2] = {KC, static_cast<uint32_t>(p.win_rows)};
  CUresult r = tma::encode_s8(&mx, x, 2, xdims, xstride, xbox,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const uint64_t wdims[2] = {static_cast<uint64_t>(9) * Cin,
                             static_cast<uint64_t>(Cout)};
  const uint64_t wstride[1] = {static_cast<uint64_t>(9) * Cin};
  const uint32_t wbox[2] = {KC, BN};
  r = tma::encode_s8(&mw, wt, 2, wdims, wstride, wbox,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  static unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(done & (1u << (dev & 31)))) {
    err = cudaFuncSetAttribute(
        conv_bt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess) done |= 1u << (dev & 31);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_bt_kernel<<<grid, wg::THREADS, SMEM,
                   static_cast<cudaStream_t>(stream)>>>(mx, mw, p);
  return static_cast<int>(cudaGetLastError());
}
