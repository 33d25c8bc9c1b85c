// Fused float GEMM for Hopper (sm_90a): C = act(A @ B * scale[col] +
// bias[col]), A (M, K) float32, B K-major (N, K) float32 or int8 codes,
// accumulated in float32, float32 out.
//
// Replaces: dnn_inference_engine_tpu/ops/pallas_gemm.py, gemm_fused with
// float operands (both pl.pallas_call sites: the weights-resident and the
// 3-D tiled schedules, at Precision.HIGHEST). An int8 B is the weight-only
// (w8) form: the JAX kernel casts the codes to A's dtype in VMEM. Its
// callers are conv_lowering.conv2d_fp32_pallas (the fp32 gemm tier) and
// conv2d_w8_pallas (w8 with kernel="pallas").
//
// What bounds it on an H100 (data-sheet rates of the SXM part at 700 W):
// HIGHEST precision rules out a one-pass TF32 product (10 mantissa bits),
// but not three: each operand x is split into a TF32 hi and lo (hi + lo
// within 2^-21 |x|), and hi*hi + hi*lo + lo*hi (lo*lo dropped) is the
// float32 product to a few 2^-21 of |a||b|, below the float32 sum's own
// error. On the TF32 tensor cores (495 TFLOP/s) three products of the
// YOLO fp32 tier's batch-32 shapes take 1.09 ms, against 2.69 ms for one
// float32 product on the FMA pipe (67 TFLOP/s). An int8 B needs two: a
// code is exact in TF32, so b_lo = 0. At batch 1 (M = 169) 2-16 tiles
// cannot fill 132 SMs unless K is split.
//
// Two forms, chosen by the wrapper from the shape alone
// (ops/gemm.py:gemm_f32_form):
//
// - wgmma (K % 4 == 0 and every operand 16-byte aligned, which a TMA map
//   needs: every shape of the fp32 and w8 tiers' detect paths). The shape
//   of gemm_fused's (wgmma_s8.cuh): a persistent grid of at most one
//   block an SM walks units (128 x 128 tile, K-split) in order; a producer
//   thread keeps 8 stages (12 with an int8 B) of 16 floats of K in flight
//   by TMA (2-D tiled maps over the float32 rows as bytes, 64-byte
//   swizzle, the M, N and K edges zero-filled by the copy engine); two
//   consumer warpgroups take the units in turn (ping-pong, one's epilogue under
//   the other's mainloop) and run wgmma.mma_async m64n128k8
//   .f32.tf32.tf32, K-major. B's split is made once per weight tensor by
//   the wrapper (ops/gemm.py:tf32_split: hi = tf32_rn(b), lo = tf32_rn(b
//   - hi), cached beside the transposed weights; an int8 B comes as its
//   codes in float32). A's is made in the consumer, a k8 slice at a time:
//   A as it landed is its hi (the tensor cores read a float32 operand as
//   TF32 by dropping its low 13 bits), so hi*b comes from shared memory;
//   lo = tf32_rn(a - hi) is computed from the thread's own fragment of A
//   (four 4-byte shared loads through the swizzle) and fed as wgmma's
//   register A, while the previous slice's products run. No pass writes
//   A's halves anywhere: a pre-pass to device memory would triple A's
//   bytes, and one into shared memory (three warps of the producer
//   writing lo beside each landed stage, fenced for the tensor cores)
//   was slower than the register A, and the converters bound it. An A
//   element that is a NaN with a payload in its low 13 bits only reads
//   as inf. Per k8 slice the products run smallest first: hi*lo, lo*hi,
//   hi*hi (lo*b, hi*b for an int8 B).
//   Split-K: where the tiles alone leave SMs idle (the batch-1 shapes),
//   each (tile, split) is a unit of its own; the last unit of a tile to
//   finish adds the float32 partial sums in split order 0, 1, ... (its own
//   read back too), so the result does not depend on which unit finished
//   last, but the sum is taken in another order than an unsplit one: the
//   same tolerance holds (the card test's 8 sqrt(K) + 4 half-ulps of the
//   largest sum |a||b||scale|).
// - ragged (K % 4 != 0 or a misaligned operand: K = 27 of a generic
//   tier's first conv). The plain SIMT kernel: 128x128 output tiles per
//   block of 256 threads, each thread an 8x8 register tile (two 4x4
//   quadrants 64 apart, so its shared-memory reads are float4 broadcasts
//   free of bank conflicts); K in steps of 16 through a two-stage shared
//   memory ring; float32 A and B tiles arrive by 4-byte cp.async,
//   transposed to k-major on the way (src-size 0 zero-fills the ragged M,
//   N and K edges), an int8 B through registers one step ahead, converted
//   on store.
//
// Both forms fuse the epilogue in _epilogue's order: y = acc*scale + bias
// (rounded twice: __fmul_rn, __fadd_rn; nvcc would contract it into an
// FMA), then the activation.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "tma.cuh"
#include "wgmma_s8.cuh"

namespace {

__device__ __forceinline__ float activate(float y, int act) {
  if (act == 1) return y > 0.f ? y : __fmul_rn(0.1f, y);
  if (act == 2) return fmaxf(y, 0.f);
  return y;
}

__device__ __forceinline__ float epilogue(float acc, float sc, float bi,
                                          int act) {
  return activate(__fadd_rn(__fmul_rn(acc, sc), bi), act);
}

// ---------------------------------------------------------------------------
// The wgmma form
// ---------------------------------------------------------------------------

namespace f32wg {

constexpr int BM = 128;         // rows of a block tile
constexpr int BN = 128;         // columns of a block tile
constexpr int BK = 64;          // bytes of K a stage (16 floats): one atom
constexpr int KF = BK / 4;      // floats of K a stage
constexpr int TILE = 128 * BK;  // bytes of one operand's tile a stage
constexpr int NREG = BM * BN / 128;   // accumulator registers a thread

// NB: the B tiles a stage holds (2: B_hi and B_lo; 1: an int8 B's codes).
// A stage is A, then the B tiles, all filled by the copy engine.
template <int NB>
struct Cfg {
  static constexpr int STAGES = NB == 2 ? 8 : 12;
  static constexpr int STAGE_BYTES = (1 + NB) * TILE;
  // after the ring: each consumer's tile scale and bias (BN floats each)
  static constexpr int EXTRA = 2 * 2 * BN * 4;
  static constexpr int SMEM =
      1024 + STAGES * STAGE_BYTES + EXTRA + (2 * STAGES + 2) * 8 + 16;
};

template <int NB>
struct Ring {
  static constexpr int STAGES = Cfg<NB>::STAGES;
  uint8_t* base;                // 1024-byte aligned
  float* extra;                 // after the stages
  uint64_t* full;               // the copy engine filled A and B
  uint64_t* empty;              // the owning consumer's wgmma read it
  uint64_t* turn;               // consumer c's mainloop may start
  int* flags;                   // one int per consumer

  __device__ explicit Ring(uint8_t* raw) {
    const uint32_t a = tma::smem_addr(raw);
    base = raw + ((1024 - (a & 1023)) & 1023);
    extra = reinterpret_cast<float*>(base + STAGES * Cfg<NB>::STAGE_BYTES);
    full = reinterpret_cast<uint64_t*>(
        reinterpret_cast<uint8_t*>(extra) + Cfg<NB>::EXTRA);
    empty = full + STAGES;
    turn = empty + STAGES;
    flags = reinterpret_cast<int*>(turn + 2);
  }
  __device__ uint8_t* a(int s) const {
    return base + s * Cfg<NB>::STAGE_BYTES;
  }
  __device__ uint8_t* b(int s, int i) const { return a(s) + (1 + i) * TILE; }

  // One thread, before the block's first __syncthreads.
  __device__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      tma::mbar_init(&full[s], 1);
      tma::mbar_init(&empty[s], 4);     // the owning consumer's warps
    }
    tma::mbar_init(&turn[0], 1);
    tma::mbar_init(&turn[1], 1);
    tma::fence_barrier_init();
  }
};

// A's split as the tensor cores take it: they read a float32 operand as
// TF32 by dropping its low 13 bits, so A itself is hi = trunc(x), and lo
// = tf32_rn(x - hi) (x - hi is exact; rounded to nearest even at bit 13;
// 0 where x is inf or NaN): hi + lo is x to within 2^-21 |x|.
// ops/gemm.py:tf32_split_a is the same function.
__device__ __forceinline__ uint32_t lo_of(float x) {
  const uint32_t b = __float_as_uint(x);
  const uint32_t d =
      __float_as_uint(__fsub_rn(x, __uint_as_float(b & ~0x1FFFu)));
  const uint32_t r = (d + 0xFFFu + ((d >> 13) & 1u)) & ~0x1FFFu;
  return (b & 0x7F800000u) == 0x7F800000u ? 0u : r;
}

__device__ __forceinline__ void fence_acc(float (&acc)[NREG]) {
#pragma unroll
  for (int i = 0; i < NREG; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// d (64 floats) += A (64 x 8 tf32, desc a) * B (8 x 128 tf32, desc b);
// scale_d 0 overwrites d.
__device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b,
                                    int scale_d) {
  asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 floats) += A (64 x 8 tf32, registers a[4]) * B (8 x 128 tf32,
// desc b); scale_d 0 overwrites d. In warp w of the warpgroup, lane 4g +
// t holds A[16w + g][t], A[16w + g + 8][t], A[16w + g][t + 4] and A[16w
// + g + 8][t + 4] (mma.sync m16n8k8's tf32 layout).
__device__ __forceinline__ void mma_rs(float* d, const uint32_t (&a)[4],
                                       uint64_t b, int scale_d) {
  asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
}

// Keeps registers a wgmma reads asynchronously from being reused before
// the wait that retires it: a use of them that the compiler must order
// after the preceding wgmma_wait.
__device__ __forceinline__ void keep(uint32_t (&r)[2][4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[q][i])::"memory");
}

// Consumer c's `k`-th unit (k counts its own units from 0), of nk >= 1
// stages: acc = the 128 x 128 product over those stages (the first wgmma
// of each m64 half zeroes it). Turns as in wg::mma_unit.
template <int NB>
__device__ __forceinline__ void mma_unit(float (&acc)[NREG],
                                         const Ring<NB>& ring,
                                         wg::Pipe<Cfg<NB>::STAGES>& pipe,
                                         int nk, int c, int k) {
  const bool lead = threadIdx.x % 32 == 0;
  if (c == 1) {
    wg::wait(&ring.turn[1], k & 1);
  } else if (k > 0) {
    wg::wait(&ring.turn[0], (k - 1) & 1);
  }
  // this thread's rows of each m64 half (w its warp, g its quad) and the
  // 64-byte swizzle phase they share (rows r and r + 8 alike)
  const int tid = threadIdx.x % 128;
  const int t = tid % 4;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;
  const int swz = (r0 >> 1) & 3;
  uint32_t lo[2][2][4];         // [k8 slice][m half][fragment]
  int prev = -1;
  for (int kt = 0; kt < nk; ++kt) {
    wg::wait(&ring.full[pipe.stage], pipe.phase);
    const uint8_t* as = ring.a(pipe.stage);
    const uint64_t dh = wg::desc_sw64(as);
    const uint64_t b0 = wg::desc_sw64(ring.b(pipe.stage, 0));
    const uint64_t b1 = wg::desc_sw64(ring.b(pipe.stage, NB - 1));
#pragma unroll
    for (int kk = 0; kk < KF / 8; ++kk) {
      // lo of this slice's A fragments, from shared memory: element (R,
      // c) of the stage at byte 64 R + 16 ((c / 4) ^ swz) + 4 (c % 4)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint8_t* p0 = as + (64 * q + r0) * 64 + 4 * t;
        const uint8_t* p8 = p0 + 8 * 64;
        const int c0 = ((2 * kk) ^ swz) << 4, c1 = ((2 * kk + 1) ^ swz) << 4;
        lo[kk][q][0] = lo_of(*reinterpret_cast<const float*>(p0 + c0));
        lo[kk][q][1] = lo_of(*reinterpret_cast<const float*>(p8 + c0));
        lo[kk][q][2] = lo_of(*reinterpret_cast<const float*>(p0 + c1));
        lo[kk][q][3] = lo_of(*reinterpret_cast<const float*>(p8 + c1));
      }
      fence_acc(acc);
      wg::wgmma_fence();
      const int acc_on = (kt | kk) != 0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        // rows 64..127 of A start 4,096 bytes on; a k8 slice is 32 bytes
        const uint64_t ah = dh + q * (64 * BK >> 4) + 2 * kk;
        if (NB == 2) {
          mma(acc + 64 * q, ah, b1 + 2 * kk, acc_on);       // hi * lo
          mma_rs(acc + 64 * q, lo[kk][q], b0 + 2 * kk, 1);  // lo * hi
          mma(acc + 64 * q, ah, b0 + 2 * kk, 1);            // hi * hi
        } else {
          mma_rs(acc + 64 * q, lo[kk][q], b0 + 2 * kk, acc_on);  // lo * b
          mma(acc + 64 * q, ah, b0 + 2 * kk, 1);                 // hi * b
        }
      }
      wg::wgmma_commit();
      fence_acc(acc);
      // all but this slice's products retired: the other slice's lo
      // registers (two groups back) are free, and after the first slice
      // the previous stage is
      wg::wgmma_wait<1>();
      keep(lo[1 - kk]);
      if (kk == 0 && prev >= 0 && threadIdx.x % 32 == 0) {
        wg::mbar_arrive(&ring.empty[prev]);
      }
    }
    prev = pipe.stage;
    pipe.advance();
  }
  if (threadIdx.x % 128 == 0) wg::mbar_arrive(&ring.turn[1 - c]);
  wg::wgmma_wait<0>();
  fence_acc(acc);
  keep(lo[0]);
  keep(lo[1]);
  if (lead) wg::mbar_arrive(&ring.empty[prev]);
}

// Split-K, first half: consumer c's unit (tile, split s) of `rows` valid
// rows writes its partial sum to the workspace in register order
// (coalesced 16-byte stores, valid rows only) and counts itself in on the
// tile's counter; true when it is the tile's last unit (it then resets the
// counter to 0 for the next launch), which sums and stores the tile
// (reduce_store).
__device__ __forceinline__ bool splitk_arrive(const float (&acc)[NREG],
                                              float* ws, int* counters,
                                              int* flag, int c, int tile,
                                              int s, int splits, int rows) {
  const int tid = threadIdx.x % 128;
  const int r = 16 * (tid / 32) + (tid % 32) / 4;
  float4* mine = reinterpret_cast<float4*>(ws) +
                 (static_cast<size_t>(tile) * splits + s) * 32 * NREG;
#pragma unroll
  for (int q = 0; q < NREG / 4; ++q) {
    if (64 * (q / 16) + r >= rows) continue;
    __stcg(&mine[q * 128 + tid],
           make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                       acc[4 * q + 3]));
  }
  __threadfence();
  wg::warpgroup_sync(c);
  if (tid == 0) {
    const int done = atomicAdd(&counters[tile], 1) == splits - 1;
    if (done) counters[tile] = 0;
    *flag = done;
    __threadfence();
  }
  wg::warpgroup_sync(c);
  return *reinterpret_cast<volatile int*>(flag) != 0;
}

struct Args {
  const float* scale;
  const float* bias;
  float* out;
  float* ws;                    // split-K partial sums (splits > 1)
  int* counters;                // split-K arrival counters, zero
  int M, N, K, act;
  int n_tiles, splits, units, kt;
};

// Consumer c's tile from the fragments, 8 bytes a thread where N is even.
// ACT is a template argument so that the activation is no branch a value.
template <int ACT>
__device__ __forceinline__ void store_tile(const float (&acc)[NREG],
                                           const float* sc, const float* bi,
                                           int r0, int n0, const Args& p) {
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const bool even = (p.N & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cl = 8 * j + 2 * t;
    const int col = n0 + cl;
    const float2 s2 = *reinterpret_cast<const float2*>(sc + cl);
    const float2 b2 = *reinterpret_cast<const float2*>(bi + cl);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 64 * q + 16 * w + g + 8 * h;
        if (row >= p.M || col >= p.N) continue;
        const int i = 64 * q + 4 * j + 2 * h;
        float* out = p.out + static_cast<size_t>(row) * p.N + col;
        const float y0 = epilogue(acc[i], s2.x, b2.x, ACT);
        const float y1 = epilogue(acc[i + 1], s2.y, b2.y, ACT);
        if (col + 1 < p.N && even) {
          *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
        } else {
          out[0] = y0;
          if (col + 1 < p.N) out[1] = y1;
        }
      }
    }
  }
}

// Split-K, second half: the tile's last unit adds the `splits` (<= MAXS)
// partials in split order, p_0 + p_1 + ... (its own read back too), so the
// sum does not depend on which unit came last, and stores the tile with
// the epilogue, QC 16-byte fragments (2 rows x 2 columns) at a time: the
// loads of a chunk's partials are all in flight at once, so a chunk costs
// one round trip to L2 (summed into the live accumulator, a load at a
// time, the fixup took longer than a batch-1 unit's mainloop).
constexpr int MAXS = 8;
template <int ACT>
__device__ __forceinline__ void reduce_store(const float* ws, int tile,
                                             int splits, int rows,
                                             const float* sc, const float* bi,
                                             int r0, int n0, const Args& p) {
  constexpr int QC = 2;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int r = 16 * w + g;
  const float4* slot = reinterpret_cast<const float4*>(ws) +
                       static_cast<size_t>(tile) * splits * 32 * NREG;
  for (int q0 = 0; q0 < NREG / 4; q0 += QC) {
    if (64 * (q0 / 16) + r >= rows) continue;   // a chunk is in one m half
    float4 v[QC][MAXS];
#pragma unroll
    for (int qq = 0; qq < QC; ++qq) {
#pragma unroll
      for (int o = 0; o < MAXS; ++o) {
        v[qq][o] = o < splits
                       ? __ldcg(&slot[static_cast<size_t>(o) * 32 * NREG +
                                      (q0 + qq) * 128 + tid])
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int qq = 0; qq < QC; ++qq) {
      float4 sum = v[qq][0];
#pragma unroll
      for (int o = 1; o < MAXS; ++o) {
        if (o < splits) {
          sum.x = __fadd_rn(sum.x, v[qq][o].x);
          sum.y = __fadd_rn(sum.y, v[qq][o].y);
          sum.z = __fadd_rn(sum.z, v[qq][o].z);
          sum.w = __fadd_rn(sum.w, v[qq][o].w);
        }
      }
      // float4 q = 16 m + j holds rows r, r + 8 of m half m, columns
      // 8j + 2t, + 1
      const int q = q0 + qq, j = q % 16;
      const int cl = 8 * j + 2 * t, col = n0 + cl;
      if (col >= p.N) continue;
      const bool v1 = col + 1 < p.N, even = (p.N & 1) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 64 * (q / 16) + r + 8 * h;
        if (row >= p.M) continue;
        float* out = p.out + static_cast<size_t>(row) * p.N + col;
        const float y0 = epilogue(h ? sum.z : sum.x, sc[cl], bi[cl], ACT);
        const float y1 =
            epilogue(h ? sum.w : sum.y, sc[cl + 1], bi[cl + 1], ACT);
        if (v1 && even) {
          *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
        } else {
          out[0] = y0;
          if (v1) out[1] = y1;
        }
      }
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(wg::THREADS, 1)
gemm_f32_kernel_wgmma(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b0,
                      const __grid_constant__ CUtensorMap map_b1,
                      const Args p) {
  constexpr int STAGES = Cfg<NB>::STAGES;
  extern __shared__ __align__(1024) uint8_t smem[];
  const Ring<NB> ring(smem);
  if (threadIdx.x == 0) {
    ring.init();
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map_b0)) : "memory");
    if (NB == 2) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&map_b1)) : "memory");
    }
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // --- producer: one thread issues every copy, in unit order ---
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      wg::Pipe<STAGES> pipe;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const wg::Unit x = wg::unit(u, p.splits, p.n_tiles, p.kt);
        for (int kt = x.kb; kt < x.ke; ++kt) {
          uint64_t* full = &ring.full[pipe.stage];
          wg::wait(&ring.empty[pipe.stage], pipe.phase ^ 1);
          tma::mbar_expect_tx(full, Cfg<NB>::STAGE_BYTES);
          wg::tma_load_2d(ring.a(pipe.stage), &map_a, full, kt * BK,
                          x.mt * BM);
          wg::tma_load_2d(ring.b(pipe.stage, 0), &map_b0, full, kt * BK,
                          x.nt * BN);
          if (NB == 2) {
            wg::tma_load_2d(ring.b(pipe.stage, 1), &map_b1, full, kt * BK,
                            x.nt * BN);
          }
          pipe.advance();
        }
      }
    }
  } else {
    // --- consumers: c takes the block's units 2k + c, whole tiles ---
    wg::setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    float* sc_s = ring.extra + c * 2 * BN;
    float* bi_s = sc_s + BN;
    wg::Pipe<STAGES> pipe;
    int i = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++i) {
      const wg::Unit x = wg::unit(u, p.splits, p.n_tiles, p.kt);
      if ((i & 1) != c) {
        pipe.skip(x.ke - x.kb);
        continue;
      }
      // a unit's own accumulator (the first wgmma overwrites it): dead
      // once the split-K partial is written, so the reduction has its
      // registers
      float acc[NREG];
      // the tile's scale and bias, for the epilogue; the previous tile's
      // were read before its last warpgroup_sync
      const int col = x.nt * BN + tid;
      sc_s[tid] = col < p.N ? p.scale[col] : 0.f;
      bi_s[tid] = col < p.N ? p.bias[col] : 0.f;
      mma_unit<NB>(acc, ring, pipe, x.ke - x.kb, c, i >> 1);
      const int r0 = x.mt * BM, n0 = x.nt * BN;
      if (p.splits > 1) {
        if (!splitk_arrive(acc, p.ws, p.counters, &ring.flags[c], c, x.tile,
                           x.s, p.splits, p.M - r0)) {
          continue;
        }
        wg::warpgroup_sync(c);  // scale and bias written
        if (p.act == 1) {
          reduce_store<1>(p.ws, x.tile, p.splits, p.M - r0, sc_s, bi_s, r0,
                          n0, p);
        } else if (p.act == 2) {
          reduce_store<2>(p.ws, x.tile, p.splits, p.M - r0, sc_s, bi_s, r0,
                          n0, p);
        } else {
          reduce_store<0>(p.ws, x.tile, p.splits, p.M - r0, sc_s, bi_s, r0,
                          n0, p);
        }
        wg::warpgroup_sync(c);  // scale and bias read
        continue;
      }
      wg::warpgroup_sync(c);    // scale and bias written
      if (p.act == 1) {
        store_tile<1>(acc, sc_s, bi_s, r0, n0, p);
      } else if (p.act == 2) {
        store_tile<2>(acc, sc_s, bi_s, r0, n0, p);
      } else {
        store_tile<0>(acc, sc_s, bi_s, r0, n0, p);
      }
      wg::warpgroup_sync(c);    // scale and bias read
    }
  }
}

// A 2-D map of a row-major (rows, K) float32 matrix, as bytes: boxes of
// 128 rows x 64 bytes, 64-byte swizzle.
CUresult encode(CUtensorMap* map, const void* base, int rows, int K) {
  const uint64_t dims[2] = {static_cast<uint64_t>(K) * 4,
                            static_cast<uint64_t>(rows)};
  const uint64_t stride[1] = {static_cast<uint64_t>(K) * 4};
  const uint32_t box[2] = {BK, 128};
  return tma::encode_s8(map, base, 2, dims, stride, box,
                        CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int NB>
int launch(const float* A, const float* B0, const float* B1, const Args& p,
           int grid, cudaStream_t st) {
  CUtensorMap ma, mb0, mb1;
  CUresult r = encode(&ma, A, p.M, p.K);
  if (r == CUDA_SUCCESS) r = encode(&mb0, B0, p.N, p.K);
  if (r == CUDA_SUCCESS) r = encode(&mb1, NB == 2 ? B1 : B0, p.N, p.K);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  constexpr int smem = Cfg<NB>::SMEM;
  static unsigned done = 0;     // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(done & (1u << (dev & 31)))) {
    err = cudaFuncSetAttribute(gemm_f32_kernel_wgmma<NB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) done |= 1u << (dev & 31);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_f32_kernel_wgmma<NB><<<grid, wg::THREADS, smem, st>>>(ma, mb0, mb1,
                                                               p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32wg

// ---------------------------------------------------------------------------
// The ragged form
// ---------------------------------------------------------------------------

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int PAD = 4;          // keeps float4 rows 16-byte aligned
constexpr int LD = BM + PAD;    // shared row stride (floats), BM == BN
constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = THREADS / BK;   // 16 tile rows per load pass
constexpr int PASSES = BM / ROWS_PER_PASS;    // 8

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 4 : 0;        // src-size 0 zero-fills the 4 bytes
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// One (128 rows x BK) tile of a row-major (rows_total, K) float32 matrix,
// transposed into sm[k][row]. Thread t copies column t % BK of rows
// t / BK + 16 i: a warp reads two 64-byte row segments.
__device__ __forceinline__ void load_f32_tile(float* sm, const float* g,
                                              int row0, int rows_total,
                                              int k0, int K) {
  const int kk = threadIdx.x % BK;
  const int r = threadIdx.x / BK;
  const int k = k0 + kk;
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int row = r + i * ROWS_PER_PASS;
    const bool valid = (row0 + row < rows_total) && (k < K);
    const float* src =
        valid ? g + static_cast<size_t>(row0 + row) * K + k : g;
    cp_async4(sm + kk * LD + row, src, valid);
  }
}

// The int8 B tile, same mapping, into registers (zero outside).
__device__ __forceinline__ void load_s8_regs(float* v, const int8_t* g,
                                             int row0, int rows_total,
                                             int k0, int K) {
  const int kk = threadIdx.x % BK;
  const int r = threadIdx.x / BK;
  const int k = k0 + kk;
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int row = r + i * ROWS_PER_PASS;
    const bool valid = (row0 + row < rows_total) && (k < K);
    v[i] = valid ? static_cast<float>(
                       __ldg(g + static_cast<size_t>(row0 + row) * K + k))
                 : 0.f;
  }
}

__device__ __forceinline__ void store_regs(float* sm, const float* v) {
  const int kk = threadIdx.x % BK;
  const int r = threadIdx.x / BK;
#pragma unroll
  for (int i = 0; i < PASSES; ++i) sm[kk * LD + r + i * ROWS_PER_PASS] = v[i];
}

template <typename TB>
__global__ void __launch_bounds__(THREADS, 2)
gemm_f32_kernel_ragged(const float* __restrict__ A, const TB* __restrict__ B,
                const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ out,
                int M, int N, int K, int act) {
  constexpr bool kS8 = sizeof(TB) == 1;
  __shared__ __align__(16) float As[2][BK * LD];
  __shared__ __align__(16) float Bs[2][BK * LD];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16;   // output columns tx*4 and 64 + tx*4
  const int ty = threadIdx.x / 16;   // output rows ty*4 and 64 + ty*4
  const int nk = (K + BK - 1) / BK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float breg[PASSES];
  load_f32_tile(As[0], A, m0, M, 0, K);
  if constexpr (kS8) {
    load_s8_regs(breg, reinterpret_cast<const int8_t*>(B), n0, N, 0, K);
    store_regs(Bs[0], breg);
  } else {
    load_f32_tile(Bs[0], reinterpret_cast<const float*>(B), n0, N, 0, K);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    // the next step's tiles land in the other stage while this one runs;
    // every thread left that stage at the barrier closing the last step
    if (more) {
      const int k0 = (kt + 1) * BK;
      load_f32_tile(As[cur ^ 1], A, m0, M, k0, K);
      if constexpr (kS8) {
        load_s8_regs(breg, reinterpret_cast<const int8_t*>(B), n0, N, k0, K);
      } else {
        load_f32_tile(Bs[cur ^ 1], reinterpret_cast<const float*>(B), n0, N,
                      k0, K);
      }
    }
    cp_async_commit();

    const float* as = As[cur];
    const float* bs = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * LD + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * LD + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * LD + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * LD + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }

    if constexpr (kS8) {
      if (more) store_regs(Bs[cur ^ 1], breg);
    }
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
    float* o = out + static_cast<size_t>(row) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col >= N) continue;
      o[col] = epilogue(acc[i][j], scale[col], bias[col], act);
    }
  }
}

}  // namespace

// form 0: the ragged form; bt holds float32 (b_int8 0) or int8 codes (1),
// bt_lo, splits, grid, ws and counters are unused. form 1: the wgmma form
// with `splits` K-splits over `grid` persistent blocks; bt holds B_hi and
// bt_lo B_lo (b_int8 0), or bt the int8 codes as float32 and bt_lo null
// (b_int8 1); ws holds tiles * splits * 128 * 128 floats and counters
// `tiles` zeroed int32 when splits > 1. Returns a cudaError_t, or minus
// the CUresult of a failed tensor-map encode.
extern "C" int gemm_f32(const void* a, const void* bt, const void* bt_lo,
                        const void* scale, const void* bias, void* out,
                        int M, int N, int K, int act, int b_int8, int form,
                        int splits, int grid, void* ws, void* counters,
                        void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const float*>(a);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  if (form == 0) {
    dim3 g((M + BM - 1) / BM, (N + BN - 1) / BN);
    if (b_int8) {
      gemm_f32_kernel_ragged<int8_t><<<g, THREADS, 0, st>>>(
          A, static_cast<const int8_t*>(bt), sc, bi, o, M, N, K, act);
    } else {
      gemm_f32_kernel_ragged<float><<<g, THREADS, 0, st>>>(
          A, static_cast<const float*>(bt), sc, bi, o, M, N, K, act);
    }
    return static_cast<int>(cudaGetLastError());
  }
  f32wg::Args p;
  p.scale = sc;
  p.bias = bi;
  p.out = o;
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.M = M;
  p.N = N;
  p.K = K;
  p.act = act;
  p.n_tiles = (N + f32wg::BN - 1) / f32wg::BN;
  p.kt = (K + f32wg::KF - 1) / f32wg::KF;
  p.splits = splits;
  p.units = (M + f32wg::BM - 1) / f32wg::BM * p.n_tiles * splits;
  if (K % 4 != 0 || splits < 1 || splits > p.kt || splits > f32wg::MAXS ||
      grid < 1 || (!b_int8 && bt_lo == nullptr) ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* B0 = static_cast<const float*>(bt);
  const auto* B1 = static_cast<const float*>(bt_lo);
  return b_int8 ? f32wg::launch<1>(A, B0, nullptr, p, grid, st)
                : f32wg::launch<2>(A, B0, B1, p, grid, st);
}
