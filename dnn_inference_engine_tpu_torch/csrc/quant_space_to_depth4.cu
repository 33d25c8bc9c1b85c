// Fused quantize + space-to-depth(4) for Hopper (sm_90a): the network
// input of a folded entry stage, uint8 wire or f32, into int8 fold-4 codes.
//
// Replaces: dnn_inference_engine_tpu/ops/pallas_conv.py,
// quant_space_to_depth4 (kernel body _qs2d_kernel). Same contract:
//   out[n, i, j, 12p + 3q + c] = clip(rint(v / s), +-127),
//   v = xpad[n, 4i+p, 4j+q, c]  (uint8: v = u / 255 first)
// lanes 48 .. c_out-1 zero, c_out = max(pad_to, 48), any width. Both
// divisions are correctly rounded (__fdiv_rn), never a multiply by a
// reciprocal, as the JAX kernel and quantize_act divide. xpad is x seen
// through a zero border (top, left, and whatever reaches past H, W up to
// the padded Hp, Wp): the border is read as zero from the bounds, so the
// padded copy the JAX path makes before its kernel is never written. Zero
// quantizes to zero in both dtypes.
//
// What bounds it on an H100 (3.35 TB/s, SXM data sheet at 700 W): bytes,
// 3 (or 12) in and c_out out a 4 x 4 pixel block. The function is a byte
// map and an interleave: output pixel (n, i, j) is, for p = 0..3, the 12
// elements 12j - 3 left .. 12j - 3 left + 11 of input row 4i + p - top,
// each quantized, then c_out - 48 zeros. So:
//
// - One block a unit: `run` output pixels of one output row (n, i). At
//   batch 32 a unit is the whole row; at batch 1 the host cuts each row
//   into runs (qs2d4_grid in ops/fused_conv.py), so the grid holds at
//   least two blocks an SM. No division a pixel.
// - The unit's four input rows are staged whole: four threads issue one
//   bulk copy (cp.async.bulk, the copy engine) a row, of the 16-byte
//   granules that hold the run's valid elements, into a shared row buffer
//   whose byte k stands for the global byte floor16(start) + k, so every
//   copy lands 16-byte aligned whatever the row's alignment (rows of W * 3
//   bytes need not be 16-byte multiples, and the left border shifts each
//   run by 3 bytes a pixel). Elements in the border are never copied.
// - uint8: the code of a byte depends on the byte alone, so the block
//   builds a 256-entry table of codes while its copies are in flight,
//   with exactly the instructions of the plain version (two __fdiv_rn,
//   rintf, the clip): bit for bit by construction, ties to even included.
//   Each byte then costs one shared load. The table is one 256-byte copy:
//   its 64 words lie two to a bank, so a warp's lookups conflict at most
//   two ways. A copy a lane, each in a bank of its own, never conflicts
//   but costs its build and the index arithmetic, and measured slower.
//   f32 has no table: one __fdiv_rn an element.
// - Codes: each thread turns aligned words of the staged rows (4
//   elements: a funnel shift of two shared words, or 16 bytes of f32)
//   into a word of codes of a code row, element e at byte e, the border's
//   elements zero. In uint8 only the words at a row's ends take a mask,
//   so the interior loop has no branch. The conversion bounds the kernel:
//   it is the shared-memory and instruction work of every byte.
// - The output of a unit is one contiguous run of run * c_out bytes.
//   Consecutive threads store consecutive 16-byte chunks of it, each word
//   of a chunk one aligned word of a code row or zero. At c_out = 64 (the
//   folded entry stages' width, compiled in) a thread's chunk of a pixel
//   never changes, so its four code-word offsets are worked out once. A
//   width that is not a multiple of 16 leaves a unit a partial chunk at
//   each end, written a byte at a time; a width that is not a multiple of
//   4 composes a byte at a time.

#include <cstdint>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int THREADS = 128;

// Bytes of one staged row buffer: 12 * run elements of `elem` bytes, the
// copy's up to 15 bytes of leading alignment, and the second word a funnel
// shift reads past the last element. Mirrored by qs2d4_row_bytes.
__host__ __device__ constexpr int row_bytes(int run, int elem) {
  return (12 * run * elem + 15) / 16 * 16 + 32;
}

// Bytes of one code row: 12 * run codes. Mirrored by qs2d4_code_bytes.
__host__ __device__ constexpr int code_bytes(int run) {
  return (12 * run + 15) / 16 * 16;
}

// A block's dynamic shared memory: its staged rows and code rows.
__host__ __device__ constexpr int smem_bytes(int run, int elem) {
  return 4 * row_bytes(run, elem) + 4 * code_bytes(run);
}

struct Geom {
  int N, H, W, top, left, H4, W4, c_out, segs, run, units;
};

__device__ __forceinline__ uint32_t quant(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(q)));
}

__device__ __forceinline__ uint32_t pack(uint32_t c0, uint32_t c1,
                                         uint32_t c2, uint32_t c3) {
  return __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040),
                     0x5410);
}

// The bytes k of a word of elements e .. e+3 that lie in [lo, hi).
__device__ __forceinline__ uint32_t valid_mask(int e, int lo, int hi) {
  const int a = min(max(lo - e, 0), 4), b = min(max(hi - e, 0), 4);
  return static_cast<uint32_t>(((1ull << (8 * b)) - 1) &
                               ~((1ull << (8 * a)) - 1));
}

// The codes of the staged elements e .. e+3 whose first element is at
// shared byte `first` (a multiple of 4 for f32), packed.
template <bool U8>
__device__ __forceinline__ uint32_t convert4(const uint8_t* smem, int first,
                                             int e, const uint8_t* tbl,
                                             float s) {
  if (U8) {
    const int b = first + e;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(smem);
    const uint32_t x =
        __funnelshift_r(w[b >> 2], w[(b >> 2) + 1], 8 * (b & 3));
    return pack(tbl[x & 255], tbl[(x >> 8) & 255], tbl[(x >> 16) & 255],
                tbl[x >> 24]);
  }
  const int b = first + 4 * e;
  float4 v;
  if ((b & 15) == 0) {
    v = *reinterpret_cast<const float4*>(smem + b);
  } else {
    const float* f = reinterpret_cast<const float*>(smem + b);
    v = make_float4(f[0], f[1], f[2], f[3]);
  }
  return pack(quant(v.x, s), quant(v.y, s), quant(v.z, s), quant(v.w, s));
}

// Thread p < 4 of the block: stages input row p of `unit` (one bulk copy,
// arriving on `bar` with its bytes) and writes the row's buffer byte of the
// run's first element and its valid elements [lo, hi) (0, 0 for a row in
// the border).
template <int E>
__device__ __forceinline__ void stage_row(const void* xin, const Geom& g,
                                          int unit, int p, uint8_t* stage,
                                          int rb, uint64_t* bar, int* off,
                                          int* lo, int* hi) {
  const int row = unit / g.segs;             // n * H4 + i
  const int j0 = (unit - row * g.segs) * g.run;
  const int px = min(g.run, g.W4 - j0);
  const int n = row / g.H4, i = row - n * g.H4;
  const int u0 = 12 * j0 - 3 * g.left;       // the run's first element
  const int y = 4 * i + p - g.top;
  const int v0 = max(u0, 0), v1 = min(u0 + 12 * px, 3 * g.W);
  off[p] = lo[p] = hi[p] = 0;
  if (y < 0 || y >= g.H || v0 >= v1) {
    tma::mbar_expect_tx(bar, 0);
    return;
  }
  const long long r0 =
      static_cast<long long>(reinterpret_cast<uintptr_t>(xin)) +
      ((static_cast<long long>(n) * g.H + y) * g.W * 3) * E;
  const long long first = r0 + static_cast<long long>(u0) * E;
  const long long base = first & ~15ll;      // buffer byte 0
  const long long src = (r0 + static_cast<long long>(v0) * E) & ~15ll;
  const int len = static_cast<int>(
      ((r0 + static_cast<long long>(v1) * E + 15) & ~15ll) - src);
  off[p] = static_cast<int>(first - base);
  lo[p] = v0 - u0;
  hi[p] = v1 - u0;
  tma::mbar_expect_tx(bar, static_cast<uint32_t>(len));
  tma::bulk_load(stage + p * rb + static_cast<int>(src - base),
                 reinterpret_cast<const void*>(src),
                 static_cast<uint32_t>(len), bar);
}

// C64: c_out = 64 compiled in, else any width. Block b: unit b.
template <bool U8, bool C64>
__global__ void __launch_bounds__(THREADS)
qs2d4_kernel(const void* __restrict__ xin, float s, int8_t* __restrict__ out,
             Geom g) {
  constexpr int E = U8 ? 1 : 4;              // bytes an element
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint8_t tbl[U8 ? 256 : 1];
  __shared__ int off[4], lo[4], hi[4];
  __shared__ uint64_t bar;

  const int t = threadIdx.x;
  const int unit = blockIdx.x;
  const int rb = row_bytes(g.run, E), cb = code_bytes(g.run);
  uint8_t* codes = smem + 4 * rb;
  if (t == 0) {
    tma::mbar_init(&bar, 4);
    tma::fence_barrier_init();
  }
  __syncthreads();
  if (t < 4) stage_row<E>(xin, g, unit, t, smem, rb, &bar, off, lo, hi);
  if (U8) {
    for (int v = t; v < 256; v += THREADS)
      tbl[v] = static_cast<uint8_t>(
          quant(__fdiv_rn(__uint2float_rn(v), 255.f), s));
  }
  __syncthreads();

  const int row = unit / g.segs;
  const int j0 = (unit - row * g.segs) * g.run;
  const int px = min(g.run, g.W4 - j0);
  tma::mbar_wait(&bar, 0, "quant_space_to_depth4");

  // codes: word i of code row p holds the run's elements 4i .. 4i+3. A
  // row in the border is zeros; in uint8 the words inside the row's valid
  // elements [a, b) take no mask, the ends a mask; in f32, whose divisions
  // outweigh a mask, every word takes one
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int a = lo[p], b = hi[p], first = p * rb + off[p], n3 = 3 * px;
    uint32_t* crow = reinterpret_cast<uint32_t*>(codes + p * cb);
    if (a == b) {
      for (int i = t; i < n3; i += THREADS) crow[i] = 0;
    } else if (U8) {
      const int ia = min((a + 3) >> 2, n3), ib = max(ia, min(b >> 2, n3));
#pragma unroll 2
      for (int i = ia + t; i < ib; i += THREADS)
        crow[i] = convert4<U8>(smem, first, 4 * i, tbl, s);
      for (int i = t; i < n3 - (ib - ia); i += THREADS) {   // the ends
        const int j = i < ia ? i : i + (ib - ia);
        const uint32_t m = valid_mask(4 * j, a, b);
        crow[j] = m ? convert4<U8>(smem, first, 4 * j, tbl, s) & m : 0;
      }
    } else {
      for (int i = t; i < n3; i += THREADS)
        crow[i] = convert4<U8>(smem, first, 4 * i, tbl, s) &
                  valid_mask(4 * i, a, b);
    }
  }
  __syncthreads();

  const int c_out = C64 ? 64 : g.c_out;
  const uint32_t* cw = reinterpret_cast<const uint32_t*>(codes);
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(out) +
                       (static_cast<size_t>(row) * g.W4 + j0) * c_out;
  const uintptr_t g1 = g0 + static_cast<size_t>(px) * c_out;
  const uintptr_t c0 = g0 & ~uintptr_t(15);
  const int chunks = static_cast<int>((g1 - c0 + 15) >> 4);
  // the code at byte o of the run's output (lane o % c_out of pixel
  // o / c_out)
  auto byte_at = [&](int o) -> uint32_t {
    const int jj = o / c_out, l = o - jj * c_out;
    if (l >= 48) return 0;
    const int p = l / 12;
    return codes[p * cb + 12 * jj + l - 12 * p];
  };
  if (C64) {
    // 4 chunks a pixel, whole chunks: thread t stores chunk t & 3 of
    // pixels t / 4, t / 4 + THREADS / 4, ...; word k of chunk q is lanes
    // 16q + 4k .. +3, code word 3 jj + (16q + 4k) % 12 / 4 of row
    // (16q + 4k) / 12, or zero from lane 48 on
    const int q = t & 3;
    int wo[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = 16 * q + 4 * k, p = l / 12;
      wo[k] = l < 48 ? p * (cb / 4) + (l - 12 * p) / 4 : -1;
    }
    for (int jj = t >> 2; jj < px; jj += THREADS / 4) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = wo[k] < 0 ? 0 : cw[wo[k] + 3 * jj];
      *reinterpret_cast<uint4*>(g0 + 64 * jj + 16 * q) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
  for (int c = t; c < chunks; c += THREADS) {
    const uintptr_t gb = c0 + 16 * static_cast<uintptr_t>(c);
    if (gb < g0 || gb + 16 > g1) {           // a partial chunk at an end
      for (int q = 0; q < 16; ++q)
        if (gb + q >= g0 && gb + q < g1)
          *reinterpret_cast<int8_t*>(gb + q) =
              static_cast<int8_t>(byte_at(static_cast<int>(gb + q - g0)));
      continue;
    }
    const int o = static_cast<int>(gb - g0);
    uint32_t w[4];
    if (c_out % 4 == 0) {
      int jj = o / c_out, l = o - jj * c_out;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (l < 48) {
          const int p = l / 12;
          w[q] = cw[p * (cb / 4) + 3 * jj + (l - 12 * p) / 4];
        } else {
          w[q] = 0;
        }
        l += 4;
        if (l >= c_out) {
          l -= c_out;
          ++jj;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = pack(byte_at(o + 4 * q), byte_at(o + 4 * q + 1),
                    byte_at(o + 4 * q + 2), byte_at(o + 4 * q + 3));
    }
    *reinterpret_cast<uint4*>(gb) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <bool U8, bool C64>
cudaError_t launch(const void* x, float s, int8_t* out, const Geom& g,
                   cudaStream_t st) {
  qs2d4_kernel<U8, C64><<<static_cast<unsigned>(g.units), THREADS,
                          smem_bytes(g.run, U8 ? 1 : 4), st>>>(x, s, out, g);
  return cudaGetLastError();
}

template <bool U8>
cudaError_t launch(const void* x, float s, int8_t* out, const Geom& g,
                   cudaStream_t st) {
  return g.c_out == 64 ? launch<U8, true>(x, s, out, g, st)
                       : launch<U8, false>(x, s, out, g, st);
}

}  // namespace

// x (N, H, W, 3) uint8 (u8 != 0) or f32, read as if zero-padded to
// (Hp, Wp) with its first pixel at (top, left); out (N, Hp/4, Wp/4, c_out)
// int8, c_out >= 48, 16-byte aligned. Each output row is cut into `segs`
// units of `run` pixels (the last may be shorter), a block each; a block's
// shared memory (smem_bytes) must fit the 48 KB a block gets without
// opting in.
extern "C" int quant_space_to_depth4(const void* x, float s, void* out, int N,
                                     int H, int W, int top, int left, int Hp,
                                     int Wp, int c_out, int segs, int run,
                                     int u8, void* stream) {
  const long long units = static_cast<long long>(N) * (Hp / 4) * segs;
  const Geom g{N,    H,   W, top, left, Hp / 4, Wp / 4, c_out,
               segs, run, static_cast<int>(units)};
  if (c_out < 48 || segs < 1 || run < 1 ||
      static_cast<long long>(segs) * run < g.W4 ||
      static_cast<long long>(segs - 1) * run >= g.W4 ||
      units > 0x7fffffffll || smem_bytes(run, u8 ? 1 : 4) > 48 * 1024 ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (units == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<int8_t*>(out);
  return static_cast<int>(u8 ? launch<true>(x, s, o, g, st)
                             : launch<false>(x, s, o, g, st));
}
