// The NMS's suppress stage for Hopper (sm_90a): exact greedy NMS keep masks
// of one detect in one launch, from the candidates' boxes and scores.
//
// Replaces: dnn_inference_engine_tpu/postprocess.py, _greedy_fixpoint (its
// dominance build and its lax.while_loop) with the IoU lines of
// device_nms_cols before it. Not a Pallas kernel: XLA runs those on the
// device inside the jitted detect. Same result, for each (image b, class c):
//   valid[i] = s[i] > score_thresh
//   hit[i][j] = IoU(box i, box j) > iou_thresh, step by step as the plain
//               version computes it (postprocess.nms_suppress_plain)
//   j precedes i: s[j] > s[i], or s[j] == s[i] and oidx[j] < oidx[i]
//   keep[i] = valid[i] and no kept j that precedes i has hit[i][j]
// Precedence is a strict order, so the relation is a DAG and keep is
// unique: greedy NMS in any order that extends precedence. The kernel scans
// the valid candidates in rank order (score descending, then oidx, then
// position), and a pair of equal score and equal oidx, which neither
// precedes, gets no bit.
//
// Operands: xyxy (B, 4, K) float32 (x1, y1, x2, y2 planes), s (B, C, K)
// float32, oidx (B, K) int64; keep (B, C, K) bool out. Thresholds as
// float32, as PyTorch's and JAX's comparisons cast them.
//
// What bounds it on an H100. Bytes are few: xyxy, s and oidx read once and
// keep written once are 1.0 MB at batch 32, K 256 (0.0003 ms at 3.35
// TB/s). The IoU of the valid pairs is the work (n (n - 1) / 2 a block, n
// the valid candidates of its class: 12.8 on average at batch 32, all K
// at the eval grade's score 0.005), and the scan's n dependent steps are
// the floor a block cannot go under. So:
//
// - One block an (image, class), or, where B * C blocks leave most SMs
//   idle and K is large, a cluster of G blocks (G <= 8, from the wrapper)
//   that share the IoU; the cluster's block 0 scans.
// - Compact: only the class's valid candidates enter shared memory, in
//   position order (a ballot and a count a warp). An invalid candidate is
//   never kept and never suppresses.
// - Rank: up to 256 candidates, each thread counts the candidates before
//   its own, without a branch (no barrier: the pins' classes hold a dozen,
//   a few over a hundred); more, a bitonic
//   sort in shared memory (a stage a barrier). Then the boxes, areas and
//   positions are gathered in rank order.
// - Build: the upper-triangular bitmatrix over ranks, row r a bitset over
//   r' > r of hit(r', r), ceil(n/64) words a row. A task is one 64-bit word
//   (64 IoUs), taken by S lanes (a power of two up to 32, as many as the
//   block's tasks leave threads for), lane s testing ranks s, s + S, ...
//   of the word, an OR of shuffles making it. Consecutive groups take
//   consecutive rows of one word, so a warp reads each box of the word
//   once (a broadcast). The eval grade's thousands of tasks a block give
//   each thread its own, so the 64 tests of a word run back to back in
//   one thread with nothing to combine; the pins' dozen candidates a
//   class spread a word's tests over many lanes, shortening the chain of
//   tests in a thread. Each IoU is the
//   plain version's, step by step: __fsub_rn, __fmul_rn, __fadd_rn,
//   __fdiv_rn (nvcc would otherwise contract (a + b) - w * h into an FMA),
//   max and min that return NaN when either operand is NaN (max.NaN and
//   min.NaN, as torch.maximum, torch.minimum and clamp_min propagate it);
//   a pair that does not overlap skips the division (0 / union is 0).
//   The test stays one pass with a branch: a branch-free pass that
//   leaves the overlapping pairs to a second one loses where overlaps
//   are common, as in the eval grade's detections (PERF.md §6).
//   The rows stay in shared memory when K * ceil(K/64) words fit (K 845:
//   94.6 KB), written by a cluster's other blocks through distributed
//   shared memory; otherwise in a global scratch the wrapper allocates
//   (K 2535: 811 KB a class). Where even the candidates' lists do not fit
//   (K over about 4800: YOLOv3-tiny from 608 px), they too go to a global
//   scratch, a region a block, and only the removed and kept words stay in
//   shared memory (the scan's atomics and reads of them).
// - Scan, 64 ranks a chunk. Warp 0 resolves a chunk from its 64 diagonal
//   words (two registers a lane): a rank whose diagonal word is zero
//   removes no rank of its chunk, so only the ranks with a nonzero word
//   are walked, in order, a kept one ORing its word into the chunk's
//   removed word (shuffled from its lane). Then the whole block ORs each
//   (kept row, later word) pair into the removed words in shared memory,
//   one load a thread. Two barriers a chunk.
// - Scatter: keep is zeroed first; each kept rank sets its position.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int MAX_THREADS = 1024;
// the most candidates a class ranks by counting (a thread each; the
// wrapper's blocks have at least this many threads)
constexpr int COUNT_MAX = 256;

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// clamp_min(x2 - x1, 0) * clamp_min(y2 - y1, 0)
__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.f),
                   max_nan(__fsub_rn(b.w, b.y), 0.f));
}

// iou[i][j] > thr as the plain version computes it: i the later candidate
// (the row of the plain IoU), j the earlier
__device__ __forceinline__ bool iou_hit(float4 bi, float ai, float4 bj,
                                        float aj, float thr) {
  const float ix1 = max_nan(bi.x, bj.x), iy1 = max_nan(bi.y, bj.y);
  const float ix2 = min_nan(bi.z, bj.z), iy2 = min_nan(bi.w, bj.w);
  const float inter = __fmul_rn(max_nan(__fsub_rn(ix2, ix1), 0.f),
                                max_nan(__fsub_rn(iy2, iy1), 0.f));
  const float uni = max_nan(__fsub_rn(__fadd_rn(ai, aj), inter), 1e-9f);
  // no overlap: 0 / uni is 0, or NaN where uni is NaN, so the division,
  // the dearest step, is skipped
  if (inter == 0.f) return uni == uni && 0.f > thr;
  return __fdiv_rn(inter, uni) > thr;
}

// rank order of compacted candidates a and b: score descending, then oidx,
// then position (the compacted index); indices >= n (the sort's padding)
// after every candidate
__device__ __forceinline__ bool before(int a, int b, int n, const float* s,
                                       const long long* o) {
  if (a >= n || b >= n) return a < b;
  const float sa = s[a], sb = s[b];
  if (sa != sb) return sa > sb;
  const long long oa = o[a], ob = o[b];
  if (oa != ob) return oa < ob;
  return a < b;
}

struct Args {
  const float* xyxy;
  const float* s;
  const long long* oidx;
  uint8_t* keep;
  u64* scratch;       // (B*C, K, ceil(K/64)) words: the global route's rows
  unsigned char* lists;  // (B*C*G, list_bytes): a block's lists, else null
  long long list_bytes;
  int C, K, G;
  float iou, score;
};

template <bool GROWS>
__device__ __forceinline__ u64 ld_row(const u64* p) {
  if (GROWS) return __ldcg(p);    // written by other blocks of the cluster
  return *p;
}

// GROWS: the bitmatrix rows in the global scratch, else in shared memory;
// GLISTS (with GROWS): the lists in the block's global region, else in
// shared memory. Both are template flags so that the shared routes' loads
// compile to shared-memory loads, not generic ones.
// Dynamic shared memory, in this order (nms_suppress_smem and
// nms_suppress_lists in postprocess.py): removed, kept u64[W] each; then
// the lists, here or in the block's global region:
// box float4[K]; rows u64[K * W] (shared route only); o int64[K]; s, area
// float[K]; pos, rpos int[K]; idx int[P]; dup uint8[K]. W = ceil(K/64), P
// the power of two >= K.
template <bool GROWS, bool GLISTS>
__global__ void __launch_bounds__(MAX_THREADS)
nms_suppress_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_n[32];
  __shared__ int kept_idx[64];       // the scan's kept ranks of a chunk
  __shared__ int n_kept;

  const int K = a.K, W = (K + 63) >> 6;
  int P = 1;
  while (P < K) P <<= 1;
  u64* removed = reinterpret_cast<u64*>(smem);
  u64* kept_bits = removed + W;
  unsigned char* lists =
      GLISTS ? a.lists + static_cast<size_t>(blockIdx.x) * a.list_bytes
             : reinterpret_cast<unsigned char*>(kept_bits + W);
  float4* box = reinterpret_cast<float4*>(lists);
  u64* rows_sm = reinterpret_cast<u64*>(box + K);
  long long* o = reinterpret_cast<long long*>(
      GROWS ? rows_sm : rows_sm + static_cast<size_t>(K) * W);
  float* s = reinterpret_cast<float*>(o + K);
  float* area = s + K;
  int* pos = reinterpret_cast<int*>(area + K);
  int* rpos = pos + K;
  int* idx = rpos + K;
  uint8_t* dup = reinterpret_cast<uint8_t*>(idx + P);

  const int t = threadIdx.x, T = blockDim.x, lane = t & 31, warp = t >> 5;
  const int G = a.G;
  const int bc = blockIdx.x / G, g = blockIdx.x - bc * G;
  const int b = bc / a.C;
  const float* sk = a.s + static_cast<size_t>(bc) * K;
  const float* xy = a.xyxy + static_cast<size_t>(b) * 4 * K;
  const long long* oi = a.oidx + static_cast<size_t>(b) * K;
  uint8_t* keep = a.keep + static_cast<size_t>(bc) * K;

  // every block of the cluster has started before any remote store
  if (G > 1) cg::this_cluster().sync();

  // 1. compact the valid candidates, in position order; block 0 zeroes keep
  int n = 0;
  for (int k0 = 0; k0 < K; k0 += T) {
    const int k = k0 + t;
    float sc = 0.f;
    long long ok = 0;
    bool v = false;
    if (k < K) {
      sc = sk[k];
      ok = oi[k];                      // in flight with the score
      v = sc > a.score;
      if (g == 0) keep[k] = 0;
    }
    const unsigned m = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int off = n, tot = 0;
    for (int i = 0; i < (T >> 5); ++i) {
      const int c = warp_n[i];
      off += i < warp ? c : 0;
      tot += c;
    }
    if (v) {
      const int j = off + __popc(m & ((1u << lane) - 1u));
      pos[j] = k;
      s[j] = sc;
      o[j] = ok;
    }
    n += tot;
    __syncthreads();     // warp_n is rewritten by the next chunk
  }

  // 2. rank: up to COUNT_MAX candidates, a thread each counts those that
  // come before its own (no barrier); more, a bitonic sort
  if (n <= COUNT_MAX) {
    if (t < n) {
      const float si = s[t];
      const long long oi_t = o[t];
      int rk = 0;
#pragma unroll 8
      for (int j = 0; j < n; ++j) {          // before(j, t), without branches
        const float sj = s[j];
        const long long oj = o[j];
        rk += (sj > si) |
              ((sj == si) & ((oj < oi_t) | ((oj == oi_t) & (j < t))));
      }
      idx[rk] = t;
    }
    __syncthreads();
  } else {
    int Pn = 1;
    while (Pn < n) Pn <<= 1;
    for (int i = t; i < Pn; i += T) idx[i] = i;
    __syncthreads();
    for (int k2 = 2; k2 <= Pn; k2 <<= 1) {
      for (int j = k2 >> 1; j > 0; j >>= 1) {
        for (int p = t; p < (Pn >> 1); p += T) {
          const int i = 2 * p - (p & (j - 1)), l = i + j;
          const int x = idx[i], y = idx[l];
          const bool up = (i & k2) == 0;
          if (up ? before(y, x, n, s, o) : before(x, y, n, s, o)) {
            idx[i] = y;
            idx[l] = x;
          }
        }
        __syncthreads();
      }
    }
  }

  // 3. gather in rank order; mark ranks equal in score and oidx to the
  // rank before (neither precedes the other)
  int has_dup = 0;
  for (int r = t; r < n; r += T) {
    const int j = idx[r];
    const int k = pos[j];
    rpos[r] = k;
    const float4 bx = make_float4(xy[k], xy[K + k], xy[2 * K + k],
                                  xy[3 * K + k]);
    box[r] = bx;
    area[r] = box_area(bx);
    bool d = false;
    if (r > 0) {
      const int jp = idx[r - 1];
      d = s[jp] == s[j] && o[jp] == o[j];
    }
    dup[r] = d;
    has_dup |= d;
  }
  if (g == 0)
    for (int w = t; w < W; w += T) removed[w] = 0ull;
  has_dup = __syncthreads_or(has_dup);

  // 4. build this block's share of the bitmatrix: task q is word w of row
  // r, rows grouped by 64 (group gg's rows have words gg .. Wn-1)
  const int Wn = (n + 63) >> 6;
  u64* rows_rd = GROWS ? a.scratch + static_cast<size_t>(bc) * K * W
                       : rows_sm;
  u64* rows_wr = rows_rd;
  if (!GROWS && G > 1) rows_wr = cg::this_cluster().map_shared_rank(rows_sm, 0);
  const int Q = 32 * Wn * (Wn + 1);
  const int q0 = static_cast<int>(static_cast<long long>(Q) * g / G);
  const int q1 = static_cast<int>(static_cast<long long>(Q) * (g + 1) / G);
  // S lanes a task (a power of two up to a warp), as many as leave no
  // thread idle: the pins' classes (a dozen candidates) spread each word's
  // 64 tests over many lanes, the eval grade's give each thread its own
  const int live = (Q - (64 * Wn - n)) / G;    // tasks of rows < n, a block
  int S = 1;
  while (S < 32 && live * S * 2 <= T) S <<= 1;
  const int sub = lane & (S - 1);
  const unsigned group = S == 32 ? 0xffffffffu
                                 : ((1u << S) - 1u) << (lane & ~(S - 1));
  int gg = 0, first = 0;                       // a row group and its task 0
  for (int q = q0 + t / S; q < q1; q += T / S) {
    while (q >= first + 64 * (Wn - gg)) {
      first += 64 * (Wn - gg);
      ++gg;
    }
    const int local = q - first;
    const int w = gg + (local >> 6), r = (gg << 6) + (local & 63);
    if (r >= n) continue;                      // the same in the S lanes
    const float4 bj = box[r];
    const float aj = area[r];
    const int r0 = w << 6, hi = min(64, n - r0);
    u64 word = 0ull;
#pragma unroll 4
    for (int jj = sub; jj < hi; jj += S) {
      const int r2 = r0 + jj;
      if (r2 > r && iou_hit(box[r2], area[r2], bj, aj, a.iou))
        word |= 1ull << jj;
    }
    for (int d = S >> 1; d > 0; d >>= 1)
      word |= __shfl_xor_sync(group, word, d);
    if (sub == 0) rows_wr[static_cast<size_t>(r) * Wn + w] = word;
  }
  if (G > 1) {
    if (GROWS) __threadfence();
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  if (g != 0) return;

  // 5. clear the bits between ranks of equal score and oidx (rare)
  if (has_dup) {
    for (int r2 = t; r2 < n; r2 += T) {
      if (!dup[r2]) continue;
      int gs = r2;
      while (gs > 0 && dup[gs]) --gs;
      const u64 clear = ~(1ull << (r2 & 63));
      for (int r = gs; r < r2; ++r)
        atomicAnd(rows_rd + static_cast<size_t>(r) * Wn + (r2 >> 6), clear);
    }
    __syncthreads();
  }

  // 6. scan, 64 ranks a chunk. Warp 0 resolves the chunk: a rank whose
  // diagonal word is zero removes no rank of the chunk, so only the ranks
  // with a nonzero one are walked, in order, each kept one ORing its word
  // in; then every thread ORs a (kept row, later word) pair into removed.
  for (int c = 0; c < Wn; ++c) {
    const int r0 = c << 6, m = min(64, n - r0);
    if (warp == 0) {
      u64 d0 = 0ull, d1 = 0ull;
      if (lane < m)
        d0 = ld_row<GROWS>(rows_rd + static_cast<size_t>(r0 + lane) * Wn + c);
      if (lane + 32 < m)
        d1 = ld_row<GROWS>(rows_rd +
                           static_cast<size_t>(r0 + 32 + lane) * Wn + c);
      const u64 ranks = m == 64 ? ~0ull : (1ull << m) - 1ull;
      const u64 nz = static_cast<u64>(__ballot_sync(0xffffffffu, d0 != 0ull))
          | static_cast<u64>(__ballot_sync(0xffffffffu, d1 != 0ull)) << 32;
      u64 rm = removed[c];
      u64 todo = nz & ~rm & ranks;             // the same in every lane
      while (todo) {
        const int j = __ffsll(static_cast<long long>(todo)) - 1;
        rm |= __shfl_sync(0xffffffffu, j < 32 ? d0 : d1, j & 31);
        todo &= ~rm & (~1ull << j);
      }
      const u64 kept = ~rm & ranks;
      const unsigned k_lo = static_cast<unsigned>(kept);
      const unsigned k_hi = static_cast<unsigned>(kept >> 32);
      const unsigned below = (1u << lane) - 1u;
      if ((k_lo >> lane) & 1u) kept_idx[__popc(k_lo & below)] = lane;
      if ((k_hi >> lane) & 1u)
        kept_idx[__popc(k_lo) + __popc(k_hi & below)] = 32 + lane;
      if (lane == 0) {
        kept_bits[c] = kept;
        n_kept = __popcll(kept);
      }
    }
    __syncthreads();
    const int words = Wn - c - 1, pairs = n_kept * words;
    for (int p = t; p < pairs; p += T) {
      const int jn = p / words, w = c + 1 + p - jn * words;
      const u64 v = ld_row<GROWS>(
          rows_rd + static_cast<size_t>(r0 + kept_idx[jn]) * Wn + w);
      if (v) atomicOr(removed + w, v);
    }
    __syncthreads();
  }

  // 7. scatter
  for (int r = t; r < n; r += T)
    if ((kept_bits[r >> 6] >> (r & 63)) & 1ull) keep[rpos[r]] = 1;
}

}  // namespace

// BC * G blocks of `threads`, `smem` bytes of dynamic shared memory each
// (the wrapper's nms_suppress_form); scratch null for the shared route;
// lists null where they fit in shared memory, else BC * G regions of
// list_bytes (a multiple of 16), with scratch set.
extern "C" int nms_suppress(const void* xyxy, const void* s,
                            const void* oidx, void* keep, void* scratch,
                            void* lists, long long list_bytes,
                            int BC, int C, int K, float iou_thresh,
                            float score_thresh, int G, int threads, int smem,
                            void* stream) {
  if (BC <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  if (lists != nullptr && (scratch == nullptr || list_bytes % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(xyxy), static_cast<const float*>(s),
         static_cast<const long long*>(oidx), static_cast<uint8_t*>(keep),
         static_cast<u64*>(scratch), static_cast<unsigned char*>(lists),
         list_bytes, C, K, G, iou_thresh, score_thresh};
  const int route = lists != nullptr ? 2 : scratch != nullptr ? 1 : 0;
  void (*kern)(Args) = route == 2   ? nms_suppress_kernel<true, true>
                       : route == 1 ? nms_suppress_kernel<true, false>
                                    : nms_suppress_kernel<false, false>;
  // the dynamic shared memory allowed, raised where this launch needs more
  // (per instantiation and device)
  static std::atomic<int> allowed[3][64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::atomic<int>& cur = allowed[route][dev & 63];
  if (smem > cur.load()) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cur.store(smem);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BC * G);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = G > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
